"""``paddle_tpu_torch.vision.models.resnet18`` trained through the port's
``make_train_step`` against the reference's jitted ``make_train_step``,
from the same weights and running statistics
(``params_from_numpy``), on the same batches.

The comparison is in float64.  In fp32 it would say nothing: 4-sample
BatchNorm amplifies reduction-order noise to ~5% on deep conv gradients,
and a 1e-6 change to one weight flips a 3-step trajectory
(``tests/test_vision_models_extra.py``).  Losses, every parameter and
every running statistic must agree within ``rtol=1e-8, atol=1e-8`` after
each of 3 Momentum steps (lr 0.1, momentum 0.9, weight decay 1e-4, the
harness's vision step), in NCHW and NHWC, with ``donate`` True and
False.  Each reference trajectory is computed once per module.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import functional as jf
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision.models import resnet18 as jresnet18
from paddle_tpu_torch.jit.functional import make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision.models import params_from_numpy, resnet18

KEY0 = np.array([0, 0], np.uint32)          # jax.random.PRNGKey(0)'s data
RTOL = ATOL = 1e-8
B, HW, STEPS, LR = 4, 32, 3, 0.1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: the
    suite runs six workers on the cores, and a worker spreading small
    ops over every core spends its time in OpenMP's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


def _batches(df):
    r = np.random.RandomState(11)
    out = []
    for _ in range(STEPS):
        x = r.randn(B, 3, HW, HW)
        if df == "NHWC":
            x = np.ascontiguousarray(np.transpose(x, (0, 2, 3, 1)))
        out.append((x, r.randint(0, 10, (B,)).astype(np.int64)))
    return out


def _to64(m):
    for _, p in m.named_parameters():
        p._data = p._data.astype(jnp.float64)
    for _, b in m.named_buffers():
        b._data = b._data.astype(jnp.float64)


def _snapshot(state):
    return {part: {n: np.asarray(v) for n, v in state[part].items()}
            for part in ("params", "buffers")}


@pytest.fixture(scope="module")
def reference():
    """Per data format: the initial numpy state and, after each step, the
    loss, the parameters and the buffers of the reference's jitted
    step."""
    jax.config.update("jax_enable_x64", True)
    try:
        runs = {}
        for df in ("NCHW", "NHWC"):
            paddle.seed(0)
            m = jresnet18(num_classes=10, data_format=df)
            _to64(m)
            step, st = jf.make_train_step(
                m, lambda o, y: JF.cross_entropy(o, y),
                JMomentum(LR, momentum=0.9, weight_decay=1e-4),
                donate=False)
            init = _snapshot(st)
            traj = []
            for x, y in _batches(df):
                st, (loss, _) = step(st, jax.random.PRNGKey(0),
                                     np.float32(LR), [x], [y])
                traj.append((float(loss), _snapshot(st)))
            runs[df] = (init, traj)
        return runs
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("donate", [True, False])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_resnet18_float64_trajectory(reference, df, donate):
    init, traj = reference[df]
    model = resnet18(num_classes=10, data_format=df, device="cpu").double()
    params_from_numpy(model, init["params"], init["buffers"])
    step, state = make_train_step(
        model, lambda o, y: F.cross_entropy(o, y),
        Momentum(LR, momentum=0.9, weight_decay=1e-4), donate=donate)
    for i, ((x, y), (jloss, want)) in enumerate(zip(_batches(df), traj)):
        state, (loss, out) = step(state, KEY0, LR, [torch.from_numpy(x)],
                                  [torch.from_numpy(y)])
        assert out.shape == (B, 10) and out.dtype == torch.float64
        np.testing.assert_allclose(float(loss), jloss, rtol=RTOL, atol=ATOL,
                                   err_msg=f"loss at step {i}")
        for part in ("params", "buffers"):
            assert set(state[part]) == set(want[part])
            for n, v in state[part].items():
                np.testing.assert_allclose(
                    v.detach().numpy(), want[part][n], rtol=RTOL, atol=ATOL,
                    err_msg=f"step {i} {part} {n}")
    own = dict(model.named_buffers())
    if donate:                     # the model's own statistics moved
        assert all(state["buffers"][n] is own[n] for n in own)
    else:                          # the model's own were never written
        np.testing.assert_array_equal(own["bn1._mean"].numpy(),
                                      init["buffers"]["bn1._mean"])

"""Parts of the vision models against the reference, from the same
weights (``params_from_numpy``) on the same numpy inputs:

- a ``BottleneckBlock`` with a strided downsample (NCHW) and a resnext
  block (``groups=32``, ``base_width=4``, NHWC) in float64, training
  mode: outputs, the gradients of ``mean(out**2)`` and the running
  statistics within ``rtol=1e-8, atol=1e-8``;
- ``LeNet`` through 3 fp32 Momentum steps (lr 0.01, the harness's
  ``bench_mnist_lenet`` step) of the reference's jitted
  ``make_train_step``: losses and parameters within 1e-4 relative;
- the bf16-input dtype flow of ``resnet18(data_format="NHWC")``: a bf16
  ``conv1``, fp32 after the first BatchNorm (its fp32 weight promotes),
  fp32 logits within the bf16 tier (2e-2) of the reference's and fp32
  running statistics.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import functional as jf
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision import models as jm
from paddle_tpu.vision.models import resnet as jresnet
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit.functional import make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tm

KEY0 = np.array([0, 0], np.uint32)          # jax.random.PRNGKey(0)'s data
RTOL64 = ATOL64 = 1e-8
LENET_RTOL = 1e-4
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


def _numpy_state(m):
    _, params, buffers = jf.functionalize(m)
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in buffers.items()})


def _blocks(kind):
    """(reference block, port block, input, data format)."""
    if kind == "bottleneck":
        df, cin, planes, kw, shape = "NCHW", 64, 16, {}, (3, 64, 8, 8)
        stride = 2
    else:
        df, cin, planes, shape = "NHWC", 128, 64, (3, 6, 6, 128)
        kw, stride = {"groups": 32, "base_width": 4}, 1
    out_c = planes * 4

    def build(pkg):
        down = pkg.Sequential(
            pkg.Conv2D(cin, out_c, 1, stride=stride, bias_attr=False,
                       data_format=df),
            pkg.BatchNorm2D(out_c, data_format=df))
        mod = jresnet if pkg is jnn else tm
        return mod.BottleneckBlock(cin, planes, stride, down, data_format=df,
                                   **kw)

    paddle.seed(1)
    jblk = build(jnn)
    with nn.building("cpu"):
        tblk = build(nn).double()
    params, buffers = _numpy_state(jblk)
    tm.params_from_numpy(tblk, {k: v.astype(np.float64)
                                for k, v in params.items()},
                         {k: v.astype(np.float64) for k, v in buffers.items()})
    x = np.random.RandomState(2).randn(*shape)
    return jblk, tblk, x, (params, buffers)


@pytest.mark.parametrize("kind", ["bottleneck", "resnext"])
def test_block_float64_forward_and_gradients(kind):
    jblk, tblk, x, (params, buffers) = _blocks(kind)
    jax.config.update("jax_enable_x64", True)
    try:
        apply_fn = jf.functionalize(jblk)[0]
        p64 = {k: jnp.asarray(v, jnp.float64) for k, v in params.items()}
        b64 = {k: jnp.asarray(v, jnp.float64) for k, v in buffers.items()}

        def loss(p):
            out, nb = apply_fn(p, b64, jnp.asarray(x), training=True)
            return jnp.mean(out ** 2), (out, nb)

        (jloss, (jout, jbuf)), jgrad = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(p64)
        want = (float(jloss), np.asarray(jout),
                {k: np.asarray(v) for k, v in jgrad.items()},
                {k: np.asarray(v) for k, v in jbuf.items()})
    finally:
        jax.config.update("jax_enable_x64", False)
    tblk.train()
    out = tblk(torch.from_numpy(x))
    tloss = (out ** 2).mean()
    tloss.backward()
    np.testing.assert_allclose(float(tloss.detach()), want[0], rtol=RTOL64)
    np.testing.assert_allclose(out.detach().numpy(), want[1], rtol=RTOL64,
                               atol=ATOL64)
    for n, p in tblk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[2][n], rtol=RTOL64,
                                   atol=ATOL64, err_msg=n)
    for n, b in tblk.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[3][n], rtol=RTOL64,
                                   atol=ATOL64, err_msg=n)


def test_lenet_fp32_three_steps():
    paddle.seed(0)
    jmodel = jm.LeNet()
    params, _ = _numpy_state(jmodel)
    jstep, jst = jf.make_train_step(
        jmodel, lambda o, y: JF.cross_entropy(o, y),
        JMomentum(0.01, momentum=0.9, weight_decay=1e-4), donate=False)
    model = tm.params_from_numpy(tm.LeNet(device="cpu"), params, {})
    step, state = make_train_step(
        model, lambda o, y: F.cross_entropy(o, y),
        Momentum(0.01, momentum=0.9, weight_decay=1e-4))
    r = np.random.RandomState(4)
    for i in range(3):
        x = r.standard_normal((16, 1, 28, 28)).astype(np.float32)
        y = r.randint(0, 10, (16,)).astype(np.int64)
        jst, (jloss, jout) = jstep(jst, jax.random.PRNGKey(0),
                                   np.float32(0.01), [x], [y])
        state, (loss, out) = step(state, KEY0, 0.01, [torch.from_numpy(x)],
                                  [torch.from_numpy(y)])
        np.testing.assert_allclose(float(loss), float(jloss),
                                   rtol=LENET_RTOL, err_msg=f"step {i}")
        np.testing.assert_allclose(out.numpy(), np.asarray(jout),
                                   rtol=LENET_RTOL, atol=1e-5)
        for n, v in state["params"].items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(jst["params"][n]),
                                       rtol=LENET_RTOL, atol=1e-6,
                                       err_msg=f"step {i} {n}")


def test_resnet18_bf16_input_dtype_flow():
    """In training mode the port's dtypes follow the reference's, and its
    first BatchNorm's running statistics (fp32) match the reference's
    from a bf16 stem.  The logits are compared in eval mode: a conv1
    output 1 bf16 ulp apart in a few elements is amplified by the deeper
    layers' 8-sample batch statistics in training mode, while eval mode
    passes it on linearly."""
    paddle.seed(0)
    jmodel = jm.resnet18(num_classes=10, data_format="NHWC")
    params, buffers = _numpy_state(jmodel)
    x = np.random.RandomState(6).randn(8, 32, 32, 3).astype(np.float32)
    xb = jnp.asarray(x, jnp.bfloat16)
    apply_fn = jf.functionalize(jmodel)[0]
    jout, _ = jax.jit(lambda p, b, a: apply_fn(p, b, a, training=False))(
        params, buffers, xb)
    jstem = jmodel.conv1(paddle.to_tensor(xb))
    assert str(jstem._data.dtype) == "bfloat16"
    jmodel.train()
    assert str(jmodel.bn1(jstem)._data.dtype) == "float32"
    assert str(jout.dtype) == "float32"

    model = tm.params_from_numpy(
        tm.resnet18(num_classes=10, data_format="NHWC", device="cpu"),
        params, buffers)
    seen = {}

    def record(name):
        def hook(mod, inp, out):
            seen[name] = out.dtype
        return hook

    for name in ("conv1", "bn1", "maxpool", "layer1", "layer4", "avgpool",
                 "fc"):
        getattr(model, name).register_forward_hook(record(name))
    xt = torch.from_numpy(x).to(torch.bfloat16)
    out = model(xt)
    assert seen == {"conv1": torch.bfloat16, **{
        n: torch.float32 for n in ("bn1", "maxpool", "layer1", "layer4",
                                   "avgpool", "fc")}}
    assert out.dtype == torch.float32
    for n, b in model.named_buffers():
        assert b.dtype == torch.float32, n
    for n in ("_mean", "_variance"):
        np.testing.assert_allclose(
            getattr(model.bn1, n).numpy(),
            np.asarray(getattr(jmodel.bn1, n)._data), rtol=BF16_TOL,
            atol=BF16_TOL, err_msg=n)
    tm.params_from_numpy(model, params, buffers)
    model.eval()
    with torch.no_grad():
        out = model(xt)
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), rtol=BF16_TOL,
                               atol=BF16_TOL)

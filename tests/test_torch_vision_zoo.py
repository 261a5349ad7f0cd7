"""Whole models of the eight vision families against the reference's
jitted ``make_train_step`` (never its eager forward: one of DenseNet-121,
GoogLeNet or InceptionV3 costs a minute here), from the same weights and
running statistics (``params_from_numpy`` loads the reference's names).

- ``squeezenet1_1``, ``mobilenet_v1(scale=0.25)``,
  ``mobilenet_v2(scale=0.25)`` and ``shufflenet_v2_x0_25`` with 10
  classes: 3 Momentum steps (lr 0.1, momentum 0.9, weight decay 1e-4, the
  harness's vision step) at B 8, 64x64, keys ``fold_in_step_key(base,
  t)``, dropout active; losses, parameters and running statistics within
  ``rtol=1e-8, atol=1e-8`` in float64.  At B 2 or 4 a MobileNet's last
  BatchNorm normalises over 4-16 values and amplifies 1e-13 of
  reduction-order noise some 30x a step, past the bound by the third.
- ``squeezenet1_1`` in fp32 (the reference with x64 off, so its masks
  are 32-bit draws), within the fp32 tier (1e-4, as LeNet's fp32 case).
- the same key twice gives the same state, two keys different losses;
- ``alexnet``, ``vgg11(batch_norm=True)``, ``googlenet``,
  ``inception_v3`` and ``densenet121``: the parameter and buffer names
  and shapes equal the reference's (traced by ``jax.eval_shape``: no
  reference weight is made) and an eval-mode forward gives the logits'
  shape (``test_torch_vision_zoo_wide.py`` trains the first three against
  the reference);
- GoogLeNet's train-mode 3-tuple and the step's loss of its first;
- ``pretrained=True`` raises, and every family's constructor raises
  without a card rather than build on the CPU.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.core import rng as jrng
from paddle_tpu.jit import functional as jf
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision import models as jm
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.jit.functional import fold_in_step_key, make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import Momentum
from paddle_tpu_torch.vision import models as tm

RTOL64 = ATOL64 = 1e-8
FP32_RTOL, FP32_ATOL = 1e-4, 1e-5
LR, B, HW, STEPS, CLASSES = 0.1, 8, 64, 3, 10
BASE = np.array([0, 7], np.uint32)
FAMILIES = ["alexnet", "vgg16", "squeezenet1_1", "mobilenet_v2",
            "googlenet", "inception_v3", "densenet121",
            "shufflenet_v2_x1_0"]


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: with
    several test workers each spreading tiny float64 ops (depthwise
    convolutions, a group at a time) over every core, OpenMP's barriers
    made one 1-second MobileNet step run for minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_shell(ctor):
    """The reference model ``ctor()`` built under ``jax.eval_shape``: its
    initializers are traced, not run, so its parameters and buffers are
    placeholders until the caller sets them.  The reference's RNG streams
    are left as they were."""
    box, saved = [], jrng.get_rng_state()

    def build():
        box.append(ctor())
        return 0

    try:
        jax.eval_shape(build)
    finally:
        jrng.set_rng_state(saved)
    return box[0]


def _batches(b=B, hw=HW, steps=STEPS):
    r = np.random.RandomState(0)
    return [(r.randn(b, 3, hw, hw), r.randint(0, CLASSES, (b,)))
            for _ in range(steps)]


def _momentum(cls):
    return cls(LR, momentum=0.9, weight_decay=1e-4)


def _port(name, dtype, **kw):
    torch.manual_seed(0)
    rng.seed(0)                # the port's layers draw their weights here
    return getattr(tm, name)(num_classes=CLASSES, device="cpu",
                             **kw).to(dtype)


def _reference_trajectory(name, kw, model, x64):
    """(loss, params, buffers) after each step of the reference's jitted
    step, from ``model``'s weights."""
    params = {n: p.detach().numpy() for n, p in model.named_parameters()}
    buffers = {n: b.numpy() for n, b in model.named_buffers()}
    ref = reference_shell(lambda: getattr(jm, name)(num_classes=CLASSES,
                                                    **kw))
    jax.config.update("jax_enable_x64", x64)
    try:
        for n, p in ref.named_parameters():
            p._data = jnp.asarray(params[n])
        for n, b in ref.named_buffers():
            b._data = jnp.asarray(buffers[n])
        step, st = jf.make_train_step(
            ref, lambda o, y: JF.cross_entropy(o, y), _momentum(JMomentum),
            donate=False)
        out = []
        dt = np.float64 if x64 else np.float32
        for t, (x, y) in enumerate(_batches()):
            st, (loss, _) = step(st, jnp.asarray(fold_in_step_key(BASE, t)),
                                 dt(LR), [x.astype(dt)], [y])
            out.append((float(loss),
                        {n: np.asarray(v) for n, v in st["params"].items()},
                        {n: np.asarray(v) for n, v in st["buffers"].items()}))
        return out
    finally:
        jax.config.update("jax_enable_x64", False)


def _train(model, keys, dtype):
    step, state = make_train_step(model, lambda o, y: F.cross_entropy(o, y),
                                  _momentum(Momentum), donate=False)
    out = []
    for key, (x, y) in zip(keys, _batches()):
        state, (loss, _) = step(state, key, LR,
                                [torch.from_numpy(x).to(dtype)],
                                [torch.from_numpy(y)])
        out.append((float(loss), state))
    return out


@pytest.mark.parametrize("name,kw", [
    ("squeezenet1_1", {}), ("mobilenet_v1", {"scale": 0.25}),
    ("mobilenet_v2", {"scale": 0.25}), ("shufflenet_v2_x0_25", {})],
    ids=["squeezenet1_1", "mobilenet_v1_0.25", "mobilenet_v2_0.25",
         "shufflenet_v2_x0_25"])
def test_float64_trajectory_with_dropout(name, kw):
    model = _port(name, torch.float64, **kw)
    want = _reference_trajectory(name, kw, model, x64=True)
    keys = [fold_in_step_key(BASE, t) for t in range(STEPS)]
    for t, ((loss, state), (jloss, jp, jb)) in enumerate(
            zip(_train(model, keys, torch.float64), want)):
        np.testing.assert_allclose(loss, jloss, rtol=RTOL64, atol=ATOL64,
                                   err_msg=f"loss at step {t}")
        for part, ref in (("params", jp), ("buffers", jb)):
            assert set(state[part]) == set(ref)
            for n, v in state[part].items():
                np.testing.assert_allclose(
                    v.detach().numpy(), ref[n], rtol=RTOL64, atol=ATOL64,
                    err_msg=f"step {t} {part} {n}")


def test_fp32_trajectory_with_dropout():
    model = _port("squeezenet1_1", torch.float32)
    want = _reference_trajectory("squeezenet1_1", {}, model, x64=False)
    keys = [fold_in_step_key(BASE, t) for t in range(STEPS)]
    for t, ((loss, state), (jloss, jp, _)) in enumerate(
            zip(_train(model, keys, torch.float32), want)):
        np.testing.assert_allclose(loss, jloss, rtol=FP32_RTOL,
                                   err_msg=f"loss at step {t}")
        for n, v in state["params"].items():
            np.testing.assert_allclose(v.detach().numpy(), jp[n],
                                       rtol=FP32_RTOL, atol=FP32_ATOL,
                                       err_msg=f"step {t} {n}")


def test_the_key_decides_the_masks():
    model = _port("squeezenet1_1", torch.float64)
    key = fold_in_step_key(BASE, 0)
    a = _train(model, [key], torch.float64)[0]
    b = _train(model, [key], torch.float64)[0]
    c = _train(model, [fold_in_step_key(BASE, 1)], torch.float64)[0]
    assert a[0] == b[0] and a[0] != c[0]
    for part in ("params", "buffers"):
        assert all(torch.equal(v, b[1][part][n])
                   for n, v in a[1][part].items())


def _shapes(named):
    return {n: tuple(int(d) for d in t.shape) for n, t in named}


@pytest.mark.parametrize("name,kw,hw", [
    ("alexnet", {}, 64), ("vgg11", {"batch_norm": True}, 32),
    ("googlenet", {}, 64), ("inception_v3", {}, 80),
    ("densenet121", {}, 32)], ids=["alexnet", "vgg11_bn", "googlenet",
                                   "inception_v3", "densenet121"])
def test_names_shapes_and_eval_forward(name, kw, hw):
    ref = reference_shell(lambda: getattr(jm, name)(num_classes=CLASSES,
                                                    **kw))
    model = getattr(tm, name)(num_classes=CLASSES, device="cpu", **kw)
    rp, tp = _shapes(ref.named_parameters()), _shapes(model.named_parameters())
    rb, tb = _shapes(ref.named_buffers()), _shapes(model.named_buffers())
    assert list(rp) == list(tp) and rp == tp
    assert list(rb) == list(tb) and rb == tb
    model.eval()
    with torch.no_grad():
        out = model(torch.randn(2, 3, hw, hw))
    assert out.shape == (2, CLASSES) and bool(torch.isfinite(out).all())


def test_googlenet_train_mode_tuple_and_step_loss():
    model = _port("googlenet", torch.float32)
    r = np.random.RandomState(1)
    x = torch.from_numpy(r.randn(2, 3, 64, 64).astype(np.float32))
    y = torch.from_numpy(r.randint(0, CLASSES, (2,)))
    key = fold_in_step_key(BASE, 3)
    model.train()
    with torch.no_grad(), rng.rng_scope(key):
        main, aux1, aux2 = model(x)
    assert main.shape == aux1.shape == aux2.shape == (2, CLASSES)
    step, state = make_train_step(model, lambda o, t: F.cross_entropy(o, t),
                                  _momentum(Momentum), donate=False)
    _, (loss, out) = step(state, key, LR, [x], [y])
    torch.testing.assert_close(out, main, rtol=0, atol=0)
    torch.testing.assert_close(loss, F.cross_entropy(main, y), rtol=0,
                               atol=0)


@pytest.mark.parametrize("name", FAMILIES)
def test_pretrained_raises(name):
    with pytest.raises(ValueError, match="pretrained"):
        getattr(tm, name)(pretrained=True, device="cpu")


@pytest.mark.parametrize("name", FAMILIES)
def test_constructors_need_a_card_by_default(name):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(tm, name)()


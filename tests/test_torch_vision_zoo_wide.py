"""The vision families whose top level the narrow trajectories of
``test_torch_vision_zoo.py`` do not reach, against the reference's jitted
``make_train_step`` from the same weights, with dropout drawn from the
step keys ``fold_in_step_key(base, t)``:

- ``alexnet`` (its classifier drops before each of its 4096-wide
  linears) in float64: 3 Momentum steps at B 4, 64x64, within
  ``rtol=1e-8, atol=1e-8``;
- ``vgg11(batch_norm=True)`` (linear, relu, dropout twice) in fp32 with
  x64 off, so its masks are 32-bit draws: 3 SGD steps at B 4, 32x32, lr
  1e-3, within the fp32 tier.  A float64 copy of its 25088x4096
  classifier is 0.8 GB and a float64 step of both packages took over
  5 GB here; at lr 0.1 or 0.01 its loss grew 10-1000x a step;
- ``googlenet`` in float64 at B 2, 64x64: its train-mode 3-tuple
  and running statistics against the reference's jitted forward under
  one key (aux1's dropout is the first draw, aux2's the second, the main
  head's the third, so another order changes the heads), then one step.

The states are compared after every step, then dropped: no trajectory is
kept.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import torch

import paddle_tpu.nn.functional as JF
from paddle_tpu.jit import functional as jf
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu.optimizer import Momentum as JMomentum
from paddle_tpu.vision import models as jm
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.jit.functional import fold_in_step_key, make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD, Momentum
from test_torch_vision_zoo import (ATOL64, BASE, CLASSES, FP32_ATOL,
                                   FP32_RTOL, LR, RTOL64, STEPS, _batches,
                                   _momentum, _port, reference_shell)
# the module fixtures: one torch thread, the JAX arrays released at the end
from test_torch_vision_zoo import (_one_torch_thread,  # noqa: F401
                                   _release_jax_arrays)  # noqa: F401


def _pair(name, kw, dtype):
    """The port's model in ``dtype`` and the reference's shell holding
    copies of its weights and running statistics (a CPU jax array may
    alias its numpy source, and each package updates its own state in
    place).  Call with x64 set for ``dtype``."""
    model = _port(name, dtype, **kw)
    ref = reference_shell(lambda: getattr(jm, name)(num_classes=CLASSES,
                                                    **kw))
    for mine, theirs in ((model.named_parameters(), ref.named_parameters()),
                         (model.named_buffers(), ref.named_buffers())):
        mine = dict(mine)
        for n, t in theirs:
            t._data = jnp.array(mine[n].detach().numpy(), copy=True)
    return model, ref


@contextlib.contextmanager
def _x64(dtype):
    jax.config.update("jax_enable_x64", dtype == torch.float64)
    try:
        yield np.float64 if dtype == torch.float64 else np.float32
    finally:
        jax.config.update("jax_enable_x64", False)


def _lockstep(model, ref, b, hw, steps, opt, dt, lr=LR):
    """Both packages' steps side by side, each donating its state: yields
    ``(t, loss, state, jloss, jstate)`` after each step.  ``opt(ref)``
    makes the reference's optimizer (``ref`` true) or the port's."""
    jstep, jst = jf.make_train_step(
        ref, lambda o, y: JF.cross_entropy(o, y), opt(True), donate=True)
    step, st = make_train_step(model, lambda o, y: F.cross_entropy(o, y),
                               opt(False), donate=True)
    for t, (x, y) in enumerate(_batches(b, hw, steps)):
        key, x = fold_in_step_key(BASE, t), x.astype(dt)
        jst, (jloss, _) = jstep(jst, jnp.asarray(key), dt(lr), [x], [y])
        st, (loss, _) = step(st, key, lr, [torch.from_numpy(x)],
                             [torch.from_numpy(y)])
        yield t, float(loss), st, float(jloss), jst


def _close(got, want, rtol, atol, msg):
    """``assert_allclose``'s test in one numpy pass (it takes seconds
    over a 100M-element classifier); its report where the pass fails."""
    if not np.all(np.abs(got - want) <= atol + rtol * np.abs(want)):
        np.testing.assert_allclose(got, want, rtol=rtol, atol=atol,
                                   err_msg=msg)


def _assert_states_close(got, rtol, atol):
    t, loss, state, jloss, jstate = got
    _close(loss, jloss, rtol, atol, f"loss at step {t}")
    for part in ("params", "buffers"):
        assert set(state[part]) == set(jstate[part])
        for n, v in state[part].items():
            _close(v.detach().numpy(), np.asarray(jstate[part][n]), rtol,
                   atol, f"step {t} {part} {n}")


def _momentum_of(ref):
    return _momentum(JMomentum if ref else Momentum)


def test_alexnet_float64_trajectory_with_dropout():
    with _x64(torch.float64) as dt:
        model, ref = _pair("alexnet", {}, torch.float64)
        for got in _lockstep(model, ref, 4, 64, STEPS, _momentum_of, dt):
            _assert_states_close(got, RTOL64, ATOL64)


def test_vgg11_bn_fp32_trajectory_with_dropout():
    lr = 1e-3
    with _x64(torch.float32) as dt:
        model, ref = _pair("vgg11", {"batch_norm": True}, torch.float32)
        for got in _lockstep(model, ref, 4, 32, STEPS,
                             lambda r: (JSGD if r else SGD)(lr), dt, lr):
            _assert_states_close(got, FP32_RTOL, FP32_ATOL)


def test_googlenet_train_forward_and_step_pin_the_draw_order():
    key = fold_in_step_key(BASE, 0)
    x = np.random.RandomState(2).randn(2, 3, 64, 64)
    with _x64(torch.float64) as dt:
        model, ref = _pair("googlenet", {}, torch.float64)
        apply_fn, params, buffers = jf.functionalize(ref)
        want, new_b = jax.jit(lambda p, b, k, a: apply_fn(
            p, b, a, rng_key=k, training=True))(
                params, buffers, jnp.asarray(key), jnp.asarray(x))
        before = {n: b.clone() for n, b in model.named_buffers()}
        model.train()
        with torch.no_grad(), rng.rng_scope(key):
            got = model(torch.from_numpy(x))
        for head, g, w in zip(("main", "aux1", "aux2"), got, want):
            _close(g.numpy(), np.asarray(w), RTOL64, ATOL64,
                   f"train-mode {head}")
        for n, b in model.named_buffers():     # then the step starts afresh
            _close(b.numpy(), np.asarray(new_b[n]), RTOL64, ATOL64, n)
            b.copy_(before[n])
        for got in _lockstep(model, ref, 2, 64, 1, _momentum_of, dt):
            _assert_states_close(got, RTOL64, ATOL64)

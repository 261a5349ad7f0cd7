"""The functional train steps' buffers (``paddle_tpu_torch/jit/functional.py``
and the one-device step of ``distributed/spmd.py``) against the
reference's ``make_train_step``, which runs its forward on
``state["buffers"]`` and returns the updated ones without touching its
input (``paddle_tpu/jit/functional.py:191-210``).

A ``Linear -> BatchNorm1D`` layer trains 3 SGD steps in both packages
from the same numpy weights, with ``donate`` True and False, plain and
accumulating.  Running statistics, parameters and losses must equal the
reference's within 1e-6.  Under ``donate=False`` the given state is left
as it was, bit for bit, and a state whose buffers differ from the
layer's (all 7.0) is the one read and advanced.
"""

import gc

import jax
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.jit import functional as jf
from paddle_tpu.optimizer import SGD as JSGD
from paddle_tpu_torch import nn
from paddle_tpu_torch.jit import functional as tf
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.vision.models import params_from_numpy

KEY0 = np.array([0, 0], np.uint32)          # jax.random.PRNGKey(0)'s data
TOL = 1e-6
LR = 0.1


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


def _batches(n=3):
    r = np.random.RandomState(7)
    return [(r.randn(8, 4).astype(np.float32) * 2 + 1,
             r.randn(8, 4).astype(np.float32)) for _ in range(n)]


def _layers():
    """The reference's ``Linear(4, 4) -> BatchNorm1D(4)`` and the port's,
    holding the same weights."""
    paddle.seed(3)
    jl = jnn.Sequential(jnn.Linear(4, 4), jnn.BatchNorm1D(4))
    _, params, buffers = jf.functionalize(jl)
    with nn.building("cpu"):
        tl = nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4))
    params_from_numpy(tl, {k: np.asarray(v) for k, v in params.items()},
                      {k: np.asarray(v) for k, v in buffers.items()})
    return jl, tl


def _steps(kind, donate):
    jl, tl = _layers()
    if kind == "accum":
        jstep, jst = jf.make_accum_train_step(
            jl, lambda o, y: jnn.functional.mse_loss(o, y), JSGD(LR), 2,
            donate=donate)
        tstep, tst = tf.make_accum_train_step(
            tl, torch.nn.functional.mse_loss, SGD(LR), 2, donate=donate)
    else:
        jstep, jst = jf.make_train_step(
            jl, lambda o, y: jnn.functional.mse_loss(o, y), JSGD(LR),
            donate=donate)
        tstep, tst = tf.make_train_step(
            tl, torch.nn.functional.mse_loss, SGD(LR), donate=donate)
    return jstep, jst, tstep, tst, tl


def _clone_tree(tree):
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone() if isinstance(tree, torch.Tensor) else tree


def _assert_trees_equal(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _assert_trees_equal(a[k], b[k], f"{path}/{k}")
    else:
        assert torch.equal(torch.as_tensor(a), torch.as_tensor(b)), path


def _assert_close(tst, jst, what):
    for part in ("params", "buffers"):
        assert set(tst[part]) == set(jst[part]), part
        for n, v in tst[part].items():
            np.testing.assert_allclose(v.detach().numpy(),
                                       np.asarray(jst[part][n]), rtol=TOL,
                                       atol=TOL, err_msg=f"{what} {part} {n}")


def _run(jstep, jst, tstep, tst, donate):
    for i, (x, y) in enumerate(_batches()):
        before = None if donate else _clone_tree(tst)
        old = tst
        jst, (jloss, _) = jstep(jst, jax.random.PRNGKey(0), np.float32(LR),
                                [x], [y])
        tst, (tloss, _) = tstep(tst, KEY0, LR, [torch.from_numpy(x)],
                                [torch.from_numpy(y)])
        if not donate:             # the given state is left as it was
            _assert_trees_equal(old, before)
        np.testing.assert_allclose(float(tloss), float(jloss), rtol=TOL,
                                   atol=TOL)
        _assert_close(tst, jst, f"step {i}")
    return jst, tst


@pytest.mark.parametrize("kind", ["plain", "accum"])
@pytest.mark.parametrize("donate", [True, False])
def test_running_statistics_match_reference(kind, donate):
    jstep, jst, tstep, tst, tl = _steps(kind, donate)
    init = {n: b.clone() for n, b in tl.named_buffers()}
    jst, tst = _run(jstep, jst, tstep, tst, donate)
    moved = {n: not torch.equal(b, init[n])
             for n, b in tst["buffers"].items()}
    assert all(moved.values()), moved
    own = dict(tl.named_buffers())
    if donate:                     # the state's buffers are the layer's
        assert all(tst["buffers"][n] is own[n] for n in own)
    else:                          # the layer's own were never written
        assert all(torch.equal(own[n], init[n]) for n in own)


@pytest.mark.parametrize("kind", ["plain", "accum"])
def test_kept_state_buffers_are_read_and_advanced(kind):
    """A state whose running statistics differ from the layer's (all 7.0)
    is the one the step reads: the batch statistics mix into 7.0, as in
    the reference, and the layer's own buffers stay as they were."""
    jstep, jst, tstep, tst, tl = _steps(kind, donate=False)
    jst = dict(jst, buffers={n: jax.numpy.full_like(v, 7.0)
                             for n, v in jst["buffers"].items()})
    tst = dict(tst, buffers={n: torch.full_like(v, 7.0)
                             for n, v in tst["buffers"].items()})
    init = {n: b.clone() for n, b in tl.named_buffers()}
    jst, tst = _run(jstep, jst, tstep, tst, donate=False)
    mean = tst["buffers"]["1._mean"]
    assert torch.all((mean - 7.0).abs() > 1.0), mean
    assert all(torch.equal(b, init[n]) for n, b in tl.named_buffers())


def test_eval_step_reads_the_given_buffers():
    """The eval step normalizes with the buffers it is given (reference
    ``make_eval_step``), in eval mode, and writes none."""
    jl, tl = _layers()
    _, params, buffers = jf.functionalize(jl)
    buffers = {n: jax.numpy.full_like(v, 2.0) for n, v in buffers.items()}
    x = _batches(1)[0][0]
    jout, _ = jf.make_eval_step(jl)(params, buffers, [x])
    tparams = dict(tl.named_parameters())
    tbuf = {n: torch.full_like(b, 2.0) for n, b in tl.named_buffers()}
    tout, _ = tf.make_eval_step(tl)(tparams, tbuf, [torch.from_numpy(x)])
    np.testing.assert_allclose(tout.numpy(), np.asarray(jout), rtol=TOL,
                               atol=TOL)
    assert all(torch.equal(b, torch.full_like(b, 2.0)) for b in tbuf.values())

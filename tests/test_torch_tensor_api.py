"""``paddle_tpu_torch``'s tensor namespace (``tensor/creation``, ``math``,
``logic``, ``search``, ``stat``, ``einsum``, ``manipulation`` and the
package's own names, at the top level as in the reference) against
``paddle_tpu``'s on the same numpy inputs, and the AST walk that holds
every ported module's public names against the reference's.

Each case is a group of calls written once for both packages (the
package passed in; the port's run inside ``nn.building("cpu")``), the
reference's jitted where it can be (its op-by-op dispatch costs seconds).
fp32 values within 1e-5 of the tensor's scale, integer and bool values
exactly; an integer output is int64 in the port where the reference's is
int32 (ROADMAP §C).  Orders hold with ties present: stable ``argsort``
both ways, ``topk`` lower index first, ``kthvalue``, ``mode``.  Some
groups also hold the gradients of ``sum(out * g)``.
"""

import ast
import gc
import importlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
import paddle_tpu_torch as P
from paddle_tpu_torch import nn

TOL = 1e-5
ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _r(shape, seed, scale=1.0, shift=0.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale
                      + shift, np.float32)


def _ints(shape, seed, lo, hi):
    return np.random.RandomState(seed).randint(lo, hi, shape).astype(
        np.int64)


def _flat(out):
    if isinstance(out, (list, tuple)):
        return [v for o in out for v in _flat(o)]
    return [out]


def _raw(v):
    return v._data if isinstance(v, Tensor) else v


def _close(got, want, what=""):
    want = np.asarray(want)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind in "biu" or got.dtype.kind in "biu":
        assert got.dtype.kind == want.dtype.kind or (
            {got.dtype.kind, want.dtype.kind} <= set("iu")), what
        assert np.array_equal(got, want), what
        return
    want = want.astype(np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(got.astype(np.float32) / scale, want / scale,
                               rtol=TOL, atol=TOL, err_msg=what)


def _both(call, arrays, jit=True):
    """``call(package, *tensors)`` through both packages, flattened."""
    def ref(*xs):
        return [_raw(v) for v in _flat(call(paddle, *[Tensor(x)
                                                      for x in xs]))]
    want = (jax.jit(ref) if jit else ref)(*[jnp.asarray(a) for a in arrays])
    with nn.building("cpu"):
        got = _flat(call(P, *[torch.from_numpy(np.array(a))
                              for a in arrays]))
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"output {i}")
    return got


def _grads(call, arrays, diff):
    """The gradients of ``sum(call(...) * g)`` in the ``diff`` inputs."""
    def ref(*xs):
        return _raw(call(paddle, *[Tensor(x) for x in xs]))
    jarrays = [jnp.asarray(a) for a in arrays]
    g = _r(tuple(np.shape(jax.jit(ref)(*jarrays))), 99)
    want = jax.jit(jax.grad(lambda *xs: jnp.sum(ref(*xs) * g),
                            argnums=tuple(diff)))(*jarrays)
    tx = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
          for i, a in enumerate(arrays)]
    with nn.building("cpu"):
        out = call(P, *tx)
    (out * torch.from_numpy(g)).sum().backward()
    for i, w in zip(diff, want):
        _close(tx[i].grad, w, f"grad of input {i}")


M = _r((3, 4), 1)
V = _r((4,), 2)
POS = np.abs(_r((3, 4), 3)) + 0.5
UNIT = np.clip(_r((3, 4), 4, 0.4), -0.9, 0.9)
TIES = np.array([[3., 1., 3., 2., 1., 3.], [0., 0., 5., 5., 2., 0.]],
                np.float32)
I = _ints((3, 4), 5, -6, 7)
J = _ints((3, 4), 6, 1, 5)
B1 = _r((3, 4), 7) > 0
B2 = _r((3, 4), 8) > 0

# name: (call, inputs, jit)
CASES = {
    "creation_shapes": (lambda p: [
        p.zeros([2, 3]), p.ones([2, 3], "int32"), p.full([2, 2], 1.5),
        p.full([2], 3), p.empty([1, 2]), p.eye(3), p.eye(2, 4)], [], True),
    "creation_ranges": (lambda p: [
        p.arange(5), p.arange(1, 7, 2), p.arange(0., 1., 0.25),
        p.linspace(0, 1, 5), p.logspace(0, 2, 3)], [], True),
    "creation_like": (lambda p, x: [
        p.zeros_like(x), p.ones_like(x, "int64"), p.full_like(x, 2.),
        p.empty_like(x), p.clone(x), p.assign(x), p.numel(x)], [M], True),
    "creation_diag": (lambda p, v, m: [
        p.diag(v), p.diag(v, 1, padding_value=9), p.diag(m, -1),
        p.diagflat(v, 1), p.tril(m), p.triu(m, 1),
        *p.meshgrid(v, v[:2])], [V, M], True),
    "unary_any": (lambda p, x: [
        getattr(p, n)(x) for n in (
            "exp", "expm1", "abs", "ceil", "floor", "round", "trunc", "cos",
            "sin", "tan", "atan", "cosh", "sinh", "tanh", "asinh",
            "reciprocal", "square", "sign", "neg", "erf", "sigmoid", "frac",
            "isnan", "isinf", "isfinite", "real", "imag", "conj", "angle",
            "rad2deg", "deg2rad", "stanh")], [M], True),
    "unary_positive": (lambda p, x: [
        getattr(p, n)(x) for n in (
            "log", "log2", "log10", "log1p", "sqrt", "rsqrt", "acosh",
            "digamma", "lgamma", "i0", "i1")], [POS + 1.0], True),
    "unary_unit": (lambda p, x: [
        getattr(p, n)(x) for n in ("acos", "asin", "atanh", "erfinv")],
        [UNIT], True),
    "binary_float": (lambda p, x, y: [
        getattr(p, n)(x, y) for n in (
            "add", "subtract", "multiply", "divide", "maximum", "minimum",
            "fmax", "fmin", "atan2", "logaddexp", "hypot", "heaviside",
            "copysign", "nextafter", "floor_divide", "mod", "remainder",
            "floor_mod")] + [p.pow(p.abs(x), y), p.inner(x, y),
                             p.outer(x[0], y[1]), p.kron(x[:2, :2], y[:2, :2])],
        [M, _r((3, 4), 9)], True),
    "binary_int": (lambda p, x, y: [
        getattr(p, n)(x, y) for n in (
            "add", "multiply", "floor_divide", "mod", "gcd", "lcm",
            "maximum")] + [p.divide(x, y), p.ldexp(p.cast(x, "float32"), y)],
        [I, J], True),
    "scale_clip_lerp": (lambda p, x, y: [
        p.scale(x, 2.0, 0.5), p.scale(x, 2.0, 0.5, False), p.clip(x, -0.5),
        p.clip(x, -0.5, 0.5), p.lerp(x, y, 0.3),
        p.add_n([x, y, x])], [M, _r((3, 4), 9)], True),
    "reductions": (lambda p, x: [
        p.sum(x), p.sum(x, 1), p.sum(x, [0, 1], True), p.mean(x, -1, True),
        p.max(x, 0), p.min(x), p.prod(x, [0]), p.amax(x, 1), p.amin(x, 0),
        p.logsumexp(x, 1), p.nansum(x, 0), p.nanmean(x),
        p.count_nonzero(p.round(x), 1)], [M], True),
    "reductions_bool_int": (lambda p, a, i: [
        p.all(a), p.any(a, 1), p.all(a, [0], True), p.sum(i, 0),
        p.mean(i), p.prod(i, 1)], [B1, J], True),
    "scans": (lambda p, x, t: [
        p.cumsum(x), p.cumsum(x, 1), p.cumprod(x, 0), p.cumsum(x, 0,
                                                              "float64"),
        *p.cummax(t, 1), *p.cummin(t, 1), *p.cummax(t)], [M, TIES], True),
    "linear_algebra": (lambda p, x, y: [
        p.matmul(x, y, transpose_y=True), p.matmul(x, y, True, False),
        p.mm(x, p.t(y)), p.bmm(x[None], p.t(y)[None]), p.dot(x, y),
        p.mv(x, y[0]), p.addmm(p.ones([3, 3]), x, p.t(y), 0.5, 2.0),
        p.trace(p.matmul(x, p.t(y))), p.trace(x, 1), p.dist(x, y),
        p.dist(x, y, 1), p.diff(x, 1, 1), p.einsum("ij,kj->ik", x, y),
        p.multiplex([x, y], p.to_tensor([[1], [0], [1]]))],
        [M, _r((3, 4), 9)], True),
    "compare": (lambda p, x, y: [
        p.isclose(x, x + 1e-6), p.allclose(x, x + 1e-6), p.allclose(x, y),
        p.equal_all(x, x), p.equal_all(x, y),
        p.take(x, p.to_tensor([[0, 11], [5, 13]]), mode="wrap"),
        p.take(x, p.to_tensor([-1, 3, 20]), mode="clip")], [M, _r((3, 4), 9)],
        True),
    "logic": (lambda p, a, b, i, j, x, y: [
        p.equal(x, y), p.not_equal(i, j), p.greater_than(x, y),
        p.greater_equal(i, j), p.less_than(x, y), p.less_equal(i, j),
        p.logical_and(a, b), p.logical_or(a, b), p.logical_xor(a, b),
        p.logical_not(a), p.bitwise_and(i, j), p.bitwise_or(i, j),
        p.bitwise_xor(i, j), p.bitwise_not(i),
        p.bitwise_left_shift(j, p.abs(j) % 3),
        p.bitwise_right_shift(p.abs(i), j % 3), p.is_empty(x)],
        [B1, B2, I, J, M, _r((3, 4), 9)], True),
    "search_args": (lambda p, x, t: [
        p.argmax(x), p.argmax(x, 1), p.argmin(x, 0, True), p.argmax(x, None,
                                                                   True),
        p.argsort(t), p.argsort(t, descending=True), p.argsort(t, 0),
        p.sort(t, 1, True), *p.topk(t, 3), *p.topk(t, 4, largest=False),
        *p.topk(t, 1, axis=0), *p.kthvalue(t, 3), *p.kthvalue(t, 2, 0,
                                                               True),
        *p.mode(t), *p.mode(t, 0, True)], [M, TIES], True),
    "search_where": (lambda p, a, x, y, s, v: [
        p.where(a, x, y), p.where(a, x, 0.5),
        p.searchsorted(s, v), p.searchsorted(s, v, right=True),
        p.searchsorted(p.stack([s, s + 0.5]), p.stack([v[:3], v[:3]])),
        p.bucketize(v, s, out_int32=True),
        p.index_fill(x, p.to_tensor([0, 2]), 1, -1.0)],
        [B1, M, _r((3, 4), 9), np.sort(_r((6,), 10)), _r((5,), 11)], True),
    "search_data_dependent": (lambda p, a, x: [
        *p.where(a), p.nonzero(a), *p.nonzero(a, as_tuple=True),
        p.masked_select(x, a),
        p.repeat_interleave(x[0], p.to_tensor([1, 0, 2, 1]))], [B1, M],
        False),
    "stat": (lambda p, x: [
        p.var(x), p.var(x, 1, False), p.std(x, [0, 1], True, True),
        p.std(x, 0), p.median(x), p.median(x, 1, True), p.median(x, 0,
                                                              mode="min"),
        p.quantile(x, 0.3), p.quantile(x, [0.25, 0.75], 1, True),
        p.quantile(x, 0.4, 0, interpolation="lower"),
        p.nanmedian(x, 1), p.nanquantile(x, 0.6, 1)], [M], True),
    "shape_ops": (lambda p, x: [
        p.reshape(x, [2, -1]), p.flatten(x), p.transpose(x, [1, 0]),
        p.moveaxis(x[None], 0, 2), p.swapaxes(x, 0, 1),
        p.unsqueeze(x, [0, 3]), p.squeeze(x[None, :, None], [0, 2]),
        p.squeeze(x[None]), p.t(x), p.view(x, [4, 3]), p.view_as(x, p.t(x)),
        p.atleast_3d(x[0]), p.atleast_2d(x[0]), p.atleast_1d(x[0, 0]),
        p.tile(x, [2, 1]), p.expand(x[:1], [2, -1, -1]),
        p.expand_as(x[:1], x), p.broadcast_to(x[:1], [3, 4]),
        *p.broadcast_tensors([x, x[:1]]), p.flip(x, 1), p.flip(x, [0, 1]),
        p.rot90(x), p.rot90(x, 2, [1, 0]), p.roll(x, 2), p.roll(x, [1, -1],
                                                                 [0, 1]),
        p.crop(x, [2, -1], [1, 1]), p.tensordot(x, x, [[1], [1]]),
        p.tensordot(x, p.t(x), 1), p.rank(x), p.shape(x), p.cast(x,
                                                                 "int32")],
        [M], True),
    "split_stack": (lambda p, x: [
        *p.split(x, 2, 1), *p.split(x, [1, -1, 1], 1), *p.chunk(x, 3),
        p.stack([x, x], 1), *p.unstack(x, 1), *p.unbind(x),
        p.concat([x, x], 0)], [M], True),
    "gather_scatter": (lambda p, x, i, u: [
        p.gather(x, i), p.gather(x, p.to_tensor([1, 3]), 1),
        p.gather_nd(x, p.to_tensor([[0, 1], [2, 3]])),
        p.take_along_axis(x, p.to_tensor([[0], [3], [2]]), 1),
        p.put_along_axis(x, p.to_tensor([[0], [3], [2]]), 9.0, 1),
        p.put_along_axis(x, p.to_tensor([[0], [3], [2]]), 2.0, 1, "add"),
        p.put_along_axis(x, p.to_tensor([[0], [3], [2]]), 2.0, 1, "mul"),
        p.scatter(x, i, u[:2]), p.scatter(x, i, u[:2], overwrite=False),
        p.scatter_nd(p.to_tensor([[1], [0], [1]]), u[:3], [3, 4]),
        p.scatter_nd_add(x, p.to_tensor([[0, 1], [2, 2]]), u[0, :2]),
        p.index_select(x, p.to_tensor([2, 0]), 0),
        p.index_sample(x, p.to_tensor([[1, 0], [3, 3], [2, 1]])),
        p.index_add(x, p.to_tensor([0, 2]), 0, u[:2]),
        p.index_put(x, (p.to_tensor([0, 2]), p.to_tensor([1, 3])),
                    p.to_tensor(5.0)),
        p.index_put(x, (p.to_tensor([0, 0]), p.to_tensor([1, 1])),
                    p.to_tensor(1.0), accumulate=True),
        p.masked_fill(x, x > 0, -2.0), p.repeat_interleave(x, 2, 1),
        p.shard_index(p.to_tensor([[1], [5], [9]]), 12, 3, 1)],
        [M, np.array([2, 0], np.int64), _r((3, 4), 12)], True),
    "slices_and_pads": (lambda p, x: [
        p.slice(x, [0, 1], [1, 0], [3, 3]),
        p.strided_slice(x, [1], [3], [0], [-2]),
        p.strided_slice(x, [0, 1], [0, 0], [3, 4], [2, 3]),
        p.pad(x[None, None], [1, 2, 0, 1]),
        p.pad(x[None, None], [1, 2, 2, 1], "reflect"),
        p.pad(x[None], [1, 0, 0, 2], "circular", data_format="NLC"),
        p.pad(x, [1, 0, 0, 2], "replicate")], [M], True),
    "complex_views": (lambda p, x: [
        p.as_real(p.as_complex(p.reshape(x, [3, 2, 2]))),
        p.real(p.as_complex(p.reshape(x, [3, 2, 2]))),
        p.imag(p.as_complex(p.reshape(x, [3, 2, 2])))], [M], True),
    "unique": (lambda p, t: [
        p.unique(t), *p.unique(t, True, True, True),
        *p.unique(t, return_counts=True, axis=0),
        *p.unique_consecutive(t, True, True),
        *p.unique_consecutive(t, return_counts=True, axis=1)], [TIES],
        False),
}


@pytest.mark.parametrize("name", sorted(CASES))
def test_tensor_ops(name):
    call, arrays, jit = CASES[name]
    _both(call, arrays, jit)


def test_index_outputs_are_int64():
    t = torch.from_numpy(TIES)
    outs = [P.argsort(t), P.topk(t, 2)[1], P.kthvalue(t, 2)[1],
            P.mode(t)[1], P.argmax(t), P.nonzero(t), P.unique(t, True)[1],
            P.searchsorted(torch.tensor([1., 2.]), t), P.cummax(t, 1)[1],
            P.shape(t), P.rank(t), P.numel(t)]
    assert all(o.dtype == torch.int64 for o in outs)


GRADS = {
    "elementwise": (lambda p, x, y: p.sum(p.multiply(p.exp(x), p.tanh(y)),
                                          1) + p.mean(p.maximum(x, y), 1),
                    [M, _r((3, 4), 9)], (0, 1)),
    "reductions": (lambda p, x: p.logsumexp(x, 1) + p.amax(x, 1)
                   + p.prod(x, 1) + p.std(x, 1), [M], (0,)),
    "linear": (lambda p, x, y: p.matmul(x, y, transpose_y=True)
               + p.einsum("ij,kj->ik", x, y), [M, _r((3, 4), 9)], (0, 1)),
    "manipulation": (lambda p, x: p.concat([
        p.flatten(p.gather(x, p.to_tensor([2, 0]))),
        p.flatten(p.roll(p.flip(x, 0), 1, 1)),
        p.flatten(p.pad(x[None, None], [1, 2, 1, 0], "reflect")),
        p.flatten(p.strided_slice(x, [1], [3], [0], [-2])),
        p.flatten(p.take_along_axis(x, p.to_tensor([[0], [3], [2]]), 1)),
        p.flatten(p.tile(x, [1, 2])), p.cumsum(x, 1)[:, -1],
        p.flatten(p.masked_fill(x, x > 0, 0.0)),
        p.flatten(p.index_add(x, p.to_tensor([0, 2]), 0, x[:2])),
        p.flatten(p.put_along_axis(x, p.to_tensor([[1], [0], [2]]), 0.5, 1,
                                   "add"))]), [M], (0,)),
    "search_stat": (lambda p, x: p.topk(x, 2)[0].sum(1)
                    + p.sort(x, 1)[:, 0] + p.median(x, 1)
                    + p.quantile(x, 0.3, 1) + p.where(x > 0, x, x * x).sum(1),
                    [M], (0,)),
}


@pytest.mark.parametrize("name", sorted(GRADS))
def test_tensor_op_gradients(name):
    call, arrays, diff = GRADS[name]
    _grads(call, arrays, diff)


def test_in_place_forms_and_no_patched_methods():
    x = torch.from_numpy(M.copy())
    assert P.increment(x, 2.0) is x and np.allclose(x.numpy(), M + 2)
    y = torch.from_numpy(M.copy())
    assert P.masked_fill_(y, y > 0, 0.0) is y and (y <= 0).all()
    z = torch.from_numpy(M.copy())
    assert P.reshape_(z, [4, 3]) is z and z.shape == (4, 3)
    assert P.unsqueeze_(z, 0) is z and z.shape == (1, 4, 3)
    assert P.squeeze_(z, 0) is z and z.shape == (4, 3)
    w = torch.from_numpy(M.copy())
    P.scatter_(w, torch.tensor([1]), torch.ones(1, 4))
    assert (w[1] == 1).all()
    assert P.where_(torch.from_numpy(B1), w, torch.zeros_like(w)) is w
    # the port's tensors are torch's, with torch's methods only
    for name in ("gather_nd", "scatter_nd_add", "index_sample",
                 "put_along_axis", "strided_slice", "unstack"):
        assert not hasattr(torch.Tensor, name), name


def test_creation_lands_on_the_build_device_or_raises():
    with nn.building("cpu"):
        assert P.zeros([2]).device.type == "cpu"
        assert P.to_tensor([1.0]).dtype == torch.float32
    assert P.arange(3, device="cpu").dtype == torch.int64
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.zeros([2])


# ------------------------------------------------------------- the AST walk

# reference module -> port module
MODULES = {
    "paddle_tpu/__init__.py": "paddle_tpu_torch",
    "paddle_tpu/core/dtype.py": "paddle_tpu_torch.core.dtype",
    "paddle_tpu/core/device.py": "paddle_tpu_torch.core.device",
    "paddle_tpu/framework/io.py": "paddle_tpu_torch.framework.io",
    "paddle_tpu/tensor/__init__.py": "paddle_tpu_torch.tensor",
    "paddle_tpu/tensor/creation.py": "paddle_tpu_torch.tensor.creation",
    "paddle_tpu/tensor/math.py": "paddle_tpu_torch.tensor.math",
    "paddle_tpu/tensor/logic.py": "paddle_tpu_torch.tensor.logic",
    "paddle_tpu/tensor/search.py": "paddle_tpu_torch.tensor.search",
    "paddle_tpu/tensor/stat.py": "paddle_tpu_torch.tensor.stat",
    "paddle_tpu/tensor/einsum.py": "paddle_tpu_torch.tensor.einsum",
    "paddle_tpu/tensor/manipulation.py":
        "paddle_tpu_torch.tensor.manipulation",
    "paddle_tpu/tensor/random.py": "paddle_tpu_torch.tensor.random",
    "paddle_tpu/nn/layer/rnn.py": "paddle_tpu_torch.nn.layer.rnn",
    "paddle_tpu/nn/decode.py": "paddle_tpu_torch.nn.decode",
    "paddle_tpu/nn/functional/__init__.py": "paddle_tpu_torch.nn.functional",
    "paddle_tpu/nn/functional/activation.py":
        "paddle_tpu_torch.nn.functional.activation",
    "paddle_tpu/nn/functional/common.py":
        "paddle_tpu_torch.nn.functional.common",
    "paddle_tpu/nn/functional/loss.py": "paddle_tpu_torch.nn.functional.loss",
    "paddle_tpu/nn/layer/activation.py":
        "paddle_tpu_torch.nn.layer.activation",
    "paddle_tpu/nn/layer/common.py": "paddle_tpu_torch.nn.layer.common",
    "paddle_tpu/nn/layer/loss.py": "paddle_tpu_torch.nn.layer.loss",
    "paddle_tpu/nn/layer/transformer.py":
        "paddle_tpu_torch.nn.layer.transformer",
}

# names the port defines to raise NotImplementedError naming their item
DEFERRED = {
    ("paddle_tpu_torch", "summary"): "A8b-2",
    ("paddle_tpu_torch", "flops"): "A8b-2",
    ("paddle_tpu_torch", "enable_static"): "A8c",
    ("paddle_tpu_torch", "disable_dygraph"): "A8c",
    ("paddle_tpu_torch.nn.layer.loss", "HSigmoidLoss"): "A8b-1",
}


def _public_names(path):
    """Top-level ``def``/``class`` names and assigned names that do not
    start with ``_``, and the string keys of the dict literals a
    top-level ``for`` loop walks (``math.py``'s op tables)."""
    tree = ast.parse((ROOT / path).read_text())
    names = set()
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names.update(t.id for t in node.targets
                         if isinstance(t, ast.Name))
        elif isinstance(node, ast.For) and isinstance(node.iter, ast.Call) \
                and isinstance(node.iter.func, ast.Attribute) \
                and isinstance(node.iter.func.value, ast.Dict):
            names.update(k.value for k in node.iter.func.value.keys
                         if isinstance(k, ast.Constant))
    return {n for n in names if not n.startswith("_")}


@pytest.mark.parametrize("path", sorted(MODULES))
def test_every_public_name_is_ported(path):
    mod = importlib.import_module(MODULES[path])
    names = _public_names(path)
    assert names
    missing = sorted(n for n in names if not hasattr(mod, n))
    assert not missing, f"{MODULES[path]} lacks {missing}"


def test_deferred_names_raise_naming_their_item():
    x = torch.zeros(2, 3)
    calls = {"summary": lambda f: f(None), "flops": lambda f: f(None, None),
             "enable_static": lambda f: f(), "disable_dygraph": lambda f: f(),
             "HSigmoidLoss": lambda f: f(4, 5)}
    for (mod, name), item in DEFERRED.items():
        fn = getattr(importlib.import_module(mod), name)
        with pytest.raises(NotImplementedError, match=item):
            calls[name](fn)

"""Elementwise and reduction math (counterpart of
``paddle_tpu/tensor/math.py``).

The unary and binary ops are made from two tables, as in the reference.
A reduction takes ``axis`` as None, an int or a list, and ``keepdim``.
An integer sum or product is int64 (the reference's is int32 with x64
off: ROADMAP §C); a mean of integers is in the default float dtype.
"""

from __future__ import annotations

import builtins
import functools
import sys

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype

_mod = sys.modules[__name__]


def _unary(name, fn):
    def wrapper(x, name=None):
        return fn(x)
    wrapper.__name__ = wrapper.__qualname__ = name
    setattr(_mod, name, wrapper)


def _binary(name, fn):
    def wrapper(x, y, name=None):
        return fn(x, y)
    wrapper.__name__ = wrapper.__qualname__ = name
    setattr(_mod, name, wrapper)


def _imag(x):
    return torch.imag(x) if x.is_complex() else torch.zeros_like(x)


def _real(x):
    return torch.real(x) if x.is_complex() else x


def _heaviside(x, y):
    dt = torch.promote_types(x.dtype, y.dtype)
    return torch.heaviside(x.to(dt), y.to(dt))


for _n, _f in {
    "exp": torch.exp, "expm1": torch.expm1, "log": torch.log,
    "log2": torch.log2, "log10": torch.log10, "log1p": torch.log1p,
    "sqrt": torch.sqrt, "rsqrt": torch.rsqrt, "abs": torch.abs,
    "ceil": torch.ceil, "floor": torch.floor, "round": torch.round,
    "trunc": torch.trunc, "cos": torch.cos, "sin": torch.sin,
    "tan": torch.tan, "acos": torch.acos, "asin": torch.asin,
    "atan": torch.atan, "cosh": torch.cosh, "sinh": torch.sinh,
    "tanh": torch.tanh, "acosh": torch.acosh, "asinh": torch.asinh,
    "atanh": torch.atanh, "reciprocal": torch.reciprocal,
    "square": torch.square, "sign": torch.sign, "neg": torch.neg,
    "erf": torch.erf, "erfinv": torch.erfinv, "digamma": torch.digamma,
    "lgamma": torch.lgamma, "sigmoid": torch.sigmoid, "angle": torch.angle,
    "conj": torch.conj_physical, "real": _real, "imag": _imag,
    "frac": lambda x: x - torch.trunc(x), "isnan": torch.isnan,
    "isinf": torch.isinf, "isfinite": torch.isfinite,
    "i0": torch.special.i0, "i1": torch.special.i1,
}.items():
    _unary(_n, _f)

for _n, _f in {
    "add": torch.add, "subtract": torch.sub, "multiply": torch.mul,
    "divide": torch.true_divide, "floor_divide": torch.floor_divide,
    "mod": torch.remainder, "remainder": torch.remainder,
    "floor_mod": torch.remainder, "pow": torch.pow,
    "maximum": torch.maximum, "minimum": torch.minimum, "fmax": torch.fmax,
    "fmin": torch.fmin, "atan2": torch.atan2, "logaddexp": torch.logaddexp,
    "hypot": torch.hypot, "heaviside": _heaviside,
    "copysign": torch.copysign, "nextafter": torch.nextafter,
    "ldexp": torch.ldexp, "gcd": torch.gcd, "lcm": torch.lcm,
    "inner": torch.inner, "outer": torch.outer, "kron": torch.kron,
}.items():
    _binary(_n, _f)


def scale(x, scale=1.0, bias=0.0, bias_after_scale=True, act=None,
          name=None):
    """``x * scale + bias``, or ``(x + bias) * scale``."""
    return x * scale + bias if bias_after_scale else (x + bias) * scale


def clip(x, min=None, max=None, name=None):
    return torch.clamp(x, min, max)


def multiplex(inputs, index, name=None):
    """Row ``i`` of ``inputs[index[i]]``."""
    stacked = torch.stack(list(inputs), 1)
    rows = torch.arange(stacked.shape[0], device=stacked.device)
    return stacked[rows, index.reshape(-1).to(torch.int64)]


def _dims(x, axis):
    if axis is None:
        return tuple(range(x.dim()))
    if isinstance(axis, torch.Tensor):
        axis = axis.tolist()
    axes = axis if isinstance(axis, (list, tuple)) else [axis]
    return tuple(sorted({int(a) % builtins.max(x.dim(), 1) for a in axes}))


def _over_dims(fn, x, axis, keepdim):
    """``fn(x, dim, keepdim=True)`` over each reduced dim in turn (the
    ops that take one dim), squeezed unless ``keepdim``."""
    dims = _dims(x, axis)
    if x.dim() == 0:
        return fn(x.reshape(1), 0, keepdim=False)
    out = x
    for d in reversed(dims):
        out = fn(out, d, keepdim=True)
    return out if keepdim else out.squeeze(dims) if dims else out


def _float(x):
    return x if x.is_floating_point() or x.is_complex() \
        else x.to(get_default_dtype())


def _reduction(name, fn):
    def wrapper(x, axis=None, keepdim=False, name=None):
        return _over_dims(fn, x, axis, keepdim)
    wrapper.__name__ = wrapper.__qualname__ = name
    setattr(_mod, name, wrapper)


for _n, _f in {
    "sum": lambda a, d, keepdim: torch.sum(a, d, keepdim=keepdim),
    "mean": lambda a, d, keepdim: torch.mean(_float(a), d, keepdim=keepdim),
    "max": lambda a, d, keepdim: torch.amax(a, d, keepdim=keepdim),
    "min": lambda a, d, keepdim: torch.amin(a, d, keepdim=keepdim),
    "prod": lambda a, d, keepdim: torch.prod(a, d, keepdim=keepdim),
    "amax": lambda a, d, keepdim: torch.amax(a, d, keepdim=keepdim),
    "amin": lambda a, d, keepdim: torch.amin(a, d, keepdim=keepdim),
    "nansum": lambda a, d, keepdim: torch.nansum(a, d, keepdim=keepdim),
    "nanmean": lambda a, d, keepdim: torch.nanmean(_float(a), d,
                                                   keepdim=keepdim),
    "logsumexp": lambda a, d, keepdim: torch.logsumexp(_float(a), d,
                                                       keepdim=keepdim),
    "all": lambda a, d, keepdim: torch.all(a, d, keepdim=keepdim),
    "any": lambda a, d, keepdim: torch.any(a, d, keepdim=keepdim),
}.items():
    _reduction(_n, _f)


def count_nonzero(x, axis=None, keepdim=False, name=None):
    return _over_dims(lambda a, d, keepdim: (a != 0).sum(d, keepdim=keepdim),
                      x, axis, keepdim)


def cumsum(x, axis=None, dtype=None, name=None):
    a = x if dtype is None else x.to(convert_dtype(dtype))
    return torch.cumsum(a.reshape(-1) if axis is None else a,
                        0 if axis is None else axis)


def cumprod(x, dim=None, dtype=None, name=None):
    a = x if dtype is None else x.to(convert_dtype(dtype))
    return torch.cumprod(a.reshape(-1) if dim is None else a,
                         0 if dim is None else dim)


def _cum_arg(x, axis, dtype, scan):
    """Running extreme and the index of its last occurrence."""
    ax = 0 if axis is None else axis
    flat = x.reshape(-1) if axis is None else x
    vals = scan(flat, ax).values
    shape = [1] * flat.dim()
    shape[ax] = flat.shape[ax]
    iota = torch.arange(flat.shape[ax], device=x.device).reshape(
        shape).expand(flat.shape)
    idx = torch.cummax(torch.where(flat == vals, iota,
                                   torch.full_like(iota, -1)), ax).values
    return vals, idx.to(convert_dtype(dtype))


def cummax(x, axis=None, dtype="int64", name=None):
    return _cum_arg(x, axis, dtype, torch.cummax)


def cummin(x, axis=None, dtype="int64", name=None):
    return _cum_arg(x, axis, dtype, torch.cummin)


def diff(x, n=1, axis=-1, prepend=None, append=None, name=None):
    return torch.diff(x, n, axis, prepend, append)


def trace(x, offset=0, axis1=0, axis2=1, name=None):
    return torch.diagonal(x, offset, axis1, axis2).sum(-1)


def addmm(input, x, y, beta=1.0, alpha=1.0, name=None):
    return beta * input + alpha * (x @ y)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    if transpose_x and x.dim() > 1:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() > 1:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


def mm(x, y, name=None):
    return torch.matmul(x, y)


def bmm(x, y, name=None):
    return torch.matmul(x, y)


def dot(x, y, name=None):
    """The last-axis dot product (batched for 2-d inputs)."""
    return (x * y).sum(-1)


def mv(x, y, name=None):
    return torch.matmul(x, y)


def dist(x, y, p=2, name=None):
    return torch.linalg.vector_norm((x - y).reshape(-1), ord=p)


def stanh(x, scale_a=0.67, scale_b=1.7159, name=None):
    return scale_b * torch.tanh(scale_a * x)


def increment(x, value=1.0, name=None):
    """``x += value`` in place; returns ``x``."""
    return x.add_(value)


def isclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    return torch.isclose(x, y, rtol, atol, equal_nan)


def allclose(x, y, rtol=1e-05, atol=1e-08, equal_nan=False, name=None):
    """A 0-d bool tensor."""
    return torch.isclose(x, y, rtol, atol, equal_nan).all()


def equal_all(x, y, name=None):
    """A 0-d bool tensor: equal shapes and elements."""
    same = tuple(x.shape) == tuple(y.shape) and bool((x == y).all())
    return torch.tensor(same, device=x.device)


def lerp(x, y, weight, name=None):
    return x + weight * (y - x)


def rad2deg(x, name=None):
    return torch.rad2deg(_float(x))


def deg2rad(x, name=None):
    return torch.deg2rad(_float(x))


def take(x, index, mode="raise", name=None):
    """Elements of flattened ``x`` at ``index``: ``wrap`` takes indices
    modulo the size, ``clip`` (and ``raise``, which a device cannot do,
    as in the reference) clamps them."""
    flat = x.reshape(-1)
    n = flat.shape[0]
    i = index.to(torch.int64)
    i = torch.remainder(i, n) if mode == "wrap" else i.clamp(0, n - 1)
    return flat[i.reshape(-1)].reshape(index.shape)


def broadcast_shape(x_shape, y_shape):
    return list(np.broadcast_shapes(tuple(x_shape), tuple(y_shape)))


def add_n(inputs, name=None):
    """The elementwise sum of a list of tensors."""
    if not isinstance(inputs, (list, tuple)):
        inputs = [inputs]
    return functools.reduce(torch.add, inputs)


def tanh_(x, name=None):
    return torch.tanh_(x)


__all__ = sorted(n for n, v in vars(_mod).items()
                 if not n.startswith("_") and callable(v)
                 and getattr(v, "__module__", None) == __name__)

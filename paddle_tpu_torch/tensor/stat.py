"""Statistics (counterpart of ``paddle_tpu/tensor/stat.py``).  A median
with ``mode="avg"`` averages the two middle values (``quantile`` 0.5);
``mode="min"`` takes the lower one."""

from __future__ import annotations

import torch

from .math import _dims, _float


def _flat_dims(x, axis):
    """``x`` with the reduced axes moved last and merged, and the shape
    of the kept axes (each reduced axis as 1, for ``keepdim``)."""
    dims = _dims(x, axis)
    keep = [d for d in range(x.dim()) if d not in dims]
    moved = x.permute(keep + list(dims)).reshape(
        [x.shape[d] for d in keep] + [-1])
    kept_shape = [1 if d in dims else x.shape[d] for d in range(x.dim())]
    return moved, kept_shape


def _quantile(fn, x, q, axis, keepdim, interpolation):
    moved, kept_shape = _flat_dims(_float(x), axis)
    qt = torch.as_tensor(q, dtype=moved.dtype, device=moved.device)
    out = fn(moved, qt, dim=-1, interpolation=interpolation)
    if keepdim:
        out = out.reshape(tuple(qt.shape) + tuple(kept_shape))
    return out


def mean(x, axis=None, keepdim=False, name=None):
    dims = _dims(x, axis)
    return torch.mean(_float(x), dims, keepdim=keepdim) if dims else \
        _float(x)


def var(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.var(_float(x), _dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def std(x, axis=None, unbiased=True, keepdim=False, name=None):
    return torch.std(_float(x), _dims(x, axis), correction=int(unbiased),
                     keepdim=keepdim)


def median(x, axis=None, keepdim=False, mode="avg", name=None):
    if mode == "avg":
        return _quantile(torch.quantile, x, 0.5, axis, keepdim, "linear")
    a = x.reshape(-1) if axis is None else x
    ax = 0 if axis is None else axis
    srt = torch.sort(a, dim=ax).values
    return srt.select(ax, (a.shape[ax] - 1) // 2)


def nanmedian(x, axis=None, keepdim=False, name=None):
    return _quantile(torch.nanquantile, x, 0.5, axis, keepdim, "linear")


def quantile(x, q, axis=None, keepdim=False, interpolation="linear",
             name=None):
    return _quantile(torch.quantile, x, q, axis, keepdim, interpolation)


def nanquantile(x, q, axis=None, keepdim=False, interpolation="linear",
                name=None):
    return _quantile(torch.nanquantile, x, q, axis, keepdim, interpolation)


__all__ = ["mean", "var", "std", "median", "nanmedian", "quantile",
           "nanquantile"]

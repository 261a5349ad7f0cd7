"""Search and sort (counterpart of ``paddle_tpu/tensor/search.py``).

Orders are the reference's with ties present: ``argsort`` is always
stable (ties keep their input order, descending too), ``topk`` puts the
lower index first for ``largest`` either way (``lax.top_k``'s rule), and
``kthvalue`` picks from the stable order.  Index outputs are int64.
"""

from __future__ import annotations

import torch

from ..core.dtype import convert_dtype


def argmax(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = torch.argmax(x, axis, keepdim)
    if axis is None and keepdim:
        out = out.reshape((1,) * x.dim())
    return out.to(convert_dtype(dtype))


def argmin(x, axis=None, keepdim=False, dtype="int64", name=None):
    out = torch.argmin(x, axis, keepdim)
    if axis is None and keepdim:
        out = out.reshape((1,) * x.dim())
    return out.to(convert_dtype(dtype))


def argsort(x, axis=-1, descending=False, stable=False, name=None):
    """A stable sort's indices (``stable`` is accepted; the order is
    stable always, as the reference's)."""
    return torch.argsort(x, dim=axis, descending=descending, stable=True)


def sort(x, axis=-1, descending=False, stable=False, name=None):
    return torch.sort(x, dim=axis, descending=descending, stable=True).values


def topk(x, k, axis=None, largest=True, sorted=True, name=None):
    """The ``k`` largest (smallest) values along ``axis`` (default the
    last) and their int64 indices; among equal values the lower index
    comes first."""
    k = int(k.item()) if isinstance(k, torch.Tensor) else int(k)
    ax = x.dim() - 1 if axis is None else axis
    idx = torch.argsort(x, dim=ax, descending=largest, stable=True)
    idx = idx.narrow(ax, 0, k)
    return torch.gather(x, ax, idx), idx


def where(condition, x=None, y=None, name=None):
    """``x`` where ``condition``, else ``y``; with neither, the indices
    of the true elements (``nonzero(as_tuple=True)``)."""
    if x is None and y is None:
        return nonzero(condition, as_tuple=True)
    return torch.where(condition, x, y)


def where_(condition, x, y, name=None):
    """``where`` written into ``x``."""
    return x.copy_(where(condition, x, y))


def nonzero(x, as_tuple=False):
    """int64 indices of the nonzero elements: (n, ndim), or a tuple of
    ndim (n,) tensors."""
    return torch.nonzero(x, as_tuple=as_tuple)


def masked_fill_(x, mask, value, name=None):
    from .manipulation import masked_fill
    return x.copy_(masked_fill(x, mask, value))


def searchsorted(sorted_sequence, values, out_int32=False, right=False,
                 name=None):
    """Insertion points of ``values`` in the last axis of
    ``sorted_sequence`` (leading axes matched row by row)."""
    s = sorted_sequence
    v = values
    if s.dim() > 1:
        v = v.reshape(-1, v.shape[-1])
        out = torch.searchsorted(s.reshape(-1, s.shape[-1]).contiguous(),
                                 v.contiguous(), right=right)
        out = out.reshape(values.shape)
    else:
        out = torch.searchsorted(s.contiguous(), v.contiguous(), right=right)
    return out.to(torch.int32 if out_int32 else torch.int64)


def bucketize(x, sorted_sequence, out_int32=False, right=False, name=None):
    return searchsorted(sorted_sequence, x, out_int32, right)


def kthvalue(x, k, axis=-1, keepdim=False, name=None):
    """The ``k``-th smallest value along ``axis`` and its index in the
    stable order."""
    ax = axis % x.dim()
    srt = torch.sort(x, dim=ax, stable=True)
    vals = srt.values.select(ax, k - 1)
    inds = srt.indices.select(ax, k - 1)
    if keepdim:
        vals, inds = vals.unsqueeze(ax), inds.unsqueeze(ax)
    return vals, inds


def mode(x, axis=-1, keepdim=False, name=None):
    """The most frequent value along ``axis`` (the smallest of a tie) and
    the index of its last occurrence."""
    ax = axis % x.dim()
    moved = x.movedim(ax, -1)
    rows = moved.reshape(-1, moved.shape[-1])
    n = rows.shape[-1]
    srt = torch.sort(rows, -1).values
    first = torch.ones_like(srt, dtype=torch.bool)
    first[:, 1:] = srt[:, 1:] != srt[:, :-1]
    grp = torch.cumsum(first.to(torch.int64), -1) - 1
    counts = torch.zeros_like(grp).scatter_add_(1, grp, torch.ones_like(grp))
    best = torch.argmax(counts, -1, keepdim=True)
    val_pos = torch.argmax((grp == best).to(torch.int8), -1, keepdim=True)
    vals = torch.gather(srt, 1, val_pos)
    last = n - 1 - torch.argmax(torch.flip(rows == vals, [-1]).to(torch.int8),
                                -1)
    vals = vals.reshape(moved.shape[:-1])
    idxs = last.reshape(moved.shape[:-1])
    if keepdim:
        vals, idxs = vals.unsqueeze(ax), idxs.unsqueeze(ax)
    return vals, idxs


def index_fill(x, index, axis, value, name=None):
    return x.index_fill(axis, index.to(torch.int64), value)


__all__ = ["argmax", "argmin", "argsort", "sort", "topk", "where", "where_",
           "nonzero", "masked_fill_", "searchsorted", "bucketize",
           "kthvalue", "mode", "index_fill"]

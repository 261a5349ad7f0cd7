"""Shape, layout, indexing and scatter ops (counterpart of
``paddle_tpu/tensor/manipulation.py``), each with the reference's
semantics on torch tensors.  Index outputs (``unique``'s) are int64; an
index argument may be int32 or int64.  ``unique``, ``unique_consecutive``
and ``masked_select`` have data-dependent shapes: the first two run
through numpy on the host, as the reference's.  The ``_`` forms write
into their input and return it.
"""

from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core.dtype import convert_dtype


def _shape(s):
    """A shape given as an int, a sequence of ints or 0-d tensors, or a
    1-d tensor, as a tuple of ints."""
    if isinstance(s, torch.Tensor):
        return tuple(int(v) for v in s.reshape(-1).tolist())
    if isinstance(s, (int, np.integer)):
        return (int(s),)
    return tuple(int(v) for v in s)


def _int(v):
    return int(v.item()) if isinstance(v, torch.Tensor) else int(v)


def _idx(i):
    return i.to(torch.int64) if isinstance(i, torch.Tensor) else \
        torch.as_tensor(i, dtype=torch.int64)


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1)."""
    return x.reshape(_shape(shape))


def reshape_(x, shape, name=None):
    """``x`` reshaped in place (its metadata; autograd sees no op, as
    with ``.data``)."""
    x.data = x.data.reshape(_shape(shape))
    return x


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge the axes ``start_axis``..``stop_axis`` (inclusive) into one."""
    nd = x.dim()
    s0 = start_axis % nd if nd else 0
    s1 = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s0]) + (-1,) + tuple(x.shape[s1 + 1:]))


def transpose(x, perm=None, name=None):
    """``x`` with its axes permuted by ``perm`` (reversed for None)."""
    return x.permute(tuple(range(x.dim() - 1, -1, -1)) if perm is None
                     else tuple(int(p) for p in perm))


transpose_ = transpose


def moveaxis(x, source, destination, name=None):
    return torch.movedim(x, source, destination)


def swapaxes(x, axis0, axis1, name=None):
    return torch.swapaxes(x, axis0, axis1)


def unsqueeze(x, axis, name=None):
    """New size-1 axes at ``axis`` (positions in the output)."""
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    nd = x.dim() + len(axes)
    out = x
    for a in sorted(_int(a) % nd for a in axes):
        out = out.unsqueeze(a)
    return out


def squeeze(x, axis=None, name=None):
    """Drop the size-1 axes (of ``axis`` only, when given)."""
    if axis is None:
        return x.squeeze()
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    keep = tuple(a % x.dim() for a in axes if x.shape[a] == 1)
    return x.squeeze(keep) if keep else x


def squeeze_(x, axis=None, name=None):
    if axis is None:
        return x.squeeze_()
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    for a in sorted((a % x.dim() for a in axes if x.shape[a] == 1),
                    reverse=True):
        x.squeeze_(a)
    return x


def unsqueeze_(x, axis, name=None):
    axes = list(axis) if isinstance(axis, (list, tuple)) else [axis]
    nd = x.dim() + len(axes)
    for a in sorted(_int(a) % nd for a in axes):
        x.unsqueeze_(a)
    return x


def concat(x, axis=0, name=None):
    """The tensors of ``x`` joined along ``axis`` (an int or a 0-d
    tensor); mixed dtypes promote, as ``jnp.concatenate`` does."""
    return torch.cat(list(x), dim=_int(axis))


def stack(x, axis=0, name=None):
    return torch.stack(list(x), dim=axis)


def unstack(x, axis=0, num=None, name=None):
    return list(torch.unbind(x, axis))


def split(x, num_or_sections, axis=0, name=None):
    """``num`` equal parts (which must divide the axis), or parts of the
    given sizes (one may be -1: the rest)."""
    axis = _int(axis)
    total = x.shape[axis]
    if isinstance(num_or_sections, int):
        if total % num_or_sections:
            raise ValueError(f"array split does not result in an equal "
                             f"division: {total} into {num_or_sections}")
        return list(torch.split(x, total // num_or_sections, axis))
    secs = [_int(s) for s in num_or_sections]
    known = sum(s for s in secs if s != -1)
    secs = [s if s != -1 else total - known for s in secs]
    return list(torch.split(x, secs, axis))


def chunk(x, chunks, axis=0, name=None):
    return split(x, chunks, axis)


def tile(x, repeat_times, name=None):
    return torch.tile(x, _shape(repeat_times))


def expand(x, shape, name=None):
    """``x`` broadcast to ``shape``; -1 keeps the input's size."""
    tgt = list(_shape(shape))
    for i, t in enumerate(tgt):
        if t == -1:
            tgt[i] = x.shape[i - (len(tgt) - x.dim())]
    return x.expand(tgt)


def expand_as(x, y, name=None):
    return x.expand(y.shape)


def broadcast_to(x, shape, name=None):
    return torch.broadcast_to(x, _shape(shape))


def broadcast_tensors(inputs, name=None):
    return list(torch.broadcast_tensors(*inputs))


def flip(x, axis, name=None):
    return torch.flip(x, [axis] if isinstance(axis, int) else list(axis))


def rot90(x, k=1, axes=(0, 1), name=None):
    return torch.rot90(x, k, list(axes))


def roll(x, shifts, axis=None, name=None):
    return torch.roll(x, shifts, axis)


def _wrap(i, n):
    return torch.where(i < 0, i + n, i)


def gather(x, index, axis=0, name=None):
    """Slices of ``x`` along ``axis`` at ``index`` (a 0-d index drops the
    axis)."""
    axis = _int(axis)
    i = _wrap(_idx(index).to(x.device), x.shape[axis])
    if i.dim() == 0:
        return x.select(axis, int(i))
    return x.index_select(axis, i.reshape(-1))


def gather_nd(x, index, name=None):
    """``x[index[..., 0], index[..., 1], ...]``."""
    i = _idx(index).to(x.device)
    return x[tuple(i.movedim(-1, 0))]


def take_along_axis(arr, indices, axis, broadcast=True, name=None):
    return torch.take_along_dim(arr, _idx(indices).to(arr.device), axis)


def put_along_axis(arr, indices, values, axis, reduce="assign", name=None):
    """``arr`` with ``values`` put at ``indices`` along ``axis``:
    assigned, added (``add``) or multiplied (``mul``)."""
    i = _idx(indices).to(arr.device)
    v = torch.as_tensor(values, device=arr.device).to(arr.dtype) \
        .broadcast_to(i.shape)
    if reduce == "add":
        return arr.scatter_add(axis, i, v)
    if reduce in ("mul", "multiply"):
        return arr.scatter_reduce(axis, i, v, "prod")
    return arr.scatter(axis, i, v)


def scatter(x, index, updates, overwrite=True, name=None):
    """Rows ``index`` of ``x`` set to ``updates`` (added to them without
    ``overwrite``, as the reference does)."""
    i = _idx(index).to(x.device).reshape(-1)
    u = updates.to(x.dtype)
    return x.index_copy(0, i, u) if overwrite else x.index_add(0, i, u)


def scatter_(x, index, updates, overwrite=True, name=None):
    i = _idx(index).to(x.device).reshape(-1)
    u = updates.to(x.dtype)
    return x.index_copy_(0, i, u) if overwrite else x.index_add_(0, i, u)


def scatter_nd(index, updates, shape, name=None):
    """Zeros of ``shape`` with ``updates`` added at the ``index`` rows."""
    z = torch.zeros(_shape(shape), dtype=updates.dtype,
                    device=updates.device)
    return scatter_nd_add(z, index, updates)


def scatter_nd_add(x, index, updates, name=None):
    i = _idx(index).to(x.device)
    return x.index_put(tuple(i.movedim(-1, 0)), updates.to(x.dtype),
                       accumulate=True)


def index_select(x, index, axis=0, name=None):
    return x.index_select(axis, _wrap(_idx(index).to(x.device),
                                      x.shape[axis]))


def index_sample(x, index):
    return torch.take_along_dim(x, _idx(index).to(x.device), 1)


def index_add(x, index, axis, value, name=None):
    return x.index_add(axis, _idx(index).to(x.device), value.to(x.dtype))


def index_put(x, indices, value, accumulate=False, name=None):
    idx = tuple(_idx(i).to(x.device) if i.dtype != torch.bool else i
                for i in indices)
    return x.index_put(idx, torch.as_tensor(value, device=x.device).to(
        x.dtype), accumulate=accumulate)


def repeat_interleave(x, repeats, axis=None, name=None):
    if isinstance(repeats, torch.Tensor):
        repeats = repeats.to(torch.int64).to(x.device)
    return torch.repeat_interleave(x, repeats, dim=axis)


def _host(x):
    return x.detach().cpu().numpy()


def _back(a, like):
    return torch.from_numpy(np.ascontiguousarray(a)).to(like.device)


def unique(x, return_index=False, return_inverse=False, return_counts=False,
           axis=None, dtype="int64", name=None):
    """``np.unique`` on the host: the sorted unique values, then the
    requested int64 index, inverse and count tensors."""
    res = np.unique(_host(x), return_index=return_index,
                    return_inverse=return_inverse,
                    return_counts=return_counts, axis=axis)
    if isinstance(res, tuple):
        return (_back(res[0], x),) + tuple(
            _back(r.astype(np.int64), x) for r in res[1:])
    return _back(res, x)


def unique_consecutive(x, return_inverse=False, return_counts=False,
                       axis=None, dtype="int64", name=None):
    """Drop repeats of the previous slice along ``axis`` (flattened for
    None); with int64 inverse and counts."""
    a = _host(x)
    if axis is None:
        a = a.reshape(-1)
        ax = 0
    else:
        ax = axis
    take = np.ones(a.shape[ax], dtype=bool)
    sl = [builtins.slice(None)] * a.ndim
    sl[ax] = builtins.slice(1, None)
    sl2 = [builtins.slice(None)] * a.ndim
    sl2[ax] = builtins.slice(None, -1)
    neq = a[tuple(sl)] != a[tuple(sl2)]
    while neq.ndim > 1:
        neq = neq.any(axis=-1 if ax == 0 else 0)
    take[1:] = neq
    out = [_back(np.compress(take, a, axis=ax), x)]
    if return_inverse:
        out.append(_back((np.cumsum(take) - 1).astype(np.int64), x))
    if return_counts:
        idx = np.nonzero(take)[0]
        out.append(_back(np.diff(np.append(idx, a.shape[ax])).astype(
            np.int64), x))
    return out[0] if len(out) == 1 else tuple(out)


def masked_select(x, mask, name=None):
    """The elements of ``x`` where ``mask`` (broadcast) is true, 1-d;
    differentiable in ``x``."""
    return torch.masked_select(x, mask.to(torch.bool))


def masked_fill(x, mask, value, name=None):
    v = torch.as_tensor(value, device=x.device).to(x.dtype)
    return torch.where(mask.to(torch.bool), v, x)


def _pad_index(n, lo, hi, mode, device):
    """Source positions of the padded axis for a non-constant mode."""
    p = torch.arange(-lo, n + hi, device=device)
    if mode == "edge":
        return p.clamp(0, n - 1)
    if mode == "wrap":
        return torch.remainder(p, n)
    if n == 1:                                            # reflect
        return torch.zeros_like(p)
    period = 2 * (n - 1)
    q = torch.remainder(p, period)
    return torch.where(q >= n, period - q, q)


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    """``pad`` as 2 * ndim widths in axis order, or as (last_lo, last_hi,
    second_last_lo, ...) over the spatial axes of ``data_format``;
    ``constant``, ``reflect``, ``replicate`` or ``circular``."""
    p = [_int(v) for v in (pad.reshape(-1).tolist()
                           if isinstance(pad, torch.Tensor) else pad)]
    nd = x.dim()
    if len(p) == 2 * nd:
        width = [(p[2 * i], p[2 * i + 1]) for i in range(nd)]
    else:
        k = len(p) // 2
        width = [(0, 0)] * nd
        dims = (list(range(nd - k, nd))
                if data_format in ("NCHW", "NCL", "NCDHW")
                else list(range(1, 1 + k)))
        for j, d in enumerate(reversed(dims)):
            width[d] = (p[2 * j], p[2 * j + 1])
    jmode = {"constant": "constant", "reflect": "reflect",
             "replicate": "edge", "circular": "wrap"}[mode]
    if jmode == "constant":
        flat = [v for lo_hi in reversed(width) for v in lo_hi]
        return torch.nn.functional.pad(x, flat, value=value)
    out = x
    for d, (lo, hi) in enumerate(width):
        if lo or hi:
            out = out.index_select(d, _pad_index(x.shape[d], lo, hi, jmode,
                                                 x.device))
    return out


def strided_slice(x, axes, starts, ends, strides, name=None):
    """Python slicing ``start:end:stride`` along each of ``axes``
    (negative strides too)."""
    out = x
    for ax, s, e, st in zip(axes, starts, ends, strides):
        st = _int(st)
        if st > 0:
            sl = [builtins.slice(None)] * out.dim()
            sl[ax] = builtins.slice(_int(s), _int(e), st)
            out = out[tuple(sl)]
        else:
            ids = range(*builtins.slice(_int(s), _int(e), st).indices(
                out.shape[ax]))
            out = out.index_select(ax, torch.tensor(list(ids),
                                                    dtype=torch.int64,
                                                    device=x.device))
    return out


def slice(x, axes, starts, ends, name=None):  # noqa: A001
    return strided_slice(x, axes, starts, ends, [1] * len(axes))


def crop(x, shape=None, offsets=None, name=None):
    """The block of ``shape`` (-1: to the end) at ``offsets``."""
    sh = _shape(shape)
    off = [0] * x.dim() if offsets is None else [_int(o) for o in offsets]
    return x[tuple(builtins.slice(o, (o + s) if s != -1 else None)
                   for o, s in zip(off, sh))]


def as_complex(x, name=None):
    return torch.complex(x[..., 0], x[..., 1])


def as_real(x, name=None):
    return torch.stack([torch.real(x), torch.imag(x)], -1)


def view(x, shape_or_dtype, name=None):
    if isinstance(shape_or_dtype, (list, tuple)):
        return reshape(x, shape_or_dtype)
    return x.view(convert_dtype(shape_or_dtype))


def view_as(x, other, name=None):
    return x.reshape(other.shape)


def atleast_1d(*inputs, name=None):
    outs = [torch.atleast_1d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_2d(*inputs, name=None):
    outs = [torch.atleast_2d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def atleast_3d(*inputs, name=None):
    outs = [torch.atleast_3d(t) for t in inputs]
    return outs[0] if len(outs) == 1 else outs


def tensordot(x, y, axes=2, name=None):
    if isinstance(axes, (list, tuple)):
        axes = [list(a) if isinstance(a, (list, tuple)) else [a]
                for a in axes]
    return torch.tensordot(x, y, dims=axes)


def shard_index(input, index_num, nshards, shard_id, ignore_value=-1):
    """Indices of shard ``shard_id`` (of ``index_num // nshards`` each)
    made local; the others become ``ignore_value``."""
    size = index_num // nshards
    lo, hi = shard_id * size, (shard_id + 1) * size
    inside = (input >= lo) & (input < hi)
    return torch.where(inside, input - lo,
                       torch.full_like(input, ignore_value))


def t(x, name=None):
    """Transpose a 0-, 1- or 2-d tensor."""
    if x.dim() > 2:
        raise ValueError(
            f"paddle.t only accepts tensors of rank <= 2, got rank "
            f"{x.dim()}; use paddle.transpose for higher ranks")
    return x if x.dim() < 2 else x.transpose(0, 1)


__all__ = ["as_complex", "as_real", "atleast_1d", "atleast_2d",
           "atleast_3d", "broadcast_tensors", "broadcast_to", "chunk",
           "concat", "crop", "expand", "expand_as", "flatten", "flip",
           "gather", "gather_nd", "index_add", "index_put", "index_sample",
           "index_select", "masked_fill", "masked_select", "moveaxis", "pad",
           "put_along_axis", "repeat_interleave", "reshape", "reshape_",
           "roll", "rot90", "scatter", "scatter_", "scatter_nd",
           "scatter_nd_add", "shard_index", "slice", "split", "squeeze",
           "squeeze_", "stack", "strided_slice", "swapaxes", "t",
           "take_along_axis", "tensordot", "tile", "transpose",
           "transpose_", "unique", "unique_consecutive", "unsqueeze",
           "unsqueeze_", "unstack", "view", "view_as"]

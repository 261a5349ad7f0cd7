"""Shape manipulation (counterpart of ``paddle_tpu/tensor/manipulation.py``):
``reshape``, ``flatten``, ``transpose`` and ``concat`` for now."""

from __future__ import annotations

import torch


def _shape(s):
    """A shape given as an int, a sequence of ints or 0-d tensors, or a
    1-d tensor, as a tuple of ints."""
    if isinstance(s, torch.Tensor):
        return tuple(int(v) for v in s.reshape(-1).tolist())
    if isinstance(s, int):
        return (s,)
    return tuple(int(v) for v in s)


def reshape(x, shape, name=None):
    """``x`` in ``shape`` (one entry may be -1)."""
    return x.reshape(_shape(shape))


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


def concat(x, axis=0, name=None):
    """The tensors of ``x`` joined along ``axis`` (an int or a 0-d
    tensor); mixed dtypes promote, as ``jnp.concatenate`` does."""
    return torch.cat(list(x), dim=int(axis))


__all__ = ["reshape", "flatten", "transpose", "concat"]

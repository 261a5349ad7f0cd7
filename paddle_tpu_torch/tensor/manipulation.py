"""Shape manipulation (counterpart of ``paddle_tpu/tensor/manipulation.py``):
``flatten`` for now."""

from __future__ import annotations


def flatten(x, start_axis=0, stop_axis=-1, name=None):
    """Merge the axes ``start_axis``..``stop_axis`` (inclusive) into one."""
    nd = x.dim()
    s0 = start_axis % nd if nd else 0
    s1 = stop_axis % nd if nd else 0
    return x.reshape(tuple(x.shape[:s0]) + (-1,) + tuple(x.shape[s1 + 1:]))


__all__ = ["flatten"]

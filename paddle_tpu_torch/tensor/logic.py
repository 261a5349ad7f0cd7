"""Comparisons and logical and bitwise ops (counterpart of
``paddle_tpu/tensor/logic.py``)."""

from __future__ import annotations

import torch


def equal(x, y, name=None):
    return torch.eq(x, y)


def not_equal(x, y, name=None):
    return torch.ne(x, y)


def greater_than(x, y, name=None):
    return torch.gt(x, y)


def greater_equal(x, y, name=None):
    return torch.ge(x, y)


def less_than(x, y, name=None):
    return torch.lt(x, y)


def less_equal(x, y, name=None):
    return torch.le(x, y)


def logical_and(x, y, out=None, name=None):
    return torch.logical_and(x, y)


def logical_or(x, y, out=None, name=None):
    return torch.logical_or(x, y)


def logical_xor(x, y, out=None, name=None):
    return torch.logical_xor(x, y)


def logical_not(x, out=None, name=None):
    return torch.logical_not(x)


def bitwise_and(x, y, out=None, name=None):
    return torch.bitwise_and(x, y)


def bitwise_or(x, y, out=None, name=None):
    return torch.bitwise_or(x, y)


def bitwise_xor(x, y, out=None, name=None):
    return torch.bitwise_xor(x, y)


def bitwise_not(x, out=None, name=None):
    return torch.bitwise_not(x)


def bitwise_left_shift(x, y, name=None):
    return torch.bitwise_left_shift(x, y)


def bitwise_right_shift(x, y, name=None):
    return torch.bitwise_right_shift(x, y)


def is_tensor(x):
    return isinstance(x, torch.Tensor)


def is_empty(x, name=None):
    """A 0-d bool tensor: whether ``x`` has no elements."""
    return torch.tensor(x.numel() == 0, device=x.device)


__all__ = ["equal", "not_equal", "greater_than", "greater_equal",
           "less_than", "less_equal", "logical_and", "logical_or",
           "logical_xor", "logical_not", "bitwise_and", "bitwise_or",
           "bitwise_xor", "bitwise_not", "bitwise_left_shift",
           "bitwise_right_shift", "is_tensor", "is_empty"]

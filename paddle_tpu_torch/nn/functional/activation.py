"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``): ``relu``, ``relu6``,
``silu`` (``swish``) and ``softmax`` for now."""

from __future__ import annotations

import torch

from ..initializer import to_dtype


def relu(x, name=None):
    return torch.relu(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def silu(x, name=None):
    """``x * sigmoid(x)``."""
    return torch.nn.functional.silu(x)


swish = silu


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(to_dtype(dtype))
    return torch.softmax(x, dim=axis)


__all__ = ["relu", "relu6", "silu", "swish", "softmax"]

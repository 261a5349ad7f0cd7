"""Einsum (counterpart of ``paddle_tpu/tensor/einsum.py``)."""

from __future__ import annotations

import torch


def einsum(equation, *operands):
    return torch.einsum(equation, *operands)


__all__ = ["einsum"]

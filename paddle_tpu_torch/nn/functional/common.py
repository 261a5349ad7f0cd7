"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` for now."""

from __future__ import annotations

import torch


def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with the reference's (in, out) weight layout.
    Mixed float dtypes promote, as ``jnp.matmul`` does."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


__all__ = ["linear"]

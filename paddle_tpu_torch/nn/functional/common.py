"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear`` and the dropouts.

A dropout's keep-mask is ``core.rng.bernoulli(next_key(), 1 - p,
mask_shape)``: the reference's mask from the same key, bit for bit.  Its
uniform is as wide as the input: 64-bit bits and a float64 compare for a
float64 input, 32-bit bits and a float32 compare for any other.  The
reference draws at the width of its ``1.0 - p``, a Python float: float64
with ``jax_enable_x64`` on, float32 with it off.  So a float64 mask is the
reference's under x64 on, and any other the reference's under x64 off,
where it trains.  Eval mode and ``p == 0`` draw nothing.  Inside a mesh
train step over data ranks (``core.rng.row_block``) a rank draws its rows
of the reference's mask over the global batch (the mask shape keeps dim
0: ``dropout2d``/``3d`` too); a mask broadcast over the batch (``axis``
without 0) is the reference's whole mask on every rank.
"""

from __future__ import annotations

import contextlib

import torch

from ...core import rng


def linear(x, weight, bias=None, name=None):
    """``y = x @ W + b`` with the reference's (in, out) weight layout.
    Mixed float dtypes promote, as ``jnp.matmul`` does."""
    dt = torch.promote_types(x.dtype, weight.dtype)
    out = torch.matmul(x.to(dt), weight.to(dt))
    if bias is not None:
        out = out + bias.to(out.dtype)
    return out


def _keep(x, p, mask_shape, over_batch=True):
    """The keep-mask of ``mask_shape`` with probability ``1 - p``, at the
    input's width (module docstring), on the input's device.
    ``over_batch``: the mask's dim 0 is the batch's (else it is broadcast
    over the batch, and every rank of a mesh step draws all of it)."""
    dt = torch.float64 if x.dtype == torch.float64 else torch.float32
    with (contextlib.nullcontext() if over_batch
          else rng.batch_broadcast()):
        return rng.bernoulli(rng.next_key(), 1.0 - p, mask_shape, dt,
                             device=x.device)


def _scalar(v, x):
    """``v`` as a 0-d tensor of ``x``'s dtype on its device (a fill, no
    copy from the host; a true division where a host scalar would become
    a multiply by its reciprocal on the card)."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def dropout(x, p=0.5, axis=None, training=True, mode="upscale_in_train",
            name=None):
    """Zero each element (each slice along the axes not in ``axis``) with
    probability ``p``; ``upscale_in_train`` divides the kept ones by
    ``1 - p``, ``downscale_in_infer`` multiplies by ``1 - p`` in eval
    mode instead."""
    if not training or p == 0.0:
        if mode == "downscale_in_infer" and not training:
            return x * _scalar(1.0 - p, x)
        return x
    if axis is None:
        axes = list(range(x.dim()))
    else:
        axes = [axis] if isinstance(axis, int) else list(axis)
    mask_shape = tuple(x.shape[i] if i in axes else 1
                       for i in range(x.dim()))
    keep = _keep(x, p, mask_shape, 0 in axes)
    zero = _scalar(0.0, x)
    if mode == "upscale_in_train":
        return torch.where(keep, x / _scalar(1.0 - p, x), zero)
    return torch.where(keep, x, zero)


def dropout2d(x, p=0.5, training=True, data_format="NCHW", name=None):
    """Drop whole channels: one draw per (sample, channel)."""
    ax = [0, 1] if data_format == "NCHW" else [0, 3]
    return dropout(x, p, axis=ax, training=training)


def dropout3d(x, p=0.5, training=True, data_format="NCDHW", name=None):
    ax = [0, 1] if data_format == "NCDHW" else [0, 4]
    return dropout(x, p, axis=ax, training=training)


def alpha_dropout(x, p=0.5, training=True, name=None):
    """SELU-preserving dropout: a dropped element becomes ``-alpha *
    scale``, then an affine map restores the mean and variance."""
    if not training or p == 0.0:
        return x
    alpha = 1.6732632423543772
    scale = 1.0507009873554805
    alpha_p = -alpha * scale
    keep = _keep(x, p, tuple(x.shape))
    q = 1.0 - p
    a_coef = (q + alpha_p ** 2 * q * p) ** -0.5
    b_coef = -a_coef * alpha_p * p
    return (_scalar(a_coef, x) * torch.where(keep, x, _scalar(alpha_p, x))
            + _scalar(b_coef, x))


__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout"]

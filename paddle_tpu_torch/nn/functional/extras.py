"""Functionals of ``paddle_tpu/nn/functional/extras.py`` that the port
has: ``max_unpool2d``, the inverse of ``max_pool2d(return_mask=True)``,
``zeropad2d`` and the in-place ``elu_``/``tanh_``; the rest of that file
(``hsigmoid_loss``, ``margin_cross_entropy``, ``class_center_sample``,
``gather_tree``) waits for ROADMAP A8b-1's second slice."""

from __future__ import annotations

import torch


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter each pooled value of ``x`` (N, C, H, W) back to its
    argmax position (``indices``: flattened input-spatial ids, as
    ``max_pool2d(return_mask=True)`` gives them) in a zero (N, C, Ho, Wo)
    map, ``Ho = (H - 1) * stride - 2 * padding + kernel`` unless
    ``output_size`` names it.  NCHW only, as in the reference."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    ks = _pair(kernel_size)
    st = ks if stride is None else _pair(stride)
    pd = _pair(padding)
    n, c, h, w = x.shape
    if output_size is not None:
        ho, wo = output_size[-2:]
    else:
        ho = (h - 1) * st[0] - 2 * pd[0] + ks[0]
        wo = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    flat = torch.zeros((n, c, ho * wo), dtype=x.dtype, device=x.device)
    ids = indices.reshape(n, c, h * w).to(torch.int64)
    return flat.scatter(2, ids, x.reshape(n, c, h * w)).reshape(n, c, ho, wo)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad H and W; ``padding`` = [left, right, top, bottom]."""
    l, r, t, b = padding
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (l, r, t, b))
    return torch.nn.functional.pad(x, (0, 0, l, r, t, b))


def elu_(x, alpha=1.0, name=None):
    return torch.nn.functional.elu_(x, alpha)


def tanh_(x, name=None):
    return torch.tanh_(x)


__all__ = ["max_unpool2d", "zeropad2d", "elu_", "tanh_"]

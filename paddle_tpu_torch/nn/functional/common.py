"""Common functionals (counterpart of ``paddle_tpu/nn/functional/common.py``):
``linear``, the dropouts, ``embedding``, ``one_hot``, ``label_smooth``,
``interpolate``/``upsample``, the pixel and channel shuffles, ``pad``,
``cosine_similarity``, ``bilinear``, ``affine_grid``, ``grid_sample``,
and ``unfold``/``fold`` (``conv``'s).

``interpolate`` is the reference's: ``nearest`` takes ``floor(i * in /
out)``; ``align_corners`` interpolates linearly between the corner-aligned
neighbours in every mode but ``nearest``; otherwise the linear modes and
``area`` are ``jax.image.resize``'s antialiased triangle filter and
``bicubic`` its Keys cubic (a = -0.5), both with half-pixel centres
(:func:`_resize`).

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

import numpy as np
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


def embedding(x, weight, padding_idx=None, sparse=False, name=None):
    """Rows ``x`` of ``weight``; rows of ``padding_idx`` come out zero."""
    out = weight[x.to(torch.int64)]
    if padding_idx is not None:
        pid = padding_idx if padding_idx >= 0 else weight.shape[0] + \
            padding_idx
        out = out * (x != pid).unsqueeze(-1).to(out.dtype)
    return out


def one_hot(x, num_classes, name=None):
    """float32 one-hot rows (an index outside [0, num_classes) gives a
    zero row, as ``jax.nn.one_hot``)."""
    classes = torch.arange(num_classes, device=x.device)
    return (x.unsqueeze(-1) == classes).to(torch.float32)


def label_smooth(label, prior_dist=None, epsilon=0.1, name=None):
    if prior_dist is not None:
        return (1 - epsilon) * label + epsilon * prior_dist
    return (1 - epsilon) * label + epsilon / label.shape[-1]


def _linear_kernel(x):
    return torch.clamp(1 - x.abs(), min=0.0)


def _cubic_kernel(x):
    """Keys' cubic with a = -0.5, as ``jax.image``'s."""
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = torch.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    return torch.where(x >= 2.0, torch.zeros_like(x), out)


def _weight_mat(n_in, n_out, kernel, device):
    """``jax.image``'s (n_in, n_out) float32 weights of an antialiased
    resize with half-pixel centres (scale n_out / n_in, no translation)."""
    f32 = torch.float32
    inv_scale = torch.full((), 1.0 / (n_out / n_in), dtype=f32)
    kscale = torch.clamp(inv_scale, min=1.0)
    sample = ((torch.arange(n_out, dtype=f32) + 0.5) * inv_scale - 0.5)
    x = (sample[None, :] - torch.arange(n_in, dtype=f32)[:, None]).abs() \
        / kscale
    w = kernel(x)
    total = w.sum(0, keepdim=True)
    w = torch.where(total.abs() > 1000.0 * float(np.finfo(np.float32).eps),
                    w / torch.where(total != 0, total, torch.ones_like(total)),
                    torch.zeros_like(w))
    inside = (sample >= -0.5) & (sample <= n_in - 0.5)
    return torch.where(inside[None, :], w, torch.zeros_like(w)).to(device)


def _resize(a, dims, sizes, kernel):
    """``jax.image.resize`` of ``a`` to ``sizes`` along ``dims`` (the dims
    whose size changes), one weight matrix a dim."""
    out = a
    for d, o in zip(dims, sizes):
        if out.shape[d] == o:
            continue
        w = _weight_mat(out.shape[d], o, kernel, a.device).to(a.dtype)
        out = torch.tensordot(out, w, dims=([d], [0])).movedim(-1, d)
    return out


def interpolate(x, size=None, scale_factor=None, mode="nearest",
                align_corners=False, align_mode=0, data_format="NCHW",
                name=None):
    """Resize the spatial dims to ``size`` (or ``int(in * scale)``);
    module docstring for the modes."""
    nd = x.dim()
    dims = list(range(2, nd)) if data_format[1] == "C" else \
        list(range(1, nd - 1))
    if size is not None:
        if isinstance(size, torch.Tensor):
            size = size.reshape(-1).tolist()
        sizes = [int(s) for s in (size if isinstance(size, (list, tuple))
                                  else [size] * len(dims))]
    else:
        sf = scale_factor if isinstance(scale_factor, (list, tuple)) \
            else [scale_factor] * len(dims)
        sizes = [int(x.shape[d] * s) for d, s in zip(dims, sf)]
    mode = mode.lower()
    if mode not in ("nearest", "bilinear", "linear", "trilinear", "bicubic",
                    "area"):
        raise ValueError(f"interpolate: unknown mode {mode!r}")
    out = x
    if mode == "nearest":
        for d, o in zip(dims, sizes):
            pos = torch.arange(o, dtype=torch.float32) * torch.full(
                (), x.shape[d] / o, dtype=torch.float32)
            idx = torch.floor(pos).to(torch.int64).to(x.device)
            out = out.index_select(d, idx)
        return out
    if align_corners:
        for d, o in zip(dims, sizes):
            n = out.shape[d]
            pos = torch.linspace(0.0, n - 1.0, o, dtype=torch.float32)
            lo = torch.floor(pos).to(torch.int64)
            hi = torch.clamp(lo + 1, max=n - 1)
            shape = [1] * out.dim()
            shape[d] = o
            w = (pos - lo).to(x.dtype).to(x.device).reshape(shape)
            out = (out.index_select(d, lo.to(x.device)) * (1 - w)
                   + out.index_select(d, hi.to(x.device)) * w)
        return out
    return _resize(x, dims, sizes,
                   _cubic_kernel if mode == "bicubic" else _linear_kernel)


def upsample(x, size=None, scale_factor=None, mode="nearest",
             align_corners=False, align_mode=0, data_format="NCHW",
             name=None):
    return interpolate(x, size, scale_factor, mode, align_corners,
                       align_mode, data_format)


def pixel_shuffle(x, upscale_factor, data_format="NCHW", name=None):
    r = upscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        a = x.reshape(N, C // (r * r), r, r, H, W).permute(0, 1, 4, 2, 5, 3)
        return a.reshape(N, C // (r * r), H * r, W * r)
    N, H, W, C = x.shape
    a = x.reshape(N, H, W, C // (r * r), r, r).permute(0, 1, 4, 2, 5, 3)
    return a.reshape(N, H * r, W * r, C // (r * r))


def pixel_unshuffle(x, downscale_factor, data_format="NCHW", name=None):
    r = downscale_factor
    if data_format == "NCHW":
        N, C, H, W = x.shape
        a = x.reshape(N, C, H // r, r, W // r, r).permute(0, 1, 3, 5, 2, 4)
        return a.reshape(N, C * r * r, H // r, W // r)
    N, H, W, C = x.shape
    a = x.reshape(N, H // r, r, W // r, r, C).permute(0, 2, 4, 5, 1, 3)
    return a.reshape(N, H // r, W // r, C * r * r)


def channel_shuffle(x, groups, data_format="NCHW", name=None):
    if data_format == "NCHW":
        N, C = x.shape[:2]
        rest = tuple(x.shape[2:])
        a = x.reshape((N, groups, C // groups) + rest).transpose(1, 2)
        return a.reshape((N, C) + rest)
    N, C = x.shape[0], x.shape[-1]
    mid = tuple(x.shape[1:-1])
    a = x.reshape((N,) + mid + (groups, C // groups)).transpose(-1, -2)
    return a.reshape((N,) + mid + (C,))


def pad(x, pad, mode="constant", value=0.0, data_format="NCHW", name=None):
    from ...tensor.manipulation import pad as _pad
    return _pad(x, pad, mode, value, data_format)


def cosine_similarity(x1, x2, axis=1, eps=1e-8, name=None):
    """``x1 . x2 / max(|x1| |x2|, eps)`` along ``axis``."""
    dot = (x1 * x2).sum(axis)
    n = torch.linalg.vector_norm(x1, dim=axis) * \
        torch.linalg.vector_norm(x2, dim=axis)
    return dot / torch.clamp(n, min=eps)


def bilinear(x1, x2, weight, bias=None, name=None):
    """``out[b, o] = x1[b] W[o] x2[b] (+ bias)``, weight (out, in1, in2)."""
    out = torch.einsum("bi,oij,bj->bo", x1, weight, x2)
    return out if bias is None else out + bias


def affine_grid(theta, out_shape, align_corners=True, name=None):
    """The (N, H, W, 2) sampling grid of the affine maps ``theta`` (N, 2,
    3) over an ``out_shape`` (N, C, H, W) output."""
    N, H, W = out_shape[0], out_shape[2], out_shape[3]
    kw = dict(dtype=theta.dtype, device=theta.device)
    if align_corners:
        xs, ys = torch.linspace(-1, 1, W, **kw), torch.linspace(-1, 1, H,
                                                                  **kw)
    else:
        xs = (torch.arange(W, **kw) * 2 + 1) / W - 1
        ys = (torch.arange(H, **kw) * 2 + 1) / H - 1
    gy, gx = torch.meshgrid(ys, xs, indexing="ij")
    base = torch.stack([gx, gy, torch.ones_like(gx)], -1)
    return torch.einsum("nij,hwj->nhwi", theta, base)


def grid_sample(x, grid, mode="bilinear", padding_mode="zeros",
                align_corners=True, name=None):
    """Sample ``x`` (N, C, H, W) at ``grid`` (N, Hg, Wg, 2) of (x, y) in
    [-1, 1]: bilinear (zeros outside with ``padding_mode="zeros"``, else
    the clamped border) or nearest (rounded half to even; zeros
    outside)."""
    N, C, H, W = x.shape
    gx, gy = grid[..., 0], grid[..., 1]
    if align_corners:
        fx, fy = (gx + 1) * (W - 1) / 2, (gy + 1) * (H - 1) / 2
    else:
        fx, fy = ((gx + 1) * W - 1) / 2, ((gy + 1) * H - 1) / 2
    bidx = torch.arange(N, device=x.device)[:, None, None]
    xl = x.movedim(1, -1)                                # N, H, W, C

    def at(yi, xi):
        return xl[bidx, yi.clamp(0, H - 1), xi.clamp(0, W - 1)]

    def inside(yi, xi):
        return ((yi >= 0) & (yi < H) & (xi >= 0) & (xi < W))[..., None]

    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    if mode == "nearest":
        yy = torch.round(fy).to(torch.int64)
        xx = torch.round(fx).to(torch.int64)
        return torch.where(inside(yy, xx), at(yy, xx), zero).movedim(-1, 1)
    x0 = torch.floor(fx).to(torch.int64)
    y0 = torch.floor(fy).to(torch.int64)
    wx, wy = fx - x0, fy - y0
    out = 0
    for yi, wyi in ((y0, 1 - wy), (y0 + 1, wy)):
        for xi, wxi in ((x0, 1 - wx), (x0 + 1, wx)):
            v = at(yi, xi)
            if padding_mode == "zeros":
                v = torch.where(inside(yi, xi), v, zero)
            out = out + v * (wyi * wxi)[..., None].to(x.dtype)
    return out.movedim(-1, 1)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    from .conv import unfold as _unfold
    return _unfold(x, kernel_sizes, strides, paddings, dilations)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    from .conv import fold as _fold
    return _fold(x, output_sizes, kernel_sizes, strides, paddings, dilations)


__all__ = ["linear", "dropout", "dropout2d", "dropout3d", "alpha_dropout",
           "embedding", "one_hot", "label_smooth", "interpolate", "upsample",
           "pixel_shuffle", "pixel_unshuffle", "channel_shuffle", "pad",
           "cosine_similarity", "bilinear", "affine_grid", "grid_sample",
           "unfold", "fold"]

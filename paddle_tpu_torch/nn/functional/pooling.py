"""Pooling functionals (counterpart of
``paddle_tpu/nn/functional/pooling.py``): max and average pooling with
paddle's padding forms, ``ceil_mode`` and ``exclusive``, and adaptive
average and max pooling, in both data formats.

The reference reduces windows over explicitly padded inputs
(``lax.reduce_window``); here the pads are resolved the same way
(:func:`_resolve_pads`) and the window runs through torch's pooling.  A
symmetric pad of at most half the window goes to torch's own ``padding``
(no window is all pad then, so the result is the same); any other pad is
applied first, with -inf for max and 0 for sums.  ``return_mask`` gives
each maximum's index within the flattened spatial dims of the unpadded
input, the reference's contract (torch's own indices, mapped back from a
padded input where the pad was applied first).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .conv import (_padding, _string_pads, _tuplize, channels_first,
                   channels_last, pad_spatial)

_MAX = {1: F.max_pool1d, 2: F.max_pool2d, 3: F.max_pool3d}
_ADAPTIVE_AVG = {1: F.adaptive_avg_pool1d, 2: F.adaptive_avg_pool2d,
                 3: F.adaptive_avg_pool3d}
_ADAPTIVE_MAX = {1: F.adaptive_max_pool1d, 2: F.adaptive_max_pool2d,
                 3: F.adaptive_max_pool3d}


def _resolve_pads(sizes, k, s, pad, ceil_mode):
    """Paddle's padding and ``ceil_mode`` -> explicit [(lo, hi)] a spatial
    dim: ``ceil_mode`` pads the high side until the last window fits (a
    string padding ignores it, as in the reference)."""
    if isinstance(pad, str):
        return _string_pads(pad, sizes, k, s)
    pads = [tuple(p) for p in pad]
    if ceil_mode:
        for i, size in enumerate(sizes):
            rem = (size + pads[i][0] + pads[i][1] - k[i]) % s[i]
            if rem != 0:
                pads[i] = (pads[i][0], pads[i][1] + (s[i] - rem))
    return pads


def _torch_pad(pads, k):
    """The pad torch's pooling can take itself, or None."""
    if all(lo == hi and 0 <= lo <= kk // 2 for (lo, hi), kk in zip(pads, k)):
        return tuple(lo for lo, _ in pads)
    return None


def _window_sum(a, k, s):
    """Sums over the windows of ``a`` (N, C, *spatial), no padding."""
    n = len(k)
    if n == 1:
        return _window_sum(a.unsqueeze(-2), (1,) + k, (1,) + s).squeeze(-2)
    pool = F.avg_pool2d if n == 2 else F.avg_pool3d
    return pool(a, k, s, 0, divisor_override=1)


def _setup(x, kernel, stride, padding, n, data_format, ceil_mode):
    k = _tuplize(kernel, n)
    s = _tuplize(stride if stride is not None else kernel, n)
    a = channels_first(x, n, data_format)
    pads = _resolve_pads(a.shape[2:], k, s, _padding(padding, n, data_format),
                         ceil_mode)
    return a, k, s, pads


def _unpadded_index(idx, sizes, pads):
    """Flat indices into the padded spatial dims as indices into the
    unpadded ones (``sizes``)."""
    flat = torch.zeros_like(idx)
    rest = idx
    scale = 1
    for size, (lo, hi) in reversed(list(zip(sizes, pads))):
        full = size + lo + hi
        flat = flat + (rest % full - lo) * scale
        rest = rest // full
        scale *= size
    return flat


def _max_pool(x, kernel, stride, padding, return_mask, ceil_mode,
              data_format, n):
    a, k, s, pads = _setup(x, kernel, stride, padding, n, data_format,
                           ceil_mode)
    tp = _torch_pad(pads, k)
    src = a
    if tp is None:
        src, tp = pad_spatial(a, pads, value=-math.inf), 0
    if not return_mask:
        return channels_last(_MAX[n](src, k, s, tp), n, data_format)
    out, idx = _MAX[n](src, k, s, tp, return_indices=True)
    if src is not a:
        idx = _unpadded_index(idx, a.shape[2:], pads)
    return (channels_last(out, n, data_format),
            channels_last(idx, n, data_format))


def _avg_pool(x, kernel, stride, padding, ceil_mode, exclusive, data_format,
              n):
    """Window sums over the zero-padded input, divided by the window's
    real (``exclusive``) or full element count."""
    a, k, s, pads = _setup(x, kernel, stride, padding, n, data_format,
                           ceil_mode)
    padded = any(lo or hi for lo, hi in pads)
    summed = _window_sum(pad_spatial(a, pads) if padded else a, k, s)
    if exclusive and padded:
        ones = torch.ones((1, 1) + tuple(a.shape[2:]), dtype=a.dtype,
                          device=a.device)
        out = summed / _window_sum(pad_spatial(ones, pads), k, s)
    else:
        out = summed / math.prod(k)
    return channels_last(out, n, data_format)


def max_pool1d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCL", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 1)


def max_pool2d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 2)


def max_pool3d(x, kernel_size, stride=None, padding=0, return_mask=False,
               ceil_mode=False, data_format="NCDHW", name=None):
    return _max_pool(x, kernel_size, stride, padding, return_mask, ceil_mode,
                     data_format, 3)


def avg_pool1d(x, kernel_size, stride=None, padding=0, exclusive=True,
               ceil_mode=False, data_format="NCL", name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     data_format, 1)


def avg_pool2d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     data_format, 2)


def avg_pool3d(x, kernel_size, stride=None, padding=0, ceil_mode=False,
               exclusive=True, divisor_override=None, data_format="NCDHW",
               name=None):
    return _avg_pool(x, kernel_size, stride, padding, ceil_mode, exclusive,
                     data_format, 3)


def _adaptive_avg_pool(x, output_size, n, data_format):
    """Bin i of a dim of size ``in`` spans [floor(i*in/out),
    ceil((i+1)*in/out)), the reference's ``_adaptive_axes`` and torch's
    adaptive pooling alike."""
    outs = _tuplize(output_size, n)
    a = channels_first(x, n, data_format)
    return channels_last(_ADAPTIVE_AVG[n](a, outs if n > 1 else outs[0]), n,
                         data_format)


def adaptive_avg_pool1d(x, output_size, name=None):
    return _adaptive_avg_pool(x, output_size, 1, "NCL")


def adaptive_avg_pool2d(x, output_size, data_format="NCHW", name=None):
    return _adaptive_avg_pool(x, output_size, 2, data_format)


def adaptive_avg_pool3d(x, output_size, data_format="NCDHW", name=None):
    return _adaptive_avg_pool(x, output_size, 3, data_format)


def _adaptive_max_pool(x, output_size, n, return_mask):
    """Channels-first only, as in the reference; with ``return_mask`` the
    index of each bin's maximum within the input's flattened spatial
    dims."""
    outs = _tuplize(output_size, n)
    return _ADAPTIVE_MAX[n](x, outs if n > 1 else outs[0],
                            return_indices=return_mask)


def adaptive_max_pool1d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 1, return_mask)


def adaptive_max_pool2d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 2, return_mask)


def adaptive_max_pool3d(x, output_size, return_mask=False, name=None):
    return _adaptive_max_pool(x, output_size, 3, return_mask)


__all__ = ["max_pool1d", "max_pool2d", "max_pool3d", "avg_pool1d",
           "avg_pool2d", "avg_pool3d", "adaptive_avg_pool1d",
           "adaptive_avg_pool2d", "adaptive_avg_pool3d",
           "adaptive_max_pool1d", "adaptive_max_pool2d",
           "adaptive_max_pool3d"]

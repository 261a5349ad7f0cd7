"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``: ``conv1d``/``conv2d``/``conv3d``).

The reference lowers every conv to ``lax.conv_general_dilated``; here it
is ``torch.nn.functional.conv{n}d`` (cuDNN on the card).  The weight is
OIHW-style (out, in/groups, *k) in both data formats.  A channels-last
input (NLC, NHWC, NDHWC) is viewed channels-first with ``permute`` (no
copy), so cuDNN gets the channels-last tensor as it is, and the output is
viewed back the same way.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

_CONV = {1: F.conv1d, 2: F.conv2d, 3: F.conv3d}


def _tuplize(v, n):
    if isinstance(v, (list, tuple)):
        if len(v) == n:
            return tuple(int(x) for x in v)
        if len(v) == 1:
            return tuple(int(v[0]) for _ in range(n))
        return tuple(int(x) for x in v)
    return tuple(int(v) for _ in range(n))


def _padding(padding, n, data_format):
    """Paddle's padding forms -> ``[(lo, hi)] * n`` or ``"SAME"``/``"VALID"``:
    an int, one int a spatial dim, ``[lo0, hi0, lo1, hi1, ...]``, and
    ``[lo, hi]`` pairs (those of the batch and channel dims included)."""
    if isinstance(padding, str):
        return padding.upper()
    if isinstance(padding, int):
        return [(padding, padding)] * n
    padding = list(padding)
    if all(isinstance(p, (list, tuple)) for p in padding):
        if len(padding) == n + 2:
            spatial = padding[2:] if data_format[1] == "C" else padding[1:-1]
            return [tuple(p) for p in spatial]
        return [tuple(p) for p in padding]
    if len(padding) == n:
        return [(int(p), int(p)) for p in padding]
    if len(padding) == 2 * n:
        return [(int(padding[2 * i]), int(padding[2 * i + 1]))
                for i in range(n)]
    raise ValueError(f"bad padding {padding}")


def _string_pads(mode, sizes, window, stride):
    """``lax.padtype_to_pads``: SAME gives ceil(in / stride) outputs with
    the total pad split lo = total // 2; VALID pads nothing."""
    if mode == "VALID":
        return [(0, 0)] * len(sizes)
    if mode != "SAME":
        raise ValueError(f"unknown padding {mode!r}")
    pads = []
    for i, k, s in zip(sizes, window, stride):
        total = max((-(-i // s) - 1) * s + k - i, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def channels_first(x, n, data_format):
    """``x`` as an (N, C, *spatial) view: a permuted view of a
    channels-last tensor."""
    if data_format[1] == "C":
        return x
    return x.permute(0, n + 1, *range(1, n + 1))


def channels_last(x, n, data_format):
    """The inverse of :func:`channels_first`."""
    if data_format[1] == "C":
        return x
    return x.permute(0, *range(2, n + 2), 1)


def pad_spatial(x, pads, value=0.0):
    """``x`` (N, C, *spatial) with ``pads`` [(lo, hi)] a spatial dim."""
    flat = []
    for lo, hi in reversed(pads):
        flat += [int(lo), int(hi)]
    return F.pad(x, flat, value=value)


def _compute_dtypes(a, w):
    """The reference's rule: a 2-byte float against a 4-byte one runs in
    the 2-byte dtype (bf16 activations x fp32 weights -> a bf16 conv); any
    other float mismatch promotes (fp16 against bf16 too)."""
    if a.dtype == w.dtype or not (a.dtype.is_floating_point
                                  and w.dtype.is_floating_point):
        return a, w
    sa, sw = a.dtype.itemsize, w.dtype.itemsize
    if min(sa, sw) == 2 and sa != sw:
        dt = a.dtype if sa < sw else w.dtype
    else:
        dt = torch.promote_types(a.dtype, w.dtype)
    return a.to(dt), w.to(dt)


def _conv(x, weight, bias, stride, padding, dilation, groups, data_format, n):
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    pad = _padding(padding, n, data_format)
    x, weight = _compute_dtypes(x, weight)
    a = channels_first(x, n, data_format)
    if isinstance(pad, str):
        window = [(k - 1) * d + 1 for k, d in zip(weight.shape[2:], dilation)]
        pad = _string_pads(pad, a.shape[2:], window, stride)
    if all(lo == hi and lo >= 0 for lo, hi in pad):
        torch_pad = tuple(lo for lo, _ in pad)
    else:
        a, torch_pad = pad_spatial(a, pad), 0
    out = _CONV[n](a, weight, None, stride, torch_pad, dilation, groups)
    if bias is not None:
        out = out + bias.to(out.dtype).reshape((1, -1) + (1,) * n)
    return channels_last(out, n, data_format)


def conv1d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCL", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 1)


def conv2d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 2)


def conv3d(x, weight, bias=None, stride=1, padding=0, dilation=1, groups=1,
           data_format="NCDHW", name=None):
    return _conv(x, weight, bias, stride, padding, dilation, groups,
                 data_format, 3)


__all__ = ["conv1d", "conv2d", "conv3d"]

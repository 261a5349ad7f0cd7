"""Convolution functionals (counterpart of
``paddle_tpu/nn/functional/conv.py``: ``conv1d``/``conv2d``/``conv3d``,
their transposes, ``unfold`` and ``fold``).

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
_CONV_T = {1: F.conv_transpose1d, 2: F.conv_transpose2d,
           3: F.conv_transpose3d}


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


def _conv_transpose(x, weight, bias, stride, padding, output_padding,
                    dilation, groups, data_format, n):
    """The reference's transposed conv (an input dilated by the stride,
    convolved with the flipped (in, out/groups, *k) weight over the pads
    ``(K - 1 - lo, K - 1 - hi + output_padding)``, K the dilated kernel;
    a string padding names those pads directly and takes no output
    padding): torch's unpadded transpose, then each spatial dim cut to
    ``[lo, (in - 1) * stride + K - hi + output_padding)`` (zeros past its
    end, where no input reaches).  The reference reads no
    ``output_size``, and neither does this."""
    stride = _tuplize(stride, n)
    dilation = _tuplize(dilation, n)
    opad = _tuplize(output_padding, n)
    pad = _padding(padding, n, data_format)
    k = [(kk - 1) * d + 1 for kk, d in zip(weight.shape[2:], dilation)]
    if isinstance(pad, str):
        eff = ([((kk - 1) // 2, kk - 1 - (kk - 1) // 2) for kk in k]
               if pad == "SAME" else [(kk - 1, kk - 1) for kk in k])
        pad = [(kk - 1 - lo, kk - 1 - hi) for kk, (lo, hi) in zip(k, eff)]
        opad = (0,) * n
    a = channels_first(x, n, data_format)
    out = _CONV_T[n](a, weight, None, stride, 0, 0, groups, dilation)
    for i, ((lo, hi), op) in enumerate(zip(pad, opad)):
        end = out.shape[2 + i] - hi + op
        if end > out.shape[2 + i]:
            extra = [0, 0] * n
            extra[2 * (n - 1 - i) + 1] = end - out.shape[2 + i]
            out = F.pad(out, extra)
        out = out.narrow(2 + i, lo, end - lo)
    if bias is not None:
        out = out + bias.reshape((1, -1) + (1,) * n)
    return channels_last(out, n, data_format)


def conv1d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCL", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 1)


def conv2d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 2)


def conv3d_transpose(x, weight, bias=None, stride=1, padding=0,
                     output_padding=0, groups=1, dilation=1,
                     output_size=None, data_format="NCDHW", name=None):
    return _conv_transpose(x, weight, bias, stride, padding, output_padding,
                           dilation, groups, data_format, 3)


def unfold(x, kernel_sizes, strides=1, paddings=0, dilations=1, name=None):
    """im2col of an NCHW input: (N, C * kh * kw, L), channel-major."""
    k, s, d = (_tuplize(v, 2) for v in (kernel_sizes, strides, dilations))
    a = pad_spatial(x, _padding(paddings, 2, "NCHW"))
    return F.unfold(a, k, d, 0, s)


def fold(x, output_sizes, kernel_sizes, strides=1, paddings=0, dilations=1,
         name=None):
    """col2im, :func:`unfold`'s transpose: the (N, C * kh * kw, L) columns
    summed into the padded (N, C, H, W) map, then the pads cut off."""
    k, s, d = (_tuplize(v, 2) for v in (kernel_sizes, strides, dilations))
    (t, b), (left, r) = _padding(paddings, 2, "NCHW")
    oh, ow = _tuplize(output_sizes, 2)
    out = F.fold(x, (oh + t + b, ow + left + r), k, d, 0, s)
    return out[:, :, t:t + oh, left:left + ow]


__all__ = ["conv1d", "conv2d", "conv3d", "conv1d_transpose",
           "conv2d_transpose", "conv3d_transpose", "unfold", "fold"]

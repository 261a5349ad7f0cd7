"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each initializer is a callable ``(shape, dtype, generator=None) -> Tensor``
that draws from ``generator`` (a ``torch.Generator``; the tensor lands on
its device) or, without one, from torch's default generator on the
default device.  The laws and the fan rules are the reference's; the
draws are torch's, so a port model is loaded from the reference's numpy
state (``vision.models.params_from_numpy``) where values must match.
"""

from __future__ import annotations

import math

import numpy as np
import torch

_HALF = (torch.bfloat16, torch.float16)


def _fan(shape):
    shape = tuple(int(s) for s in shape)
    if len(shape) == 0:
        return 1, 1
    if len(shape) == 1:
        return shape[0], shape[0]
    if len(shape) == 2:
        return shape[0], shape[1]
    receptive = int(np.prod(shape[2:]))
    return shape[1] * receptive, shape[0] * receptive


def to_dtype(dtype) -> torch.dtype:
    """A torch dtype from a torch dtype or a name (``"float32"``): the
    table of ``core.dtype``."""
    from ...core.dtype import convert_dtype
    return convert_dtype(dtype)


def _empty(shape, dtype, generator):
    """An uninitialised tensor to sample into: 16-bit floats sample in
    fp32, as the reference does."""
    dt = to_dtype(dtype)
    return torch.empty(tuple(int(s) for s in shape),
                       dtype=torch.float32 if dt in _HALF else dt,
                       device=None if generator is None else generator.device)


class Initializer:
    def __call__(self, shape, dtype, generator=None):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype, generator=None):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=to_dtype(dtype),
                          device=None if generator is None
                          else generator.device)


class Normal(Initializer):
    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None):
        out = _empty(shape, dtype, generator).normal_(self.mean, self.std,
                                                      generator=generator)
        return out.to(to_dtype(dtype))


class TruncatedNormal(Initializer):
    """``mean + std * z`` with z a standard normal truncated to [-2, 2]."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype, generator=None):
        z = _empty(shape, dtype, generator)
        lo, hi = (0.5 * (1 + math.erf(b / math.sqrt(2))) for b in (-2.0, 2.0))
        z.uniform_(2 * lo - 1, 2 * hi - 1, generator=generator)
        z = torch.erfinv(z).mul_(math.sqrt(2.0)).clamp_(-2.0, 2.0)
        return (self.mean + self.std * z).to(to_dtype(dtype))


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype, generator=None):
        out = _empty(shape, dtype, generator).uniform_(self.low, self.high,
                                                       generator=generator)
        return out.to(to_dtype(dtype))


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, generator=None):
        fi, fo = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype, generator)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype, generator=None):
        fi, fo = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype, generator)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, generator=None):
        fi, _ = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype, generator)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype, generator=None):
        fi, _ = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype, generator)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype, generator=None):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.detach().to(
            device=None if generator is None else generator.device,
            dtype=to_dtype(dtype)).reshape(tuple(int(s) for s in shape))


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR of a standard-normal (max(r, c),
    min(r, c)) fp32 draw, signed by R's diagonal (transposed when r < c),
    reshaped to ``shape`` (r = shape[0], c = the rest)."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype, generator=None):
        shape = tuple(int(s) for s in shape)
        rows, cols = shape[0], int(np.prod(shape[1:]))
        flat = _empty((max(rows, cols), min(rows, cols)), torch.float32,
                      generator).normal_(generator=generator)
        q, r = torch.linalg.qr(flat)
        q = q * torch.sign(torch.diagonal(r))
        q = q.T if rows < cols else q
        return (self.gain * q[:rows, :cols]).reshape(shape).to(
            to_dtype(dtype))


class Dirac(Initializer):
    """A conv weight (out, in, *k) that passes channel i of each of
    ``groups`` groups through: 1 at the kernel's centre, 0 elsewhere."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype, generator=None):
        shape = tuple(int(s) for s in shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i) + centers] = 1.0
        return torch.as_tensor(out, dtype=to_dtype(dtype),
                               device=None if generator is None
                               else generator.device)


class Bilinear(Initializer):
    """The bilinear up-sampling kernel of a 4-D transposed-conv weight,
    for every (out, in) channel pair, its factor taken from ``shape[3]``
    for both axes, as the reference takes it."""

    def __call__(self, shape, dtype, generator=None):
        shape = tuple(int(s) for s in shape)
        if len(shape) != 4:
            raise ValueError(f"Bilinear expects a 4-D conv weight, got "
                             f"{shape}")
        f = int(np.ceil(shape[3] / 2.0))
        c = (2 * f - 1 - f % 2) / (2.0 * f)
        og = np.ogrid[:shape[2], :shape[3]]
        filt = (1 - abs(og[0] / f - c)) * (1 - abs(og[1] / f - c))
        out = np.ascontiguousarray(np.broadcast_to(
            filt.astype(np.float32), shape))
        return torch.as_tensor(out, dtype=to_dtype(dtype),
                               device=None if generator is None
                               else generator.device)


def calculate_gain(nonlinearity: str, param=None) -> float:
    """The recommended gain of ``nonlinearity`` (the reference's table)."""
    if nonlinearity in ("sigmoid", "linear", "conv1d", "conv2d", "conv3d"):
        return 1.0
    if nonlinearity == "tanh":
        return 5.0 / 3
    if nonlinearity == "relu":
        return math.sqrt(2.0)
    if nonlinearity == "leaky_relu":
        a = 0.01 if param is None else param
        return math.sqrt(2.0 / (1 + a ** 2))
    if nonlinearity == "selu":
        return 3.0 / 4
    raise ValueError(f"unknown nonlinearity {nonlinearity}")


_global_initializer = None


def set_global_initializer(weight_init, bias_init=None):
    """Set process-wide default initializers (reference
    ``set_global_initializer``): ``Layer.create_parameter`` takes them
    when no attr gives an initializer; pass None to reset."""
    global _global_initializer
    _global_initializer = (weight_init, bias_init)


def get_global_initializer():
    return _global_initializer


__all__ = ["Initializer", "Constant", "Normal", "TruncatedNormal", "Uniform",
           "XavierNormal", "XavierUniform", "KaimingNormal", "KaimingUniform",
           "Assign", "Orthogonal", "Dirac", "Bilinear", "calculate_gain",
           "set_global_initializer", "get_global_initializer"]

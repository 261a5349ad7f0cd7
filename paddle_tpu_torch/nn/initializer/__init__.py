"""Parameter initializers (counterpart of ``paddle_tpu/nn/initializer``).

Each initializer is a callable ``(shape, dtype) -> Tensor`` on the
``nn.building`` scope's device (else ``cuda``, raising without a card).
A drawing one takes one key, ``core.rng.next_key()``, and computes the
reference's ``jax.random`` law on it (16-bit dtypes draw in fp32, then
cast), so a model built after ``seed(s)`` holds the reference's initial
weights: bit for bit for the uniform laws, within a few ulp for the
normal ones (``core.rng.erf_inv``).  ``Constant``, ``Assign``, ``Dirac``
and ``Bilinear`` draw nothing.  On the ``meta`` device nothing is drawn
and no key is taken, so a build there leaves the stream where it was.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ...core import rng

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


def _device():
    from ..layer.base import build_device
    return build_device()


def _draw(law, shape, dtype):
    """``law(key, shape, sample dtype, device)`` cast to ``dtype``: 16-bit
    floats sample in fp32, as the reference does; on ``meta`` an empty
    tensor, taking no key."""
    shape, dt, dev = tuple(int(s) for s in shape), to_dtype(dtype), _device()
    if dev.type == "meta":
        return torch.empty(shape, dtype=dt, device=dev)
    sample = torch.float32 if dt in _HALF else dt
    return law(rng.next_key(), shape, sample, dev).to(dt)


class Initializer:
    def __call__(self, shape, dtype):
        raise NotImplementedError


class Constant(Initializer):
    def __init__(self, value: float = 0.0):
        self.value = value

    def __call__(self, shape, dtype):
        return torch.full(tuple(int(s) for s in shape), self.value,
                          dtype=to_dtype(dtype), device=_device())


class Normal(Initializer):
    """``mean + std * z``, z ``jax.random.normal``'s draw."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _draw(lambda k, s, dt, dev: self.mean + self.std * rng.normal(
            k, s, dt, dev), shape, dtype)


class TruncatedNormal(Initializer):
    """``mean + std * z``, z ``jax.random.truncated_normal``'s draw on
    (-2, 2)."""

    def __init__(self, mean: float = 0.0, std: float = 1.0):
        self.mean, self.std = mean, std

    def __call__(self, shape, dtype):
        return _draw(lambda k, s, dt, dev: self.mean + self.std *
                     rng.truncated_normal(k, -2.0, 2.0, s, dt, dev),
                     shape, dtype)


class Uniform(Initializer):
    def __init__(self, low: float = -1.0, high: float = 1.0):
        self.low, self.high = low, high

    def __call__(self, shape, dtype):
        return _draw(lambda k, s, dt, dev: rng.uniform(
            k, s, dt, self.low, self.high, dev), shape, dtype)


class XavierNormal(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        std = self.gain * math.sqrt(2.0 / (fi + fo))
        return Normal(0.0, std)(shape, dtype)


class XavierUniform(Initializer):
    def __init__(self, fan_in=None, fan_out=None, gain: float = 1.0):
        self._fan_in, self._fan_out, self.gain = fan_in, fan_out, gain

    def __call__(self, shape, dtype):
        fi, fo = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        fo = self._fan_out if self._fan_out is not None else fo
        limit = self.gain * math.sqrt(6.0 / (fi + fo))
        return Uniform(-limit, limit)(shape, dtype)


def _kaiming_gain(negative_slope, nonlinearity):
    if nonlinearity == "leaky_relu":
        return math.sqrt(2.0 / (1 + negative_slope ** 2))
    return math.sqrt(2.0)


class KaimingNormal(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        std = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            / math.sqrt(fi)
        return Normal(0.0, std)(shape, dtype)


class KaimingUniform(Initializer):
    def __init__(self, fan_in=None, negative_slope: float = 0.0,
                 nonlinearity: str = "relu"):
        self._fan_in, self.negative_slope = fan_in, negative_slope
        self.nonlinearity = nonlinearity

    def __call__(self, shape, dtype):
        fi, _ = _fan(shape)
        fi = self._fan_in if self._fan_in is not None else fi
        limit = _kaiming_gain(self.negative_slope, self.nonlinearity) \
            * math.sqrt(3.0 / fi)
        return Uniform(-limit, limit)(shape, dtype)


class Assign(Initializer):
    def __init__(self, value):
        self.value = value

    def __call__(self, shape, dtype):
        v = self.value
        if not isinstance(v, torch.Tensor):
            v = torch.from_numpy(np.array(v))
        return v.detach().to(device=_device(), dtype=to_dtype(dtype)).reshape(
            tuple(int(s) for s in shape))


class Orthogonal(Initializer):
    """``gain`` times the Q of a QR of a standard-normal (max(r, c),
    min(r, c)) fp32 draw, signed by R's diagonal (transposed when r < c),
    reshaped to ``shape`` (r = shape[0], c = the rest)."""

    def __init__(self, gain: float = 1.0):
        self.gain = gain

    def __call__(self, shape, dtype):
        shape = tuple(int(s) for s in shape)
        rows, cols = shape[0], int(np.prod(shape[1:]))

        def law(key, _, __, dev):
            flat = rng.normal(key, (max(rows, cols), min(rows, cols)),
                              torch.float32, dev)
            q, r = torch.linalg.qr(flat)
            q = q * torch.sign(torch.diagonal(r))
            q = q.T if rows < cols else q
            return (self.gain * q[:rows, :cols]).reshape(shape)
        out = _draw(law, shape, torch.float32)
        return out.to(to_dtype(dtype))


class Dirac(Initializer):
    """A conv weight (out, in, *k) that passes channel i of each of
    ``groups`` groups through: 1 at the kernel's centre, 0 elsewhere."""

    def __init__(self, groups: int = 1):
        self.groups = groups

    def __call__(self, shape, dtype):
        shape = tuple(int(s) for s in shape)
        out = np.zeros(shape, np.float32)
        oc, ic = shape[0], shape[1]
        centers = tuple(s // 2 for s in shape[2:])
        for g in range(self.groups):
            for i in range(min(oc // self.groups, ic)):
                out[(g * (oc // self.groups) + i, i) + centers] = 1.0
        return torch.as_tensor(out, dtype=to_dtype(dtype), device=_device())


class Bilinear(Initializer):
    """The bilinear up-sampling kernel of a 4-D transposed-conv weight,
    for every (out, in) channel pair, its factor taken from ``shape[3]``
    for both axes, as the reference takes it."""

    def __call__(self, shape, dtype):
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
        return torch.as_tensor(out, dtype=to_dtype(dtype), device=_device())


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

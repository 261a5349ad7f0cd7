"""Activation functionals (counterpart of
``paddle_tpu/nn/functional/activation.py``), each the reference's formula
in PyTorch ops.  The ``_`` forms write into their input and return it, as
the reference's adopt theirs (``elu_`` and ``tanh_`` are ``extras``').
``rrelu`` in training and ``gumbel_softmax`` take one key,
``core.rng.next_key()``, and draw the reference's uniform and gumbel
laws on it."""

from __future__ import annotations

import torch

from ...core import rng
from ...core.dtype import convert_dtype


def _s(v, x):
    """``v`` as a 0-d tensor of ``x``'s dtype on its device."""
    return torch.full((), v, dtype=x.dtype, device=x.device)


def relu(x, name=None):
    return torch.relu(x)


def relu_(x, name=None):
    return torch.relu_(x)


def relu6(x, name=None):
    return torch.clamp(x, 0.0, 6.0)


def elu(x, alpha=1.0, name=None):
    """``x`` where positive, else ``alpha * expm1(x)``."""
    return torch.where(x > 0, x, _s(alpha, x) * torch.expm1(x))


def selu(x, scale=1.0507009873554805, alpha=1.6732632423543772, name=None):
    return _s(scale, x) * torch.where(x > 0, x,
                                      _s(alpha, x) * torch.expm1(x))


def celu(x, alpha=1.0, name=None):
    """``max(x, 0) + min(0, alpha * expm1(x / alpha))``."""
    return torch.where(x > 0, x,
                       _s(alpha, x) * torch.expm1(x / _s(alpha, x)))


def gelu(x, approximate=False, name=None):
    """Exact (erf) or the tanh approximation."""
    return torch.nn.functional.gelu(
        x, approximate="tanh" if approximate else "none")


def sigmoid(x, name=None):
    return torch.sigmoid(x)


def hardsigmoid(x, slope=0.1666667, offset=0.5, name=None):
    return torch.clamp(_s(slope, x) * x + _s(offset, x), 0.0, 1.0)


def hardswish(x, name=None):
    return x * torch.clamp(x + 3.0, 0.0, 6.0) / 6.0


def hardtanh(x, min=-1.0, max=1.0, name=None):
    return torch.clamp(x, min, max)


def hardshrink(x, threshold=0.5, name=None):
    return torch.where(x.abs() > threshold, x, _s(0.0, x))


def softshrink(x, threshold=0.5, name=None):
    t = _s(threshold, x)
    return torch.where(x > t, x - t, torch.where(x < -t, x + t, _s(0.0, x)))


def tanhshrink(x, name=None):
    return x - torch.tanh(x)


def leaky_relu(x, negative_slope=0.01, name=None):
    return torch.where(x >= 0, x, _s(negative_slope, x) * x)


def prelu(x, weight, data_format="NCHW", name=None):
    """``x`` where positive, else ``weight * x``: one weight, or one per
    channel (axis 1 for ``NC*``, the last axis otherwise)."""
    if weight.numel() == 1:
        return torch.where(x > 0, x, weight.reshape(()) * x)
    shape = [1] * x.dim()
    shape[1 if data_format[1] == "C" else x.dim() - 1] = weight.numel()
    return torch.where(x > 0, x, weight.reshape(shape) * x)


def rrelu(x, lower=0.125, upper=0.3333333, training=False, name=None):
    """``x`` where non-negative, else ``x`` times a slope: in training a
    uniform draw on [lower, upper) of ``x``'s dtype an element, else the
    mean slope."""
    if training:
        slope = rng.uniform(rng.next_key(), x.shape, x.dtype, lower, upper,
                            x.device)
        return torch.where(x >= 0, x, x * slope)
    return torch.where(x >= 0, x, x * _s((lower + upper) / 2.0, x))


def log_sigmoid(x, name=None):
    return torch.nn.functional.logsigmoid(x)


def maxout(x, groups, axis=1, name=None):
    """Max over ``groups`` consecutive channels: block i is channels
    [i * groups, (i + 1) * groups)."""
    ax = axis % x.dim()
    c = x.shape[ax]
    shape = tuple(x.shape[:ax]) + (c // groups, groups) + tuple(
        x.shape[ax + 1:])
    return x.reshape(shape).amax(ax + 1)


def silu(x, name=None):
    """``x * sigmoid(x)``."""
    return torch.nn.functional.silu(x)


swish = silu


def _softplus(x):
    """``log1p(exp(-|x|)) + max(x, 0)``: ``jax.nn.softplus``."""
    return torch.log1p(torch.exp(-x.abs())) + torch.relu(x)


def mish(x, name=None):
    return x * torch.tanh(_softplus(x))


def softplus(x, beta=1.0, threshold=20.0, name=None):
    """``softplus(beta * x) / beta``, linear where ``beta * x`` passes
    ``threshold``."""
    bx = x * _s(beta, x)
    return torch.where(bx > threshold, x, _softplus(bx) / _s(beta, x))


def softsign(x, name=None):
    return x / (x.abs() + 1)


def tanh(x, name=None):
    return torch.tanh(x)


def thresholded_relu(x, threshold=1.0, value=0.0, name=None):
    return torch.where(x > threshold, x, _s(value, x))


def softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.softmax(x, dim=axis)


def softmax_(x, axis=-1, dtype=None, name=None):
    """``softmax`` written into ``x`` (autograd sees the copy; the
    softmax keeps its own output for its backward)."""
    return x.copy_(softmax(x, axis, dtype))


def log_softmax(x, axis=-1, dtype=None, name=None):
    if dtype is not None:
        x = x.to(convert_dtype(dtype))
    return torch.log_softmax(x, dim=axis)


def gumbel_softmax(x, temperature=1.0, hard=False, axis=-1, name=None):
    """The softmax over ``axis`` of ``(x + g) / temperature``, g a gumbel
    draw of ``x``'s shape and dtype; ``hard``: the one-hot of its argmax
    in the forward, the soft gradient in the backward."""
    g = rng.gumbel(rng.next_key(), x.shape, x.dtype, x.device)
    z = (x + g) / temperature
    e = torch.exp(z - z.amax(dim=axis, keepdim=True).detach())
    y = e / e.sum(dim=axis, keepdim=True)
    if not hard:
        return y
    idx = torch.argmax(y, dim=axis, keepdim=True)
    y_hard = torch.zeros_like(y).scatter_(axis, idx, 1.0)
    return y_hard - y.detach() + y


def glu(x, axis=-1, name=None):
    """The first half of ``x`` along ``axis`` gated by the sigmoid of the
    second."""
    a, b = torch.chunk(x, 2, dim=axis)
    return a * torch.sigmoid(b)


__all__ = ["celu", "elu", "gelu", "glu", "gumbel_softmax",
           "hardshrink", "hardsigmoid", "hardswish", "hardtanh", "leaky_relu",
           "log_sigmoid", "log_softmax", "maxout", "mish", "prelu", "relu",
           "relu6", "relu_", "rrelu", "selu", "sigmoid", "silu", "softmax",
           "softmax_", "softplus", "softshrink", "softsign", "swish", "tanh",
           "tanhshrink", "thresholded_relu"]

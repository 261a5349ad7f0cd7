"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
the ``_simple`` family over ``nn.functional`` and ``PReLU``.  ``RReLU``
calls ``rrelu`` in eval form (the reference's layer passes no
``training``), so it draws nothing."""

from __future__ import annotations

from .. import functional as F
from ..initializer import Constant
from .base import Layer


def _simple(name, fn_name=None, **defaults):
    fn = getattr(F, fn_name or name.lower())

    class _Act(Layer):
        def __init__(self, *args, **kwargs):
            super().__init__()
            merged = dict(defaults)
            keys = list(defaults.keys())
            for i, a in enumerate(args):
                merged[keys[i]] = a
            merged.update({k: v for k, v in kwargs.items() if k != "name"})
            self._kwargs = merged

        def forward(self, x):
            return fn(x, **self._kwargs)

    _Act.__name__ = _Act.__qualname__ = name
    return _Act


CELU = _simple("CELU", "celu", alpha=1.0)
ELU = _simple("ELU", "elu", alpha=1.0)
GELU = _simple("GELU", "gelu", approximate=False)
Hardshrink = _simple("Hardshrink", "hardshrink", threshold=0.5)
Hardswish = _simple("Hardswish", "hardswish")
Hardtanh = _simple("Hardtanh", "hardtanh", min=-1.0, max=1.0)
Hardsigmoid = _simple("Hardsigmoid", "hardsigmoid")
LeakyReLU = _simple("LeakyReLU", "leaky_relu", negative_slope=0.01)
LogSigmoid = _simple("LogSigmoid", "log_sigmoid")
Maxout = _simple("Maxout", "maxout", groups=2, axis=1)
Mish = _simple("Mish", "mish")
ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
SELU = _simple("SELU", "selu")
Sigmoid = _simple("Sigmoid", "sigmoid")
Silu = _simple("Silu", "silu")
Softplus = _simple("Softplus", "softplus", beta=1.0, threshold=20.0)
Softshrink = _simple("Softshrink", "softshrink", threshold=0.5)
Softsign = _simple("Softsign", "softsign")
Swish = _simple("Swish", "swish")
Tanh = _simple("Tanh", "tanh")
Tanhshrink = _simple("Tanhshrink", "tanhshrink")
ThresholdedReLU = _simple("ThresholdedReLU", "thresholded_relu",
                          threshold=1.0)
Softmax = _simple("Softmax", "softmax", axis=-1)
LogSoftmax = _simple("LogSoftmax", "log_softmax", axis=-1)
GLU = _simple("GLU", "glu", axis=-1)
RReLU = _simple("RReLU", "rrelu", lower=0.125, upper=0.3333333)


class PReLU(Layer):
    """``prelu`` with a learned slope: one, or ``num_parameters`` (one a
    channel), initialised to ``init``."""

    def __init__(self, num_parameters=1, init=0.25, weight_attr=None,
                 data_format="NCHW", name=None):
        super().__init__()
        self._data_format = data_format
        self.weight = self.create_parameter(
            [num_parameters], attr=weight_attr,
            default_initializer=Constant(init))

    def forward(self, x):
        return F.prelu(x, self.weight, self._data_format)


__all__ = ["CELU", "ELU", "GELU", "GLU", "Hardshrink", "Hardsigmoid",
           "Hardswish", "Hardtanh", "LeakyReLU", "LogSigmoid", "LogSoftmax",
           "Maxout", "Mish", "PReLU", "RReLU", "ReLU", "ReLU6", "SELU",
           "Sigmoid", "Silu", "Softmax", "Softplus", "Softshrink",
           "Softsign", "Swish", "Tanh", "Tanhshrink", "ThresholdedReLU"]

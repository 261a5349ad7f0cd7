"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Identity``, ``Linear`` and ``Flatten``."""

from __future__ import annotations

from .. import functional as F
from ..initializer import XavierUniform
from .base import Layer


class Identity(Layer):
    def __init__(self, *args, **kwargs):
        super().__init__()

    def forward(self, input):
        return input


class Linear(Layer):
    """``y = xW + b`` with the weight (in_features, out_features), as the
    reference stores it (``torch.nn.Linear`` stores (out, in)), so a state
    dict moves between the packages with no transpose."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.weight = self.create_parameter(
            [in_features, out_features], attr=weight_attr,
            default_initializer=XavierUniform())
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([out_features], attr=bias_attr,
                                              is_bias=True)

    def forward(self, input):
        return F.linear(input, self.weight, self.bias)

    def extra_repr(self):
        return (f"in_features={self._in_features}, "
                f"out_features={self._out_features}")


class Flatten(Layer):
    def __init__(self, start_axis=1, stop_axis=-1):
        super().__init__()
        self.start_axis, self.stop_axis = start_axis, stop_axis

    def forward(self, input):
        from ...tensor.manipulation import flatten
        return flatten(input, self.start_axis, self.stop_axis)


__all__ = ["Identity", "Linear", "Flatten"]

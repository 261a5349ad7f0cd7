"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Identity``, ``Linear``, ``Flatten`` and the dropouts (each draws its
mask from ``core.rng``: see ``nn.functional.common``)."""

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


class Dropout(Layer):
    def __init__(self, p=0.5, axis=None, mode="upscale_in_train", name=None):
        super().__init__()
        self.p, self.axis, self.mode = p, axis, mode

    def forward(self, input):
        return F.dropout(input, self.p, self.axis, self.training, self.mode)

    def extra_repr(self):
        return f"p={self.p}, axis={self.axis}, mode={self.mode}"


class Dropout2D(Layer):
    def __init__(self, p=0.5, data_format="NCHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout2d(input, self.p, self.training, self.data_format)


class Dropout3D(Layer):
    def __init__(self, p=0.5, data_format="NCDHW", name=None):
        super().__init__()
        self.p, self.data_format = p, data_format

    def forward(self, input):
        return F.dropout3d(input, self.p, self.training, self.data_format)


class AlphaDropout(Layer):
    def __init__(self, p=0.5, name=None):
        super().__init__()
        self.p = p

    def forward(self, input):
        return F.alpha_dropout(input, self.p, self.training)


__all__ = ["Identity", "Linear", "Flatten", "Dropout", "Dropout2D",
           "Dropout3D", "AlphaDropout"]

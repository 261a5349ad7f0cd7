"""Conv layers (counterpart of ``paddle_tpu/nn/layer/conv.py``):
``Conv1D``/``Conv2D``/``Conv3D`` and their transposes."""

from __future__ import annotations

import numpy as np

from .. import functional as F
from ..functional.conv import _tuplize
from ..initializer import Constant, Uniform
from .base import Layer


class _ConvNd(Layer):
    """The weight is (out, in/groups, *k) in every data format ((in,
    out/groups, *k) for a transpose), drawn from Uniform(+-1/sqrt(fan_in))
    with fan_in = in/groups * prod(k); the bias is Constant(0), or None
    with ``bias_attr=False``."""

    _FN = None

    def __init__(self, in_channels, out_channels, kernel_size, n, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 transposed=False, output_padding=0):
        super().__init__()
        self._in_channels, self._out_channels = in_channels, out_channels
        self._kernel_size = _tuplize(kernel_size, n)
        self._stride, self._padding = stride, padding
        self._dilation, self._groups = dilation, groups
        self._data_format = data_format
        self._output_padding = output_padding
        w_shape = ((in_channels, out_channels // groups) if transposed else
                   (out_channels, in_channels // groups)) + self._kernel_size
        fan_in = in_channels // groups * int(np.prod(self._kernel_size))
        bound = 1.0 / np.sqrt(fan_in)
        self.weight = self.create_parameter(
            w_shape, attr=weight_attr,
            default_initializer=Uniform(-bound, bound))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter(
                [out_channels], attr=bias_attr, is_bias=True,
                default_initializer=Constant(0.0))

    def forward(self, x):
        return type(self)._FN(x, self.weight, self.bias, self._stride,
                              self._padding, self._dilation, self._groups,
                              self._data_format)


class Conv1D(_ConvNd):
    _FN = staticmethod(F.conv1d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv2D(_ConvNd):
    _FN = staticmethod(F.conv2d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class Conv3D(_ConvNd):
    _FN = staticmethod(F.conv3d)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, dilation=1, groups=1, padding_mode="zeros",
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, padding_mode,
                         weight_attr, bias_attr, data_format)


class _ConvTransposeNd(_ConvNd):
    def forward(self, x, output_size=None):
        return type(self)._FN(x, self.weight, self.bias, self._stride,
                              self._padding, self._output_padding,
                              self._groups, self._dilation, output_size,
                              self._data_format)


class Conv1DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv1d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, groups=1, dilation=1,
                 weight_attr=None, bias_attr=None, data_format="NCL"):
        super().__init__(in_channels, out_channels, kernel_size, 1, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding)


class Conv2DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv2d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCHW"):
        super().__init__(in_channels, out_channels, kernel_size, 2, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding)


class Conv3DTranspose(_ConvTransposeNd):
    _FN = staticmethod(F.conv3d_transpose)

    def __init__(self, in_channels, out_channels, kernel_size, stride=1,
                 padding=0, output_padding=0, dilation=1, groups=1,
                 weight_attr=None, bias_attr=None, data_format="NCDHW"):
        super().__init__(in_channels, out_channels, kernel_size, 3, stride,
                         padding, dilation, groups, "zeros", weight_attr,
                         bias_attr, data_format, True, output_padding)


__all__ = ["Conv1D", "Conv2D", "Conv3D", "Conv1DTranspose",
           "Conv2DTranspose", "Conv3DTranspose"]

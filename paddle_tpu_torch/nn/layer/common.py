"""Common layers (counterpart of ``paddle_tpu/nn/layer/common.py``):
``Identity``, ``Linear``, ``Embedding``, ``Flatten``, ``Unflatten``, the
dropouts (each draws its mask from ``core.rng``: see
``nn.functional.common``), the ``Upsample`` family, ``Bilinear``, the
pads, ``CosineSimilarity``, ``PairwiseDistance``, the pixel and channel
shuffles, ``Unfold`` and ``Fold``."""

from __future__ import annotations

import torch

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


class Embedding(Layer):
    """A (num_embeddings, embedding_dim) table; the ``padding_idx`` row is
    zeroed at build and looked up as zeros."""

    def __init__(self, num_embeddings, embedding_dim, padding_idx=None,
                 sparse=False, weight_attr=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._padding_idx = padding_idx
        self.weight = self.create_parameter(
            [num_embeddings, embedding_dim], attr=weight_attr,
            default_initializer=XavierUniform())
        if padding_idx is not None:
            pid = padding_idx if padding_idx >= 0 else \
                num_embeddings + padding_idx
            with torch.no_grad():
                self.weight[pid] = 0.0

    def forward(self, x):
        return F.embedding(x, self.weight, self._padding_idx)

    def extra_repr(self):
        return f"{self._num_embeddings}, {self._embedding_dim}"


class Upsample(Layer):
    def __init__(self, size=None, scale_factor=None, mode="nearest",
                 align_corners=False, align_mode=0, data_format="NCHW",
                 name=None):
        super().__init__()
        self.size, self.scale_factor = size, scale_factor
        self.mode, self.align_corners = mode, align_corners
        self.align_mode, self.data_format = align_mode, data_format

    def forward(self, x):
        return F.interpolate(x, self.size, self.scale_factor, self.mode,
                             self.align_corners, self.align_mode,
                             self.data_format)


class UpsamplingNearest2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "nearest", False, 0, data_format)


class UpsamplingBilinear2D(Upsample):
    def __init__(self, size=None, scale_factor=None, data_format="NCHW",
                 name=None):
        super().__init__(size, scale_factor, "bilinear", True, 0, data_format)


class Bilinear(Layer):
    """``x1 W x2 + b`` with W (out, in1, in2) and b (1, out)."""

    def __init__(self, in1_features, in2_features, out_features,
                 weight_attr=None, bias_attr=None, name=None):
        super().__init__()
        self.weight = self.create_parameter(
            [out_features, in1_features, in2_features], attr=weight_attr,
            default_initializer=XavierUniform())
        self.bias = None if bias_attr is False else self.create_parameter(
            [1, out_features], attr=bias_attr, is_bias=True)

    def forward(self, x1, x2):
        return F.bilinear(x1, x2, self.weight, self.bias)


class _PadNd(Layer):
    def __init__(self, padding, mode, value, data_format):
        super().__init__()
        self._pad = padding if isinstance(padding, (list, tuple)) \
            else [padding]
        self._mode, self._value, self._data_format = mode, value, data_format

    def forward(self, x):
        return F.pad(x, self._pad, self._mode, self._value,
                     self._data_format)


class Pad1D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCL", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad2D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCHW", name=None):
        super().__init__(padding, mode, value, data_format)


class Pad3D(_PadNd):
    def __init__(self, padding, mode="constant", value=0.0,
                 data_format="NCDHW", name=None):
        super().__init__(padding, mode, value, data_format)


class ZeroPad2D(Pad2D):
    def __init__(self, padding, data_format="NCHW", name=None):
        super().__init__(padding, "constant", 0.0, data_format)


class CosineSimilarity(Layer):
    def __init__(self, axis=1, eps=1e-8):
        super().__init__()
        self.axis, self.eps = axis, eps

    def forward(self, x1, x2):
        return F.cosine_similarity(x1, x2, self.axis, self.eps)


class PairwiseDistance(Layer):
    """The ``p``-norm of ``x - y + epsilon`` over the last axis."""

    def __init__(self, p=2.0, epsilon=1e-6, keepdim=False, name=None):
        super().__init__()
        self.p, self.epsilon, self.keepdim = p, epsilon, keepdim

    def forward(self, x, y):
        return torch.linalg.vector_norm(x - y + self.epsilon, ord=self.p,
                                        dim=-1, keepdim=self.keepdim)


class PixelShuffle(Layer):
    def __init__(self, upscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.upscale_factor, self.data_format = upscale_factor, data_format

    def forward(self, x):
        return F.pixel_shuffle(x, self.upscale_factor, self.data_format)


class PixelUnshuffle(Layer):
    def __init__(self, downscale_factor, data_format="NCHW", name=None):
        super().__init__()
        self.downscale_factor, self.data_format = (downscale_factor,
                                                   data_format)

    def forward(self, x):
        return F.pixel_unshuffle(x, self.downscale_factor, self.data_format)


class ChannelShuffle(Layer):
    def __init__(self, groups, data_format="NCHW", name=None):
        super().__init__()
        self.groups, self.data_format = groups, data_format

    def forward(self, x):
        return F.channel_shuffle(x, self.groups, self.data_format)


class Unfold(Layer):
    def __init__(self, kernel_sizes, strides=1, paddings=0, dilations=1,
                 name=None):
        super().__init__()
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.unfold(x, *self.args)


class Fold(Layer):
    def __init__(self, output_sizes, kernel_sizes, strides=1, paddings=0,
                 dilations=1, name=None):
        super().__init__()
        self.output_sizes = output_sizes
        self.args = (kernel_sizes, strides, paddings, dilations)

    def forward(self, x):
        return F.fold(x, self.output_sizes, *self.args)


class Unflatten(Layer):
    """Axis ``axis`` split into ``shape``."""

    def __init__(self, axis, shape, name=None):
        super().__init__()
        self.axis, self.shape = axis, shape

    def forward(self, x):
        ax = self.axis % x.dim()
        return x.reshape(tuple(x.shape[:ax]) + tuple(self.shape)
                         + tuple(x.shape[ax + 1:]))


__all__ = ["Identity", "Linear", "Embedding", "Flatten", "Unflatten",
           "Dropout", "Dropout2D", "Dropout3D", "AlphaDropout", "Upsample",
           "UpsamplingNearest2D", "UpsamplingBilinear2D", "Bilinear",
           "Pad1D", "Pad2D", "Pad3D", "ZeroPad2D", "CosineSimilarity",
           "PairwiseDistance", "PixelShuffle", "PixelUnshuffle",
           "ChannelShuffle", "Unfold", "Fold"]

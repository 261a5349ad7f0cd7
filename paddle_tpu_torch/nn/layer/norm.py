"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
the ``_BatchNormBase`` family.  ``SyncBatchNorm`` waits for ROADMAP A7b."""

from __future__ import annotations

import torch

from .. import functional as F
from ..initializer import Constant
from .base import Layer, build_device


class _BatchNormBase(Layer):
    """Paddle's batch norm: ``weight`` Constant(1), ``bias`` Constant(0),
    and the running statistics as the buffers ``_mean`` (zeros) and
    ``_variance`` (ones) in the layer's dtype, with no
    ``num_batches_tracked``.  ``momentum`` 0.9 keeps 0.9 of the old
    statistics a step (``torch.nn.BatchNorm2d``'s 0.1 keeps 0.9 too, but
    its variance is unbiased)."""

    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 use_global_stats=None, name=None):
        super().__init__()
        self._num_features = num_features
        self._momentum, self._epsilon = momentum, epsilon
        self._data_format = data_format
        self._use_global_stats = use_global_stats
        if weight_attr is False:
            self.weight = None
        else:
            self.weight = self.create_parameter(
                [num_features], attr=weight_attr,
                default_initializer=Constant(1.0))
        if bias_attr is False:
            self.bias = None
        else:
            self.bias = self.create_parameter([num_features], attr=bias_attr,
                                              is_bias=True)
        dev = build_device()
        self.register_buffer("_mean", torch.zeros(
            [num_features], dtype=self._dtype, device=dev))
        self.register_buffer("_variance", torch.ones(
            [num_features], dtype=self._dtype, device=dev))

    def forward(self, input):
        return F.batch_norm(input, self._mean, self._variance, self.weight,
                            self.bias, training=self.training,
                            momentum=self._momentum, epsilon=self._epsilon,
                            data_format=self._data_format,
                            use_global_stats=self._use_global_stats)


class BatchNorm(_BatchNormBase):
    """The fluid-era BatchNorm, with an optional activation by name."""

    def __init__(self, num_channels, act=None, momentum=0.9, epsilon=1e-5,
                 param_attr=None, bias_attr=None, data_layout="NCHW",
                 use_global_stats=False, **kwargs):
        super().__init__(num_channels, momentum, epsilon, param_attr,
                         bias_attr, data_layout, use_global_stats)
        self._act = act

    def forward(self, input):
        out = super().forward(input)
        if self._act:
            out = getattr(F, self._act)(out)
        return out


class BatchNorm1D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCL",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


class BatchNorm2D(_BatchNormBase):
    pass


class BatchNorm3D(_BatchNormBase):
    def __init__(self, num_features, momentum=0.9, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCDHW",
                 use_global_stats=None, name=None):
        super().__init__(num_features, momentum, epsilon, weight_attr,
                         bias_attr, data_format, use_global_stats)


__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D"]

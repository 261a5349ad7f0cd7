"""Normalization layers (counterpart of ``paddle_tpu/nn/layer/norm.py``):
the ``_BatchNormBase`` family with ``SyncBatchNorm``, ``LayerNorm``,
``GroupNorm``, ``InstanceNorm1D/2D/3D``, ``LocalResponseNorm`` and
``SpectralNorm``, with the reference's parameter and buffer names (an
instance norm's weight is ``scale``).

Every batch norm takes its training statistics over the global batch
inside a mesh train step (``functional.batch_stats_over``), as the
reference's GSPMD step does for each of them, so ``SyncBatchNorm`` is a
``BatchNorm`` by another name: outside a step, on one rank's rows, it
behaves as one, as the reference's docstring says."""

from __future__ import annotations

import numpy as np
import torch

from .. import functional as F
from ..initializer import Constant, Normal
from .base import Layer, build_device, building


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


class SyncBatchNorm(_BatchNormBase):
    """A batch norm whose statistics cover every batch rank's rows inside
    a mesh train step (as every batch norm's do there); elsewhere a
    ``BatchNorm`` (reference: python/paddle/nn/layer/norm.py:1034)."""

    @classmethod
    def convert_sync_batchnorm(cls, layer):
        """Replace every batch-norm sublayer of ``layer`` (not ``layer``
        itself) by a ``SyncBatchNorm`` holding its parameters and
        buffers, as the reference does: the features, momentum, epsilon
        and data format carry over, an activation or ``use_global_stats``
        does not.  Returns ``layer``."""
        def convert(parent):
            for name, sub in list(parent._modules.items()):
                if isinstance(sub, _BatchNormBase) and \
                        not isinstance(sub, SyncBatchNorm):
                    with building(sub._mean.device):
                        new = SyncBatchNorm(sub._num_features, sub._momentum,
                                            sub._epsilon,
                                            data_format=sub._data_format)
                    new._dtype = sub._dtype
                    new.weight, new.bias = sub.weight, sub.bias
                    new._buffers.update(sub._buffers)
                    parent._modules[name] = new
                elif sub is not None:
                    convert(sub)
        convert(layer)
        return layer


class LayerNorm(Layer):
    def __init__(self, normalized_shape, epsilon=1e-5, weight_attr=None,
                 bias_attr=None, name=None):
        super().__init__()
        if isinstance(normalized_shape, int):
            normalized_shape = [normalized_shape]
        self._normalized_shape = list(normalized_shape)
        self._epsilon = epsilon
        self.weight = None if weight_attr is False else \
            self.create_parameter(self._normalized_shape, attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            self._normalized_shape, attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.layer_norm(input, self._normalized_shape, self.weight,
                            self.bias, self._epsilon)


class GroupNorm(Layer):
    def __init__(self, num_groups, num_channels, epsilon=1e-5,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_groups, self._num_channels = num_groups, num_channels
        self._epsilon, self._data_format = epsilon, data_format
        self.weight = None if weight_attr is False else \
            self.create_parameter([num_channels], attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_channels], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.group_norm(input, self._num_groups, self._epsilon,
                            self.weight, self.bias, self._data_format)


class _InstanceNormBase(Layer):
    """The weight is ``scale``, as in the reference; ``momentum`` is kept
    and not read (no running statistics)."""

    def __init__(self, num_features, epsilon=1e-5, momentum=0.9,
                 weight_attr=None, bias_attr=None, data_format="NCHW",
                 name=None):
        super().__init__()
        self._num_features, self._epsilon = num_features, epsilon
        self._data_format = data_format
        self.scale = None if weight_attr is False else \
            self.create_parameter([num_features], attr=weight_attr,
                                  default_initializer=Constant(1.0))
        self.bias = None if bias_attr is False else self.create_parameter(
            [num_features], attr=bias_attr, is_bias=True)

    def forward(self, input):
        return F.instance_norm(input, weight=self.scale, bias=self.bias,
                               eps=self._epsilon,
                               data_format=self._data_format)


class InstanceNorm1D(_InstanceNormBase):
    pass


class InstanceNorm2D(_InstanceNormBase):
    pass


class InstanceNorm3D(_InstanceNormBase):
    pass


class LocalResponseNorm(Layer):
    def __init__(self, size, alpha=1e-4, beta=0.75, k=1.0,
                 data_format="NCHW", name=None):
        super().__init__()
        self.size, self.alpha, self.beta, self.k = size, alpha, beta, k
        self.data_format = data_format

    def forward(self, input):
        return F.local_response_norm(input, self.size, self.alpha, self.beta,
                                     self.k, self.data_format)


class SpectralNorm(Layer):
    """``weight / sigma``, sigma the largest singular value of ``weight``
    (dim ``dim`` its rows) by ``power_iters`` power iterations from the
    buffers ``weight_u`` (h,) and ``weight_v`` (w,), fp32 draws of
    Normal(0, 1) from ``core.rng``'s stream, the reference's.  Every
    forward writes the iterated u and v back into the
    buffers, as the reference's does; the gradient flows through the
    iteration, as JAX differentiates it there."""

    def __init__(self, weight_shape, dim=0, power_iters=1, epsilon=1e-12,
                 name=None):
        super().__init__()
        self._dim, self._power_iters, self._epsilon = dim, power_iters, epsilon
        h = weight_shape[dim]
        w = int(np.prod(weight_shape)) // h
        with torch.device(build_device()):
            self.register_buffer("weight_u", Normal(0, 1)([h], torch.float32))
            self.register_buffer("weight_v", Normal(0, 1)([w], torch.float32))

    def forward(self, weight):
        w_m = torch.movedim(weight, self._dim, 0).reshape(
            weight.shape[self._dim], -1)
        dt = torch.promote_types(w_m.dtype, self.weight_u.dtype)
        w_m = w_m.to(dt)
        # copies: the backward reads them after the buffers are written
        u, v = self.weight_u.to(dt, copy=True), self.weight_v.to(dt, copy=True)
        for _ in range(self._power_iters):
            v = w_m.T @ u
            v = v / (torch.linalg.vector_norm(v) + self._epsilon)
            u = w_m @ v
            u = u / (torch.linalg.vector_norm(u) + self._epsilon)
        sigma = u @ w_m @ v
        with torch.no_grad():
            self.weight_u.copy_(u)
            self.weight_v.copy_(v)
        return weight.to(dt) / sigma      # promoted, as jnp promotes


__all__ = ["BatchNorm", "BatchNorm1D", "BatchNorm2D", "BatchNorm3D",
           "SyncBatchNorm", "LayerNorm", "GroupNorm", "InstanceNorm1D",
           "InstanceNorm2D", "InstanceNorm3D", "LocalResponseNorm",
           "SpectralNorm"]

"""``paddle_tpu_torch.vision.models`` (counterpart of
``paddle_tpu/vision/models``): the ResNet family and LeNet, and
:func:`params_from_numpy`, which carries the reference's weights and
running statistics across.  The other eight families wait for ROADMAP
A8a's remainder."""

from __future__ import annotations

import numpy as np
import torch

from .lenet import LeNet  # noqa: F401
from .resnet import (  # noqa: F401
    BasicBlock, BottleneckBlock, ResNet, resnet18, resnet34, resnet50,
    resnet101, resnet152, resnext50_32x4d, resnext101_32x4d,
    wide_resnet50_2, wide_resnet101_2)


def _load(kind, named, arrays):
    if set(named) != set(arrays):
        raise ValueError(f"{kind} names differ: missing "
                         f"{sorted(set(named) - set(arrays))}, unexpected "
                         f"{sorted(set(arrays) - set(named))}")
    for n, t in named.items():
        arr = np.asarray(arrays[n])
        if arr.shape != tuple(t.shape):
            raise ValueError(f"{kind} {n}: shape {arr.shape} != "
                             f"{tuple(t.shape)}")
        t.copy_(torch.from_numpy(np.array(arr)))


def params_from_numpy(model, params, buffers=None):
    """Copy the reference's numpy parameters (and, given ``buffers``, its
    running statistics) into ``model`` by name, with no mapping and no
    transpose: ``params, buffers = functionalize(m)[1:]`` of a
    ``paddle_tpu`` model, as numpy.  Each value is cast to the model
    tensor's dtype; a missing, extra or mis-shaped name raises.  Returns
    ``model``."""
    with torch.no_grad():
        _load("parameter", dict(model.named_parameters()), params)
        if buffers is not None:
            _load("buffer", dict(model.named_buffers()), buffers)
    return model


__all__ = ["LeNet", "ResNet", "BasicBlock", "BottleneckBlock", "resnet18",
           "resnet34", "resnet50", "resnet101", "resnet152",
           "wide_resnet50_2", "wide_resnet101_2", "resnext50_32x4d",
           "resnext101_32x4d", "params_from_numpy"]

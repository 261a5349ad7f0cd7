"""Activation layers (counterpart of ``paddle_tpu/nn/layer/activation.py``):
the ``_simple`` family: ``ReLU``, ``ReLU6`` and ``Swish`` for now."""

from __future__ import annotations

from .. import functional as F
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


ReLU = _simple("ReLU", "relu")
ReLU6 = _simple("ReLU6", "relu6")
Swish = _simple("Swish", "swish")

__all__ = ["ReLU", "ReLU6", "Swish"]

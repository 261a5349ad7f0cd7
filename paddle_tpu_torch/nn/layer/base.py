"""The layer base class (counterpart of ``paddle_tpu/nn/layer/base.py``).

A ``Layer`` is a ``torch.nn.Module`` with the reference's
``create_parameter`` and ``_dtype``.  The reference's functional bridge
(``raw_state``/``bind``) has no counterpart: the port's steps swap
parameters and buffers in with ``torch.func.functional_call``.

Parameters and buffers are made on the device of the innermost
:func:`building` scope, or on ``cuda`` outside one (raising without a
card), each drawn parameter from the next key of ``core.rng``'s stream,
in the order the layers create them: a model built after
``paddle_tpu_torch.seed(s)`` holds the reference's weights built after
``paddle.seed(s)``.
"""

from __future__ import annotations

import contextlib
import contextvars

import numpy as np
import torch

from ..initializer import (Constant, Initializer, XavierUniform,
                           get_global_initializer, to_dtype)

_DEVICE = contextvars.ContextVar("paddle_tpu_torch_build_device",
                                 default=None)


def build_device() -> torch.device:
    """The device a layer made now puts its parameters and buffers on:
    the innermost :func:`building` scope's, else ``cuda`` (raises without
    a card)."""
    dev = _DEVICE.get()
    if dev is None:
        from ... import resolve_device
        dev = resolve_device(None)
    return dev


@contextlib.contextmanager
def building(device=None):
    """Build layers on ``device`` (default: the enclosing scope's, else
    ``cuda``, which raises without a card)."""
    from ... import resolve_device

    dev = build_device() if device is None else resolve_device(device)
    token = _DEVICE.set(dev)
    try:
        yield dev
    finally:
        _DEVICE.reset(token)


class Layer(torch.nn.Module):
    """Base class of the port's layers."""

    def __init__(self, name_scope=None, dtype=None):
        super().__init__()
        self._dtype = (to_dtype(dtype) if dtype is not None
                       else torch.get_default_dtype())

    def add_sublayer(self, name, sublayer):
        self.add_module(str(name), sublayer)
        return sublayer

    def create_parameter(self, shape, attr=None, dtype=None,
                         is_bias: bool = False, default_initializer=None):
        """A parameter of ``shape`` drawn by, in order: ``attr`` (an
        ``Initializer``, or an object with an ``initializer``), the
        global initializer, ``default_initializer``, then ``Constant(0)``
        for a bias or ``XavierUniform`` for a weight.  ``attr.trainable``
        False makes it need no gradient."""
        dtype = to_dtype(dtype) if dtype is not None else self._dtype
        init = attr if isinstance(attr, Initializer) else \
            getattr(attr, "initializer", None)
        if init is None:
            glob = get_global_initializer()
            if glob is not None:
                init = glob[1] if is_bias else glob[0]
            if init is None:
                init = default_initializer
            if init is None:
                init = Constant(0.0) if is_bias else XavierUniform()
        with torch.device(build_device()):
            data = init(shape, dtype)
        return torch.nn.Parameter(
            data, requires_grad=bool(getattr(attr, "trainable", True)))


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
    ``paddle_tpu`` model (or its ``state_dict()``), as numpy.  Each value
    is cast to the model tensor's dtype; a missing, extra or mis-shaped
    name raises.  Returns ``model``."""
    with torch.no_grad():
        _load("parameter", dict(model.named_parameters()), params)
        if buffers is not None:
            _load("buffer", dict(model.named_buffers()), buffers)
    return model


__all__ = ["Layer", "build_device", "building", "params_from_numpy"]

"""``save``/``load`` (counterpart of ``paddle_tpu/framework/io.py``): a
pickle of the object with every tensor as the reference's payload
``{"__tensor__": True, "data": ndarray, "stop_gradient", "name",
"is_param"}``, so a ``.pdparams``/``.pdopt`` written by either package
loads in the other.

bfloat16 needs care: the reference's arrays are ``ml_dtypes.bfloat16``
ndarrays, and the card's machine has no ``ml_dtypes``.  So, as
``distributed.checkpoint`` does for its chunks, the port moves bf16 as
its 16-bit words:

- ``save`` pickles a bf16 tensor as the ndarray numpy itself would
  write, with its dtype rebuilt as ``numpy.dtype("bfloat16")`` (the name
  ``ml_dtypes`` registers), so the reference unpickles an
  ``ml_dtypes.bfloat16`` array without the port importing it;
- ``load`` unpickles through :class:`_Unpickler`, which reads an
  ``ml_dtypes.bfloat16`` (or ``"bfloat16"``) dtype as a marker and
  rebuilds such an array from its raw bytes as uint16 words, then a
  torch bf16 tensor.  With ``return_numpy=True`` a bf16 array comes back
  as float32 (exact: every bf16 value is a float32 one).
"""

from __future__ import annotations

import os
import pickle
from typing import Any

import numpy as np
import torch

_NP_RECONSTRUCT = np.zeros(0).__reduce__()[0]


class _Bf16Words:
    """A bf16 array as its uint16 words (``words``), in transit."""

    def __init__(self, words: np.ndarray):
        self.words = words


class _Bf16DType:
    """The bfloat16 dtype in a pickle: written as
    ``numpy.dtype("bfloat16")``, and what an unpickled bfloat16 dtype
    becomes here (its state is ignored)."""

    def __setstate__(self, state):
        pass


_BF16 = _Bf16DType()


class _Pickler(pickle.Pickler):
    def reducer_override(self, obj):
        if isinstance(obj, _Bf16Words):
            w = np.ascontiguousarray(obj.words)
            return (_NP_RECONSTRUCT, (np.ndarray, (0,), b"b"),
                    (1, w.shape, _BF16, False, w.tobytes()))
        if obj is _BF16:
            return (np.dtype, ("bfloat16",))
        return NotImplemented


class _ArrayState:
    """Stands for an ndarray while it unpickles (``_reconstruct`` then
    ``__setstate__``): a bfloat16 one becomes :class:`_Bf16Words`."""

    def __init__(self, *args):
        self.value = None

    def __setstate__(self, state):
        if len(state) == 5:
            _, shape, dtype, fortran, raw = state
        else:
            shape, dtype, fortran, raw = state
        if dtype is _BF16:
            self.value = _Bf16Words(np.frombuffer(raw, np.uint16).reshape(
                shape, order="F" if fortran else "C").copy())
        else:
            arr = _NP_RECONSTRUCT(np.ndarray, (0,), b"b")
            arr.__setstate__(state)
            self.value = arr


def _dtype(spec, *args):
    if spec is _BF16 or (isinstance(spec, str) and spec == "bfloat16"):
        return _BF16
    return np.dtype(spec, *args)


def _frombuffer(buf, dtype, shape, order):
    if dtype is _BF16:
        return _Bf16Words(np.frombuffer(buf, np.uint16).reshape(
            shape, order=order).copy())
    return np.frombuffer(buf, dtype).reshape(shape, order=order)


class _Unpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _BF16
        if module.startswith("numpy"):
            if name == "dtype":
                return _dtype
            if name == "_reconstruct":
                return _ArrayState
            if name == "_frombuffer":
                return _frombuffer
        return super().find_class(module, name)


def _host(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return _Bf16Words(t.view(torch.uint16).numpy())
    return t.numpy()


def _to_serializable(obj):
    if isinstance(obj, torch.Tensor):
        return {"__tensor__": True, "data": _host(obj),
                "stop_gradient": not obj.requires_grad, "name": None,
                "is_param": isinstance(obj, torch.nn.Parameter)}
    if hasattr(obj, "shape") and hasattr(obj, "dtype") and \
            not isinstance(obj, np.ndarray):
        return {"__tensor__": True, "data": np.asarray(obj),
                "stop_gradient": True, "name": None, "is_param": False}
    if isinstance(obj, dict):
        return {k: _to_serializable(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_serializable(v) for v in obj)
    return obj


def _numpy(v):
    """An unpickled array: an ndarray (a bf16 one as float32)."""
    if isinstance(v, _ArrayState):
        v = v.value
    if isinstance(v, _Bf16Words):
        return (v.words.astype(np.uint32) << 16).view(np.float32)
    return v


def _tensor(v, device):
    if isinstance(v, _ArrayState):
        v = v.value
    if isinstance(v, _Bf16Words):
        return torch.from_numpy(v.words).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(v)).to(device)


def _from_serializable(obj, return_numpy, device):
    if isinstance(obj, (_ArrayState, _Bf16Words)):
        return _numpy(obj)
    if isinstance(obj, dict):
        if obj.get("__tensor__"):
            if return_numpy:
                return _numpy(obj["data"])
            t = _tensor(obj["data"], device)
            if obj.get("is_param"):
                return torch.nn.Parameter(t)
            return t.requires_grad_(not obj.get("stop_gradient", True)) \
                if t.is_floating_point() else t
        return {k: _from_serializable(v, return_numpy, device)
                for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_from_serializable(v, return_numpy, device)
                         for v in obj)
    return obj


def save(obj: Any, path: str, protocol: int = 4, **configs) -> None:
    """``paddle.save``: pickle ``obj`` (tensors as the reference's
    payload) to ``path``.  Reports its wall time to the active goodput
    ledger as ``checkpoint_save`` (``telemetry_ledger``)."""
    from ..telemetry_ledger import ledger_span
    if protocol < 2 or protocol > 5:
        raise ValueError("protocol must be in [2, 5]")
    with ledger_span("checkpoint_save"):
        dirname = os.path.dirname(path)
        if dirname:
            os.makedirs(dirname, exist_ok=True)
        payload = _to_serializable(obj)
        with open(path, "wb") as f:
            _Pickler(f, protocol=protocol).dump(payload)


def load(path: str, **configs) -> Any:
    """``paddle.load``: the saved object with each tensor payload a
    torch tensor on ``configs["device"]`` (default: the ``nn.building``
    scope's, else ``cuda``), a Parameter where one was saved; with
    ``return_numpy=True``, ndarrays (and no device).  Reports its wall
    time as ``checkpoint_restore``."""
    from ..telemetry_ledger import ledger_span
    if not os.path.exists(path):
        raise ValueError(f"path {path} does not exist")
    return_numpy = configs.get("return_numpy", False)
    device = None
    if not return_numpy:
        from ..tensor.creation import _device
        device = _device(configs.get("device"))
    with ledger_span("checkpoint_restore"):
        with open(path, "rb") as f:
            payload = _Unpickler(f).load()
        return _from_serializable(payload, return_numpy, device)


__all__ = ["save", "load"]

"""Tensor creation (counterpart of ``paddle_tpu/tensor/creation.py``).

A tensor made from nothing (``zeros``, ``full``, ``arange``, ``eye``, ...)
lands on ``device``: by default the enclosing ``nn.building`` scope's,
else ``cuda`` (raising without a card), as the port's layers do.  A
``*_like`` function and one that takes a tensor keep its device.  Integer
defaults are int64 (ROADMAP §C); float defaults are torch's default
dtype (``core.dtype.get_default_dtype``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.dtype import convert_dtype, get_default_dtype


def _device(device):
    if device is not None:
        from .. import resolve_device
        return resolve_device(device)
    from ..nn.layer.base import build_device
    return build_device()


def _dt(dtype, default_float=True):
    if dtype is None:
        return get_default_dtype() if default_float else torch.int64
    return convert_dtype(dtype)


def _u(v):
    return v.item() if isinstance(v, torch.Tensor) else v


def _to_shape(shape):
    if isinstance(shape, torch.Tensor):
        return tuple(int(s) for s in shape.reshape(-1).tolist())
    if isinstance(shape, (int, np.integer)):
        return (int(shape),)
    return tuple(int(_u(s)) for s in shape)


def zeros(shape, dtype=None, name=None, device=None):
    return torch.zeros(_to_shape(shape), dtype=_dt(dtype),
                       device=_device(device))


def ones(shape, dtype=None, name=None, device=None):
    return torch.ones(_to_shape(shape), dtype=_dt(dtype),
                      device=_device(device))


def full(shape, fill_value, dtype=None, name=None, device=None):
    """``fill_value`` everywhere; without ``dtype`` its own kind (int64,
    the default float, bool)."""
    fill_value = _u(fill_value)
    return torch.full(_to_shape(shape), fill_value,
                      dtype=None if dtype is None else _dt(dtype),
                      device=_device(device))


def empty(shape, dtype=None, name=None, device=None):
    """Zeros, as the reference's (its memory is never uninitialised)."""
    return zeros(shape, dtype, device=device)


def zeros_like(x, dtype=None, name=None):
    return torch.zeros_like(x, dtype=convert_dtype(dtype))


def ones_like(x, dtype=None, name=None):
    return torch.ones_like(x, dtype=convert_dtype(dtype))


def full_like(x, fill_value, dtype=None, name=None):
    return torch.full_like(x, _u(fill_value), dtype=convert_dtype(dtype))


def empty_like(x, dtype=None, name=None):
    return zeros_like(x, dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None, device=None):
    """[start, end) by ``step``: int64 when all three are integers, else
    the default float, without ``dtype``."""
    start, end, step = _u(start), _u(end), _u(step)
    if end is None:
        start, end = 0, start
    if dtype is None:
        ints = all(isinstance(v, (int, np.integer))
                   for v in (start, end, step))
        dtype = torch.int64 if ints else get_default_dtype()
    return torch.arange(start, end, step, dtype=convert_dtype(dtype),
                        device=_device(device))


def linspace(start, stop, num, dtype=None, name=None, device=None):
    return torch.linspace(_u(start), _u(stop), int(_u(num)),
                          dtype=_dt(dtype), device=_device(device))


def logspace(start, stop, num, base=10.0, dtype=None, name=None,
             device=None):
    return torch.logspace(_u(start), _u(stop), int(_u(num)),
                          base=_u(base), dtype=_dt(dtype),
                          device=_device(device))


def eye(num_rows, num_columns=None, dtype=None, name=None, device=None):
    return torch.eye(num_rows, num_rows if num_columns is None
                     else num_columns, dtype=_dt(dtype),
                     device=_device(device))


def diag(x, offset=0, padding_value=0, name=None):
    """The ``offset`` diagonal of a matrix, or a matrix with the vector
    on it (``padding_value`` elsewhere)."""
    d = torch.diag(x, offset)
    if x.dim() == 1 and padding_value != 0:
        on = torch.ones(len(x), dtype=torch.bool, device=x.device)
        return torch.where(torch.diag(on, offset), d,
                           torch.full((), padding_value, dtype=d.dtype,
                                      device=d.device))
    return d


def diagflat(x, offset=0, name=None):
    return torch.diagflat(x, offset)


def tril(x, diagonal=0, name=None):
    return torch.tril(x, diagonal)


def triu(x, diagonal=0, name=None):
    return torch.triu(x, diagonal)


def meshgrid(*args, **kwargs):
    """``ij``-indexed grids of the given 1-d tensors."""
    tensors = args[0] if len(args) == 1 and isinstance(
        args[0], (list, tuple)) else args
    return list(torch.meshgrid(*tensors, indexing="ij"))


def assign(x, output=None):
    """A copy of ``x`` (a tensor, or array-like data put on the build
    device); into ``output`` when given."""
    out = x.clone() if isinstance(x, torch.Tensor) else torch.as_tensor(
        np.asarray(x), device=_device(None))
    if output is not None:
        with torch.no_grad():
            output.copy_(out)
        return output
    return out


def clone(x, name=None):
    return x.clone()


def tolist(x):
    return x.tolist()


def numel(x, name=None):
    """The element count, a 0-d int64 tensor on ``x``'s device."""
    return torch.tensor(x.numel(), dtype=torch.int64, device=x.device)


__all__ = ["zeros", "ones", "full", "empty", "zeros_like", "ones_like",
           "full_like", "empty_like", "arange", "linspace", "logspace",
           "eye", "diag", "diagflat", "tril", "triu", "meshgrid", "assign",
           "clone", "tolist", "numel"]

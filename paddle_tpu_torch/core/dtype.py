"""Dtypes (counterpart of ``paddle_tpu/core/dtype.py``).

The reference's dtype names and aliases map onto torch dtypes through one
table, :data:`_ALIASES`, which ``nn.initializer.to_dtype`` reads too.
Unlike the reference with ``jax_enable_x64`` off, 64-bit names are not
narrowed: ``convert_dtype("int64")`` is ``torch.int64``, and index outputs
are int64 (ROADMAP §C).  The default dtype is torch's own
(``torch.get_default_dtype``), which the port's layers build in.
"""

from __future__ import annotations

import numpy as np
import torch

float16 = torch.float16
bfloat16 = torch.bfloat16
float32 = torch.float32
float64 = torch.float64
int8 = torch.int8
int16 = torch.int16
int32 = torch.int32
int64 = torch.int64
uint8 = torch.uint8
uint16 = torch.uint16
uint32 = torch.uint32
uint64 = torch.uint64
bool_ = torch.bool
bool = torch.bool  # noqa: A001 - the reference exposes paddle.bool
complex64 = torch.complex64
complex128 = torch.complex128

_ALIASES = {
    "float16": float16, "fp16": float16, "half": float16,
    "bfloat16": bfloat16, "bf16": bfloat16,
    "float32": float32, "fp32": float32, "float": float32,
    "float64": float64, "fp64": float64, "double": float64,
    "int8": int8, "int16": int16, "int32": int32, "int64": int64,
    "uint8": uint8, "uint16": uint16, "uint32": uint32, "uint64": uint64,
    "bool": bool_, "complex64": complex64, "complex128": complex128,
}

FLOATING = (float16, bfloat16, float32, float64)
INTEGER = (int8, int16, int32, int64, uint8, uint16, uint32, uint64)


def convert_dtype(dtype):
    """A torch dtype from a torch dtype, a name or alias (``"fp32"``,
    ``"paddle.int64"``), or a numpy dtype; None stays None."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    if isinstance(dtype, str):
        key = dtype.lower().replace("paddle.", "").replace("torch.", "")
    else:
        key = np.dtype(dtype).name
    dt = _ALIASES.get(key, getattr(torch, key, None))
    if not isinstance(dt, torch.dtype):
        raise ValueError(f"unknown dtype {dtype!r}")
    return dt


def is_floating_point(dtype) -> bool:
    return convert_dtype(dtype).is_floating_point


def is_integer(dtype) -> bool:
    dt = convert_dtype(dtype)
    return not (dt.is_floating_point or dt.is_complex or dt == torch.bool)


def get_default_dtype():
    """``paddle.get_default_dtype``: torch's default float dtype."""
    return torch.get_default_dtype()


def set_default_dtype(d) -> None:
    """``paddle.set_default_dtype``: a floating dtype, else TypeError."""
    dt = convert_dtype(d)
    if not dt.is_floating_point:
        raise TypeError(f"default dtype must be floating point, got {dt}")
    torch.set_default_dtype(dt)


__all__ = ["convert_dtype", "get_default_dtype", "set_default_dtype",
           "is_floating_point", "is_integer", "float16", "bfloat16",
           "float32", "float64", "int8", "int16", "int32", "int64", "uint8",
           "uint16", "uint32", "uint64", "bool_", "complex64", "complex128"]

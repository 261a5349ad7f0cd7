"""Bucket policies shared by the serving engines (counterpart of
``paddle_tpu/jit/bucketing.py``: ``select_bucket``, ``pow2_bucket`` and
``pow2_grid``)."""

from __future__ import annotations

from typing import Sequence


def select_bucket(length: int, buckets: Sequence[int]) -> int:
    """Smallest bucket admitting ``length``."""
    bucket = next((b for b in buckets if b >= length), None)
    if bucket is None:
        raise ValueError(
            f"length {length} exceeds the largest bucket {max(buckets)}; "
            f"add a bucket or truncate the input")
    return bucket


def pow2_bucket(need: int, cap: int) -> int:
    """Smallest power of two covering ``need``, clamped to ``cap`` — the
    table-width bucket of the paged/ragged engines."""
    C = 1
    while C < max(int(need), 1):
        C *= 2
    return min(C, int(cap))


def pow2_grid(cap: int):
    """Every value :func:`pow2_bucket` can return for a given ``cap``:
    powers of two below it plus the clamp value itself — the full
    table-width grid a paged/ragged engine enumerates for warmup (at most
    ``log2(cap) + 1`` entries)."""
    cap = int(cap)
    if cap < 1:
        raise ValueError("cap must be >= 1")
    out = []
    C = 1
    while C < cap:
        out.append(C)
        C *= 2
    out.append(cap)
    return tuple(out)

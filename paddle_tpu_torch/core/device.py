"""Places and device queries (counterpart of ``paddle_tpu/core/device.py``).

A place names a torch device: ``"gpu"``/``"gpu:N"`` (and the reference's
``"tpu"``, kept as a synonym) is CUDA ordinal N, ``"cpu"`` the host.  The
current place starts as ``gpu:0`` when a card is present, else ``cpu``;
:func:`set_device` changes it (and the current CUDA device).  It is not a
default for the port's entry points, which take ``device=`` and run on
``cuda`` unless told otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch

_GPU_KINDS = ("gpu", "cuda", "tpu")


class Place:
    """A device handle (``paddle.CUDAPlace``-family): ``"gpu:0"``,
    ``"cpu"``, ``"cuda:1"``."""

    def __init__(self, spec: str = "gpu:0"):
        if ":" in spec:
            kind, idx = spec.split(":")
            self.kind, self.index = kind, int(idx)
        else:
            self.kind, self.index = spec, 0

    def __repr__(self):
        return f"Place({self.kind}:{self.index})"

    def __eq__(self, other):
        other = Place(other) if isinstance(other, str) else other
        return (self.kind, self.index) == (other.kind, other.index)

    def __hash__(self):
        return hash((self.kind, self.index))

    def is_cpu_place(self):
        return self.kind == "cpu"

    def is_gpu_place(self):
        return self.kind in _GPU_KINDS

    def torch_device(self) -> torch.device:
        """The torch device of this place (``cuda:N`` for a card)."""
        if self.is_cpu_place():
            return torch.device("cpu")
        return torch.device("cuda", self.index)


_current: Optional[Place] = None


def local_devices(platform: Optional[str] = None):
    """The torch devices of ``platform``: ``"cpu"``, or (by default) every
    card, or the CPU when there is none."""
    if platform == "cpu" or not torch.cuda.is_available():
        return [torch.device("cpu")]
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def set_device(spec) -> Place:
    """``paddle.set_device``: make ``spec`` the current place; a card's
    place raises without CUDA and becomes torch's current device."""
    global _current
    place = Place(spec) if isinstance(spec, str) else spec
    if place.is_gpu_place():
        if not torch.cuda.is_available():
            raise RuntimeError(f"cannot set device {spec!r}: CUDA is not "
                               f"available")
        torch.cuda.set_device(place.index)
    _current = place
    return _current


def get_device() -> str:
    """``paddle.get_device``: ``"gpu:0"`` or ``"cpu"``-style."""
    p = _get_place()
    return "cpu" if p.is_cpu_place() else f"gpu:{p.index}"


def _get_place() -> Place:
    global _current
    if _current is None:
        _current = Place(f"gpu:{torch.cuda.current_device()}"
                         if torch.cuda.is_available() else "cpu")
    return _current


def device_count() -> int:
    """Number of CUDA devices."""
    return torch.cuda.device_count()


def is_compiled_with_cuda() -> bool:
    """True when this torch build has CUDA (a card may still be absent)."""
    return torch.backends.cuda.is_built()


def is_compiled_with_tpu() -> bool:
    return False


def synchronize() -> None:
    """Wait for the current card's work (nothing to wait for without
    one)."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()


__all__ = ["Place", "local_devices", "set_device", "get_device", "device_count",
           "is_compiled_with_cuda", "is_compiled_with_tpu", "synchronize"]

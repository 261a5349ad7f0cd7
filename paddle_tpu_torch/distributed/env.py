"""Distributed environment (counterpart of ``paddle_tpu/distributed/env.py``;
reference: python/paddle/distributed/parallel.py init_parallel_env:71).

One process per rank under ``torch.distributed``.  ``init_parallel_env``
reads the reference's PaddleCloud contract (``PADDLE_TRAINERS_NUM``,
``PADDLE_TRAINER_ID``, ``PADDLE_MASTER`` or the first of
``PADDLE_TRAINER_ENDPOINTS``) or torchrun's (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``/``MASTER_PORT``), or takes an explicit ``init_method``
(``tcp://host:port`` or ``file://path``) with ``rank`` and
``world_size``.  The backend is ``nccl`` on the current card unless the
caller asks for ``gloo``; it never falls back to gloo or to the CPU.
"""

from __future__ import annotations

import os
from typing import Optional

_initialized = False


def _env_int(*names) -> Optional[int]:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return int(v)
    return None


def _rendezvous(init_method: Optional[str]) -> Optional[str]:
    """The init method: the caller's, else the reference's master
    endpoint, else torchrun's ``env://`` (None: nothing to rendezvous)."""
    if init_method is not None:
        return init_method
    coord = os.environ.get("PADDLE_MASTER")
    if coord is None:
        eps = os.environ.get("PADDLE_TRAINER_ENDPOINTS", "")
        coord = eps.split(",")[0] if eps else None
    if coord:
        return coord if "://" in coord else f"tcp://{coord}"
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return "env://"
    return None


def init_parallel_env(backend: Optional[str] = None,
                      init_method: Optional[str] = None,
                      rank: Optional[int] = None,
                      world_size: Optional[int] = None, timeout=None):
    """``paddle.distributed.init_parallel_env`` parity: initialise the
    default ``torch.distributed`` process group once.

    ``backend``: ``"nccl"`` (the default) binds this process to its card
    (``ParallelEnv().device_id``) and raises when there is no card or no
    NCCL; ``"gloo"`` only when asked for (the CPU tests, ranks that share
    one card).  ``rank``/``world_size`` default to ``PADDLE_TRAINER_ID`` /
    ``PADDLE_TRAINERS_NUM`` or ``RANK`` / ``WORLD_SIZE`` (0 and 1)."""
    global _initialized
    import torch
    import torch.distributed as dist

    if _initialized or (dist.is_available() and dist.is_initialized()):
        _initialized = True
        return
    backend = backend or "nccl"
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend must be 'nccl' or 'gloo', got "
                         f"{backend!r}")
    if not dist.is_available():
        raise RuntimeError("this torch build has no torch.distributed")
    world = world_size if world_size is not None else \
        (_env_int("PADDLE_TRAINERS_NUM", "WORLD_SIZE") or 1)
    me = rank if rank is not None else \
        (_env_int("PADDLE_TRAINER_ID", "RANK") or 0)
    if backend == "nccl":
        if not torch.cuda.is_available():
            raise RuntimeError("init_parallel_env: backend 'nccl' needs a "
                               "CUDA device and none is available; pass "
                               "backend='gloo' to run on the CPU")
        if not dist.is_nccl_available():
            raise RuntimeError("init_parallel_env: this torch build has no "
                               "NCCL; pass backend='gloo' explicitly")
        torch.cuda.set_device(ParallelEnv().device_id)
    method = _rendezvous(init_method)
    if method is None:
        if world > 1:
            raise RuntimeError(
                "init_parallel_env: a world of more than one rank needs a "
                "rendezvous (PADDLE_MASTER, PADDLE_TRAINER_ENDPOINTS, "
                "MASTER_ADDR/MASTER_PORT or init_method=)")
        import tempfile
        fd, path = tempfile.mkstemp(prefix="paddle_tpu_torch_pg_")
        os.close(fd)
        os.unlink(path)
        method = f"file://{path}"
    kw = {} if timeout is None else {"timeout": timeout}
    dist.init_process_group(backend, init_method=method, rank=me,
                            world_size=world, **kw)
    _initialized = True


def get_rank() -> int:
    """``paddle.distributed.get_rank``: this process's rank (0 with no
    process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    env = _env_int("PADDLE_TRAINER_ID")
    return env if env is not None else 0


def get_world_size() -> int:
    """``paddle.distributed.get_world_size`` (1 with no process group)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    env = _env_int("PADDLE_TRAINERS_NUM")
    return env if env is not None else 1


def is_initialized() -> bool:
    import torch.distributed as dist
    return _initialized or (dist.is_available() and dist.is_initialized())


def get_backend() -> Optional[str]:
    """The default group's backend, or None with no process group."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_backend()
    return None


def _forget():
    """Called by ``collective.destroy_process_group``."""
    global _initialized
    _initialized = False


class ParallelEnv:
    """Reference: fluid/dygraph/parallel.py ParallelEnv."""

    @property
    def rank(self):
        return get_rank()

    @property
    def world_size(self):
        return get_world_size()

    @property
    def device_id(self):
        """``LOCAL_RANK``, else the first of ``FLAGS_selected_gpus``, else
        0."""
        local = _env_int("LOCAL_RANK")
        if local is not None:
            return local
        return int(os.environ.get("FLAGS_selected_gpus", "0").split(",")[0])

    local_rank = rank
    nranks = world_size

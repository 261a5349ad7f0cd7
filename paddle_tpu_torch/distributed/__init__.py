"""``paddle_tpu_torch.distributed`` (counterpart of
``paddle_tpu/distributed``; reference: python/paddle/distributed/).

Hybrid-parallel training on ``torch.distributed``, one process per rank:
the collective API (with the autograd collectives of tensor, sequence
and expert parallelism), the hybrid group and ``fleet`` (the
tensor-parallel layers in ``fleet.meta_parallel``), the expert exchange
(``utils``: ``global_scatter``/``global_gather`` and their ragged
forms), the gradient communication policies, ZeRO stages 1-3 with
offload, weight-update sharding, the data × sharding × sep × model
train steps (expert weights held over the data axis) and the pipeline
(``spmd``'s 1F1B and interleaved schedules over the pipe axis,
``pipeline_engine``, ``fleet.meta_parallel.PipelineLayer``).
Crash-consistent training rides ``checkpoint`` (sharded saves, resumes
on another layout), ``store`` (the TCP store), ``fleet.elastic``
(membership) and ``launch`` (``python -m
paddle_tpu_torch.distributed.launch``).  ``localsgd``, ``dgc`` and
``auto_parallel`` wait for their slices (ROADMAP A7b).
"""

from . import checkpoint, env, fleet, utils  # noqa: F401
from .collective import (Group, ReduceOp, all_gather, all_gather_object,  # noqa: F401
                         all_reduce, alltoall, alltoall_single, barrier, broadcast,
                         broadcast_object_list, destroy_process_group, get_group,
                         irecv, is_initialized, isend, new_group, recv, reduce,
                         reduce_scatter, scatter, send, split, wait)
from .env import ParallelEnv, get_rank, get_world_size, init_parallel_env  # noqa: F401
from .fleet.meta_parallel import DataParallel  # noqa: F401
from .grad_comm import (GradCommPolicy, compressed_all_reduce,  # noqa: F401
                        compressed_reduce_scatter, resolve_policy)
from .sharding_rules import (ShardingRules, match_partition_rules,  # noqa: F401
                             sharding_rules_digest, spec_tree_digest)
from .spmd import make_spmd_train_step, shard_batch  # noqa: F401
from .update_sharding import make_dp_update_sharded_train_step  # noqa: F401
from .zero import make_zero_train_step, per_device_state_bytes  # noqa: F401
from .topology import CommunicateTopology, HybridCommunicateGroup  # noqa: F401


def spawn(func, args=(), nprocs=-1, join=True, daemon=False, **options):
    """Reference: distributed/spawn.py.  Runs ``func`` in-process when
    ``nprocs`` <= 1; otherwise ``torch.multiprocessing.spawn`` starts
    ``nprocs`` processes, each calling ``func(*args)`` with
    ``PADDLE_TRAINER_ID``/``PADDLE_TRAINERS_NUM`` set (the caller's
    ``init_parallel_env`` then needs a rendezvous: ``PADDLE_MASTER``)."""
    if nprocs in (-1, 0, 1):
        func(*args)
        return None
    import torch.multiprocessing as mp
    return mp.start_processes(_spawned, args=(func, args, nprocs),
                              nprocs=nprocs, join=join, daemon=daemon,
                              start_method="spawn")


def _spawned(rank, func, args, nprocs):
    import os
    os.environ["PADDLE_TRAINER_ID"] = str(rank)
    os.environ["PADDLE_TRAINERS_NUM"] = str(nprocs)
    func(*args)


def get_backend():
    """The default process group's backend (None without one)."""
    return env.get_backend()


def gloo_init_parallel_env(rank_id, rank_num, server_endpoint):
    """Reference parallel_with_gloo.py — CPU rendezvous over gloo; the
    explicit arguments are authoritative."""
    env.init_parallel_env(backend="gloo", init_method=(
        server_endpoint if "://" in server_endpoint
        else f"tcp://{server_endpoint}"), rank=rank_id, world_size=rank_num)


def gloo_barrier():
    barrier()


def gloo_release():
    """Tear the gloo process group down."""
    destroy_process_group()

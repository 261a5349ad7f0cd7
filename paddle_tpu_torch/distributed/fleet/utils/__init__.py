"""fleet.utils (counterpart of ``paddle_tpu/distributed/fleet/utils``;
reference: fleet/utils/ — recompute.py:63, hybrid_parallel_util.py).

Here the hybrid-parallel helpers run real collectives over the hybrid
group's process groups (the reference's are no-ops: GSPMD reduces there).
"""

from __future__ import annotations


def recompute(function, *args, **kwargs):
    """Activation recomputation (reference fleet/utils/recompute.py:63):
    ``torch.utils.checkpoint`` (non-reentrant), the RNG state replayed."""
    from torch.utils.checkpoint import checkpoint
    preserve = kwargs.pop("preserve_rng_state", True)
    kwargs.pop("use_reentrant", None)
    return checkpoint(function, *args, use_reentrant=False,
                      preserve_rng_state=preserve, **kwargs)


def _params(model_or_list):
    return list(model_or_list.parameters()) \
        if hasattr(model_or_list, "parameters") else list(model_or_list)


def fused_allreduce_gradients(parameter_list, hcg):
    """Reference hybrid_parallel_util.py:117: every parameter's ``.grad``
    becomes its mean over the data-parallel group (one collective over
    the flattened gradients)."""
    import torch
    from ...collective import ReduceOp, all_reduce
    group = hcg.get_data_parallel_group()
    grads = [p.grad for p in _params(parameter_list) if p.grad is not None]
    if group.nranks <= 1 or not grads:
        return None
    flat = torch.cat([g.reshape(-1).float() for g in grads])
    all_reduce(flat, ReduceOp.AVG, group)
    off = 0
    for g in grads:
        g.copy_(flat[off:off + g.numel()].view_as(g))
        off += g.numel()
    return None


def _broadcast_params(model, group):
    import torch
    from ...collective import broadcast
    if group.nranks <= 1:
        return None
    with torch.no_grad():
        for p in _params(model):
            broadcast(p.data, group.ranks[0], group)
    return None


def broadcast_mp_parameters(model, hcg):
    return _broadcast_params(model, hcg.get_model_parallel_group())


def broadcast_dp_parameters(model, hcg):
    """Every parameter set to the data-parallel group's first rank's."""
    return _broadcast_params(model, hcg.get_data_parallel_group())


def broadcast_sharding_parameters(model, hcg):
    """Every parameter set to the sharding group's first rank's."""
    return _broadcast_params(model, hcg.get_sharding_parallel_group())


class UtilBase:
    """Fleet util surface (reference fleet/base/util_factory.py UtilBase)."""

    def all_reduce(self, input, mode="sum", comm_world="worker"):
        import numpy as np
        from ..metrics.metric import _allreduce
        return _allreduce(np.asarray(input), mode)

    def barrier(self, comm_world="worker"):
        from ...collective import barrier as _barrier
        _barrier()

    def all_gather(self, input, comm_world="worker"):
        from ...collective import all_gather_object
        out = []
        all_gather_object(out, input)
        return out

    def get_file_shard(self, files):
        """Split a file list over workers with the remainder spread one file
        at a time (shard sizes differ by at most 1)."""
        from .. import fleet
        n = fleet.worker_num()
        i = fleet.worker_index()
        base, rem = divmod(len(files), n)
        start = i * base + min(i, rem)
        return files[start:start + base + (1 if i < rem else 0)]

    def print_on_rank(self, message, rank_id=0):
        from .. import fleet
        if fleet.worker_index() == rank_id:
            print(message)

"""Hybrid-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``; reference:
fleet/meta_parallel/{data_parallel → dygraph/parallel.py:397,
tensor_parallel.py:25, sharding_parallel.py:23}).

The wrappers forward to the wrapped ``nn.Module``; the distribution itself
is the train-step builders' (``distributed.spmd``, ``zero``,
``update_sharding``) and the tensor-parallel layers'
(``parallel_layers.mp_layers``).  ``DataParallel.apply_collective_grads``
averages the gradients over the data-parallel group for an eager loop;
``TensorParallel`` broadcasts the parameters the model ranks replicate.
``PipelineParallel`` waits for ROADMAP A7c.
"""

from __future__ import annotations

from torch import nn

from ...topology import get_hybrid_communicate_group
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              ParallelCrossEntropy, RNGStatesTracker,
                              RowParallelLinear, VocabParallelEmbedding,
                              get_rng_state_tracker,
                              model_parallel_random_seed)


class MetaParallelBase(nn.Module):
    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__()
        self._layers = layers
        self._hcg = hcg or get_hybrid_communicate_group()
        self._strategy = strategy

    def forward(self, *inputs, **kwargs):
        return self._layers(*inputs, **kwargs)

    def state_dict(self, *args, **kwargs):
        return self._layers.state_dict(*args, **kwargs)

    def set_state_dict(self, state_dict, *args, **kwargs):
        return self._layers.load_state_dict(state_dict, *args, **kwargs)


class DataParallel(MetaParallelBase):
    """Reference: fluid/dygraph/parallel.py:397."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers, None, strategy)

    def scale_loss(self, loss):
        return loss

    def apply_collective_grads(self):
        """Average every parameter's gradient over the data-parallel
        group (``fleet.utils.fused_allreduce_gradients``)."""
        from ..utils import fused_allreduce_gradients
        if self._hcg is not None:
            fused_allreduce_gradients(self._layers, self._hcg)


class ShardingParallel(MetaParallelBase):
    """Reference: sharding_parallel.py:23."""


class TensorParallel(MetaParallelBase):
    """Reference: tensor_parallel.py:25.  Paddle's wrapper broadcasts, at
    construction, the parameters a group replicates from the group's
    first rank: over the model group those not split over it (whose
    ``is_distributed`` attribute is not True: a tensor's own
    ``is_distributed`` is a method), over the data and sharding groups
    all of them; the layers' own collectives do the rest."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        if self._hcg is None:
            return
        import torch
        from ...collective import broadcast
        mesh = self._hcg.mesh
        with torch.no_grad():
            for _, p in self._layers.named_parameters():
                axes = ["data", "sharding"]
                if getattr(p, "is_distributed", False) is not True:
                    axes.append("model")
                for ax in axes:
                    broadcast(p.data, src=0, group=mesh.axis_group(ax))


class PipelineParallel(MetaParallelBase):
    """Reference: pipeline_parallel.py:30 — waits for ROADMAP A7c."""

    def __init__(self, layers, hcg=None, strategy=None):
        raise NotImplementedError("PipelineParallel: the pipeline engine is "
                                  "ROADMAP A7c")

"""Hybrid-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``; reference:
fleet/meta_parallel/{data_parallel → dygraph/parallel.py:397,
sharding_parallel.py:23}).

The wrappers forward to the wrapped ``nn.Module``; the distribution itself
is the train-step builders' (``distributed.spmd``, ``zero``,
``update_sharding``).  ``DataParallel.apply_collective_grads`` averages
the gradients over the data-parallel group for an eager loop.
``TensorParallel`` waits for ROADMAP A7b, ``PipelineParallel`` for A7c.
"""

from __future__ import annotations

from torch import nn

from ...topology import get_hybrid_communicate_group


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
    """Reference: tensor_parallel.py:25 — waits for ROADMAP A7b."""

    def __init__(self, layers, hcg=None, strategy=None):
        raise NotImplementedError("TensorParallel: tensor parallelism is "
                                  "ROADMAP A7b")


class PipelineParallel(MetaParallelBase):
    """Reference: pipeline_parallel.py:30 — waits for ROADMAP A7c."""

    def __init__(self, layers, hcg=None, strategy=None):
        raise NotImplementedError("PipelineParallel: the pipeline engine is "
                                  "ROADMAP A7c")

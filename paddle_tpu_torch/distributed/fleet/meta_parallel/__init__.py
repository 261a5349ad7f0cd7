"""Hybrid-parallel model wrappers (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel``; reference:
fleet/meta_parallel/{data_parallel → dygraph/parallel.py:397,
tensor_parallel.py:25, pipeline_parallel.py:30, sharding_parallel.py:23}).

The wrappers forward to the wrapped ``nn.Module``; the distribution itself
is the train-step builders' (``distributed.spmd``, ``zero``,
``update_sharding``) and the tensor-parallel layers'
(``parallel_layers.mp_layers``).  ``DataParallel.apply_collective_grads``
averages the gradients over the data-parallel group for an eager loop;
``TensorParallel`` broadcasts the parameters the model ranks replicate.
``PipelineParallel`` trains a ``PipelineLayer`` through
``distributed.pipeline_engine`` (1F1B over the pipe ranks).
"""

from __future__ import annotations

from torch import nn

from ...topology import get_hybrid_communicate_group
from .parallel_layers import (ColumnParallelLinear,  # noqa: F401
                              LayerDesc, ParallelCrossEntropy, PipelineLayer,
                              RNGStatesTracker, RowParallelLinear,
                              SegmentLayers, SharedLayerDesc,
                              VocabParallelEmbedding, get_rng_state_tracker,
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
    """Reference: fluid/dygraph/parallel.py:397.  Each rank runs the
    forward on its own rows; in training mode a batch norm inside takes
    its statistics over every batch rank's rows
    (``nn.functional.batch_stats_over`` the hybrid group's batch group),
    as the reference's one controller does over the whole batch it is
    given (``ROADMAP.md`` §C, data-parallel training)."""

    def __init__(self, layers, strategy=None, comm_buffer_size=25,
                 last_comm_buffer_size=1, find_unused_parameters=False,
                 group=None):
        super().__init__(layers, None, strategy)

    def forward(self, *inputs, **kwargs):
        if self._hcg is None or not self.training:
            return self._layers(*inputs, **kwargs)
        from ....nn.functional.norm import batch_stats_over
        group, _ = self._hcg.mesh.batch_group()
        with batch_stats_over(group):
            return self._layers(*inputs, **kwargs)

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
    """Reference: pipeline_parallel.py:30 (train_batch:152,
    forward_backward_pipeline:80 1F1B).  ``train_batch`` keeps the
    reference's signature: every rank feeds the global batch, split into
    ``accumulate_steps`` micro-batches (``strategy.pipeline_configs``) of
    this rank's rows; the step is built at the first call
    (``pipeline_engine.make_pipeline_train_step``) and updates the layer's
    own parameters.  ``micro_batch_size`` is kept and not read, as in the
    reference."""

    def __init__(self, layers, hcg=None, strategy=None):
        super().__init__(layers, hcg, strategy)
        if not isinstance(layers, PipelineLayer):
            raise TypeError("PipelineParallel expects a PipelineLayer")
        cfg = (strategy.pipeline_configs if strategy is not None else
               {"accumulate_steps": 1, "micro_batch_size": 1})
        self.accumulate_steps = cfg.get("accumulate_steps", 1)
        self.micro_batch_size = cfg.get("micro_batch_size", 1)
        self._step_fn = None
        self._state = None

    def train_batch(self, data, optimizer, lr_scheduler=None, scaler=None):
        """One step on ``data = (inputs, labels)``: the global mean loss
        (on every rank)."""
        inputs, labels = data
        if self._step_fn is None:
            from ...pipeline_engine import make_pipeline_train_step
            self._step_fn, self._state = make_pipeline_train_step(
                self._layers, self._layers._loss_fn,
                getattr(optimizer, "_inner_opt", optimizer), self._hcg,
                self.accumulate_steps)
        self._state, loss = self._step_fn(self._state, None,
                                          optimizer.get_lr(), inputs, labels)
        if lr_scheduler is not None:
            lr_scheduler.step()
        return loss

    def eval_batch(self, data, compute_loss=True):
        """The forward over the pipe ranks: the loss (or, without
        ``compute_loss``, the last stage's output) on every rank."""
        import torch
        from ...pipeline_engine import _one
        from ...spmd import broadcast_from, run_pipeline
        inputs, labels = (_one(t) for t in data)
        layers = self._layers
        if layers.get_num_stages() <= 1:
            with torch.no_grad():
                out = layers.forward_stage(inputs, 0)
            if compute_loss and layers._loss_fn is not None:
                return layers._loss_fn(out, labels)
            return out
        pipe = self._hcg.get_pipe_parallel_group()
        stage = self._hcg.get_stage_id()
        outputs, _, _, _ = run_pipeline(
            lambda v, x, m: layers.forward_stage(x, stage), [], [[]],
            [inputs], pipe.nranks, 1, pipe)
        out = outputs[0]
        if out is not None and compute_loss and layers._loss_fn is not None:
            with torch.no_grad():
                out = layers._loss_fn(out, labels)
        return broadcast_from(out, pipe.ranks[-1], pipe, inputs.device)

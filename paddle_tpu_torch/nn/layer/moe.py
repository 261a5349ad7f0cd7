"""Mixture-of-Experts layer (counterpart of
``paddle_tpu/nn/layer/moe.py``): a dygraph wrapper over ``ops/moe.py``
with stacked expert parameters (a leading E dim).

:meth:`MoELayer.set_mesh` turns on expert parallelism over the layer's
``expert_axis`` of a ``topology.ProcessMesh``.  Each rank is then given
its rows of the global batch and routes them with the others (one
routing of the global batch, ``ops/moe.py``).  Where the axis's degree
divides the experts, the layer keeps this rank's block of them: the
experts it holds are the block of the whole draw (every rank builds the
layer from the same seed), marked ``is_distributed`` with their
``_dims_mapping``, as the tensor-parallel layers are.  The reference
holds all experts and lets GSPMD place them.  Gate jitter (in training)
takes one key, ``core.rng.next_key()``, as the reference's does; over a
mesh each rank draws its rows of the global draw (``ops/moe.py``).
"""

from __future__ import annotations

import torch

from ..initializer import Constant, Normal
from .base import Layer


class MoELayer(Layer):
    """Top-k routed mixture of expert FFNs over tokens (..., d_model).

    ``num_experts`` counts every expert (across the expert axis);
    ``top_k`` 1 is Switch, 2 GShard; ``index_dispatch`` picks the slot
    index dispatch over the one-hot masks.  ``aux_loss`` holds the
    load-balance loss of the last forward."""

    def __init__(self, d_model: int, d_hidden: int, num_experts: int,
                 top_k: int = 2, capacity_factor: float = 1.25,
                 expert_axis: str = "data", gate_jitter: bool = False,
                 activation=None, index_dispatch: bool = True, name=None):
        super().__init__()
        from ...ops.moe import gelu
        self.d_model, self.d_hidden = d_model, d_hidden
        self.num_experts, self.top_k = num_experts, top_k
        self.capacity_factor = capacity_factor
        self.expert_axis = expert_axis
        self.gate_jitter = gate_jitter
        self.activation = activation or gelu
        self.index_dispatch = index_dispatch
        self._mesh = None
        E, H, I = num_experts, d_model, d_hidden
        init = Normal(0.0, 0.02)
        self.gate_weight = self.create_parameter([H, E],
                                                 default_initializer=init)
        self.expert_w1 = self.create_parameter([E, H, I],
                                               default_initializer=init)
        self.expert_b1 = self.create_parameter(
            [E, I], default_initializer=Constant(0.0))
        self.expert_w2 = self.create_parameter([E, I, H],
                                               default_initializer=init)
        self.expert_b2 = self.create_parameter(
            [E, H], default_initializer=Constant(0.0))
        self.aux_loss = None

    def set_mesh(self, mesh):
        """Expert parallelism over ``self.expert_axis`` of ``mesh``: where
        the axis's degree divides the experts, keep this rank's block of
        them (module docstring)."""
        from ...distributed.sharding_rules import PartitionSpec, local_shard
        self._mesh = mesh
        R = dict(mesh.shape).get(self.expert_axis, 1)
        if R > 1 and self.num_experts % R == 0 and \
                self.expert_w1.shape[0] == self.num_experts:
            spec = PartitionSpec(self.expert_axis)
            for n in ("expert_w1", "expert_b1", "expert_w2", "expert_b2"):
                p = getattr(self, n)
                blk = torch.nn.Parameter(local_shard(p.detach(), spec, mesh),
                                         requires_grad=p.requires_grad)
                blk.is_distributed = True
                blk._dims_mapping = {0: self.expert_axis}
                setattr(self, n, blk)
        return self

    def forward(self, x):
        from ...core import rng
        from ...ops.moe import moe_ffn, moe_ffn_indices
        jitter_key = rng.next_key() if (self.gate_jitter and
                                        self.training) else None
        ffn = moe_ffn_indices if self.index_dispatch else moe_ffn
        shape = x.shape
        out, aux = ffn(x.reshape(-1, self.d_model), self.gate_weight,
                       self.expert_w1, self.expert_b1, self.expert_w2,
                       self.expert_b2, k=self.top_k,
                       capacity_factor=self.capacity_factor, mesh=self._mesh,
                       expert_axis=self.expert_axis, jitter_key=jitter_key,
                       activation=self.activation)
        self.aux_loss = aux
        return out.reshape(shape)

    def extra_repr(self):
        return (f"d_model={self.d_model}, d_hidden={self.d_hidden}, "
                f"num_experts={self.num_experts}, top_k={self.top_k}")

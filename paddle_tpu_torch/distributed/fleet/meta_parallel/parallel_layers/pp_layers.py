"""Pipeline layer description and segmentation (counterpart of
``paddle_tpu/distributed/fleet/meta_parallel/parallel_layers/pp_layers.py``;
reference: fleet/meta_parallel/parallel_layers/pp_layers.py —
LayerDesc:31, SharedLayerDesc:49, SegmentLayers:63, PipelineLayer:132).

The user declares the whole model as a list of descriptions; every pipe
rank segments it the same way and builds only its own stage's layers
(the reference's one program builds them all and places each stage's
parameters on its pipe coordinate).  A rank's parameters keep the
reference's names: ``stages.{i}`` with ``i`` a layer's position among the
list's layers, a shared layer under its first position.  A
``SharedLayerDesc`` layer is built on each stage that uses it, its
weights broadcast from the first of them, and its gradients summed over
them (``_shared_groups``; Paddle's shared-weight all-reduce).  Training
runs through ``pipeline_engine.make_pipeline_train_step``
(``PipelineParallel.train_batch``).
"""

from __future__ import annotations

import re
from typing import List

from torch import nn

from ....topology import get_hybrid_communicate_group


class LayerDesc:
    def __init__(self, layer_cls, *inputs, **kwargs):
        self.layer_cls = layer_cls
        self.inputs = inputs
        self.kwargs = kwargs
        if not (isinstance(layer_cls, type)
                and issubclass(layer_cls, nn.Module)):
            raise TypeError("layer_cls must be an nn.Module subclass")

    def build_layer(self) -> nn.Module:
        return self.layer_cls(*self.inputs, **self.kwargs)

    def __repr__(self):
        return f"LayerDesc({self.layer_cls.__name__})"


class SharedLayerDesc(LayerDesc):
    """A layer shared between stages under ``key`` (the embedding and a
    tied head).  ``forward_func(layer, x)``, when given, is how a later
    use applies it (Paddle's; the reference keeps it unread)."""

    def __init__(self, key, layer_cls, forward_func=None,
                 shared_weight_attr="weight", *inputs, **kwargs):
        super().__init__(layer_cls, *inputs, **kwargs)
        self.layer_name = key
        self.forward_func = forward_func
        self.shared_weight_attr = shared_weight_attr


class SegmentLayers:
    """Reference pp_layers.py:63: split the descriptions into
    ``num_parts`` stages, uniformly or by the count of layers whose class
    name matches ``method = "layer:<regex>"``."""

    def __init__(self, layers_desc, num_parts, method="uniform"):
        self.descs = layers_desc
        self.num_parts = num_parts
        self.method = method
        if len(layers_desc) < num_parts:
            raise ValueError("too few layers for the number of pipeline "
                             "stages")

    def do_segment(self) -> List[int]:
        if self.method == "uniform":
            return self.uniform(len(self.descs), self.num_parts)
        if self.method.startswith("layer:"):
            name = self.method.split(":", 1)[1]
            weights = [1 if re.search(name, type_name(d)) else 0
                       for d in self.descs]
            return self.segment_by_weight(weights)
        raise ValueError(f"unknown segment method {self.method}")

    @staticmethod
    def uniform(num_items, num_parts):
        result = [0]
        base = num_items // num_parts
        extra = num_items % num_parts
        for i in range(num_parts):
            result.append(result[-1] + base
                          + (1 if i >= num_parts - extra else 0))
        return result

    def segment_by_weight(self, weights):
        total = sum(weights)
        per = total / self.num_parts
        result = [0]
        acc = 0
        part = 1
        for i, w in enumerate(weights):
            acc += w
            if acc >= per * part and part < self.num_parts:
                result.append(i + 1)
                part += 1
        result.append(len(weights))
        while len(result) < self.num_parts + 1:
            result.append(len(weights))
        return result


def type_name(d):
    if isinstance(d, LayerDesc):
        return d.layer_cls.__name__
    return type(d).__name__


class PipelineLayer(nn.Module):
    """Reference pp_layers.py:132.  This rank's stage (``get_stage_id`` of
    the hybrid group, or stage 0 of one) holds its segment's layers in
    ``stages`` (an ``nn.ModuleDict`` by position) and any shared layer it
    uses; ``forward_stage(x, stage_id)`` runs it.  ``forward`` is the
    whole model, on one stage only.  ``recompute_interval`` and
    ``num_virtual_pipeline_stages`` are kept and not read, as in the
    reference."""

    def __init__(self, layers, num_stages=None, topology=None, loss_fn=None,
                 seg_method="uniform", recompute_interval=0,
                 recompute_ctx=None, num_virtual_pipeline_stages=None):
        super().__init__()
        self._layers_desc = list(layers)
        self._loss_fn = loss_fn
        self._recompute_interval = recompute_interval
        self._num_virtual_pipeline_stages = num_virtual_pipeline_stages
        hcg = get_hybrid_communicate_group()
        self._hcg = hcg
        if num_stages is None and hcg is not None:
            num_stages = hcg.get_pipe_parallel_world_size()
        self._num_stages = num_stages or 1
        self._stage_id = hcg.get_stage_id() if hcg is not None else 0
        seg = SegmentLayers(self._layers_desc, self._num_stages, seg_method)
        self.segment_parts = seg.do_segment()
        # a layer's name: its position among the list's layers, a shared
        # layer's its first one (the reference's LayerList of them all)
        pos, first, n = [], {}, 0
        for desc in self._layers_desc:
            if isinstance(desc, (LayerDesc, nn.Module)):
                pos.append(n)
                if isinstance(desc, SharedLayerDesc):
                    first.setdefault(desc.layer_name, n)
                n += 1
            else:
                pos.append(None)
        self._users = {}          # shared key -> the stages using it
        for i, desc in enumerate(self._layers_desc):
            if isinstance(desc, SharedLayerDesc):
                users = self._users.setdefault(desc.layer_name, [])
                stage = self.get_stage_from_index(i)
                if stage not in users:
                    users.append(stage)
        self.stages = nn.ModuleDict()
        self._run = []            # this stage: (callable, forward_func)
        self._shared_names = {}   # shared key -> position name
        lo, hi = (self.segment_parts[self._stage_id],
                  self.segment_parts[self._stage_id + 1])
        for i in range(lo, hi):
            desc = self._layers_desc[i]
            if isinstance(desc, SharedLayerDesc):
                name = str(first[desc.layer_name])
                if name not in self.stages:
                    self.stages[name] = desc.build_layer()
                    self._shared_names[desc.layer_name] = name
                later = first[desc.layer_name] != pos[i]
                self._run.append((self.stages[name],
                                  desc.forward_func if later else None))
            elif isinstance(desc, LayerDesc):
                self.stages[str(pos[i])] = desc.build_layer()
                self._run.append((self.stages[str(pos[i])], None))
            elif isinstance(desc, nn.Module):
                self.stages[str(pos[i])] = desc
                self._run.append((desc, None))
            else:
                self._run.append((desc, None))      # a function
        self._groups = self._build_shared_groups()

    def _build_shared_groups(self):
        """For each shared key used by more than one stage, a group over
        its stages in every pipe group (created on every rank in the same
        order); this rank's shared weights are broadcast from the first
        stage of theirs.  Returns ``[(names, Group, first)]`` for the keys
        this rank holds."""
        hcg = self._hcg
        if hcg is None or self._num_stages <= 1 or hcg.nranks <= 1:
            return []
        import torch
        import torch.distributed as dist
        from ....collective import Group, broadcast
        mine = []
        for key in sorted(self._users):
            users = sorted(self._users[key])
            if len(users) < 2:
                continue
            for pipe_ranks in hcg.topology().get_comm_list("pipe"):
                ranks = [pipe_ranks[s] for s in users]
                pg = dist.new_group(ranks) if len(ranks) < hcg.nranks \
                    else None
                if hcg.global_rank not in ranks:
                    continue
                group = Group(ranks=ranks, axis_name="pipe_shared", pg=pg)
                layer = self.stages[self._shared_names[key]]
                with torch.no_grad():
                    for p in layer.parameters():
                        broadcast(p.data, src=ranks[0], group=group)
                prefix = f"stages.{self._shared_names[key]}."
                names = [prefix + n for n, _ in layer.named_parameters()]
                mine.append((names, group, ranks[0] == hcg.global_rank))
        return mine

    def _shared_groups(self):
        return self._groups

    def get_num_stages(self):
        return self._num_stages

    @property
    def parameters_desc(self):
        return self._layers_desc

    def get_stage_from_index(self, layer_idx):
        for stage in range(self._num_stages):
            if self.segment_parts[stage] <= layer_idx < \
                    self.segment_parts[stage + 1]:
                return stage
        return self._num_stages - 1

    def stage_layers(self, stage_id):
        """This rank's stage's layers (another stage's are held by its
        own rank)."""
        self._check_stage(stage_id)
        return [fn for fn, _ in self._run if isinstance(fn, nn.Module)]

    def _check_stage(self, stage_id):
        if stage_id != self._stage_id:
            raise ValueError(f"stage {stage_id} is held by another pipe "
                             f"rank (this rank holds stage "
                             f"{self._stage_id})")

    def forward_stage(self, x, stage_id):
        self._check_stage(stage_id)
        for fn, forward_func in self._run:
            x = fn(x) if forward_func is None else forward_func(fn, x)
        return x

    def forward(self, input, chunk_id=None):
        """The whole model (one stage: every layer is on this rank)."""
        if self._num_stages > 1:
            raise ValueError("a pipe rank holds one stage: train through "
                             "PipelineParallel.train_batch, or run "
                             "forward_stage")
        return self.forward_stage(input, 0)

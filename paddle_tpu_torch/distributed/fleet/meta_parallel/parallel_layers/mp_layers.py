"""Tensor (model) parallel layers (counterpart of the reference's
``parallel_layers/mp_layers.py``; Paddle's VocabParallelEmbedding,
ColumnParallelLinear, RowParallelLinear and ParallelCrossEntropy).

The reference holds the full weight under GSPMD and the caller's shard
under ``shard_map``.  Here one process is one rank: when the active
hybrid group has a model degree above 1, a layer holds its rank's block
of the full weight (1/mp of it: the reference's ``_dims_mapping`` dim
split over the model ranks, rank r the r-th block) and its forward issues
the collectives explicitly over the model group.  Otherwise it holds the
full weight and computes the dense layer.

The initializer draws the FULL weight (from ``weight_attr``, as a layer
of the full shape would) and the layer keeps its block, so every rank
seeded alike (``seed()``: one stream) holds a block of one weight, and an
``Assign`` of the full weight gives each rank its block.  Every rank
computes the same loss (Megatron's convention): a column-parallel input
goes through ``copy_to_group`` (its gradient summed over the model
ranks), a row-parallel output through ``reduce_from_group``, and a
gathered output's gradient is split back, not summed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as TF

from .....nn.functional.common import linear
from .....nn.initializer import Constant, XavierUniform
from .....ops.loss import (vocab_parallel_lse_and_picked,
                           vocab_parallel_softmax_minus_onehot)
from .....nn.layer.base import Layer
from .... import collective as C
from ....topology import get_hybrid_communicate_group


def _mp_group(mp_group=None):
    """The model group the layers split over: ``mp_group`` if given,
    else the active hybrid group's (None when its degree is 1 or there is
    no hybrid group)."""
    g = mp_group
    if g is None:
        hcg = get_hybrid_communicate_group()
        if hcg is None or hcg.get_model_parallel_world_size() <= 1:
            return None
        g = hcg.get_model_parallel_group()
    return g if g.nranks > 1 else None


def _block_param(layer, shape, dim, group, attr, is_bias=False,
                 default_initializer=None):
    """A parameter holding this rank's block along ``dim`` of a tensor of
    the full ``shape`` drawn as the layer's own initializer draws it (the
    whole of it without a group)."""
    full = layer.create_parameter(shape, attr=attr, is_bias=is_bias,
                                  default_initializer=default_initializer)
    if group is None:
        return full
    n = group.nranks
    if shape[dim] % n:
        raise ValueError(f"dim {dim} of {list(shape)} does not split over "
                         f"{n} model ranks")
    per = shape[dim] // n
    p = torch.nn.Parameter(full.detach().narrow(dim, group.rank * per, per)
                           .clone(), requires_grad=full.requires_grad)
    p.is_distributed = True
    return p


class _GatherOutput(torch.autograd.Function):
    """All-gather along the last dim; the gradient split back (each rank
    holds the whole, replicated gradient of the one loss)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return C.all_gather_dim(x, x.dim() - 1, group)

    @staticmethod
    def backward(ctx, g):
        n = g.shape[-1] // ctx.group.nranks
        return g.narrow(-1, ctx.group.rank * n, n).contiguous(), None


def vocab_parallel_embedding(ids, weight, group):
    """Embeddings of ``ids`` from ``weight``, this rank's block of rows of
    a table split over ``group``: a masked local lookup, all-reduced."""
    per = weight.shape[0]
    local = ids.long() - group.rank * per
    valid = (local >= 0) & (local < per)
    emb = TF.embedding(local.clamp(0, per - 1), weight)
    emb = torch.where(valid[..., None], emb,
                      torch.zeros((), dtype=emb.dtype, device=emb.device))
    return C.reduce_from_group(emb, group)


class VocabParallelEmbedding(Layer):
    """Vocab-sharded embedding: rank r holds rows [r·V/mp, (r+1)·V/mp);
    a masked local lookup, then an all-reduce over the model group."""

    def __init__(self, num_embeddings, embedding_dim, weight_attr=None,
                 mp_group=None, name=None):
        super().__init__()
        self._num_embeddings = num_embeddings
        self._embedding_dim = embedding_dim
        self._group = _mp_group(mp_group)
        self.weight = _block_param(self, [num_embeddings, embedding_dim], 0,
                                   self._group, weight_attr,
                                   default_initializer=XavierUniform())
        self.weight._dims_mapping = {0: "model"}

    def forward(self, x):
        if self._group is None:
            return TF.embedding(x.long(), self.weight)
        return vocab_parallel_embedding(x, self.weight, self._group)


class ColumnParallelLinear(Layer):
    """Weight (in, out) split on the OUT dim over the model group; the
    output is this rank's columns, or all of them with
    ``gather_output``."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=None, gather_output=True, fuse_matmul_bias=False,
                 mp_group=None, name=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.gather_output = gather_output
        self._group = _mp_group(mp_group)
        self.weight = _block_param(self, [in_features, out_features], 1,
                                   self._group, weight_attr,
                                   default_initializer=XavierUniform())
        self.weight._dims_mapping = {1: "model"}
        self.weight.is_distributed = self._group is not None
        if has_bias is False:
            self.bias = None
        else:
            self.bias = _block_param(self, [out_features], 0, self._group,
                                     None, is_bias=True,
                                     default_initializer=Constant(0.0))
            self.bias._dims_mapping = {0: "model"}
            self.bias.is_distributed = self._group is not None

    def forward(self, x):
        g = self._group
        if g is not None:
            x = C.copy_to_group(x, g)
        out = linear(x, self.weight, self.bias)
        if g is not None and self.gather_output:
            out = _GatherOutput.apply(out, g)
        return out


class RowParallelLinear(Layer):
    """Weight (in, out) split on the IN dim over the model group; the
    partial products are all-reduced, then the (replicated) bias is
    added.  Without ``input_is_parallel`` the input's last dim is split
    here (its gradient gathered back)."""

    def __init__(self, in_features, out_features, weight_attr=None,
                 has_bias=True, input_is_parallel=False,
                 fuse_matmul_bias=False, mp_group=None, name=None):
        super().__init__()
        self._in_features, self._out_features = in_features, out_features
        self.input_is_parallel = input_is_parallel
        self._group = _mp_group(mp_group)
        self.weight = _block_param(self, [in_features, out_features], 0,
                                   self._group, weight_attr,
                                   default_initializer=XavierUniform())
        self.weight._dims_mapping = {0: "model"}
        self.weight.is_distributed = self._group is not None
        self.bias = (self.create_parameter([out_features], is_bias=True,
                                           default_initializer=Constant(0.0))
                     if has_bias else None)

    def forward(self, x):
        g = self._group
        if g is not None and not self.input_is_parallel:
            x = C.split_along(x, x.dim() - 1, g)
        out = linear(x, self.weight)
        if g is not None:
            out = C.reduce_from_group(out, g)
        if self.bias is not None:
            out = out + self.bias.to(out.dtype)
        return out


class _VocabParallelCE(torch.autograd.Function):
    """Per-row cross entropy of logits split over the model group along
    the class dim (``ops/loss.py``: the max, the sum of exponentials and
    the target logit all-reduced; a backward with no collective).  Rows
    labelled ``ignore_index`` give 0 and no gradient."""

    @staticmethod
    def forward(ctx, logits, label, group, ignore_index):
        lse, picked, idx, valid = vocab_parallel_lse_and_picked(
            logits, label, group)
        keep = label.long() != ignore_index
        ctx.save_for_backward(logits, lse, idx, valid, keep)
        return torch.where(keep, lse - picked,
                           torch.zeros((), device=lse.device)).to(
                               logits.dtype)

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, valid, keep = ctx.saved_tensors
        d = vocab_parallel_softmax_minus_onehot(logits, lse, idx, valid)
        d.mul_((g.float() * keep)[..., None])
        return d.to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy(logits, label, group, ignore_index=-100):
    """Per-row cross entropy (..., V/mp) logits split over ``group`` ->
    (...) losses, equal on every rank of the group."""
    return _VocabParallelCE.apply(logits, label, group, ignore_index)


class ParallelCrossEntropy(Layer):
    """Cross entropy over logits split on the class dim over the model
    group (Paddle's c_softmax_with_cross_entropy): returns (..., 1)
    per-row losses; ``ignore_index`` rows give 0."""

    def __init__(self, mp_group=None, name=None, ignore_index=-100):
        super().__init__()
        self.ignore_index = ignore_index
        self._group = _mp_group(mp_group)

    def forward(self, input, label):
        if label.dim() == input.dim():
            label = label[..., 0]
        if self._group is None:
            from .....nn.functional.loss import cross_entropy
            return cross_entropy(input, label, reduction="none",
                                 ignore_index=self.ignore_index)
        return vocab_parallel_cross_entropy(input, label, self._group,
                                            self.ignore_index)[..., None]

"""Fused softmax cross-entropy (counterpart of ``paddle_tpu/ops/loss.py``).

The logits stay in their own dtype (bf16 at training shapes) and only the
logsumexp is taken in fp32.  The backward rebuilds ``softmax - onehot``
from the saved logits and lse in one pass instead of saving fp32
log-probabilities.  There is no Pallas kernel here: plain PyTorch.

Under tensor parallelism the logits are split over the model group along
the vocabulary (rank r holds columns [r·V/mp, (r+1)·V/mp));
:func:`vocab_parallel_cross_entropy_mean` (GPT's and ERNIE-MoE's tied
head) and :func:`vocab_parallel_cross_entropy_weighted_mean` (BERT's MLM
head) are the same means over the whole vocabulary with the max, the sum
of exponentials and the target logit all-reduced over the group, and a
backward with no collective.  The full logits are never gathered.
"""

from __future__ import annotations

import torch


def _lse_and_picked(logits, labels):
    lse = torch.logsumexp(logits.float(), -1)
    picked = logits.gather(-1, labels.long()[..., None])[..., 0]
    return lse, picked.float()


def _softmax_minus_onehot(logits, labels, lse):
    """exp(logits - lse) - onehot(labels), fp32, the one-hot applied as a
    scatter of -1 (never a materialized (..., V) table)."""
    p = torch.exp(logits.float() - lse[..., None])
    idx = labels.long()[..., None]
    return p.scatter_add_(-1, idx, torch.full(idx.shape, -1.0,
                                              device=p.device))


class _CrossEntropyMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels):
        lse, picked = _lse_and_picked(logits, labels)
        ctx.save_for_backward(logits, labels, lse)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse = ctx.saved_tensors
        d = _softmax_minus_onehot(logits, labels, lse)
        return d.mul_(g / lse.numel()).to(logits.dtype), None


class _CrossEntropyWeightedMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weights):
        lse, picked = _lse_and_picked(logits, labels)
        w = weights.float()
        denom = torch.clamp(w.sum(), min=1.0)
        ctx.save_for_backward(logits, labels, lse, w, denom)
        return ((lse - picked) * w).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, labels, lse, w, denom = ctx.saved_tensors
        d = _softmax_minus_onehot(logits, labels, lse)
        scale = (g / denom) * w
        return d.mul_(scale[..., None]).to(logits.dtype), None, None


def softmax_cross_entropy_mean(logits, labels):
    """Mean CE over all leading dims.  logits (..., V) any float dtype;
    labels (...) int.  Returns a float32 scalar."""
    return _CrossEntropyMean.apply(logits, labels)


def softmax_cross_entropy_weighted_mean(logits, labels, weights):
    """Weighted-mean CE: sum(w * ce) / max(sum(w), 1) — the MLM contract
    (ignore-index positions get weight 0)."""
    return _CrossEntropyWeightedMean.apply(logits, labels, weights)


# --------------------------------------------------------------------------
# logits split over a model group along the vocabulary
# --------------------------------------------------------------------------

def vocab_parallel_lse_and_picked(logits, labels, group):
    """(lse, picked, idx, valid) of logits split over ``group`` along the
    last dim: the fp32 logsumexp over the whole vocabulary and the target
    logit (all-reduced over the group), each label's local column
    (clamped) and whether this rank holds it."""
    from ..distributed.collective import ReduceOp, all_reduce
    per = logits.shape[-1]
    x = logits.float()
    gmax = all_reduce(x.amax(-1), ReduceOp.MAX, group)
    s = all_reduce(torch.exp(x - gmax[..., None]).sum(-1), ReduceOp.SUM,
                   group)
    local = labels.long() - group.rank * per
    valid = (local >= 0) & (local < per)
    idx = local.clamp(0, per - 1)
    picked = torch.where(valid, x.gather(-1, idx[..., None])[..., 0],
                         torch.zeros((), device=x.device))
    picked = all_reduce(picked, ReduceOp.SUM, group)
    return gmax + torch.log(s), picked, idx, valid


def vocab_parallel_softmax_minus_onehot(logits, lse, idx, valid):
    """exp(logits - lse) - onehot of this rank's columns, fp32."""
    p = torch.exp(logits.float() - lse[..., None])
    return p.scatter_add_(-1, idx[..., None], -valid.to(p.dtype)[..., None])


class _VocabParallelCrossEntropyMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, group):
        lse, picked, idx, valid = vocab_parallel_lse_and_picked(
            logits, labels, group)
        ctx.save_for_backward(logits, lse, idx, valid)
        return (lse - picked).mean()

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, valid = ctx.saved_tensors
        d = vocab_parallel_softmax_minus_onehot(logits, lse, idx, valid)
        return d.mul_(g / lse.numel()).to(logits.dtype), None, None


class _VocabParallelCrossEntropyWeightedMean(torch.autograd.Function):
    @staticmethod
    def forward(ctx, logits, labels, weights, group):
        lse, picked, idx, valid = vocab_parallel_lse_and_picked(
            logits, labels, group)
        w = weights.float()
        denom = torch.clamp(w.sum(), min=1.0)
        ctx.save_for_backward(logits, lse, idx, valid, w, denom)
        return ((lse - picked) * w).sum() / denom

    @staticmethod
    def backward(ctx, g):
        logits, lse, idx, valid, w, denom = ctx.saved_tensors
        d = vocab_parallel_softmax_minus_onehot(logits, lse, idx, valid)
        scale = (g / denom) * w
        return d.mul_(scale[..., None]).to(logits.dtype), None, None, None


def vocab_parallel_cross_entropy_mean(logits, labels, group):
    """:func:`softmax_cross_entropy_mean` of logits split over ``group``
    along the vocabulary (this rank's (..., V/mp) block): the same fp32
    scalar on every rank of the group; the gradient of this rank's
    block."""
    if group.nranks <= 1:
        return softmax_cross_entropy_mean(logits, labels)
    return _VocabParallelCrossEntropyMean.apply(logits, labels, group)


def vocab_parallel_cross_entropy_weighted_mean(logits, labels, weights,
                                               group):
    """:func:`softmax_cross_entropy_weighted_mean` of logits split over
    ``group`` along the vocabulary (BERT's MLM head over model ranks): the
    same fp32 scalar on every rank of the group; the gradient of this
    rank's block."""
    if group.nranks <= 1:
        return softmax_cross_entropy_weighted_mean(logits, labels, weights)
    return _VocabParallelCrossEntropyWeightedMean.apply(logits, labels,
                                                        weights, group)

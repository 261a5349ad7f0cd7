"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``):
``cross_entropy``."""

from __future__ import annotations

import torch


def _reduce(out, reduction):
    if reduction == "mean":
        return out.mean()
    if reduction == "sum":
        return out.sum()
    return out


def cross_entropy(input, label, weight=None, ignore_index=-100,
                  reduction="mean", soft_label=False, axis=-1,
                  use_softmax=True, label_smoothing=0.0, name=None):
    """The reference's cross entropy over class axis ``axis``.

    A soft label (``soft_label``, or a float label of the logits' shape)
    gives ``-sum(label * logp)``, smoothed toward 1/k; ``weight`` is not
    read on that path.  A hard label (with or without a trailing 1 dim)
    picks ``logp``, mixes in ``label_smoothing`` times the mean ``logp``,
    scales by ``weight[label]``, and drops ``ignore_index``; its mean
    divides by the summed weights of the valid labels (by their count,
    at least 1, without ``weight``).  ``use_softmax=False`` takes the
    input as probabilities."""
    if use_softmax:
        logp = torch.log_softmax(input, dim=axis)
    else:
        logp = torch.log(torch.clamp(input, min=1e-30))
    if soft_label or (label.dim() == input.dim()
                      and label.shape == input.shape
                      and label.dtype.is_floating_point):
        tgt = label
        if label_smoothing > 0:
            tgt = ((1 - label_smoothing) * tgt
                   + label_smoothing / input.shape[axis])
        return _reduce(-(tgt * logp).sum(axis), reduction)
    lab = label
    if lab.dim() == input.dim():                  # a trailing 1 dim
        lab = lab.squeeze(axis)
    lab = lab.to(torch.int64)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    logp_last = logp.movedim(axis, -1)
    picked = torch.gather(logp_last, -1, safe.unsqueeze(-1)).squeeze(-1)
    if label_smoothing > 0:
        picked = ((1 - label_smoothing) * picked
                  + label_smoothing * logp_last.mean(-1))
    loss = -picked
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, torch.zeros_like(loss))
    if reduction == "mean":
        if weight is not None:
            denom = torch.where(valid, weight[safe],
                                torch.zeros_like(loss)).sum()
        else:
            denom = torch.clamp(valid.to(loss.dtype).sum(), min=1.0)
        return loss.sum() / denom
    if reduction == "sum":
        return loss.sum()
    return loss


__all__ = ["cross_entropy"]

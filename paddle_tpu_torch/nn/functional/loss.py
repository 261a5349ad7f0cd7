"""Loss functionals (counterpart of ``paddle_tpu/nn/functional/loss.py``),
each the reference's formula: ``cross_entropy`` and
``softmax_with_cross_entropy``, ``nll_loss``, the regression, margin and
embedding losses, ``binary_cross_entropy(_with_logits)``, ``kl_div``,
``sigmoid_focal_loss``, ``npair_loss``, ``dice_loss`` and ``ctc_loss``
(the reference's log-space forward recursion, step for step)."""

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


def softmax_with_cross_entropy(logits, label, soft_label=False,
                               ignore_index=-100, numeric_stable_mode=True,
                               return_softmax=False, axis=-1):
    """The unreduced cross entropy, with a trailing 1 dim for a hard
    label; ``return_softmax`` adds the softmax."""
    loss = cross_entropy(logits, label, reduction="none",
                         soft_label=soft_label, ignore_index=ignore_index,
                         axis=axis)
    if not soft_label:
        loss = loss.unsqueeze(-1)
    if return_softmax:
        return loss, torch.softmax(logits, dim=axis)
    return loss


def nll_loss(input, label, weight=None, ignore_index=-100, reduction="mean",
             name=None):
    """``-input[n, label[n]]`` (class axis 1), weighted by
    ``weight[label]``, ``ignore_index`` dropped; the mean divides by the
    summed weights of the valid labels (their count without ``weight``),
    at least 1e-12."""
    lab = label.to(torch.int64)
    valid = lab != ignore_index
    safe = torch.where(valid, lab, torch.zeros_like(lab))
    loss = -torch.gather(input, 1, safe.unsqueeze(1)).squeeze(1)
    zero = torch.zeros((), dtype=loss.dtype, device=loss.device)
    if weight is not None:
        loss = loss * weight[safe]
    loss = torch.where(valid, loss, zero)
    if reduction == "mean":
        w = weight[safe] if weight is not None else torch.ones_like(loss)
        denom = torch.where(valid, w, zero).sum()
        return loss.sum() / torch.clamp(denom, min=1e-12)
    if reduction == "sum":
        return loss.sum()
    return loss


def mse_loss(input, label, reduction="mean", name=None):
    return _reduce(torch.square(input - label), reduction)


def l1_loss(input, label, reduction="mean", name=None):
    return _reduce((input - label).abs(), reduction)


def smooth_l1_loss(input, label, reduction="mean", delta=1.0, name=None):
    d = (input - label).abs()
    loss = torch.where(d < delta, 0.5 * d * d, delta * (d - 0.5 * delta))
    return _reduce(loss, reduction)


def binary_cross_entropy(input, label, weight=None, reduction="mean",
                         name=None):
    """On probabilities clipped to [1e-12, 1 - 1e-7]."""
    p = torch.clamp(input, 1e-12, 1.0 - 1e-7)
    loss = -(label * torch.log(p) + (1 - label) * torch.log1p(-p))
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def binary_cross_entropy_with_logits(logit, label, weight=None,
                                     reduction="mean", pos_weight=None,
                                     name=None):
    """``(1 - y) z + w_pos (log1p(exp(-|z|)) + max(-z, 0))``, ``w_pos`` =
    ``(pos_weight - 1) y + 1`` (1 without ``pos_weight``)."""
    max_val = torch.clamp(-logit, min=0.0)
    soft = torch.log1p(torch.exp(-logit.abs())) + max_val
    if pos_weight is not None:
        soft = ((pos_weight - 1) * label + 1) * soft
    loss = (1 - label) * logit + soft
    if weight is not None:
        loss = loss * weight
    return _reduce(loss, reduction)


def kl_div(input, label, reduction="mean", name=None):
    """``label * (log(label) - input)`` (``input`` log-probabilities;
    ``batchmean`` divides the sum by dim 0)."""
    loss = label * (torch.log(torch.clamp(label, min=1e-30)) - input)
    if reduction == "batchmean":
        return loss.sum() / input.shape[0]
    return _reduce(loss, reduction)


def margin_ranking_loss(input, other, label, margin=0.0, reduction="mean",
                        name=None):
    return _reduce(torch.clamp(-label * (input - other) + margin, min=0.0),
                   reduction)


def hinge_embedding_loss(input, label, margin=1.0, reduction="mean",
                         name=None):
    return _reduce(torch.where(label == 1, input,
                               torch.clamp(margin - input, min=0.0)),
                   reduction)


def cosine_embedding_loss(input1, input2, label, margin=0.0, reduction="mean",
                          name=None):
    cos = (input1 * input2).sum(-1) / torch.clamp(
        torch.linalg.vector_norm(input1, dim=-1)
        * torch.linalg.vector_norm(input2, dim=-1), min=1e-12)
    loss = torch.where(label == 1, 1 - cos, torch.clamp(cos - margin,
                                                        min=0.0))
    return _reduce(loss, reduction)


def triplet_margin_loss(input, positive, negative, margin=1.0, p=2.0,
                        epsilon=1e-6, swap=False, reduction="mean",
                        name=None):
    dp = torch.linalg.vector_norm(input - positive + epsilon, ord=p, dim=-1)
    dn = torch.linalg.vector_norm(input - negative + epsilon, ord=p, dim=-1)
    if swap:
        dn = torch.minimum(dn, torch.linalg.vector_norm(
            positive - negative + epsilon, ord=p, dim=-1))
    return _reduce(torch.clamp(dp - dn + margin, min=0.0), reduction)


def log_loss(input, label, epsilon=1e-4, name=None):
    return (-label * torch.log(input + epsilon)
            - (1 - label) * torch.log(1 - input + epsilon))


def square_error_cost(input, label):
    return torch.square(input - label)


def sigmoid_focal_loss(logit, label, normalizer=None, alpha=0.25, gamma=2.0,
                       reduction="sum", name=None):
    p = torch.sigmoid(logit)
    ce = (torch.clamp(logit, min=0) - logit * label
          + torch.log1p(torch.exp(-logit.abs())))
    p_t = p * label + (1 - p) * (1 - label)
    loss = ce * ((1 - p_t) ** gamma)
    if alpha >= 0:
        loss = (alpha * label + (1 - alpha) * (1 - label)) * loss
    if normalizer is not None:
        loss = loss / normalizer
    return _reduce(loss, reduction)


def ctc_loss(log_probs, labels, input_lengths, label_lengths, blank=0,
             reduction="mean", norm_by_times=False):
    """CTC of raw (T, B, C) logits (log-softmaxed here, as the
    reference does) against padded ``labels`` (B, L): the forward
    recursion over the extended labels (blank, l1, blank, ..., blank) in
    log space with a -1e30 floor, frames past a row's input length
    holding its alphas.  ``mean`` is the batch mean of each loss divided
    by its label length (at least 1); ``norm_by_times`` is accepted and
    not read, as in the reference."""
    lp = torch.log_softmax(log_probs, dim=-1)
    T, B, _ = lp.shape
    L = labels.shape[1]
    S = 2 * L + 1
    dev, dt = lp.device, lp.dtype
    neg = torch.full((), -1e30, dtype=dt, device=dev)
    lab = labels.to(torch.int64)
    lab_len = label_lengths.to(torch.int64)
    in_len = input_lengths.to(torch.int64)
    ext = torch.full((B, S), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = lab
    rows = torch.arange(B, device=dev)
    alpha = torch.full((B, S), -1e30, dtype=dt, device=dev)
    alpha[:, 0] = lp[0, rows, blank]
    alpha[:, 1] = torch.where(lab_len > 0, lp[0, rows, ext[:, 1]], neg)
    same = torch.cat([torch.zeros(B, 2, dtype=torch.bool, device=dev),
                      ext[:, 2:] == ext[:, :-2]], 1)
    no_skip = same | (torch.arange(S, device=dev) % 2 == 0)[None, :]
    pad1 = torch.full((B, 1), -1e30, dtype=dt, device=dev)
    pad2 = torch.full((B, 2), -1e30, dtype=dt, device=dev)
    zero = torch.zeros((), dtype=dt, device=dev)
    for t in range(1, T):
        a2 = torch.cat([pad1, alpha[:, :-1]], 1)
        a3 = torch.where(no_skip, neg, torch.cat([pad2, alpha[:, :-2]], 1))
        m = torch.maximum(torch.maximum(alpha, a2), a3)
        ms = torch.where(m == neg, zero, m)
        tot = (torch.exp(alpha - ms) + torch.exp(a2 - ms)
               + torch.exp(a3 - ms))
        new = torch.where(m == neg, neg, ms + torch.log(tot))
        new = new + torch.gather(lp[t], 1, ext)
        alpha = torch.where((t < in_len)[:, None], new, alpha)
    end1 = alpha[rows, 2 * lab_len]
    end2 = alpha[rows, torch.clamp(2 * lab_len - 1, min=0)]
    m = torch.maximum(end1, end2)
    ms = torch.where(m == neg, zero, m)
    loss = -(ms + torch.log(torch.exp(end1 - ms) + torch.exp(end2 - ms)))
    if reduction == "mean":
        return (loss / torch.clamp(lab_len.to(dt), min=1.0)).mean()
    if reduction == "sum":
        return loss.sum()
    return loss


def npair_loss(anchor, positive, labels, l2_reg=0.002):
    sim = anchor @ positive.T
    y = labels.reshape(-1, 1)
    tgt = (y == y.T).to(anchor.dtype)
    tgt = tgt / tgt.sum(1, keepdim=True)
    xent = (-tgt * torch.log_softmax(sim, dim=1)).sum(1).mean()
    reg = l2_reg * ((anchor * anchor).sum(1).mean()
                    + (positive * positive).sum(1).mean()) * 0.25
    return xent + reg


def dice_loss(input, label, epsilon=1e-5, name=None):
    """``1 - 2 |A n B| / (|A| + |B| + eps)``, the batch mean; ``label``
    holds class ids with a trailing 1 dim."""
    classes = torch.arange(input.shape[-1], device=input.device)
    y1 = (label.squeeze(-1).unsqueeze(-1) == classes).to(input.dtype)
    dims = tuple(range(1, input.dim()))
    inter = 2 * (input * y1).sum(dims)
    union = input.sum(dims) + y1.sum(dims)
    return (1 - inter / (union + epsilon)).mean()


__all__ = ["binary_cross_entropy", "binary_cross_entropy_with_logits",
           "cosine_embedding_loss", "cross_entropy", "ctc_loss", "dice_loss",
           "hinge_embedding_loss", "kl_div", "l1_loss", "log_loss",
           "margin_ranking_loss", "mse_loss", "nll_loss", "npair_loss",
           "sigmoid_focal_loss", "smooth_l1_loss",
           "softmax_with_cross_entropy", "square_error_cost",
           "triplet_margin_loss"]

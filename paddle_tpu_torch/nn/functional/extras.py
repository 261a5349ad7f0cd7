"""Functionals of ``paddle_tpu/nn/functional/extras.py`` that the port
has: ``max_unpool2d``, the inverse of ``max_pool2d(return_mask=True)``,
``zeropad2d``, the in-place ``elu_``/``tanh_``, ``class_center_sample``
(one uniform draw from ``core.rng``, the reference's) and ``gather_tree``
(the beam backtrace); ``hsigmoid_loss`` and ``margin_cross_entropy`` wait
for ROADMAP A8b-1's next slice."""

from __future__ import annotations

import torch

from ...core import rng


def _pair(v):
    return (v, v) if isinstance(v, int) else tuple(v)


def max_unpool2d(x, indices, kernel_size, stride=None, padding=0,
                 data_format="NCHW", output_size=None, name=None):
    """Scatter each pooled value of ``x`` (N, C, H, W) back to its
    argmax position (``indices``: flattened input-spatial ids, as
    ``max_pool2d(return_mask=True)`` gives them) in a zero (N, C, Ho, Wo)
    map, ``Ho = (H - 1) * stride - 2 * padding + kernel`` unless
    ``output_size`` names it.  NCHW only, as in the reference."""
    if data_format != "NCHW":
        raise ValueError("max_unpool2d supports NCHW only")
    ks = _pair(kernel_size)
    st = ks if stride is None else _pair(stride)
    pd = _pair(padding)
    n, c, h, w = x.shape
    if output_size is not None:
        ho, wo = output_size[-2:]
    else:
        ho = (h - 1) * st[0] - 2 * pd[0] + ks[0]
        wo = (w - 1) * st[1] - 2 * pd[1] + ks[1]
    flat = torch.zeros((n, c, ho * wo), dtype=x.dtype, device=x.device)
    ids = indices.reshape(n, c, h * w).to(torch.int64)
    return flat.scatter(2, ids, x.reshape(n, c, h * w)).reshape(n, c, ho, wo)


def zeropad2d(x, padding, data_format="NCHW", name=None):
    """Zero-pad H and W; ``padding`` = [left, right, top, bottom]."""
    l, r, t, b = padding
    if data_format == "NCHW":
        return torch.nn.functional.pad(x, (l, r, t, b))
    return torch.nn.functional.pad(x, (0, 0, l, r, t, b))


def elu_(x, alpha=1.0, name=None):
    return torch.nn.functional.elu_(x, alpha)


def tanh_(x, name=None):
    return torch.tanh_(x)


def class_center_sample(label, num_classes, num_samples, group=None):
    """PartialFC's class sampling: every class in ``label`` and uniformly
    drawn others, ``num_samples`` in all.  Classes are ranked by a uniform
    draw over ``num_classes`` (the positives shifted below the rest), the
    first ``num_samples`` of a stable argsort kept and sorted.  Returns
    (each label's position among the sampled, the sampled class ids),
    int64."""
    if group is not None:
        raise ValueError("explicit process groups are not used here, as in "
                         "the reference")
    if num_samples > num_classes:
        raise ValueError(f"num_samples ({num_samples}) cannot exceed "
                         f"num_classes ({num_classes})")
    key = rng.next_key()
    lbl = label.reshape(-1).long()
    pos = torch.zeros(num_classes, dtype=torch.bool, device=lbl.device)
    pos[lbl] = True
    noise = rng.uniform(key, (num_classes,), torch.float32,
                        device=lbl.device)
    rank = torch.where(pos, noise - 1.0, noise)
    order = torch.sort(rank, stable=True).indices
    sampled = torch.sort(order[:num_samples]).values
    inv = torch.full((num_classes,), -1, dtype=torch.int64,
                     device=lbl.device)
    inv[sampled] = torch.arange(num_samples, device=lbl.device)
    return inv[lbl], sampled


def gather_tree(ids, parents):
    """The full beam paths from per-step ``ids`` and ``parents`` (T, B,
    K): from the last step back, step t's id of the beam its successor
    came from.  Keeps ``ids``' dtype."""
    T, B, K = ids.shape
    par = parents.long()
    rows = torch.arange(B, device=ids.device)[:, None]
    beam = torch.arange(K, device=ids.device).expand(B, K)
    out = []
    for t in range(T - 1, -1, -1):
        out.append(ids[t][rows, beam])
        beam = par[t][rows, beam]
    return torch.stack(out[::-1])


__all__ = ["max_unpool2d", "zeropad2d", "elu_", "tanh_",
           "class_center_sample", "gather_tree"]

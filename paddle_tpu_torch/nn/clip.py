"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

Each clip has an eager form, ``_clip_eager(params, grads)`` over a dict of
gradients keyed by parameter id (``Optimizer.step``), and a dict form,
``_clip_pytree(grads)`` over named gradients (``Optimizer.update``); both
compute the same over the dict's values.  A None gradient passes
through.  Norms are taken in fp32 and each clipped
gradient is cast back to its own dtype; nothing is read on the host.

``_clip_shards(grads, split, group)`` is the dict form over gradients of
which those named in ``split`` are this rank's shards over ``group``
(ZeRO's layout, ``distributed/spmd.py``): a norm sums their squares over
the group, so the clip sees whole tensors.
"""

from __future__ import annotations

import torch


def _map(fn, grads: dict) -> dict:
    return {k: (None if g is None else fn(g)) for k, g in grads.items()}


def _sq(g):
    """The fp32 sum of ``g``'s squares."""
    return torch.sum(torch.square(g.float()))


class ClipGradBase:
    def _clip_eager(self, params, grads: dict) -> dict:
        return self._clip_pytree(grads)

    def _clip_pytree(self, grads):
        raise NotImplementedError

    def _clip_shards(self, grads, split, group):
        """An elementwise clip is the same on a shard."""
        return self._clip_pytree(grads)

    def __call__(self, params_grads):
        """The static-graph ``[(param, grad)]`` interface: returned as
        given, as in the reference."""
        return list(params_grads)


class ClipGradByValue(ClipGradBase):
    def __init__(self, max, min=None):
        self.max = float(max)
        self.min = float(min) if min is not None else -self.max

    def _clip_pytree(self, grads):
        return _map(lambda g: torch.clamp(g, self.min, self.max), grads)


class ClipGradByNorm(ClipGradBase):
    """Per-tensor norm clip."""

    def __init__(self, clip_norm):
        self.clip_norm = float(clip_norm)

    def _one(self, g, sq=None):
        """``g`` clipped by the norm whose square is ``sq`` (its own by
        default)."""
        g32 = g.float()
        norm = torch.sqrt(_sq(g32) if sq is None else sq)
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g32 * scale).to(g.dtype)

    def _clip_pytree(self, grads):
        return _map(self._one, grads)

    def _clip_shards(self, grads, split, group):
        from ..distributed.collective import ReduceOp, all_reduce
        names = sorted(split)
        part = torch.stack([_sq(grads[n]) for n in names])
        all_reduce(part, ReduceOp.SUM, group)
        whole = dict(zip(names, part))
        return {n: (None if g is None else self._one(g, whole.get(n)))
                for n, g in grads.items()}


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``.
    ``axes`` (mesh axis names, set by ``fleet.distributed_optimizer`` as
    the reference's ``HybridParallelClipGrad``): the squared norm is summed
    over each axis's process group of the active hybrid group."""

    def __init__(self, clip_norm, group_name="default_group", axes=None):
        self.clip_norm = float(clip_norm)
        self.axes = axes

    def _reduce_axes(self, sq):
        """``sq`` summed over the ``axes`` groups (in place; the identity
        without axes or a hybrid group)."""
        if not self.axes:
            return sq
        from ..distributed.collective import ReduceOp, all_reduce
        from ..distributed.topology import get_hybrid_communicate_group
        hcg = get_hybrid_communicate_group()
        if hcg is None:
            return sq
        for ax in self.axes:
            all_reduce(sq, ReduceOp.SUM, hcg.mesh.axis_group(ax))
        return sq

    def _scaled(self, grads, sq):
        """Every gradient scaled by the global norm whose square is
        ``sq`` (summed over the ``axes`` groups first)."""
        sq = self._reduce_axes(sq)
        scale = self.clip_norm / torch.clamp(torch.sqrt(sq),
                                             min=self.clip_norm)
        return _map(lambda g: (g.float() * scale).to(g.dtype), grads)

    def _clip_pytree(self, grads):
        leaves = [g for g in grads.values() if g is not None]
        if not leaves:
            return grads
        return self._scaled(grads, sum(_sq(g) for g in leaves))

    def _clip_shards(self, grads, split, group):
        from ..distributed.collective import ReduceOp, all_reduce
        part = sum(_sq(g) for n, g in grads.items() if n in split)
        all_reduce(part, ReduceOp.SUM, group)
        return self._scaled(grads, part + sum(
            (_sq(g) for n, g in grads.items()
             if n not in split and g is not None),
            torch.zeros((), device=part.device)))

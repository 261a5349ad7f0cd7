"""Gradient clipping (counterpart of ``paddle_tpu/nn/clip.py``):
``ClipGradByValue``, ``ClipGradByNorm`` and ``ClipGradByGlobalNorm``.

Each clip has an eager form, ``_clip_eager(params, grads)`` over a dict of
gradients keyed by parameter id (``Optimizer.step``), and a dict form,
``_clip_pytree(grads)`` over named gradients (``Optimizer.update``); both
compute the same over the dict's values.  A None gradient passes
through.  Norms are taken in fp32 and each clipped
gradient is cast back to its own dtype; nothing is read on the host.
"""

from __future__ import annotations

import torch


def _map(fn, grads: dict) -> dict:
    return {k: (None if g is None else fn(g)) for k, g in grads.items()}


class ClipGradBase:
    def _clip_eager(self, params, grads: dict) -> dict:
        return self._clip_pytree(grads)

    def _clip_pytree(self, grads):
        raise NotImplementedError

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

    def _one(self, g):
        g32 = g.float()
        norm = torch.sqrt(torch.sum(torch.square(g32)))
        scale = torch.clamp(self.clip_norm / torch.clamp(norm, min=1e-12),
                            max=1.0)
        return (g32 * scale).to(g.dtype)

    def _clip_pytree(self, grads):
        return _map(self._one, grads)


class ClipGradByGlobalNorm(ClipGradBase):
    """Scale every gradient by ``clip_norm / max(global_norm, clip_norm)``.
    ``axes`` (the mesh axes the reference sums the squared norm over)
    raises: a mesh is the distributed slice of the port (ROADMAP A7)."""

    def __init__(self, clip_norm, group_name="default_group", axes=None):
        if axes:
            raise NotImplementedError(
                "ClipGradByGlobalNorm(axes=...) reduces the norm over mesh "
                "axes: the distributed slice of the port (ROADMAP A7)")
        self.clip_norm = float(clip_norm)
        self.axes = axes

    def _clip_pytree(self, grads):
        leaves = [g for g in grads.values() if g is not None]
        if not leaves:
            return grads
        sq = sum(torch.sum(torch.square(g.float())) for g in leaves)
        scale = self.clip_norm / torch.clamp(torch.sqrt(sq),
                                             min=self.clip_norm)
        return _map(lambda g: (g.float() * scale).to(g.dtype), grads)

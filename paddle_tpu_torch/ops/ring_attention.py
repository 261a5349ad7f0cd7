"""Sequence (context) parallel attention: ring attention and Ulysses
(counterpart of ``paddle_tpu/ops/ring_attention.py``).

The sequence is split over the ranks of a group (the hybrid group's
``sep`` axis): rank r holds positions [r·Lc, (r+1)·Lc) of q, k and v,
each (B, Lc, H, D).

- :func:`ring_attention`: the K/V blocks travel around the ring (one
  ``collective.ring_exchange`` a hop) while each rank accumulates its
  queries' online-softmax partials in fp32; with ``causal`` a block
  wholly in a rank's future is skipped (it still travels on).  The
  backward is the reference's hand-written ring (``:136-212``): the
  blocks travel again, each rank accumulates its dQ, dK and dV travel
  with their block, and one last hop returns them to their owner.  A
  rank holds O(L/sp) in both directions.  Its blocks are plain PyTorch,
  as the reference's are plain ``jnp``.
- :func:`ulysses_attention`: an all-to-all swaps the split from the
  sequence to the heads, the port's ``flash_attention`` (the B2–B4
  kernels on a card) runs over the whole sequence with H/sp heads, and
  the inverse all-to-all swaps back.
- :func:`sequence_parallel_attention` dispatches between the two.

The group is ``group``, else the active hybrid group's ``axis_name``
axis (a one-rank group without one: the whole sequence on this rank).
"""

from __future__ import annotations

import math
from functools import partial

import torch

from ..distributed import collective as C

_NEG_INF = -1e30


def _group(group, axis_name):
    if group is not None:
        return group
    from ..distributed.topology import get_hybrid_communicate_group
    hcg = get_hybrid_communicate_group()
    if hcg is None:
        return C.Group(ranks=[C.env.get_rank()], axis_name=axis_name)
    return hcg.mesh.axis_group(axis_name)


def _local_scores(q, k, scale):
    """q (B, Lq, H, D), k (B, Lk, H, D) -> (B, H, Lq, Lk) fp32 scores."""
    return torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale


def _masked(s, idx, blk_idx, causal):
    """``s`` with the keys of block ``blk_idx`` after each query of block
    ``idx`` (global positions) set to -1e30."""
    if not causal:
        return s
    Lc = s.shape[-1]
    pos = torch.arange(Lc, device=s.device)
    keep = (blk_idx * Lc + pos)[None, :] <= (idx * Lc + pos)[:, None]
    return torch.where(keep, s, torch.full((), _NEG_INF, device=s.device))


def _ring_fwd(q, k, v, group, causal, scale):
    """One full ring: (out fp32 (B, H, Lc, D), lse (B, H, Lc, 1))."""
    B, Lc, H, D = q.shape
    sp, idx = group.nranks, max(group.rank, 0)
    m = torch.full((B, H, Lc, 1), _NEG_INF, device=q.device)
    l = torch.zeros((B, H, Lc, 1), device=q.device)
    acc = torch.zeros((B, H, Lc, D), device=q.device)
    k_blk, v_blk = k, v
    for t in range(sp):
        blk_idx = (idx - t) % sp        # the home rank of the block held
        if not (causal and blk_idx > idx):
            s = _masked(_local_scores(q, k_blk, scale), idx, blk_idx, causal)
            m_new = torch.maximum(m, s.amax(-1, keepdim=True))
            p = torch.exp(s - m_new)
            alpha = torch.exp(m - m_new)
            l = alpha * l + p.sum(-1, keepdim=True)
            acc = acc * alpha + torch.einsum("bhlm,bmhd->bhld", p,
                                             v_blk.float())
            m = m_new
        if t < sp - 1:
            k_blk, v_blk = C.ring_exchange([k_blk, v_blk], group)
    l_safe = torch.clamp(l, min=1e-30)
    return acc / l_safe, m + torch.log(l_safe)


def _ring_bwd(q, k, v, out, lse, g, group, causal, scale):
    B, Lc, H, D = q.shape
    sp, idx = group.nranks, max(group.rank, 0)
    do = g.transpose(1, 2).float()                          # (B, H, Lc, D)
    delta = (do * out).sum(-1, keepdim=True)
    qf = q.float()
    dq = torch.zeros((B, Lc, H, D), device=q.device)
    dk_blk = torch.zeros((B, Lc, H, D), device=q.device)
    dv_blk = torch.zeros((B, Lc, H, D), device=q.device)
    k_blk, v_blk = k, v
    for t in range(sp):
        blk_idx = (idx - t) % sp
        if not (causal and blk_idx > idx):
            s = _masked(_local_scores(q, k_blk, scale), idx, blk_idx, causal)
            p = torch.exp(s - lse)
            dv_blk = dv_blk + torch.einsum("bhlm,bhld->bmhd", p, do)
            dp = torch.einsum("bhld,bmhd->bhlm", do, v_blk.float())
            ds = p * (dp - delta) * scale
            dq = dq + torch.einsum("bhlm,bmhd->blhd", ds, k_blk.float())
            dk_blk = dk_blk + torch.einsum("bhlm,blhd->bmhd", ds, qf)
        if t < sp - 1:
            k_blk, v_blk, dk_blk, dv_blk = C.ring_exchange(
                [k_blk, v_blk, dk_blk, dv_blk], group)
    if sp > 1:
        # block j rests on rank j-1 after sp-1 hops: one more sends every
        # dK/dV home
        dk_blk, dv_blk = C.ring_exchange([dk_blk, dv_blk], group)
    return dq.to(q.dtype), dk_blk.to(k.dtype), dv_blk.to(v.dtype)


class _RingAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, group, causal, scale):
        out, lse = _ring_fwd(q, k, v, group, causal, scale)
        # saved: the inputs, the output and the softmax statistics, O(L/sp)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (group, causal, scale)
        return out.transpose(1, 2).to(q.dtype)               # (B, Lc, H, D)

    @staticmethod
    def backward(ctx, g):
        q, k, v, out, lse = ctx.saved_tensors
        return (*_ring_bwd(q, k, v, out, lse, g, *ctx.args), None, None,
                None)


def ring_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                   scale=None, group=None):
    """Ring attention over sequence shards: q, k, v this rank's
    (B, Lc, H, D) blocks, the global sequence their concatenation in
    group order; ``causal`` masks in global positions.  Returns this
    rank's output block (B, Lc, H, D) in q's dtype."""
    group = _group(group, axis_name)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if isinstance(scale, torch.Tensor):
        # a learned scale: into q, so its gradient flows through the product
        q = q * scale.to(q.dtype)
        scale = 1.0
    return _RingAttention.apply(q, k, v, group, causal, float(scale))


def ulysses_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                      scale=None, attention_fn=None, group=None):
    """Ulysses: the sequence → heads all-to-all, attention over the whole
    sequence with H/sp heads a rank (``flash_attention`` by default),
    then heads → sequence.  H must divide by the group's size."""
    from .attention import flash_attention
    group = _group(group, axis_name)
    sp, H = group.nranks, q.shape[2]
    if H % sp:
        raise ValueError(
            f"ulysses_attention needs num_heads ({H}) divisible by the "
            f"'{axis_name}' group's size ({sp}); use ring attention instead")
    if attention_fn is None:
        attention_fn = partial(flash_attention, causal=causal, scale=scale)
    qh, kh, vh = (C.all_to_all_along(t, 2, 1, group) for t in (q, k, v))
    return C.all_to_all_along(attention_fn(qh, kh, vh), 1, 2, group)


def gathered_attention(q, k, v, axis_name: str = "sep", causal: bool = False,
                       scale=None, group=None):
    """Attention over sequence shards with the whole sequence gathered on
    every rank (what the reference's GSPMD does without a
    ``sequence_parallel`` mode): q, k and v all-gathered along the
    sequence, ``flash_attention`` over it, this rank's block of the
    output kept.  Each rank holds O(L)."""
    from .attention import flash_attention
    group = _group(group, axis_name)
    Lc = q.shape[1]
    qf, kf, vf = (C.gather_along(t, 1, group) for t in (q, k, v))
    out = flash_attention(qf, kf, vf, causal=causal, scale=scale)
    return out.narrow(1, max(group.rank, 0) * Lc, Lc)


def sequence_parallel_attention(q, k, v, axis_name: str = "sep",
                                causal: bool = False, scale=None,
                                mode: str = "ring", group=None):
    """Ring (``mode="ring"``) or Ulysses (``"ulysses"``) attention over
    the sequence shards."""
    if mode == "ulysses":
        return ulysses_attention(q, k, v, axis_name, causal=causal,
                                 scale=scale, group=group)
    if mode != "ring":
        raise ValueError(f"unknown sequence-parallel mode {mode!r}")
    return ring_attention(q, k, v, axis_name, causal=causal, scale=scale,
                          group=group)

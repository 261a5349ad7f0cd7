"""Mixture-of-Experts gating, capacity dispatch and expert FFNs
(counterpart of ``paddle_tpu/ops/moe.py``).  No Pallas kernel lies here:
the reference's einsums and gathers become PyTorch matmuls and index ops.

Three dispatches compute one routed FFN:

- ``moe_ffn``: GShard's one-hot (T, E, C) dispatch and combine masks;
- ``moe_ffn_indices``: the same routing as slot indices into an
  (E·C + 1, H) buffer whose last row takes the dropped tokens (training's
  path);
- ``moe_ffn_gather``: capacity-free, every token to its top k (decoding's
  path).  The reference gathers k expert weight slices per token; here
  every expert runs over every row and each row keeps its top k, so the
  shapes stay static for a CUDA graph and no (T, k, H, I) weight copy is
  made (``ROADMAP.md`` §C, ``PERF.md`` §6).

Routing is the reference's: capacity positions from a cumulative sum over
tokens in row order, first index on argmax ties, the GShard
renormalisation over all k selected probabilities (dropped ones
included), and the aux loss ``E · Σ_e mean_prob_e · routed_fraction_e /
k``.  ``jitter_key`` is a ``torch.Generator`` (uniform noise in ±1e-2 on
the logits).  A mesh with an expert axis of more than one device raises:
expert parallelism is the distributed slice of the port (ROADMAP A7b).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

gelu = partial(F.gelu, approximate="tanh")     # jax.nn.gelu's default


def _resolve_capacity(T, E, k, capacity, capacity_factor):
    if capacity is None:
        capacity = int(math.ceil(k * T / E * capacity_factor))
        capacity = max(4, -(-capacity // 4) * 4)  # a multiple of 4
    return capacity


def _check_mesh(mesh, expert_axis):
    if mesh is not None and \
            dict(getattr(mesh, "shape", {})).get(expert_axis, 1) > 1:
        raise NotImplementedError(
            "expert parallelism over a mesh axis is the distributed slice "
            "of the port (ROADMAP A7b)")


def _gating_rounds(logits, k, C, jitter_key):
    """The top-k selection loop both gating forms share.  Returns per-round
    (idx, pos, keep, gate) — idx (T,) the chosen expert, pos (T,) its slot
    in that expert's buffer, keep (T,) pos < C, gate (T,) the selected
    probability — and (probs, ce_acc, denom)."""
    T, E = logits.shape
    if jitter_key is not None:
        noise = torch.empty(logits.shape, dtype=logits.dtype,
                            device=logits.device)
        logits = logits + noise.uniform_(-1e-2, 1e-2, generator=jitter_key)
    probs = torch.softmax(logits.float(), dim=-1)                 # (T, E)
    fill = torch.zeros(E, dtype=torch.int64, device=logits.device)
    masked = probs.detach()
    ce_acc = torch.zeros(E, dtype=torch.float32, device=logits.device)
    denom = torch.zeros(T, dtype=torch.float32, device=logits.device)
    rounds = []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                        # (T,)
        onehot = F.one_hot(idx, E)                                # (T, E)
        # position of each token within its chosen expert's buffer
        pos_in_e = torch.cumsum(onehot, dim=0) - onehot
        pos = (pos_in_e * onehot).sum(-1) + fill[idx]             # (T,)
        keep = pos < C
        gate = probs.gather(-1, idx[:, None])[:, 0]
        rounds.append((idx, pos, keep, gate))
        fill = fill + (onehot * keep[:, None]).sum(0)
        ce_acc = ce_acc + onehot.float().mean(0)
        denom = denom + gate
        masked = masked.masked_fill(onehot.bool(), float("-inf"))
    return rounds, probs, ce_acc, denom


def _aux_loss(probs, ce_acc, E, k):
    return E * torch.sum(probs.mean(0) * ce_acc / k)


def topk_gating(logits, k: int = 2, capacity: Optional[int] = None,
                capacity_factor: float = 1.25, jitter_key=None):
    """Top-k gating with a static capacity C a expert (default ceil(k · T /
    E · capacity_factor), rounded up to a multiple of 4).  logits (T, E) →
    combine (T, E, C) fp32, dispatch (T, E, C) bool, aux_loss scalar."""
    T, E = logits.shape
    C = _resolve_capacity(T, E, k, capacity, capacity_factor)
    rounds, probs, ce_acc, denom = _gating_rounds(logits, k, C, jitter_key)
    dev = logits.device
    combine = torch.zeros((T, E, C), dtype=torch.float32, device=dev)
    dispatch = torch.zeros((T, E, C), dtype=torch.bool, device=dev)
    slots = torch.arange(C, device=dev)
    for idx, pos, keep, gate in rounds:
        onehot = F.one_hot(idx, E).float()
        slot = (pos[:, None] == slots).float() * keep[:, None]
        contrib = onehot[:, :, None] * slot[:, None, :]
        combine = combine + gate[:, None, None] * contrib
        dispatch = dispatch | (contrib > 0)
    if k > 1:
        # GShard renormalisation over the chosen k (k = 1 keeps the raw
        # probability, Switch's convention)
        combine = combine / torch.clamp(denom, min=1e-9)[:, None, None]
    return combine, dispatch, _aux_loss(probs, ce_acc, E, k)


def moe_dispatch(x, dispatch):
    """x (T, H), dispatch (T, E, C) → (E, C, H)."""
    return torch.einsum("th,tec->ech", x.float(),
                        dispatch.float()).to(x.dtype)


def moe_combine(expert_out, combine, dtype=None):
    """expert_out (E, C, H), combine (T, E, C) → (T, H)."""
    out = torch.einsum("ech,tec->th", expert_out.float(), combine)
    return out.to(dtype or expert_out.dtype)


def expert_ffn(expert_in, w1, b1, w2, b2, activation=gelu):
    """Each expert's FFN: expert_in (E, C, H); w1 (E, H, I); w2 (E, I, H);
    in expert_in's dtype."""
    dt = expert_in.dtype
    h = torch.bmm(expert_in, w1.to(dt)) + b1.to(dt)[:, None, :]
    return torch.bmm(activation(h), w2.to(dt)) + b2.to(dt)[:, None, :]


def moe_ffn(x, gate_w, w1, b1, w2, b2, k: int = 2,
            capacity_factor: float = 1.25, mesh=None,
            expert_axis: str = "data", jitter_key=None, activation=gelu):
    """The MoE FFN over tokens x (T, H) with the one-hot dispatch.
    Returns (out (T, H), aux_loss)."""
    _check_mesh(mesh, expert_axis)
    logits = x.float() @ gate_w.float()
    combine, dispatch, aux = topk_gating(logits, k=k,
                                         capacity_factor=capacity_factor,
                                         jitter_key=jitter_key)
    expert_out = expert_ffn(moe_dispatch(x, dispatch), w1, b1, w2, b2,
                            activation)
    return moe_combine(expert_out, combine, dtype=x.dtype), aux


def topk_gating_indices(logits, k: int = 2, capacity: Optional[int] = None,
                        capacity_factor: float = 1.25, jitter_key=None):
    """Top-k gating as slot indices.  Returns expert_idx (T, k) int32,
    slot_idx (T, k) int32 (C where the token overflowed and was dropped),
    gates (T, k) fp32 (renormalised over the selected k when k > 1, zero
    where dropped), aux_loss, and the capacity C."""
    T, E = logits.shape
    C = _resolve_capacity(T, E, k, capacity, capacity_factor)
    rounds, probs, ce_acc, denom = _gating_rounds(logits, k, C, jitter_key)
    expert_idx = torch.stack([r[0] for r in rounds], 1).to(torch.int32)
    slot_idx = torch.stack([torch.where(r[2], r[1], C) for r in rounds],
                           1).to(torch.int32)
    gates = torch.stack([torch.where(r[2], r[3], 0.0) for r in rounds], 1)
    if k > 1:
        # topk_gating's denominator: all k selected probabilities
        gates = gates / torch.clamp(denom, min=1e-9)[:, None]
    return expert_idx, slot_idx, gates, _aux_loss(probs, ce_acc, E, k), C


def moe_ffn_indices(x, gate_w, w1, b1, w2, b2, k: int = 2,
                    capacity_factor: float = 1.25, mesh=None,
                    expert_axis: str = "data", jitter_key=None,
                    activation=gelu):
    """``moe_ffn`` through slot indices: each token moves once into an
    (E·C + 1, H) buffer (row E·C takes the dropped ones and is sliced
    off), and each output row is gathered back.  Returns (out, aux)."""
    _check_mesh(mesh, expert_axis)
    T, H = x.shape
    E = gate_w.shape[-1]
    logits = x.float() @ gate_w.float()
    expert_idx, slot_idx, gates, aux, C = topk_gating_indices(
        logits, k=k, capacity_factor=capacity_factor, jitter_key=jitter_key)
    flat = torch.where(slot_idx < C, expert_idx.long() * C + slot_idx,
                       E * C).long()                              # (T, k)
    # slots are unique by construction; only the trash row takes
    # duplicate writes.  Out of place, so the backward gathers each
    # token's cotangent from its slot.
    buf = torch.zeros((E * C + 1, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat.reshape(-1),), x.repeat_interleave(k, 0))
    expert_out = expert_ffn(buf[:E * C].reshape(E, C, H), w1, b1, w2, b2,
                            activation)
    out_flat = torch.cat([expert_out.reshape(E * C, H),
                          expert_out.new_zeros((1, H))])
    picked = out_flat[flat]                                      # (T, k, H)
    return (picked.float() * gates[..., None]).sum(1).to(x.dtype), aux


def moe_ffn_gather(x, gate_w, w1, b1, w2, b2, k: int = 2,
                   activation=gelu):
    """The capacity-free MoE FFN of decoding: every token to its top k
    experts (ties by lower expert index, as ``jax.lax.top_k``), weights
    renormalised over the k when k > 1, combined in fp32.  Every expert
    runs over all T rows in x's dtype and each row keeps its k outputs: E/k
    times the reference's expert FLOPs, each expert's weights read once,
    no data-dependent shape.  Equal to ``moe_ffn_indices`` at a no-drop
    capacity up to the matmuls' summation order.  Returns the output (T,
    H) only: the aux loss is a training quantity."""
    T, H = x.shape
    dt = x.dtype
    probs = torch.softmax(x.float() @ gate_w.float(), dim=-1)     # (T, E)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[:, :k], top_e[:, :k]
    gates = (top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
             if k > 1 else top_p)
    h = activation(torch.matmul(x, w1.to(dt)) + b1.to(dt)[:, None, :])
    out = torch.matmul(h, w2.to(dt)) + b2.to(dt)[:, None, :]     # (E, T, H)
    picked = out.transpose(0, 1).gather(
        1, top_e[:, :, None].expand(T, k, H))                    # (T, k, H)
    return (picked.float() * gates[..., None]).sum(1).to(dt)

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
k``.  ``jitter_key`` is ``uint32[2]`` key data, as the reference's: the
logits take ``core.rng.uniform`` noise on [-1e-2, 1e-2) in their own
dtype, the reference's draw over the (T, E) logits bit for bit.

Over a mesh (``moe_ffn``/``moe_ffn_indices`` with ``mesh``, a
``topology.ProcessMesh``) the semantics stay GSPMD's: **one routing of the
global batch**.  Each rank holds its rows of the batch (the data ×
sharding ranks, in rank order), so its tokens are a contiguous block of
the global token order:

- ``C`` comes from the global T (this rank's T times the batch ranks);
- a round's choice does not depend on capacity, so each rank runs all k
  rounds on its own tokens; one all-gather of the per-round, per-expert
  counts ((k, E) int64 a rank) gives each rank the slots the ranks before
  it took (its offset) and ``fill``, the global kept count after each
  round, so a token's slot is its position in the global cumulative sum;
- ``ce`` (the routed fractions) comes from the gathered counts, and the
  mean probability ``me`` is summed over the batch ranks
  (``collective.sum_over_group``: every rank's loss reads it, so its
  gradient is summed too); the aux loss is ``E · Σ me · ce / k`` of the
  global means;
- experts held as this rank's block (``w1`` of ``E / R`` experts, rank j
  holding [j·E/R, (j+1)·E/R), the ``{1: "data"}`` layout) run on the
  slots of every rank: each rank fills its tokens into a zeroed (E, C, H)
  buffer at their global slots, a reduce-scatter along E over the batch
  group places each row exactly (slots are globally unique), the experts
  run on (E/R, C, H), and an all-gather returns the outputs for the
  combine, in fp32 as in the reference.  Each exchange moves E·C·H a
  rank, needs no host sync, and its backward is the other exchange;
- experts held whole (a degree that does not divide E leaves them
  replicated, as the spec rule does) run locally on the rank's own slots:
  routing stays global, and nothing is exchanged;
- gate jitter is the rank's block of rows of the reference's (T·R, E)
  draw: its counters start at the rank's index times its own T·E, an
  explicit offset (``core.rng.row_block``'s rule, which refuses a draw
  whose dim 0 is not the batch rows, is not loosened for it).

An expert axis the tokens are not split over (``model``), a sharding
degree beside a split expert axis and a sep degree raise
``NotImplementedError`` (ROADMAP A7b).
"""

from __future__ import annotations

import math
from functools import partial
from typing import Optional

import torch
import torch.nn.functional as F

from ..core import rng

gelu = partial(F.gelu, approximate="tanh")     # jax.nn.gelu's default


def _resolve_capacity(T, E, k, capacity, capacity_factor):
    if capacity is None:
        capacity = int(math.ceil(k * T / E * capacity_factor))
        capacity = max(4, -(-capacity // 4) * 4)  # a multiple of 4
    return capacity


def _check_mesh(mesh, expert_axis):
    """The group a mesh routes over (its batch ranks; None on one) and the
    group its experts split over (the expert axis's; None unless split),
    refusing what waits for ROADMAP A7b."""
    if mesh is None or getattr(mesh, "size", 1) <= 1:
        return None, None
    shape = dict(mesh.shape)
    if shape.get("sep", 1) > 1:
        raise NotImplementedError(
            "a MoE FFN over sep ranks waits for ROADMAP A7b (the global "
            "token order across sequence chunks)")
    split = shape.get(expert_axis, 1) > 1
    if split and expert_axis != "data":
        raise NotImplementedError(
            f"an expert axis the tokens are not split over "
            f"({expert_axis!r}) waits for ROADMAP A7b")
    if split and shape.get("sharding", 1) > 1:
        raise NotImplementedError(
            "a sharding degree beside a split expert axis waits for "
            "ROADMAP A7b")
    route = mesh.batch_group()[0]
    if route.nranks <= 1:
        route = None
    return route, (mesh.axis_group(expert_axis) if split else None)


def _expert_split(E, E_local, experts):
    """Whether the expert weights given are this rank's block of the E
    experts (True) or all of them (False)."""
    if E_local == E:
        return False
    if experts is None or E_local * experts.nranks != E:
        raise ValueError(f"expert weights of {E_local} experts: want all "
                         f"{E}, or a rank's block of an expert axis that "
                         f"divides them")
    return True


def jitter_noise(jitter_key, logits, group=None):
    """The gate's jitter, uniform on [-1e-2, 1e-2) in the (T, E) logits'
    dtype: over ``group`` (the batch ranks, each with T tokens) this
    rank's rows of the draw over the global (T·R, E) logits."""
    T, E = logits.shape
    offset = 0 if group is None else group.rank * T * E
    return rng.uniform(jitter_key, (T, E), logits.dtype, -1e-2, 1e-2,
                       logits.device, offset=offset)


def _gating_rounds(logits, k, C, jitter_key, group=None):
    """The top-k selection loop both gating forms share.  Returns per-round
    (idx, pos, keep, gate) — idx (T,) the chosen expert, pos (T,) its slot
    in that expert's buffer, keep (T,) pos < C, gate (T,) the selected
    probability — and (me, ce_acc, denom), ``me`` the mean probability a
    expert.  Over ``group`` (the batch ranks) the slots, ``me`` and
    ``ce_acc`` are the global batch's (module docstring)."""
    T, E = logits.shape
    dev = logits.device
    if jitter_key is not None:
        logits = logits + jitter_noise(jitter_key, logits, group)
    probs = torch.softmax(logits.float(), dim=-1)                 # (T, E)
    masked = probs.detach()
    chosen = []
    for _ in range(k):
        idx = torch.argmax(masked, dim=-1)                        # (T,)
        onehot = F.one_hot(idx, E)                                # (T, E)
        chosen.append((idx, onehot))
        masked = masked.masked_fill(onehot.bool(), float("-inf"))
    counts = torch.stack([oh.sum(0) for _, oh in chosen])         # (k, E)
    R = 1 if group is None else group.nranks
    if R > 1:
        from ..distributed.collective import all_gather_dim, sum_over_group
        every = all_gather_dim(counts[None], 0, group)            # (R, k, E)
        before, total = every[:group.rank].sum(0), every.sum(0)
        me = sum_over_group(probs.sum(0), group) / (T * R)
    else:
        before, total = torch.zeros_like(counts), counts
        me = probs.mean(0)
    fill = torch.zeros(E, dtype=torch.int64, device=dev)
    ce_acc = torch.zeros(E, dtype=torch.float32, device=dev)
    denom = torch.zeros(T, dtype=torch.float32, device=dev)
    rounds = []
    for i, (idx, onehot) in enumerate(chosen):
        # position of each token within its chosen expert's buffer: the
        # tokens before it in the global order, and the slots taken
        pos_in_e = torch.cumsum(onehot, dim=0) - onehot
        pos = (pos_in_e * onehot).sum(-1) + (fill + before[i])[idx]
        keep = pos < C
        gate = probs.gather(-1, idx[:, None])[:, 0]
        rounds.append((idx, pos, keep, gate))
        fill = fill + torch.minimum(total[i], torch.clamp(C - fill, min=0))
        ce_acc = ce_acc + total[i].float() / (T * R)
        denom = denom + gate
    return rounds, me, ce_acc, denom


def _aux_loss(me, ce_acc, E, k):
    return E * torch.sum(me * ce_acc / k)


def _global_T(T, group):
    return T if group is None else T * group.nranks


def topk_gating(logits, k: int = 2, capacity: Optional[int] = None,
                capacity_factor: float = 1.25, jitter_key=None, group=None):
    """Top-k gating with a static capacity C a expert (default ceil(k · T /
    E · capacity_factor), rounded up to a multiple of 4).  logits (T, E) →
    combine (T, E, C) fp32, dispatch (T, E, C) bool, aux_loss scalar.
    ``group``: the batch ranks whose tokens route together (T is then
    this rank's block of the global tokens; module docstring)."""
    T, E = logits.shape
    C = _resolve_capacity(_global_T(T, group), E, k, capacity,
                          capacity_factor)
    rounds, me, ce_acc, denom = _gating_rounds(logits, k, C, jitter_key,
                                               group)
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
    return combine, dispatch, _aux_loss(me, ce_acc, E, k)


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


def _to_experts(expert_in, experts):
    """(E, C, H) slots of this rank's tokens → the slots of this rank's
    experts from every rank (a reduce-scatter along E); unchanged when
    the experts are held whole."""
    if experts is None:
        return expert_in
    from ..distributed.collective import reduce_scatter_along
    return reduce_scatter_along(expert_in, 0, experts)


def _from_experts(expert_out, experts):
    """This rank's experts' outputs → every expert's (an all-gather along
    E), for the combine."""
    if experts is None:
        return expert_out
    from ..distributed.collective import gather_along
    return gather_along(expert_out, 0, experts)


def moe_ffn(x, gate_w, w1, b1, w2, b2, k: int = 2,
            capacity_factor: float = 1.25, mesh=None,
            expert_axis: str = "data", jitter_key=None, activation=gelu):
    """The MoE FFN over tokens x (T, H) with the one-hot dispatch; over
    ``mesh`` x is this rank's tokens and ``w1``… all experts or this
    rank's block of them (module docstring).  Returns (out (T, H),
    aux_loss)."""
    route, experts = _check_mesh(mesh, expert_axis)
    split = _expert_split(gate_w.shape[-1], w1.shape[0], experts)
    logits = x.float() @ gate_w.float()
    combine, dispatch, aux = topk_gating(logits, k=k,
                                         capacity_factor=capacity_factor,
                                         jitter_key=jitter_key, group=route)
    expert_in = _to_experts(moe_dispatch(x, dispatch),
                            experts if split else None)
    expert_out = expert_ffn(expert_in, w1, b1, w2, b2, activation)
    expert_out = _from_experts(expert_out, experts if split else None)
    return moe_combine(expert_out, combine, dtype=x.dtype), aux


def topk_gating_indices(logits, k: int = 2, capacity: Optional[int] = None,
                        capacity_factor: float = 1.25, jitter_key=None,
                        group=None):
    """Top-k gating as slot indices.  Returns expert_idx (T, k) int32,
    slot_idx (T, k) int32 (C where the token overflowed and was dropped),
    gates (T, k) fp32 (renormalised over the selected k when k > 1, zero
    where dropped), aux_loss, and the capacity C.  ``group`` as
    :func:`topk_gating`'s (slots are global)."""
    T, E = logits.shape
    C = _resolve_capacity(_global_T(T, group), E, k, capacity,
                          capacity_factor)
    rounds, me, ce_acc, denom = _gating_rounds(logits, k, C, jitter_key,
                                               group)
    expert_idx = torch.stack([r[0] for r in rounds], 1).to(torch.int32)
    slot_idx = torch.stack([torch.where(r[2], r[1], C) for r in rounds],
                           1).to(torch.int32)
    gates = torch.stack([torch.where(r[2], r[3], 0.0) for r in rounds], 1)
    if k > 1:
        # topk_gating's denominator: all k selected probabilities
        gates = gates / torch.clamp(denom, min=1e-9)[:, None]
    return expert_idx, slot_idx, gates, _aux_loss(me, ce_acc, E, k), C


def moe_ffn_indices(x, gate_w, w1, b1, w2, b2, k: int = 2,
                    capacity_factor: float = 1.25, mesh=None,
                    expert_axis: str = "data", jitter_key=None,
                    activation=gelu):
    """``moe_ffn`` through slot indices: each token moves once into an
    (E·C + 1, H) buffer (row E·C takes the dropped ones and is sliced
    off), and each output row is gathered back.  Over ``mesh`` as
    :func:`moe_ffn`.  Returns (out, aux)."""
    route, experts = _check_mesh(mesh, expert_axis)
    T, H = x.shape
    E = gate_w.shape[-1]
    split = _expert_split(E, w1.shape[0], experts)
    logits = x.float() @ gate_w.float()
    expert_idx, slot_idx, gates, aux, C = topk_gating_indices(
        logits, k=k, capacity_factor=capacity_factor, jitter_key=jitter_key,
        group=route)
    flat = torch.where(slot_idx < C, expert_idx.long() * C + slot_idx,
                       E * C).long()                              # (T, k)
    # slots are unique by construction; only the trash row takes
    # duplicate writes.  Out of place, so the backward gathers each
    # token's cotangent from its slot.
    buf = torch.zeros((E * C + 1, H), dtype=x.dtype, device=x.device)
    buf = buf.index_put((flat.reshape(-1),), x.repeat_interleave(k, 0))
    expert_in = _to_experts(buf[:E * C].reshape(E, C, H),
                            experts if split else None)
    expert_out = expert_ffn(expert_in, w1, b1, w2, b2, activation)
    expert_out = _from_experts(expert_out, experts if split else None)
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

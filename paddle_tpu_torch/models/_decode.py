"""KV-cache decode machinery shared by the causal LMs (a subset of
``paddle_tpu/models/_decode.py``): int8 KV quantization, the dense and
paged cache write (``write_cache``, ``PagedKV``) and attention
(``cached_attention``), the ragged pool write and attention dispatch, the
token samplers and logits processors (repetition penalty, EOS windows, the
per-row filters of the per-request sampling planes, greedy speculative
verification, the speculative acceptance-rejection rule), the
prompt/token/chunk embeddings, and generation: ``generate``,
``generate_speculative`` and ``generate_beam`` as programs (a prefill and
a step replayed in a host loop; CUDA graphs on a card) memoised on the
model, and the ``save_generate_program``/``load_generate_program``
artifact.

Unlike the JAX reference, which rebuilds arrays functionally, the cache and
pool writes here update their target IN PLACE (``index_put_``, slice
assignment) and return it: the caller owns one cache per model and never
needs the old contents back.
"""

from __future__ import annotations

import threading
import weakref
from collections import OrderedDict
from typing import Optional

import numpy as np
import torch

from ..jit import programs
from ..ops.paged_attention import paged_decode_attention

# the model-side name of the ragged attention dispatch (the Hopper kernel
# for CUDA tensors, the plain version for CPU tensors)
from ..ops.ragged_paged_attention import \
    ragged_attention_rows as ragged_attention  # noqa: F401


_NEG_INF = -1e30

#: generation signatures whose programs a model keeps.  Unlike the
#: reference's executables, a program holds device state (its caches and
#: outputs and, on a card, its graphs' pools), so the least recently used
#: beyond this many is released.
GEN_PROGRAMS_KEPT = 4


def quantize_kv(x):
    """Symmetric int8 quantization over the LAST axis (one fp32 scale per
    (…, position, head) vector).  ``torch.round`` rounds half to even, as
    ``jnp.round`` does, so the result is bit-identical to the reference."""
    x32 = x.float()
    amax = x32.abs().amax(-1)
    scale = amax.clamp_min(1e-8) / 127.0
    q = torch.round(x32 / scale[..., None]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_cache(cache, dtype):
    """``(values_int8, scales)`` → dense ``dtype`` tensor; plain tensors
    pass through."""
    if isinstance(cache, tuple):
        vals, scales = cache
        return (vals.float() * scales[..., None]).to(dtype)
    return cache


def _row_clocks(t, B, device):
    """``t`` (a Python int, a 0-d or a (B,) tensor) as a (B,) int64
    tensor of per-row cache slots."""
    if not isinstance(t, torch.Tensor):
        return torch.full((B,), int(t), dtype=torch.long, device=device)
    t = t.to(device).long()
    return t.expand(B) if t.dim() == 0 else t


class PagedKV:
    """One k-or-v cache over a BLOCK POOL + slot block table (the paged
    engine's layout, flowing through ``write_cache``/``cached_attention``
    like a dense cache).

    ``pool``: (NB+1, bs, nh, hd), or with a leading layer axis that
    ``decode_step`` slices off; block 0 is the reserved trash block.  int8
    pools are ``(values, scales)`` pairs.  ``table``: (S, C) int32 — C
    columns cover every ACTIVE row's positions; inactive rows' table rows
    must be pre-zeroed by the caller (their writes then land in trash even
    where the clamped column lookup would alias a real block)."""

    def __init__(self, pool, table):
        self.pool = pool
        self.table = table

    @property
    def block_size(self):
        # axis 1 of the PER-LAYER pool is bs for BOTH planes: the int8
        # scale plane (NB+1, bs, nh) is one rank short of the value plane
        vals = self.pool[0] if isinstance(self.pool, tuple) else self.pool
        return vals.shape[1]

    def gather(self, dtype):
        """Dense (S, C·bs, nh, hd) copy of the table-selected blocks.
        Gather FIRST, then dequantize: only the S·C selected blocks pay
        the int8→fp convert, never the whole pool."""
        tab = self.table.long()
        picked = (tuple(p[tab] for p in self.pool)
                  if isinstance(self.pool, tuple) else self.pool[tab])
        g = dequantize_cache(picked, dtype)            # (S, C, bs, nh, hd)
        return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                         + tuple(g.shape[3:]))

    def write(self, chunk, t):
        """Write a (S, kq, …) chunk at per-row positions [t, t+kq) through
        the table, in place (column lookup clamped; pre-zeroed inactive
        rows land in trash — the only place two rows may share a
        target).  Returns self."""
        if isinstance(self.pool, tuple):
            vals, scales = self.pool
            q, s = quantize_kv(chunk)
            PagedKV(vals, self.table).write(q, t)
            PagedKV(scales, self.table).write(s, t)
            return self
        bs = self.block_size
        B, kq = chunk.shape[:2]
        dev = self.pool.device
        slots = _row_clocks(t, B, dev)[:, None] \
            + torch.arange(kq, device=dev)[None, :]            # (S, kq)
        col = torch.div(slots, bs, rounding_mode="floor").clamp(
            max=self.table.shape[1] - 1)
        pb = self.table.long().gather(1, col)
        self.pool.index_put_((pb, slots % bs), chunk.to(self.pool.dtype))
        return self


def write_cache(cache, chunk, t):
    """Write a (B, kq, nh, hd) k/v chunk into the cache at slots
    [t, t+kq), in place, and return the cache: scalar ``t`` → one slice
    assignment; per-row (B,) ``t`` → a scatter (rows at different
    positions; a row whose slot lies past the cache is dropped, as the
    reference's scatter does).

    ``cache`` may be a quantized pair ``(values_int8, scales)`` — the
    chunk is quantized and both planes written — or a ``PagedKV``
    (block-pool writes through the slot table)."""
    if isinstance(cache, PagedKV):
        return cache.write(chunk, t)
    if isinstance(cache, tuple):
        vals, scales = cache
        q, s = quantize_kv(chunk)
        write_cache(vals, q, t)
        write_cache(scales, s, t)
        return cache
    B, kq = chunk.shape[:2]
    if not (isinstance(t, torch.Tensor) and t.dim() == 1):
        t = int(t)
        cache[:, t:t + kq] = chunk.to(cache.dtype)
        return cache
    rows = torch.arange(B, device=cache.device)[:, None]
    slots = t.long()[:, None] + torch.arange(kq, device=cache.device)[None]
    inside = slots < cache.shape[1]
    slots = slots.clamp(max=cache.shape[1] - 1)
    inside = inside.reshape(inside.shape + (1,) * (chunk.dim() - 2))
    new = torch.where(inside, chunk.to(cache.dtype), cache[rows, slots])
    cache.index_put_((rows, slots), new)
    return cache


def cached_attention(q, ck, cv, t, pad_lens=None):
    """Attention for new tokens written at cache slots [t, t+k) against a
    KV cache: query row i attends positions <= t + i (causal within the
    chunk, full history before it; slots beyond hold zeros or stale
    values).  q (B, k, nh, hd) — k = 1 is the plain decode step, k > 1 the
    chunk form of the segment prefill.  ``t`` is a scalar or per-row (B,);
    ``pad_lens`` (B,) additionally masks the first pad_lens[b] slots
    (left-padded prompts).

    Over a ``PagedKV`` the decode step (k = 1) on a floating-point pool
    goes to ``paged_decode_attention``, which walks the table in place;
    int8 pools and chunks densify this layer's table-selected blocks
    (``gather``) and take the dense path, as in the reference."""
    B, kq, nh, hd = q.shape
    if isinstance(ck, PagedKV):
        if kq == 1 and not isinstance(ck.pool, tuple):
            # the engines' clocks and pads are (B,) int32 already: no
            # conversion kernel per layer then
            t_vec = (t if isinstance(t, torch.Tensor)
                     and t.dtype == torch.int32 and tuple(t.shape) == (B,)
                     else _row_clocks(t, B, q.device).to(torch.int32)
                     ).contiguous()
            pad_vec = (None if pad_lens is None else
                       pad_lens.to(torch.int32).expand(B).contiguous())
            o = paged_decode_attention(q[:, 0].contiguous(), ck.pool,
                                       cv.pool, ck.table, t_vec, pad_vec)
            return o[:, None]
        ck = ck.gather(q.dtype)
        cv = cv.gather(q.dtype)
    root = torch.sqrt(torch.full((), float(hd), dtype=torch.float32,
                                 device=q.device)).to(q.dtype)
    scores = torch.einsum("bqhd,bkhd->bhqk", q, ck) / root
    row = torch.arange(kq, device=q.device)[:, None]
    col = torch.arange(ck.shape[1], device=q.device)[None, :]
    if isinstance(t, torch.Tensor) and t.dim() == 1:   # per-row slots (B,)
        mask = col[None, None] <= t.long()[:, None, None, None] \
            + row[None, None]
    else:                                              # one slot for all
        mask = (col <= int(t) + row)[None, None]
    if pad_lens is not None:
        mask = mask & (col >= pad_lens.long()[:, None])[:, None, None, :]
    neg = torch.full((), _NEG_INF, device=q.device).to(scores.dtype)
    scores = torch.where(mask, scores, neg)
    probs = torch.softmax(scores.float(), -1).to(q.dtype)
    return torch.einsum("bhqk,bkhd->bqhd", probs, cv)


def ragged_write(pool, chunk, table, row_seq, row_pos):
    """Scatter a flattened ragged chunk (T, nh, hd) into ONE layer's block
    pool, in place, at each row's (table-mapped block, offset); padding
    rows (row_pos < 0) land in the trash block 0.  int8 pools quantize the
    chunk and write both planes.  Returns the pool."""
    if isinstance(pool, tuple):
        vals, scales = pool
        q, s = quantize_kv(chunk)
        return (ragged_write(vals, q, table, row_seq, row_pos),
                ragged_write(scales, s, table, row_seq, row_pos))
    bs = pool.shape[1]
    pos = row_pos.long()
    seq = row_seq.long().clamp(0, table.shape[0] - 1)
    col = torch.div(pos, bs, rounding_mode="floor").clamp(
        0, table.shape[1] - 1)
    real = pos >= 0
    pb = torch.where(real, table[seq, col].long(), 0)
    off = torch.where(real, pos % bs, 0)
    pool.index_put_((pb, off), chunk.to(pool.dtype))
    return pool


def filter_logits(logits32, temperature, top_k, top_p):
    """Temperature → top-k → nucleus (top-p) filtering on the last axis of
    (…, V) fp32 logits."""
    logits32 = logits32 / max(temperature, 1e-6)
    neg_inf = torch.full((), float("-inf"), device=logits32.device)
    if top_k is not None:
        kth = torch.topk(logits32, top_k, -1).values[..., -1:]
        logits32 = torch.where(logits32 < kth, neg_inf, logits32)
    if top_p is not None:
        srt = torch.sort(logits32, -1, descending=True).values
        cdf = torch.cumsum(torch.softmax(srt, -1), -1)
        n_keep = (cdf < top_p).sum(-1, keepdim=True) + 1
        kth = torch.gather(srt, -1, n_keep - 1)
        logits32 = torch.where(logits32 < kth, neg_inf, logits32)
    return logits32


def apply_repetition_penalty(logits32, presence, penalty):
    """For every token already seen in the row (prompt + generated, the
    (B, V) bool ``presence`` plane), positive logits divide by the penalty
    and negative logits multiply by it — both push the token down for
    penalty > 1.  ``penalty`` is a scalar or a per-row (B,) tensor; 1.0 is
    an exact no-op."""
    if not isinstance(penalty, torch.Tensor):
        penalty = torch.full((), float(penalty), dtype=logits32.dtype,
                             device=logits32.device)
    if penalty.dim() == 1:
        penalty = penalty[:, None]
    pen = torch.where(logits32 > 0, logits32 / penalty, logits32 * penalty)
    return torch.where(presence, pen, logits32)


def seed_presence(ids, vocab_size, pad_lens=None):
    """(B, P) prompt ids → (B, V) bool presence plane for the repetition
    penalty, the first ``pad_lens[b]`` (left-pad) positions excluded; ids
    clamp into the vocabulary."""
    B, P = ids.shape
    dev = ids.device
    valid = (torch.ones((B, P), dtype=torch.int32, device=dev)
             if pad_lens is None else
             (torch.arange(P, device=dev)[None, :]
              >= pad_lens.long()[:, None]).to(torch.int32))
    seen = torch.zeros((B, vocab_size), dtype=torch.int32, device=dev)
    seen.scatter_add_(1, ids.long().clamp(0, vocab_size - 1), valid)
    return seen > 0


def suppress_eos(logits32, eos_token_id, suppress):
    """Mask the EOS column with -inf while ``suppress`` holds — a Python or
    0-d bool (one window for the whole batch) or a (B,) bool tensor
    (per-row windows, the serving engines' case).  The ``min_new_tokens``
    contract."""
    dev = logits32.device
    col = torch.arange(logits32.shape[-1], device=dev) == eos_token_id
    sup = (suppress.to(dev, torch.bool) if isinstance(suppress, torch.Tensor)
           else torch.full((), bool(suppress), device=dev))
    if sup.dim() == 0:
        sup = sup[None]
    return torch.where(sup[:, None] & col[None, :], float("-inf"), logits32)


def filter_logits_rows(logits32, temperature, top_k, top_p):
    """``filter_logits`` with PER-ROW parameters as tensors — the serving
    engines' per-request sampling planes (one code path for any mix of
    configs).

    (B, V) fp32 logits; temperature/top_p (B,) fp32, top_k (B,) int.
    Disabled encodings are exact no-ops: top_k <= 0 or > V keeps every
    token; top_p >= 2.0 is the None encoding (cdf < 2 always holds, so the
    cut sits at the global minimum and nothing is masked)."""
    neg_inf = float("-inf")
    l = logits32 / temperature.clamp_min(1e-6)[:, None]
    V = l.shape[-1]
    srt = torch.sort(l, -1, descending=True).values
    top_k = top_k.long()
    k = torch.where((top_k <= 0) | (top_k > V), V, top_k)
    kth = torch.gather(srt, -1, (k - 1)[:, None])
    l = torch.where(l < kth, neg_inf, l)
    # nucleus on the top-k-masked logits: masking only floors values below
    # kth to -inf, which keeps srt's descending order (no second sort)
    srt2 = torch.where(srt < kth, neg_inf, srt)
    cdf = torch.cumsum(torch.softmax(srt2, -1), -1)
    n_keep = (cdf < top_p[:, None]).sum(-1) + 1
    kth2 = torch.gather(srt2, -1, (n_keep.clamp(max=V) - 1)[:, None])
    return torch.where(l < kth2, neg_inf, l)


def make_row_sampler():
    """Per-row sampler over the per-request planes: ``sample(logits32 (B,
    1, V), generator, temperature, top_k, top_p, greedy)`` → (B,) int64 —
    greedy rows take the argmax, sampling rows draw from their row-filtered
    logits with ``generator``; one call serves any mixture."""
    def sample(logits32, generator, temperature, top_k, top_p, greedy):
        l = filter_logits_rows(logits32[:, -1, :], temperature, top_k,
                               top_p)
        drawn = draw_categorical(torch.softmax(l, -1), generator)
        return torch.where(greedy, torch.argmax(l, -1), drawn)
    return sample


def suppress_eos_rows(logits32, eos_ids, suppress):
    """Per-row EOS suppression for per-request windows: ``eos_ids`` (B,)
    int with -1 = this row has no EOS; ``suppress`` (B,) bool."""
    col = torch.arange(logits32.shape[-1], device=logits32.device)[None, :] \
        == eos_ids.long()[:, None]
    return torch.where(col & suppress[:, None], float("-inf"), logits32)


def greedy_verify(d, tpred, active=None):
    """The greedy speculative-acceptance rule: accept the longest prefix of
    the draft proposals ``d`` (B, K) that matches the target's argmax
    predictions ``tpred`` (B, K+1) position for position, and emit the
    target's own prediction at the first mismatch (or at the bonus
    position when everything matched) — the emitted stream equals plain
    greedy decode token for token.

    ``active`` (B,) bool masks rows whose proposals are garbage (a mixed
    spec/non-spec batch): they get ``lead`` 0, so their emitted token is
    ``tpred[:, 0]`` — plain greedy decode.

    Returns ``(lead, block)``: per-row accepted counts and the (B, K+1)
    token block whose first ``lead + 1`` entries are the round's emitted
    tokens (``d_0..d_{lead-1}``, then the replacement at ``lead``)."""
    B, K = d.shape
    lead = torch.cumprod((d == tpred[:, :K]).to(torch.int32), 1).sum(1)
    if active is not None:
        lead = torch.where(active, lead, 0)
    repl = torch.gather(tpred, 1, lead.clamp(max=K).long()[:, None])[:, 0]
    block = torch.cat([d, torch.zeros((B, 1), dtype=d.dtype,
                                      device=d.device)], 1)
    block[torch.arange(B, device=d.device), lead.long()] = repl.to(d.dtype)
    return lead, block


def speculative_accept(q_probs, p_probs, d_tokens, generator):
    """Leviathan/Chen acceptance-rejection for one speculative round: the
    emitted tokens are distributed exactly as autoregressive sampling from
    the target distributions ``p``.

    q_probs (B, K, V): the draft distributions the K proposals were drawn
    from; p_probs (B, K+1, V): the target's at the same positions plus the
    bonus position; d_tokens (B, K): the proposals.  Draws from
    ``generator`` (graph-safe: no host sync).

    Returns (lead (B,), repl (B,)): the count of accepted proposals and the
    token for position ``lead`` — drawn from the residual norm(max(p − q,
    0)) on a rejection, from the bonus distribution when all K were
    accepted."""
    B, K, V = q_probs.shape
    dev = q_probs.device
    u = torch.empty((B, K), device=dev).uniform_(generator=generator)
    d = d_tokens.long()[..., None]
    qd = q_probs.gather(-1, d)[..., 0]
    pd = p_probs[:, :K].gather(-1, d)[..., 0]
    accept = u * qd < pd                  # u < p/q without dividing by 0
    lead = torch.cumprod(accept.to(torch.int32), 1).sum(1)
    rows = torch.arange(B, device=dev)
    idx = lead.clamp(max=K - 1).long()
    resid = (p_probs[rows, idx] - q_probs[rows, idx]).clamp_min(0.0)
    resid = resid / resid.sum(-1, keepdim=True).clamp_min(1e-20)
    dist = torch.where((lead == K)[:, None], p_probs[:, K], resid)
    return lead, draw_categorical(dist.clamp_min(1e-20), generator)


def draw_categorical(probs, generator):
    """One draw a row from (B, V) probabilities: ``torch.multinomial(probs,
    1, generator=generator)[:, 0]`` written out as its own one-sample path
    computes it (argmax of ``probs / q`` with ``q ~ Exp(1)`` from
    ``generator``), the same draws without its host-side validity check,
    so the draw can sit inside a CUDA graph."""
    q = torch.empty_like(probs).exponential_(1, generator=generator)
    return torch.argmax(probs / q, -1)


def make_token_sampler(temperature, top_k, top_p, greedy):
    """Last-position sampler: ``sample(logits32 (B, 1, V), generator)`` →
    (B,) int64 tokens — argmax (first maximum on ties, as ``jnp.argmax``),
    or a categorical draw from the filtered logits with ``generator``."""
    def sample(logits32, generator=None):
        logits32 = filter_logits(logits32[:, -1, :], temperature, top_k,
                                 top_p)
        if greedy:
            return torch.argmax(logits32, -1)
        return draw_categorical(torch.softmax(logits32, -1), generator)
    return sample


def validate_sampler_args(vocab_size, top_k, top_p, greedy, generator):
    """Sampler argument validation (fail before any device work)."""
    if not greedy and generator is None:
        raise ValueError("sampling (greedy=False) requires a generator")
    if top_k is not None and not 1 <= int(top_k) <= vocab_size:
        raise ValueError(f"top_k must be in [1, vocab_size={vocab_size}], "
                         f"got {top_k}")
    if top_p is not None and not (0.0 < top_p <= 1.0):
        raise ValueError(f"top_p must be in (0, 1], got {top_p}")


class CausalDecoderMixin:
    """KV-cache generation shared by the causal LMs.  The cache is a
    static (num_layers, B, max_len, nh, hd) buffer written in place; the
    decode loop is a host loop over one step program that keeps its
    tokens and its clock on the device.

    Host-class contract: ``self.config`` (vocab_size, compute_dtype,
    max_position_embeddings, num_layers, num_attention_heads, hidden_size;
    ``kv_cache_dtype`` where the family has one), ``prefill(ids, max_len, pad_lens) -> (h, caches)``,
    ``decode_step(h, caches, t, pad_lens) -> (h, caches)``,
    ``decode_logits(h) -> fp32 (B, k, V)``, ``embed_fn(ids)`` and the
    ``wte``/``wpe`` parameters."""

    def _wpe_rows(self, pos):
        """``wpe`` rows at ``pos``, clamped into the table as the
        reference's gather clamps (an inactive slot's parked clock may
        point past it)."""
        return self.wpe[pos.long().clamp(0, self.wpe.shape[0] - 1)]

    def _prefill_embed(self, input_ids, pad_lens):
        """Embed a (left-padded) prompt: positions shift by the per-row pad
        length so real tokens get logical positions 0..n-1."""
        P = input_ids.shape[1]
        pos = torch.arange(P, device=input_ids.device)[None, :] \
            - pad_lens.long()[:, None]
        h = self.wte[input_ids.long()] + self._wpe_rows(pos)
        return h.to(getattr(torch, self.config.compute_dtype))

    @staticmethod
    def _prefill_key_mask(P, pad_lens):
        """Additive key mask for a left-padded prompt: finite -1e30 on pad
        columns (all-pad causal rows then produce garbage-but-finite values
        that nothing reads, instead of NaNs)."""
        pad = torch.arange(P, device=pad_lens.device)[None, :] \
            < pad_lens[:, None]
        return torch.where(pad, _NEG_INF, 0.0).to(torch.float32)

    @staticmethod
    def _validate_prompt_mask(prompt_mask, input_ids):
        """Eager checks on the host: shape match, LEFT padding only
        (per-row nondecreasing, last column real), at least one real token
        per row."""
        m = np.asarray(prompt_mask)
        if m.shape != tuple(input_ids.shape):
            raise ValueError(f"prompt_mask shape {m.shape} != input_ids "
                             f"shape {tuple(input_ids.shape)}")
        if not np.isin(m, (0, 1)).all():
            raise ValueError("prompt_mask must be 0/1")
        if (m.sum(axis=1) == 0).any():
            raise ValueError("prompt_mask has an all-padding row")
        if (np.diff(m.astype(np.int8), axis=1) < 0).any() or \
                not m[:, -1].all():
            raise ValueError(
                "prompt_mask must be LEFT-padded (zeros then ones; the last "
                "position must be a real token) — right-padded masks would "
                "silently generate from a pad position")

    def _embed_one(self, tok, t, pad_lens=None):
        """Embed one token per row at cache slot ``t`` (scalar or per-row
        (B,)): (B,) -> (B, 1, H).  With left-padded prompts the LOGICAL
        position is t - pad_lens[b]."""
        pos = _row_clocks(t, tok.shape[0], tok.device)
        if pad_lens is not None:
            pos = pos - pad_lens.long()
        h = self.wte[tok.long()] + self._wpe_rows(pos)
        return h[:, None, :].to(getattr(torch, self.config.compute_dtype))

    def _embed_chunk(self, toks, t0, pad_lens=None):
        """Embed a token chunk at cache slots [t0, t0+k): toks (k,) with
        scalar t0 → (1, k, H); toks (B, k) with t0 (B,) → (B, k, H).  With
        left-padded prompts logical positions shift by the per-row pad
        length, matching _embed_one/_prefill_embed."""
        dev = toks.device
        k = toks.shape[-1]
        if toks.dim() == 1:
            pos = int(t0) + torch.arange(k, device=dev)
            if pad_lens is not None:
                pos = pos - pad_lens.long()[0]
            h = (self.wte[toks.long()] + self._wpe_rows(pos))[None]
        else:
            pos = torch.as_tensor(t0, device=dev).long()[:, None] \
                + torch.arange(k, device=dev)[None, :]
            if pad_lens is not None:
                pos = pos - pad_lens.long()[:, None]
            h = self.wte[toks.long()] + self._wpe_rows(pos)
        return h.to(getattr(torch, self.config.compute_dtype))

    def init_cache(self, batch_size: int, max_len: int):
        """Zeroed (k, v) caches (num_layers, B, max_len, nh, hd) in the
        compute dtype on the model's device — or int8 ``(values, scales)``
        pairs with fp32 (num_layers, B, max_len, nh) scales."""
        c = self.config
        nh = c.num_attention_heads
        shape = (c.num_layers, batch_size, max_len, nh, c.hidden_size // nh)
        dev = self.wte.device
        if getattr(c, "kv_cache_dtype", None) == "int8":
            def one():
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=dev))
            return one(), one()
        dt = getattr(torch, c.compute_dtype)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    @torch.no_grad()
    def generate(self, input_ids, max_new_tokens: int,
                 temperature: float = 1.0, top_k: Optional[int] = None,
                 top_p: Optional[float] = None, greedy: bool = True,
                 generator: Optional[torch.Generator] = None,
                 prompt_mask=None, repetition_penalty: float = 1.0,
                 min_new_tokens: int = 0,
                 eos_token_id: Optional[int] = None):
        """Autoregressive generation with a static KV cache.

        input_ids (B, P); returns (B, max_new_tokens) int32 generated ids
        on the model's device.  greedy=True → argmax decoding; else
        temperature (+ optional top-k and/or nucleus top-p) sampling from
        ``generator`` (its state advances as if the draws were made on
        it).

        ``prompt_mask`` (B, P), 1 = real token, 0 = padding: prompts must
        be LEFT-padded (real tokens at the end).  Pad positions are
        excluded from attention and position ids shift by the per-row pad
        length.

        ``repetition_penalty`` > 1 pushes already-seen tokens (prompt +
        generated, a (B, V) presence plane) down; ``min_new_tokens`` masks
        ``eos_token_id`` for the first n emissions.  Each step runs the
        penalty, then the EOS window, then the draw, then the presence
        update.

        The work runs as two programs per (P, max_new_tokens, sampler,
        processors, B) signature, memoised on the model
        (``_gen_program``): the prefill, and one decode step replayed
        ``max_new_tokens - 1`` times with its clock on the device — on a
        card two CUDA graphs, captured at the first call; no token leaves
        the device before the end."""
        c = self.config
        dev = self.wte.device
        ids = _host_ids(input_ids)
        B, P = ids.shape
        if max_new_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=dev)
        max_len = P + max_new_tokens
        if max_len > c.max_position_embeddings:
            raise ValueError(f"P + max_new_tokens = {max_len} exceeds "
                             f"max_position_embeddings "
                             f"({c.max_position_embeddings})")
        validate_sampler_args(c.vocab_size, top_k, top_p, greedy, generator)
        _check_generator(generator, dev)
        if repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if min_new_tokens > 0 and eos_token_id is None:
            raise ValueError("min_new_tokens needs eos_token_id (it works "
                             "by suppressing EOS)")
        if eos_token_id is not None and not 0 <= eos_token_id < c.vocab_size:
            raise ValueError(f"eos_token_id {eos_token_id} outside vocab "
                             f"(size {c.vocab_size})")
        sig = (P, max_new_tokens, float(temperature),
               None if top_k is None else int(top_k),
               None if top_p is None else float(top_p), greedy,
               prompt_mask is not None, float(repetition_penalty),
               int(min_new_tokens),
               # eos shapes the program only where it suppresses
               eos_token_id if min_new_tokens > 0 else None)
        host = [ids]
        if prompt_mask is not None:
            self._validate_prompt_mask(prompt_mask, ids)
            host.append(P - np.asarray(prompt_mask, np.int64).sum(axis=1))
        with self._gen_lock():
            return self._gen_program(*sig, batch_size=B)(host, generator)

    def _gen_program(self, P, max_new_tokens, temperature, top_k, top_p,
                     greedy, masked=False, repetition_penalty=1.0,
                     min_new_tokens=0, eos_token_id=None, batch_size=1):
        """The memoised programs of one generate() signature: the
        reference's key (P, max_new_tokens, temperature, top_k, top_p,
        greedy, masked, repetition_penalty, min_new_tokens, eos_token_id)
        plus the batch size, which a CUDA graph fixes."""
        key = (P, max_new_tokens, temperature, top_k, top_p, greedy, masked,
               repetition_penalty, min_new_tokens, eos_token_id,
               int(batch_size))
        return self._memo_program(key, lambda: _GenerateRun(self, *key))

    def _gen_lock(self):
        """One generation at a time on a model: the calls of one signature
        share its run's device state."""
        return self.__dict__.setdefault("_gen_lock_", threading.Lock())

    def _memo_program(self, key, make, draft=None):
        """The memoised run of ``key`` (``make()`` builds a missing one),
        most recently used last in ``self._gen_programs``.  A run whose
        draft has died is released, and so is the least recently used
        beyond ``GEN_PROGRAMS_KEPT``.  ``draft`` is the draft model a
        speculative run must have been built for (checked by identity
        through the run's weakref, so a recycled ``id()`` never aliases a
        dead draft)."""
        progs = self.__dict__.setdefault("_gen_programs", OrderedDict())
        for k in [k for k, r in progs.items()
                  if r.draft_ref is not None and r.draft_ref() is None]:
            progs.pop(k).release()
        run = progs.get(key)
        if run is not None and (draft is None or run.draft_ref() is draft):
            progs.move_to_end(key)
            return run
        if run is not None:                  # a fresh draft replaces it
            progs.pop(key).release()
        progs[key] = run = make()
        while len(progs) > GEN_PROGRAMS_KEPT:
            progs.popitem(last=False)[1].release()
        return run

    @torch.no_grad()
    def generate_speculative(self, input_ids, max_new_tokens: int,
                             draft_model, draft_k: int = 4,
                             greedy: bool = True, temperature: float = 1.0,
                             top_k: Optional[int] = None,
                             top_p: Optional[float] = None,
                             generator: Optional[torch.Generator] = None,
                             return_rounds: bool = False):
        """Speculative decoding, lossless: greedy mode emits exactly this
        model's greedy ``generate``; sampling mode draws from exactly the
        target's filtered distribution (``speculative_accept``).

        Per round the draft proposes ``draft_k`` tokens one at a time
        (argmax, or drawn from its filtered distribution), the target
        verifies them plus a bonus position in ONE (K+1)-query chunk, and
        the draft re-ingests that chunk (its own loop never fed the last
        proposal).  Rows advance independently by ``lead + 1``, capped at
        P + N; finished rows keep writing into the slack region of a
        ``P + N + K + 1`` buffer until the slowest row completes.

        The port's models hold their own weights, so there is no
        ``params``/``draft_params`` argument.  A round is one program (a
        CUDA graph on a card); the host reads one flag a round to stop.
        Returns (B, N) int32 tokens, with ``return_rounds`` also the round
        count (a 0-d tensor)."""
        c = self.config
        dev = self.wte.device
        ids = _host_ids(input_ids)
        B, P = ids.shape
        if draft_model.config.vocab_size != c.vocab_size:
            raise ValueError(
                f"draft vocab ({draft_model.config.vocab_size}) != target "
                f"vocab ({c.vocab_size}) — speculative acceptance compares "
                f"token ids")
        if draft_model.wte.device != dev:
            raise ValueError(f"the draft lives on {draft_model.wte.device},"
                             f" the target on {dev}")
        if max_new_tokens <= 0:
            toks = torch.zeros((B, 0), dtype=torch.int32, device=dev)
            return (toks, torch.zeros((), dtype=torch.long, device=dev)) \
                if return_rounds else toks
        K = int(draft_k)
        if K < 1:
            raise ValueError(f"draft_k must be >= 1, got {draft_k}")
        need = P + max_new_tokens + K
        for m, who in ((c, "target"), (draft_model.config, "draft")):
            if need > m.max_position_embeddings:
                raise ValueError(
                    f"P + max_new_tokens + draft_k = {need} exceeds the "
                    f"{who}'s max_position_embeddings "
                    f"({m.max_position_embeddings})")
        validate_sampler_args(c.vocab_size, top_k, top_p, greedy, generator)
        _check_generator(generator, dev)
        with self._gen_lock():
            run = self._spec_program(
                draft_model, P, max_new_tokens, K, greedy,
                float(temperature), None if top_k is None else int(top_k),
                None if top_p is None else float(top_p), batch_size=B)
            toks, rounds = run([ids], generator)
        return (toks, rounds) if return_rounds else toks

    def _spec_program(self, draft_model, P, max_new_tokens, K, greedy,
                      temperature, top_k, top_p, batch_size=1):
        """Memoised under the reference's draft-signature key (plus the
        batch size) with a weakref identity check: one entry a signature
        (a fresh draft replaces the old one), and the run holds its draft
        only weakly, so a dropped draft is freed and its run released."""
        dcfg = draft_model.config
        key = ("spec", type(draft_model).__name__, dcfg.vocab_size,
               dcfg.num_layers, dcfg.hidden_size, P, max_new_tokens, K,
               greedy, temperature, top_k, top_p, int(batch_size))
        return self._memo_program(key, lambda: _SpecRun(
            self, draft_model, int(batch_size), P, max_new_tokens, K,
            greedy, temperature, top_k, top_p), draft=draft_model)

    @torch.no_grad()
    def generate_beam(self, input_ids, max_new_tokens: int,
                      num_beams: int = 4, length_penalty: float = 1.0,
                      eos_token_id: Optional[int] = None):
        """Beam search on the KV cache: returns (sequences (B, N) int32,
        scores (B,) fp32) of each row's best beam, ``scores`` the summed
        log-probs over length**length_penalty.  With ``eos_token_id`` a
        beam that emits EOS freezes (EOS repeats at no cost) and keeps the
        length at which it finished.

        Beams fold into the batch (B·K); each step takes the top K of the
        (B, K·V) scores (ties to the lower index, as ``jax.lax.top_k``),
        gathers the caches to the surviving parents in place, and records
        tokens and parents on the device; the backtrace runs after the
        last step.  One prefill program and one step program a signature
        (CUDA graphs on a card)."""
        c = self.config
        dev = self.wte.device
        ids = _host_ids(input_ids)
        B, P = ids.shape
        K = int(num_beams)
        if not 1 <= K <= c.vocab_size:
            raise ValueError(f"num_beams must be in [1, vocab_size="
                             f"{c.vocab_size}], got {num_beams}")
        if eos_token_id is not None and not 0 <= eos_token_id < c.vocab_size:
            raise ValueError(f"eos_token_id {eos_token_id} outside the vocab "
                             f"[0, {c.vocab_size}) — EOS freezing would "
                             f"silently never trigger")
        if max_new_tokens <= 0:
            return (torch.zeros((B, 0), dtype=torch.int32, device=dev),
                    torch.zeros((B,), dtype=torch.float32, device=dev))
        max_len = P + max_new_tokens
        if max_len > c.max_position_embeddings:
            raise ValueError(f"P + max_new_tokens = {max_len} exceeds "
                             f"max_position_embeddings "
                             f"({c.max_position_embeddings})")
        with self._gen_lock():
            return self._beam_program(P, max_new_tokens, K,
                                      float(length_penalty), eos_token_id,
                                      batch_size=B)([ids])

    def _beam_program(self, P, max_new_tokens, K, length_penalty,
                      eos_token_id, batch_size=1):
        key = ("beam", P, max_new_tokens, K, length_penalty, eos_token_id,
               int(batch_size))
        return self._memo_program(key, lambda: _BeamRun(
            self, int(batch_size), P, max_new_tokens, K, length_penalty,
            eos_token_id))

    def _embed_ragged(self, toks, row_seq, row_pos, pad_lens):
        """Embed a flattened ragged pack: toks (T,) one token per row,
        row_seq (T,) owning sequence, row_pos (T,) kv position (-1 for
        padding rows), pad_lens (S,) left-pad lengths.  Logical positions
        shift by the owning sequence's pad; returns (1, T, H) in the
        compute dtype (the sum is taken in fp32, as in the reference)."""
        dt = getattr(torch, self.config.compute_dtype)
        seq = row_seq.long().clamp(0, pad_lens.shape[0] - 1)
        pos = (row_pos.long() - pad_lens.long()[seq]).clamp(
            0, self.wpe.shape[0] - 1)
        h = self.wte[toks.long()] + self.wpe[pos]
        return h[None].to(dt)


# ---------------------------------------------------------------------------
# generation programs
# ---------------------------------------------------------------------------

def _host_ids(input_ids):
    """(B, P) prompt ids as a host int64 array (a device tensor is read
    back once, before any program runs)."""
    if isinstance(input_ids, torch.Tensor):
        input_ids = input_ids.detach().cpu().numpy()
    ids = np.asarray(input_ids)
    if ids.ndim != 2:
        raise ValueError(f"input_ids must be (B, P), got shape {ids.shape}")
    return ids.astype(np.int64)


def _check_generator(generator, device):
    """A sampling generator must live on the model's device type (its
    state is copied into the program's own generator)."""
    if generator is not None and generator.device.type != device.type:
        raise ValueError(f"generator on {generator.device}, model on "
                         f"{device}")


def cache_leaves(caches):
    """The tensors of a (k, v) cache or pool pair in the reference's
    ``jax.tree.flatten`` order: k then v, an int8 pair as (values,
    scales)."""
    out = []
    for c in caches:
        out += list(c) if isinstance(c, tuple) else [c]
    return out


def _map_caches(fn, caches):
    return tuple(tuple(fn(p) for p in c) if isinstance(c, tuple) else fn(c)
                 for c in caches)


def top_k_lower_index(x, k):
    """The top ``k`` of the last axis in ``jax.lax.top_k``'s order: values
    descending, equal values by ascending index (``torch.topk`` promises no
    order among ties on a card).  A stable descending sort keeps equal
    values in index order."""
    vals, idx = torch.sort(x, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


class _DecodeRun:
    """The programs of one generation signature (``jit/programs.py``
    ``GraphProgram``): ``prefill`` takes the host operands and returns a
    dict of device state; ``step`` takes none and advances that state in
    place.  On a card both are CUDA graphs, captured at the first call
    with graphs on — prefill first, so that the step graph records the
    addresses of the prefill graph's static outputs.  Elsewhere, or inside
    ``disable_graphs()``, the same functions run eagerly.  The programs
    draw from their own generator; a caller's generator state is copied
    in before and back out after, so the caller's generator advances as
    if the draws were made on it.  The state is dropped at the end of a
    call (on a card the prefill graph's static outputs keep it), and
    ``release()`` drops the programs with their graphs and pools."""

    draft_ref = None        # a speculative run's draft, held weakly

    def __init__(self, model, label, shapes):
        self.model = model
        dev = model.wte.device
        self.gen = torch.Generator(dev)
        self.state = None
        self.prefill = programs.GraphProgram(
            f"{label}:prefill", self._prefill, shapes,
            [np.zeros(s) for s in shapes], device=dev, generator=self.gen)
        self.step = programs.GraphProgram(f"{label}:step", self._step, [],
                                          [], device=dev, generator=self.gen)

    def _begin(self, host, generator):
        """Run the prefill on ``host``; at the first call with graphs on,
        capture both programs first.  The step's capture is preceded by
        an eager run that must read real state (a token out of the
        vocabulary would fault), so the prefill graph runs once before it
        and once more after, from the same generator state.  With one new
        token the step never runs, and is never built: its eager run
        would write past the one-token output."""
        if generator is not None:
            self.gen.set_state(generator.get_state())
        if (self.N > 1 and programs.graphs_enabled(self.prefill.device)
                and self.step.graph is None):
            g0 = self.gen.get_state()
            self.state = self.prefill(*host)
            self.step.compile()
            self.gen.set_state(g0)
        self.state = self.prefill(*host)
        return self.state

    def _end(self, generator):
        if generator is not None:
            generator.set_state(self.gen.get_state())
        self.state = None

    def release(self):
        """Drop the device state and both programs (on a card their
        graphs, whose pools then return to the allocator)."""
        self.state = self.prefill = self.step = None


class _GenerateRun(_DecodeRun):
    """``generate()``'s programs: the prefill builds the caches, the
    presence plane, the first token, the (B, N) output and the step
    clock ``i``; the step embeds the last token at slot P + i, runs every
    layer with per-row (B,) clocks, samples and writes token i + 1."""

    def __init__(self, model, P, N, temperature, top_k, top_p, greedy,
                 masked, repetition_penalty, min_new_tokens, eos_token_id,
                 B):
        self.B, self.P, self.N = B, P, N
        self.max_len = P + N
        self.sample = make_token_sampler(temperature, top_k, top_p, greedy)
        self.rp, self.min_new, self.eos = (repetition_penalty,
                                           min_new_tokens, eos_token_id)
        self.track = repetition_penalty != 1.0
        shapes = [(B, P)] + [(B,)] * masked
        super().__init__(model, f"generate:{B}:{P}:{N}", shapes)

    def _next(self, logits32, presence, n_emitted):
        """Penalty → EOS window (a device comparison of the emitted
        count) → draw → presence update."""
        l2 = logits32[:, -1, :]
        if self.track:
            l2 = apply_repetition_penalty(l2, presence, self.rp)
        if self.min_new > 0:
            l2 = suppress_eos(l2, self.eos, n_emitted < self.min_new)
        tok = self.sample(l2[:, None, :], self.gen)
        if self.track:
            presence.scatter_(1, tok[:, None], True)
        return tok

    def _prefill(self, ids, pad=None):
        m = self.model
        h, caches = m.prefill(ids, self.max_len, pad_lens=pad)
        presence = (seed_presence(ids, m.config.vocab_size, pad)
                    if self.track else None)
        i = torch.zeros((), dtype=torch.long, device=ids.device)
        tok = self._next(m.decode_logits(h[:, -1:]), presence, i)
        out = torch.zeros((self.B, self.N), dtype=torch.int32,
                          device=ids.device)
        out[:, 0] = tok
        return {"caches": caches, "presence": presence, "pad": pad,
                "tok": tok, "i": i, "out": out}

    def _step(self):
        st, m = self.state, self.model
        i = st["i"]
        t = (i + self.P).expand(self.B)        # this token's cache slot
        h = m._embed_one(st["tok"], t, pad_lens=st["pad"])
        h, _ = m.decode_step(h, st["caches"], t, pad_lens=st["pad"])
        i.add_(1)
        tok = self._next(m.decode_logits(h), st["presence"], i)
        st["tok"].copy_(tok)
        st["out"].index_copy_(1, i.view(1), tok.to(torch.int32)[:, None])

    def __call__(self, host, generator=None):
        st = self._begin(host, generator)
        for _ in range(self.N - 1):
            self.step()
        self._end(generator)
        return st["out"].clone()


class _BeamRun(_DecodeRun):
    """``generate_beam``'s programs: the prefill takes each row's top K
    first tokens and tiles the caches per beam; the step extends every
    beam, keeps the top K of (B, K·V) and reorders the caches in place."""

    def __init__(self, model, B, P, N, K, length_penalty, eos_token_id):
        self.B, self.P, self.N, self.K = B, P, N, K
        self.max_len = P + N
        self.lp, self.eos = length_penalty, eos_token_id
        super().__init__(model, f"beam:{B}:{P}:{N}:{K}", [(B, P)])

    def _logprobs(self, h):
        return torch.log_softmax(
            self.model.decode_logits(h)[:, -1, :].float(), -1)

    def _prefill(self, ids):
        B, K, N = self.B, self.K, self.N
        h, caches = self.model.prefill(ids, self.max_len)
        # beams start identical: only beam 0 is live at step 0
        top_lp, top_tok = top_k_lower_index(self._logprobs(h[:, -1:]), K)
        finished = (top_tok == self.eos if self.eos is not None
                    else torch.zeros((B, K), dtype=torch.bool,
                                     device=ids.device))
        # a finished beam keeps the length at which it finished
        lengths = torch.where(finished, 1.0, float(N)).float()
        dev = ids.device
        return {"caches": _map_caches(
                    lambda a: a.repeat_interleave(K, dim=1), caches),
                "cum": top_lp.clone(), "finished": finished,
                "lengths": lengths, "first": top_tok,
                "tok": top_tok.reshape(B * K).clone(),
                "toks": torch.zeros((max(N - 1, 0), B, K), dtype=torch.long,
                                    device=dev),
                "parents": torch.zeros((max(N - 1, 0), B, K),
                                       dtype=torch.long, device=dev),
                "i": torch.zeros((), dtype=torch.long, device=dev)}

    def _step(self):
        st, m = self.state, self.model
        B, K = self.B, self.K
        V = m.config.vocab_size
        i = st["i"]
        t = (i + self.P).expand(B * K)
        hh = m._embed_one(st["tok"], t)
        hh, _ = m.decode_step(hh, st["caches"], t)
        lp = self._logprobs(hh).reshape(B, K, V)
        if self.eos is not None:
            # frozen beams: only EOS continues, at zero cost
            col = torch.arange(V, device=lp.device) == self.eos
            eos_only = torch.where(col, 0.0, _NEG_INF)
            lp = torch.where(st["finished"][..., None], eos_only, lp)
        total = st["cum"][..., None] + lp
        cum, idx = top_k_lower_index(total.reshape(B, K * V), K)
        parent = torch.div(idx, V, rounding_mode="floor")
        ntok = idx % V
        if self.eos is not None:
            was = st["finished"].gather(1, parent)
            lengths = st["lengths"].gather(1, parent)
            newly = ~was & (ntok == self.eos)
            # the token of step i is the beam's token i + 2
            st["lengths"].copy_(torch.where(newly, (i + 2).float(), lengths))
            st["finished"].copy_(was | newly)
        rows = torch.arange(B, device=lp.device)[:, None]

        def reorder(a):
            ab = a.view((a.shape[0], B, K) + tuple(a.shape[2:]))
            a.copy_(ab[:, rows, parent].reshape(a.shape))

        for leaf in cache_leaves(st["caches"]):
            reorder(leaf)
        st["cum"].copy_(cum)
        st["tok"].copy_(ntok.reshape(B * K))
        st["toks"].index_copy_(0, i.view(1), ntok[None])
        st["parents"].index_copy_(0, i.view(1), parent[None])
        i.add_(1)

    def __call__(self, host):
        st = self._begin(host, None)
        for _ in range(self.N - 1):
            self.step()
        self._end(None)
        scores = st["cum"] / torch.pow(st["lengths"], self.lp)
        best = torch.argmax(scores, 1)
        k, rev = best, []
        for s in range(self.N - 2, -1, -1):     # backtrace, last step first
            rev.append(st["toks"][s].gather(1, k[:, None])[:, 0])
            k = st["parents"][s].gather(1, k[:, None])[:, 0]
        first = st["first"].gather(1, k[:, None])[:, 0]
        seq = torch.stack([first] + rev[::-1], 1).to(torch.int32)
        return seq, scores.gather(1, best[:, None])[:, 0]


class _SpecRun(_DecodeRun):
    """``generate_speculative``'s programs: the prefill runs both models
    over the prompt into ``P + N + K + 1``-slot caches and draws the first
    token; the step is one round (the draft's K steps, the target's
    verify chunk, the draft's re-ingest, the acceptance rule, the per-row
    advance) and returns whether every row is done."""

    def __init__(self, model, draft, B, P, N, K, greedy, temperature, top_k,
                 top_p):
        self.draft_ref = weakref.ref(draft)
        self.B, self.P, self.N, self.K = B, P, N, K
        self.buf_len = P + N + K + 1     # slack: a round may write past P+N
        self.greedy = greedy
        self.filt = lambda x: filter_logits(x.float(), temperature, top_k,
                                            top_p)
        self.sample0 = make_token_sampler(temperature, top_k, top_p, greedy)
        super().__init__(model, f"spec:{B}:{P}:{N}:{K}", [(B, P)])

    def _prefill(self, ids):
        m, dm = self.model, self.draft_ref()
        B, P, dev = self.B, self.P, ids.device
        h, tc = m.prefill(ids, self.buf_len)
        _, dc = dm.prefill(ids, self.buf_len)
        tok0 = self.sample0(m.decode_logits(h[:, -1:]), self.gen)
        buf = torch.zeros((B, self.buf_len), dtype=torch.int32, device=dev)
        buf[:, :P] = ids
        buf[:, P] = tok0
        return {"tc": tc, "dc": dc, "buf": buf,
                "n": torch.full((B,), P + 1, dtype=torch.long, device=dev),
                "rounds": torch.zeros((), dtype=torch.long, device=dev)}

    def _step(self):
        st, m, dm = self.state, self.model, self.draft_ref()
        B, K = self.B, self.K
        buf, n = st["buf"], st["n"]
        rows = torch.arange(B, device=buf.device)
        prev = buf[rows, n - 1].long()
        tok, d, qp = prev, [], []
        for i in range(K):
            hh = dm._embed_one(tok, n - 1 + i)
            hh, _ = dm.decode_step(hh, st["dc"], n - 1 + i)
            ql = self.filt(dm.decode_logits(hh)[:, -1])
            if self.greedy:
                tok = torch.argmax(ql, -1)
            else:
                q = torch.softmax(ql, -1)
                tok = draw_categorical(q, self.gen)
                qp.append(q)
            d.append(tok)
        d = torch.stack(d, 1)                               # (B, K)
        # verify: ONE target chunk over [prev, d_0..d_{K-1}] gives the
        # target's filtered logits for positions n..n+K
        inp = torch.cat([prev[:, None], d], 1)             # (B, K+1)
        hv, _ = m.decode_step(m._embed_chunk(inp, n - 1), st["tc"], n - 1)
        tl = self.filt(m.decode_logits(hv))                # (B, K+1, V)
        # re-ingest the chunk into the draft cache: its loop never fed
        # d_{K-1}, which would leave a zero k/v hole after a full accept
        dm.decode_step(dm._embed_chunk(inp, n - 1), st["dc"], n - 1)
        if self.greedy:
            lead, cand = greedy_verify(d, torch.argmax(tl, -1))
        else:
            lead, repl = speculative_accept(torch.stack(qp, 1),
                                            torch.softmax(tl, -1), d,
                                            self.gen)
            d_ext = torch.cat([d, torch.zeros_like(d[:, :1])], 1)
            cand = torch.where(torch.arange(K + 1, device=d.device)[None]
                               < lead[:, None], d_ext, repl[:, None])
        slots = n[:, None] + torch.arange(K + 1, device=n.device)[None]
        buf[rows[:, None], slots] = cand.to(buf.dtype)
        n.copy_(torch.clamp(n + lead + 1, max=self.P + self.N))
        st["rounds"].add_(1)
        return (n >= self.P + self.N).all()

    def __call__(self, host, generator=None):
        st = self._begin(host, generator)
        if self.N > 1:
            while not bool(self.step()):         # one read-back a round
                pass
        self._end(generator)
        P = self.P
        return st["buf"][:, P:P + self.N].clone(), st["rounds"].clone()


# ---------------------------------------------------------------------------
# the generation artifact
# ---------------------------------------------------------------------------

_GENMODEL_FORMAT = "paddle_tpu_torch.genmodel/1"


def save_generate_program(model, path: str, prompt_len: int,
                          max_new_tokens: int, batch_size: int = 1,
                          temperature: float = 1.0, top_k=None, top_p=None,
                          greedy: bool = True, masked: bool = False,
                          platforms=("cpu", "cuda")):
    """Export one generation signature as a serving artifact.

    Files: ``path + ".genparams"`` (the reference's format: a pickle of
    the numpy state dict), ``path + ".genmeta"`` (the reference's keys:
    prompt_len, batch_size, max_new_tokens, temperature, top_k, top_p,
    greedy, masked, platforms) and ``path + ".genmodel"``.  The
    reference's ``.genmodel`` is a StableHLO program; nothing on a card
    runs one, so here it holds the model's class and config and the
    program signature, and ``load_generate_program`` rebuilds the model
    and its memoised programs from them (``ROADMAP.md`` §C).  The port's
    models hold their own weights: there is no ``params`` argument."""
    import pickle

    if max_new_tokens <= 0:
        raise ValueError("max_new_tokens must be positive for an exported "
                         "program (an empty program is not a useful "
                         "artifact)")
    max_len = prompt_len + max_new_tokens
    if max_len > model.config.max_position_embeddings:
        raise ValueError(
            f"prompt_len + max_new_tokens = {max_len} exceeds "
            f"max_position_embeddings "
            f"({model.config.max_position_embeddings})")
    # a generator is made from the seed at every call
    validate_sampler_args(model.config.vocab_size, top_k, top_p, greedy,
                          generator=object())
    meta = {"prompt_len": prompt_len, "batch_size": batch_size,
            "max_new_tokens": max_new_tokens, "temperature": temperature,
            "top_k": top_k, "top_p": top_p, "greedy": greedy,
            "masked": masked, "platforms": tuple(platforms)}
    with open(path + ".genmodel", "wb") as f:
        pickle.dump({"format": _GENMODEL_FORMAT,
                     "module": type(model).__module__,
                     "model": type(model).__name__,
                     "config": dict(vars(model.config)),
                     "signature": dict(meta)}, f)
    with open(path + ".genparams", "wb") as f:
        pickle.dump({n: p.detach().cpu().numpy()
                     for n, p in model.named_parameters()}, f)
    with open(path + ".genmeta", "wb") as f:
        pickle.dump(meta, f)


def load_generate_program(path: str, device=None):
    """Load a ``save_generate_program`` artifact onto ``device`` (a card
    unless the caller asks for the CPU).  Returns (fn, meta), where
    ``fn(input_ids, seed=0[, prompt_mask=...]) -> (B, max_new_tokens)``
    runs the saved signature on the rebuilt model; its programs are built
    (on a card, captured) at the first call and replayed after.
    ``prompt_mask`` is required when the artifact was exported with
    ``masked=True`` and refused otherwise."""
    import importlib
    import pickle

    from .. import resolve_device

    with open(path + ".genmodel", "rb") as f:
        spec = pickle.load(f)
    with open(path + ".genparams", "rb") as f:
        params = pickle.load(f)
    with open(path + ".genmeta", "rb") as f:
        meta = pickle.load(f)
    module, name = str(spec.get("module")), str(spec.get("model"))
    cls = None
    if spec.get("format") == _GENMODEL_FORMAT and \
            module.startswith("paddle_tpu_torch."):
        cls = getattr(importlib.import_module(module), name, None)
    if not (isinstance(cls, type) and issubclass(cls, CausalDecoderMixin)
            and getattr(cls, "config_class", None) is not None):
        raise ValueError(f"{path}.genmodel is not a {_GENMODEL_FORMAT} "
                         f"artifact of a causal LM of the port "
                         f"({module}.{name})")
    dev = resolve_device(device)
    if dev.type not in meta["platforms"]:
        raise ValueError(f"artifact exported for {meta['platforms']}, not "
                         f"{dev.type}")
    model = cls.from_numpy(params, cls.config_class(**spec["config"]),
                           device=dev)
    shape = (meta["batch_size"], meta["prompt_len"])

    def fn(input_ids, seed=0, prompt_mask=None):
        ids = _host_ids(input_ids)
        if ids.shape != shape:
            raise ValueError(f"input_ids shape {ids.shape} != the "
                             f"artifact's {shape}")
        if meta["masked"]:
            if prompt_mask is None:
                raise ValueError("this artifact was exported masked=True; "
                                 "pass prompt_mask")
        elif prompt_mask is not None:
            raise ValueError("artifact exported without masked=True cannot "
                             "serve ragged prompts")
        gen = (None if meta["greedy"] else
               torch.Generator(dev).manual_seed(int(seed)))
        return model.generate(ids, meta["max_new_tokens"],
                              temperature=meta["temperature"],
                              top_k=meta["top_k"], top_p=meta["top_p"],
                              greedy=meta["greedy"], generator=gen,
                              prompt_mask=prompt_mask)

    return fn, meta

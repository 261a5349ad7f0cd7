"""KV-cache decode machinery shared by the causal LMs (a subset of
``paddle_tpu/models/_decode.py``): int8 KV quantization, the dense and
paged cache write (``write_cache``, ``PagedKV``) and attention
(``cached_attention``), the ragged pool write and attention dispatch, the
token samplers and logits processors (repetition penalty, EOS windows, the
per-row filters of the per-request sampling planes, greedy speculative
verification), the prompt/token/chunk embeddings and ``generate``.

Unlike the JAX reference, which rebuilds arrays functionally, the cache and
pool writes here update their target IN PLACE (``index_put_``, slice
assignment) and return it: the caller owns one cache per model and never
needs the old contents back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..ops.paged_attention import paged_decode_attention

# the model-side name of the ragged attention dispatch (the Hopper kernel
# for CUDA tensors, the plain version for CPU tensors)
from ..ops.ragged_paged_attention import \
    ragged_attention_rows as ragged_attention  # noqa: F401


_NEG_INF = -1e30


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
    decode loop is a Python loop that keeps its tokens on the device.

    Host-class contract: ``self.config`` (vocab_size, compute_dtype,
    max_position_embeddings, num_layers, num_attention_heads, hidden_size,
    kv_cache_dtype), ``prefill(ids, max_len, pad_lens) -> (h, caches)``,
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
        if c.kv_cache_dtype == "int8":
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
        ``generator``.

        ``prompt_mask`` (B, P), 1 = real token, 0 = padding: prompts must
        be LEFT-padded (real tokens at the end).  Pad positions are
        excluded from attention and position ids shift by the per-row pad
        length.

        ``repetition_penalty`` > 1 pushes already-seen tokens (prompt +
        generated, a (B, V) presence plane) down; ``min_new_tokens`` masks
        ``eos_token_id`` for the first n emissions.  Each step runs the
        penalty, then the EOS window, then the draw, then the presence
        update."""
        c = self.config
        dev = self.wte.device
        if not isinstance(input_ids, torch.Tensor):
            input_ids = torch.as_tensor(np.asarray(input_ids))
        input_ids = input_ids.to(dev)
        B, P = input_ids.shape
        if max_new_tokens <= 0:
            return torch.zeros((B, 0), dtype=torch.int32, device=dev)
        max_len = P + max_new_tokens
        if max_len > c.max_position_embeddings:
            raise ValueError(f"P + max_new_tokens = {max_len} exceeds "
                             f"max_position_embeddings "
                             f"({c.max_position_embeddings})")
        validate_sampler_args(c.vocab_size, top_k, top_p, greedy, generator)
        if repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if min_new_tokens > 0 and eos_token_id is None:
            raise ValueError("min_new_tokens needs eos_token_id (it works "
                             "by suppressing EOS)")
        if eos_token_id is not None and not 0 <= eos_token_id < c.vocab_size:
            raise ValueError(f"eos_token_id {eos_token_id} outside vocab "
                             f"(size {c.vocab_size})")
        pad_lens = None
        if prompt_mask is not None:
            self._validate_prompt_mask(prompt_mask, input_ids)
            pad_lens = torch.as_tensor(
                P - np.asarray(prompt_mask, np.int64).sum(axis=1),
                dtype=torch.int32).to(dev)
        sample = make_token_sampler(float(temperature), top_k, top_p, greedy)
        rp, min_new = float(repetition_penalty), int(min_new_tokens)
        track = rp != 1.0                 # a presence plane only when needed
        presence = (seed_presence(input_ids, c.vocab_size, pad_lens)
                    if track else None)
        rows = torch.arange(B, device=dev)

        def next_token(logits32, n_emitted):
            l2 = logits32[:, -1, :]
            if track:
                l2 = apply_repetition_penalty(l2, presence, rp)
            if n_emitted < min_new:
                l2 = suppress_eos(l2, eos_token_id, True)
            tok = sample(l2[:, None, :], generator)
            if track:
                presence[rows, tok] = True
            return tok

        h, caches = self.prefill(input_ids, max_len, pad_lens=pad_lens)
        tok = next_token(self.decode_logits(h[:, -1:]), 0)
        toks = [tok]
        for i in range(max_new_tokens - 1):
            t = P + i                     # this token's slot in the cache
            h = self._embed_one(tok, t, pad_lens=pad_lens)
            h, caches = self.decode_step(h, caches, t, pad_lens=pad_lens)
            tok = next_token(self.decode_logits(h), i + 1)
            toks.append(tok)
        return torch.stack(toks, 1).to(torch.int32)

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

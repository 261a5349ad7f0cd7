"""Paged (block-table) KV cache: the bucketed paged engine and the ragged
mixed prefill+decode engine (a subset of ``paddle_tpu/serving_paged.py``).

- ONE physical pool of ``num_blocks`` fixed-size blocks per layer,
  ``(L, num_blocks + 1, block_size, nh, hd)`` — block 0 is a reserved TRASH
  block that absorbs padding rows' writes and is never read;
- a per-slot BLOCK TABLE ``(S, max_len // block_size)`` int32 mapping
  logical positions to pool blocks, kept on the host;
- blocks are allocated lazily as a request's positions grow, retirement
  frees them at once, and when the pool runs dry the YOUNGEST request is
  preempted (blocks freed, request requeued at the front and rerun from
  scratch — greedy decoding regenerates the identical prefix).

``PagedContinuousBatchingEngine`` keeps the contiguous engine's schedule
(one admission prefill per request, whole-bucket or in ``prefill_chunk``
segments, then ``ticks_per_sync`` batched decode ticks over all slots) on
the pool: prefill scatters the prompt's k/v into the slot's blocks, and a
decode sync wraps the pools and the first C table columns — the smallest
power-of-two cover of the deepest active clock, inactive rows zeroed — in
``PagedKV``, so every layer of every tick writes straight into pool blocks
and attends through the Hopper paged decode kernel on the card
(``ops/paged_attention.py``; int8 pools gather and take the dense path).

``RaggedPagedContinuousBatchingEngine`` runs every scheduler step as ONE
flattened ragged pack of at most ``token_budget`` rows: every active decode
slot's next-token row, then admission-prefill chunks oldest-first in the
remaining budget.  The model runs the pack through ``decode_ragged`` (k/v
written straight into pool blocks, attention by the Hopper ragged kernel on
the card), then one (S,)-row sampler draws each decode slot's next token and
each completed prompt's first token.  Steps run eagerly and update the pools
in place; each step copies its host-built metadata to the device once and
reads the sampled tokens back once.

Left for later slices: the prefix cache and tiered ``kv_store``,
speculative decoding inside the pack, per-request sampling planes, the
repetition penalty and ``min_new_tokens``, tracing/telemetry, warmup and
the mesh.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from .jit.bucketing import pow2_bucket, select_bucket
from .models._decode import PagedKV
from .ops.ragged_paged_attention import ragged_plan
from .serving import ContinuousBatchingEngine, _map_planes

__all__ = ["PagedContinuousBatchingEngine",
           "RaggedPagedContinuousBatchingEngine"]


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV cache (see the module
    docstring): the contiguous engine's schedule, with block-pool storage,
    lazy block growth before each decode sync, deferral of admissions the
    pool cannot hold and youngest-first preemption.

    ``block_size`` must divide ``max_len`` and every prompt bucket.
    ``num_blocks`` defaults to the contiguous-equivalent pool
    (``max_slots × max_len / block_size``); size it smaller to cap device
    memory — the engine then admits and preempts against the real budget.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 **kw):
        self.bs = int(block_size)
        if self.bs < 1:
            raise ValueError("block_size must be >= 1")
        if max_len % self.bs:
            raise ValueError(f"block_size ({self.bs}) must divide "
                             f"max_len ({max_len})")
        self.MB = max_len // self.bs
        self.NB = (int(num_blocks) if num_blocks is not None
                   else int(max_slots) * self.MB)
        if self.NB < 1:
            raise ValueError("num_blocks must be >= 1")
        super().__init__(model, max_slots, max_len, **kw)
        bad = [b for b in self.buckets if b % self.bs]
        if bad:
            raise ValueError(f"block_size ({self.bs}) must divide every "
                             f"prompt bucket; doesn't divide {bad}")
        # block 0 is trash; real ids are 1..NB
        self._free = list(range(self.NB, 0, -1))      # pop() -> 1, 2, …
        self._table = np.zeros((self.S, self.MB), np.int32)
        self._nblk = np.zeros(self.S, np.int32)       # leading real blocks
        self._admit_seq = np.zeros(self.S, np.int64)  # preemption (LIFO)
        self._seq = 0

    @property
    def preemptions(self) -> int:
        return int(self._stats.value("preemptions"))

    @property
    def blocks_high_water(self) -> int:
        return int(self._stats.value("blocks_high_water"))

    # ------------------------------------------------------------ storage --

    def _build_pool(self, c):
        """(pool_k, pool_v) for one model config, each
        (L, NB+1, bs, nh, hd) in the compute dtype — or int8
        ``(values, scales)`` pairs with fp32 (L, NB+1, bs, nh) scales."""
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        shape = (c.num_layers, self.NB + 1, self.bs, nh, hd)
        dev = self.device
        if c.kv_cache_dtype == "int8":
            def one():
                return (torch.zeros(shape, dtype=torch.int8, device=dev),
                        torch.zeros(shape[:-1], dtype=torch.float32,
                                    device=dev))
            return one(), one()
        dt = getattr(torch, c.compute_dtype)
        return (torch.zeros(shape, dtype=dt, device=dev),
                torch.zeros(shape, dtype=dt, device=dev))

    def _alloc_caches(self):
        return self._build_pool(self.model.config)

    # --------------------------------------------------------- allocator --

    @property
    def blocks_in_use(self) -> int:
        return self.NB - len(self._free)

    def _alloc_blocks(self, n: int):
        """Take ``n`` blocks from the free list.  TRANSACTIONAL: returns
        None (nothing taken) when the free list can't cover ``n``."""
        if n <= 0:
            return []
        if n > len(self._free):
            return None
        out = [self._free.pop() for _ in range(n)]
        self._stats.add("blocks_allocated", len(out))
        return out

    def _release(self, bid: int):
        self._free.append(bid)
        self._stats.add("blocks_released")

    def _ensure_blocks(self, slot: int, upto: int) -> bool:
        """Grow the slot's table to cover logical positions [0, upto);
        transactional via _alloc_blocks."""
        need = -(-int(upto) // self.bs)
        have = int(self._nblk[slot])
        got = self._alloc_blocks(need - have)
        if got is None:
            return False
        for i, bid in enumerate(got):
            self._table[slot, have + i] = bid
        self._nblk[slot] = max(have, need)
        self._stats.set("blocks_high_water", max(self.blocks_high_water,
                                                 self.blocks_in_use))
        return True

    def _free_slot_blocks(self, slot: int):
        n = int(self._nblk[slot])
        for b in self._table[slot, :n][::-1]:
            self._release(int(b))
        self._table[slot] = 0
        self._nblk[slot] = 0

    def _retire(self, slot: int):
        super()._retire(slot)
        self._free_slot_blocks(slot)

    def _release_cancelled_slot(self, slot: int):
        self._free_slot_blocks(slot)
        super()._release_cancelled_slot(slot)

    def _preempt_one(self) -> bool:
        """Evict the YOUNGEST in-flight request (active or still filling),
        free its blocks, and requeue it at the front for a from-scratch
        rerun.  A streaming consumer is told with one
        ``on_token(request_id, None, False)`` call (discard what was
        streamed; the rerun re-delivers from the first token)."""
        cands = [(int(self._admit_seq[s]), s)
                 for s in np.flatnonzero(self._active)]
        cands += [(int(self._admit_seq[s]), s) for s in self._filling]
        if not cands:
            return False
        _, victim = max(cands)
        if victim in self._filling:
            req = self._filling.pop(victim)["req"]
        else:
            req = self._slot_req[victim]
            self._slot_req[victim] = None
            self._active[victim] = False
        req.generated = []
        req.first_token_at = None
        self._queue.insert(0, req)
        self._free_slot_blocks(victim)
        self._stats.add("preemptions")
        if req.on_token is not None:
            try:
                req.on_token(req.id, None, False)      # replay/reset signal
            except Exception:  # noqa: BLE001 — a user callback must not
                # desync the scheduler
                logging.getLogger(__name__).exception(
                    "on_token replay signal failed for request %d", req.id)
        return True

    def _prepare_decode(self) -> bool:
        """Grow each active slot's table to cover this sync's [t, t+k)
        span, OLDEST first (victims are youngest-first, so the FIFO head
        always makes progress); preempt when the pool is dry."""
        k = self.ticks_per_sync
        order = sorted(np.flatnonzero(self._active),
                       key=lambda s: int(self._admit_seq[s]))
        for slot in order:
            while (self._active[slot]
                   and not self._ensure_blocks(int(slot),
                                               int(self._t[slot]) + k)):
                if not self._preempt_one():
                    raise RuntimeError(
                        "block pool exhausted with nothing to preempt")
        return bool(self._active.any())

    # ---------------------------------------------------- device programs --

    def _store_prompt_kv(self, slot, P, new):
        """A prefill's fresh k/v (L, 1, P, …), cut into blocks, into the
        slot's first P/bs pool blocks (already ensured)."""
        nblk = P // self.bs
        blkrow = torch.from_numpy(
            self._table[slot, :nblk].astype(np.int64)).to(self.device)

        def put(pool, n):
            pool[:, blkrow] = n.reshape((n.shape[0], nblk, self.bs)
                                        + tuple(n.shape[3:]))

        for pool, n in zip(self.caches, new):
            _map_planes(put, pool, n)

    def _suffix_prefill(self, slot, toks, t0, pad):
        """Chunk prefill over the pools: gather the slot's table view,
        embed+decode the ``toks`` (n,) chunk at positions [t0, t0+n)
        through the chunk path (attending to everything the table already
        holds), scatter the span back.  Returns the chunk's hidden
        states."""
        bs = self.bs
        tab = torch.from_numpy(self._table[slot].astype(np.int64)) \
            .to(self.device)

        def take(p):
            g = p[:, tab]                        # (L, MB, bs, …)
            return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                             + tuple(g.shape[3:]))[:, None]

        def view(pool):
            return (tuple(take(p) for p in pool) if isinstance(pool, tuple)
                    else take(pool))

        m = self.model
        ck_s, cv_s = view(self.caches[0]), view(self.caches[1])
        h = m._embed_chunk(toks, t0, pad_lens=pad)
        h, _ = m.decode_step(h, (ck_s, cv_s), t0, pad_lens=pad)
        span = t0 + torch.arange(toks.shape[0], device=self.device)
        pb = tab[torch.div(span, bs, rounding_mode="floor").clamp(
            max=tab.shape[0] - 1)]
        off = span % bs

        def put(pool, v):
            pool[:, pb, off] = v[:, 0, span]

        for pool, v in zip(self.caches, (ck_s, cv_s)):
            _map_planes(put, pool, v)
        return h

    def _view_cols(self) -> int:
        """Table columns one decode sync walks: the smallest power-of-two
        cover of the deepest ACTIVE clock (parked fillers sit at
        max_len - k by design and must not inflate the bucket: their
        writes land in trash whatever C is), capped at MB."""
        k = self.ticks_per_sync
        ts = self._t[self._active] if self._active.any() else [0]
        need = -(-int(max(ts) + k) // self.bs)
        return pow2_bucket(need, self.MB)

    def _decode_extra_operands(self):
        return (self._table[:, :self._view_cols()],)

    def _decode_caches(self, active, table):
        """Both pools wrapped in ``PagedKV`` over the sync's C table
        columns.  INACTIVE rows are zeroed so their parked-clock writes —
        whose clamped column lookup could alias a filling prompt's real
        block — land in the trash block instead."""
        tb = torch.where(active[:, None], table, 0)
        return PagedKV(self.caches[0], tb), PagedKV(self.caches[1], tb)

    # --------------------------------------------------------- scheduling --

    def _reserve_slot(self, slot, P, chunked) -> bool:
        """Whole-bucket admission needs its P/bs blocks NOW; chunked
        admission grows per segment.  A dry pool defers admission —
        decoding slots retire and free blocks."""
        if not chunked and not self._ensure_blocks(slot, P):
            return False
        self._seq += 1
        self._admit_seq[slot] = self._seq
        return True

    def _reserve_segment(self, slot, upto) -> bool:
        if self._ensure_blocks(slot, upto):
            return True
        # pool dry: normally this prompt just stalls while decode flows and
        # retirements free blocks — but with NO active decoder nothing will
        # ever free them (fillers jointly wedged); evict the youngest
        # in-flight request so the oldest filler is guaranteed progress
        if not self._active.any():
            self._preempt_one()
        return False

    def add_request(self, prompt, max_new_tokens: int, on_token=None) -> int:
        """Queue a prompt (the base contract); refuses a request the pool
        could never hold."""
        prompt_l = [int(t) for t in prompt]
        if prompt_l:
            P = select_bucket(len(prompt_l), self.buckets)
            need = self._positions_needed(P, int(max_new_tokens))
            worst = -(-need // self.bs)
            if need <= self.max_len and worst > self.NB:
                raise ValueError(
                    f"request needs up to {worst} blocks; the pool has "
                    f"{self.NB} — raise num_blocks or lower "
                    f"max_new_tokens")
        return super().add_request(prompt_l, max_new_tokens,
                                   on_token=on_token)

    def metrics(self):
        m = super().metrics()
        m["blocks_in_use"] = float(self.blocks_in_use)
        m["blocks_high_water"] = float(self.blocks_high_water)
        m["blocks_allocated"] = float(self._stats.value("blocks_allocated"))
        m["blocks_released"] = float(self._stats.value("blocks_released"))
        m["preemptions"] = float(self.preemptions)
        return m


class RaggedPagedContinuousBatchingEngine(PagedContinuousBatchingEngine):
    """Continuous batching where each scheduler step is ONE mixed
    prefill+decode ragged pack (see the module docstring).

    ``token_budget`` rows per step (default ``max_slots`` plus the largest
    prompt bucket) must cover every decode slot; prompts longer than the
    remaining budget prefill across several steps.  Outputs are greedy-
    exact against the reference engine for the same weights and arrival
    schedule, fp and int8 pools alike.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 token_budget: Optional[int] = None, **kw):
        if kw.get("prefill_chunk") is not None:
            raise ValueError(
                "the ragged engine chunks prefill via token_budget; "
                "prefill_chunk is the bucketed engines' knob")
        if int(kw.pop("ticks_per_sync", 1)) != 1:
            raise NotImplementedError(
                "the ragged engine syncs every step — amortize dispatch "
                "with token_budget, not ticks_per_sync")
        super().__init__(model, max_slots, max_len, **kw)
        tb = (int(token_budget) if token_budget is not None
              else int(max_slots) + max(self.buckets))
        if tb < int(max_slots):
            raise ValueError(
                f"token_budget ({tb}) must cover every decode slot "
                f"(max_slots={max_slots})")
        self.token_budget = tb

    @property
    def ragged_steps(self) -> int:
        return int(self._stats.value("ragged_steps"))

    @property
    def mixed_steps(self) -> int:
        """Steps that carried prefill AND decode rows."""
        return int(self._stats.value("mixed_steps"))

    def metrics(self):
        m = super().metrics()
        m["ragged_steps"] = float(self.ragged_steps)
        m["mixed_steps"] = float(self.mixed_steps)
        return m

    # --------------------------------------------------------- scheduling --

    def _admit(self):
        """Admission reserves a slot — no device work and no block
        allocation happen here; the prompt's rows flow into later ragged
        steps as budget and blocks allow."""
        free = self._free_slots()
        while self._queue and free:
            slot = free.pop(0)
            req = self._queue.pop(0)
            P = select_bucket(len(req.prompt), self.buckets)
            pad = P - len(req.prompt)
            self._seq += 1
            self._admit_seq[slot] = self._seq
            self._pad[slot] = pad
            self._t[slot] = 0
            self._filling[slot] = {"req": req, "ids": [0] * pad + req.prompt,
                                   "pad": pad, "P": P, "filled": 0}

    def _build_pack(self):
        """Assemble one step's flattened ragged pack: all active decode
        rows first (block coverage grown via _prepare_decode, preempting
        the youngest when dry), then prefill chunks oldest-first into the
        remaining budget (a dry pool shrinks the chunk — the filler stalls
        while decode retirements free blocks).  Returns None when there is
        nothing to run."""
        T = self.token_budget
        if self._active.any():
            self._prepare_decode()
        toks = np.zeros(T, np.int32)
        row_seq = np.full(T, -1, np.int32)
        row_pos = np.full(T, -1, np.int32)
        sample_rows = np.zeros(self.S, np.int32)
        n = 0
        dec_slots = [int(s) for s in np.flatnonzero(self._active)]
        for slot in dec_slots:
            toks[n] = self._tok[slot]
            row_seq[n] = slot
            row_pos[n] = self._t[slot]
            sample_rows[slot] = n
            n += 1
        fill_adv = {}
        for slot in sorted(self._filling,
                           key=lambda s: int(self._admit_seq[s])):
            if n >= T:
                break
            st = self._filling[slot]
            want = min(st["P"] - st["filled"], T - n)
            have = int(self._nblk[slot])
            if have * self.bs < st["filled"] + want:
                # grant what the pool can cover in ONE transactional request
                need = -(-(st["filled"] + want) // self.bs) - have
                take = min(need, len(self._free))
                if take > 0:
                    self._ensure_blocks(slot, (have + take) * self.bs)
            m = min(want, int(self._nblk[slot]) * self.bs - st["filled"])
            if m <= 0:
                continue
            for k in range(m):
                toks[n] = st["ids"][st["filled"] + k]
                row_seq[n] = slot
                row_pos[n] = st["filled"] + k
                n += 1
            fill_adv[slot] = m
            if st["filled"] + m == st["P"]:
                # the prompt's last row yields the first-token hidden state
                sample_rows[slot] = n - 1
        if n == 0:
            # jointly wedged fillers with no decoder: nothing will ever free
            # blocks — evict the youngest so the oldest progresses
            if self._filling and self._preempt_one():
                return self._build_pack()
            return None
        need_cols = -(-(int(row_pos[:n].max()) + 1) // self.bs)
        C = pow2_bucket(need_cols, self.MB)
        if dec_slots and fill_adv:
            self._stats.add("mixed_steps")
        return toks, row_seq, row_pos, C, sample_rows, dec_slots, fill_adv

    def _step_impl(self):
        """One scheduler round: admit, pack, run the ragged step, unpack
        sampled tokens (decode slots advance; completed prompts activate
        with their first token)."""
        self._admit()
        pack = self._build_pack()
        if pack is None:
            return
        toks, row_seq, row_pos, C, sample_rows, dec_slots, fill_adv = pack
        ntok = self._run_pack(toks, row_seq, row_pos, C, sample_rows)
        self._stats.add("ragged_steps")
        for slot in dec_slots:
            self._t[slot] += 1
            self._tok[slot] = int(ntok[slot])
            self._record(slot, int(ntok[slot]))
            # room safety net (admission-validated budgets never trigger)
            if self._active[slot] and int(self._t[slot]) + 1 > self.max_len:
                self._retire(slot)
        for slot, m in fill_adv.items():
            st = self._filling[slot]
            st["filled"] += m
            if st["filled"] == st["P"]:
                del self._filling[slot]
                self._activate(slot, st["req"], st["P"], st["pad"],
                               int(ntok[slot]))

    def _run_pack(self, toks, row_seq, row_pos, C, sample_rows):
        """The device half of a step: one host→device copy of every int32
        operand (the attention kernel's work list, ``ragged_plan``, built
        here on the host from the pack's rows, among them), embed → all
        layers → head over the S sampled rows → sample, and one
        device→host read of the (S,) tokens.  Rows of slots with nothing to
        sample read a dummy row (computed, ignored)."""
        S, T = self.S, self.token_budget
        plan = ragged_plan(torch.from_numpy(row_seq),
                           torch.from_numpy(row_pos),
                           torch.from_numpy(self._pad)).numpy()
        host = np.concatenate([toks, row_seq, row_pos, self._pad,
                               sample_rows, self._table[:, :C].ravel(),
                               plan.ravel()])
        dev = torch.from_numpy(host).to(self.device)
        toks_d, seq_d, pos_d, pad_d, samp_d, tab_d, plan_d = torch.split(
            dev, [T, T, T, S, S, S * C, plan.size])
        table = tab_d.view(S, C)
        m = self.model
        with torch.no_grad():
            h = m._embed_ragged(toks_d, seq_d, pos_d, pad_d)
            h, _ = m.decode_ragged(h, self.caches, table, seq_d, pos_d,
                                   pad_d, plan_d.view(plan.shape))
            logits = m.decode_logits(h[0, samp_d.long()][:, None])
            ntok = self._sample(logits, self.generator)
        return ntok.cpu().numpy()

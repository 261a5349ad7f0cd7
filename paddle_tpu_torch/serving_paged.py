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
  scratch — greedy decoding regenerates the identical prefix);
- with ``enable_prefix_cache=True`` a complete prompt block is published
  under a chain key (a rolling blake2b-256 over the pad length and the
  padded tokens through that block), and a later prompt that starts with
  the same chain maps those blocks into its table (refcounted pins)
  and computes only the rest; a block is free, referenced, or cached
  with no reference (evictable, least recently used first).  Prompt
  blocks never change once written: buckets are block-aligned, so decode
  growth starts in a fresh block and sharing needs no copy.

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
each completed prompt's first token.  A step is ONE program per (token
budget, table width) bucket (``ragged_step:{T}:{C}``; on a card a CUDA
graph) that updates the pools in place; each step copies its host-built
metadata to the device once and reads the sampled tokens back once.

With ``draft_model``/``draft_k`` the ragged engine speculates inside the
pack: a speculating slot claims K extra rows after its next-token row (the
verify chunk at kv positions [t, t+K]); a step is then ONE program per
bucket (``ragged_spec:{T}:{C}``) that runs (1) the draft's K greedy
proposal steps through ``decode_step`` over its own pool (same tables and
allocator as the target; the table gated to speculating rows, so everyone
else writes to trash block 0; attention by the paged decode kernel on the
card) — every step, whether or not a slot speculates, (2) the proposals
scattered into the pack on the device (non-speculating slots' into a
scratch row past the pack), (3) the target's ``decode_ragged`` over the
whole pack, (4) the draft's ``decode_ragged`` over the same pack (its pool
stays current with prompts and accepted tokens), (5) ``greedy_verify`` —
and reads the accepted counts and token blocks back once.  Streams equal
plain greedy decode token for token.

Every engine here takes the base engine's sampling planes
(``repetition_penalty``, ``min_new_tokens``, ``per_request_sampling``;
speculation is greedy-only) and the base engine's programs
(``serving.py``): the paged engine adds ``decode:{C}`` for every table
width C in ``pow2_grid(max_len // block_size)`` and the prefix-hit
programs ``cpre:{P}:{F}``, built on first dispatch and outside the grid,
as in the reference; every prefix-caching grid ends with ``kvio``, the
page gather and scatter.

With ``kv_store`` (``kv_store.TieredKVStore``) a cached prefix block that
leaves the pool — evicted by the allocator or freed by ``flush_prefix`` —
is demoted into the store as a ``KVPage`` (one device→host copy), and an
admission whose chain misses the pool but hits the store restores the page
into a fresh block (one host→device copy, written in place: the pools'
storage never moves, since the engine's graphs hold its address) before
any device step.  Pages carry the reference's metadata and bytes, so a
page exported by one package restores in the other; with a tracer each
demotion and restore is a ``kvstore`` event.  Left for later: the mesh.
"""

from __future__ import annotations

import collections
import hashlib
import logging
import math
import time
import warnings
from functools import partial
from typing import Optional

import numpy as np
import torch

from .jit.bucketing import pow2_bucket, pow2_grid, select_bucket
from .jit.programs import WarmupTask
from .kv_store import KVPage, chain_hex
from .models._decode import PagedKV, cache_leaves, greedy_verify
from .ops.paged_attention import reserve_workspace
from .ops.ragged_paged_attention import ragged_plan
from .serving import (ContinuousBatchingEngine, _default_buckets,
                      _map_planes)

# numpy's names for the pools' dtypes (the pages' portable metadata) and
# the host storage of each (bfloat16 as its raw 16-bit words)
_NP_DTYPE_NAMES = {torch.float32: "float32", torch.float16: "float16",
                   torch.bfloat16: "bfloat16", torch.int8: "int8"}
_NP_STORAGE = {torch.float32: np.float32, torch.float16: np.float16,
               torch.bfloat16: np.uint16, torch.int8: np.int8}

__all__ = ["PagedContinuousBatchingEngine",
           "PagedSpeculativeBatchingEngine",
           "RaggedPagedContinuousBatchingEngine",
           "SpeculativeBatchingEngine"]


class PagedContinuousBatchingEngine(ContinuousBatchingEngine):
    """Continuous batching over a paged KV cache (see the module
    docstring): the contiguous engine's schedule, with block-pool storage,
    lazy block growth before each decode sync, deferral of admissions the
    pool cannot hold and youngest-first preemption.

    ``block_size`` must divide ``max_len`` and every prompt bucket.
    ``num_blocks`` defaults to the contiguous-equivalent pool
    (``max_slots × max_len / block_size``); size it smaller to cap device
    memory — the engine then admits and preempts against the real budget.

    ``enable_prefix_cache``: share complete prompt blocks between requests
    with the same padded prefix (see the module docstring); a hit runs only
    the suffix past the cached blocks (the last prompt block is always
    recomputed, for the first token's hidden state).  ``kv_store`` (a
    ``kv_store.TieredKVStore``, needs the prefix cache): eviction and
    ``flush_prefix`` demote cached blocks into it as pages, and an
    admission whose chain misses the pool but hits the store restores the
    pages into fresh blocks before the request runs.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 enable_prefix_cache: bool = False, kv_store=None, **kw):
        self.prefix_caching = bool(enable_prefix_cache)
        if kv_store is not None and not self.prefix_caching:
            raise ValueError(
                "kv_store needs enable_prefix_cache=True — pages are "
                "addressed by prefix-cache chain digests")
        self.kv_store = kv_store
        self._kv_meta = None           # kv_page_meta() computes it once
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
        # prefix cache: a block is free / referenced (refs > 0) / cached
        # (refs == 0 but registered under its chain key — evictable)
        self._refs = {}                               # bid -> refcount
        self._prefix_cache = collections.OrderedDict()  # chain -> bid (LRU)
        self._key_of = {}                             # bid -> chain

    _TICK_COUNTERS = (ContinuousBatchingEngine._TICK_COUNTERS
                      + ("blocks_allocated", "blocks_released",
                         "preemptions", "prefix_hits"))

    @property
    def preemptions(self) -> int:
        return int(self._stats.value("preemptions"))

    @property
    def prefix_hits(self) -> int:
        return int(self._stats.value("prefix_hits"))

    @property
    def prefix_blocks_reused(self) -> int:
        return int(self._stats.value("prefix_blocks_reused"))

    @property
    def blocks_high_water(self) -> int:
        return int(self._stats.value("blocks_high_water"))

    def _tick_gauges(self):
        return {"blocks_in_use": self.blocks_in_use}

    # ------------------------------------------------------------ storage --

    def _build_pool(self, c):
        """(pool_k, pool_v) for one model config, each
        (L, NB+1, bs, nh, hd) in the compute dtype — or int8
        ``(values, scales)`` pairs with fp32 (L, NB+1, bs, nh) scales."""
        nh = c.num_attention_heads
        hd = c.hidden_size // nh
        shape = (c.num_layers, self.NB + 1, self.bs, nh, hd)
        dev = self.device
        if getattr(c, "kv_cache_dtype", None) == "int8":
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
        """Blocks off the free list: referenced ones and cached ones."""
        return self.NB - len(self._free)

    def _evictable_count(self) -> int:
        """Cached prefix blocks with no live pins — allocatable on demand
        (one definition for the allocator, metrics and the ragged pack
        builder)."""
        return sum(1 for b in self._prefix_cache.values()
                   if self._refs.get(b, 0) == 0)

    def _alloc_blocks(self, n: int):
        """Take ``n`` fresh blocks (refs = 1 each) from the free list,
        evicting least-recently-used UNREFERENCED cached blocks as needed.
        TRANSACTIONAL: returns None (nothing taken) when free + evictable
        can't cover ``n`` — partial growth on a slot that then isn't
        admitted would strand blocks outside every tracked set."""
        if n <= 0:
            return []
        evictable = [c for c, b in self._prefix_cache.items()
                     if self._refs.get(b, 0) == 0]
        if n > len(self._free) + len(evictable):
            return None
        out = []
        ev = iter(evictable)                      # LRU first
        while len(out) < n:
            if self._free:
                out.append(self._free.pop())
            else:
                chain = next(ev)
                bid = self._prefix_cache.pop(chain)
                del self._key_of[bid]
                if self.kv_store is not None:
                    # eviction demotes: the page moves down the tiers
                    self._demote_page(chain, bid)
                out.append(bid)
        for bid in out:
            self._refs[bid] = 1
        self._stats.add("blocks_allocated", len(out))
        return out

    def _pin(self, bid: int):
        """Take one reference on a cached prefix block.  A 0→1 pin takes
        the block out of the evictable set and counts
        ``blocks_allocated``, mirroring ``_release``'s count at 1→0, so
        ``blocks_allocated == blocks_released`` holds at quiescence."""
        self._refs[bid] += 1
        if self._refs[bid] == 1:
            self._stats.add("blocks_allocated")

    def _release(self, bid: int):
        self._refs[bid] -= 1
        if self._refs[bid] == 0:
            self._stats.add("blocks_released")    # unpinned (maybe cached)
            if bid not in self._key_of:
                self._free.append(bid)            # cached blocks linger

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

    # ------------------------------------------------------ prefix cache --

    def _chain_keys(self, ids, pad, nblocks):
        """The chain key of each of the first ``nblocks`` prompt blocks: a
        ROLLING blake2b-256 over (pad, padded tokens through block i) —
        fixed-size keys and O(P) work an admission.  The pad length is in
        the key because it shifts logical positions: equal token blocks at
        different pads hold different k/v.  blake2b because prompt tokens
        are caller-controlled in a shared cache, where a chosen-prefix
        collision would map one caller's k/v into another's context."""
        def h(data):
            return hashlib.blake2b(data, digest_size=32).digest()

        out = []
        digest = h(str(pad).encode())
        for i in range(nblocks):
            block = np.asarray(ids[i * self.bs:(i + 1) * self.bs],
                               np.int64).tobytes()
            digest = h(digest + block)
            out.append(digest)
        return out

    def _lookup_prefix(self, ids, pad, P):
        """Longest cached chain of FULL prompt blocks, capped at P/bs - 1
        so the last prompt block is always recomputed (its forward pass
        yields the first token's hidden state).  Touches each hit in the
        LRU order; returns (F, block ids).

        With a ``kv_store``, a chain block that misses the pool but hits a
        lower tier is restored into a fresh block right here, before any
        device step, so the caller sees a plain hit.  A restore allocates,
        and allocation may evict: every matched block is pinned for the
        walk's duration and released before returning (each 0→1 and 1→0
        counted, so the allocator still balances)."""
        chains = self._chain_keys(ids, pad, P // self.bs - 1)
        F, bids = 0, []
        if self.kv_store is None:
            for chain in chains:
                bid = self._prefix_cache.get(chain)
                if bid is None:
                    break
                self._prefix_cache.move_to_end(chain)
                bids.append(bid)
                F += 1
            return F, bids
        held = []
        try:
            for chain in chains:
                bid = self._prefix_cache.get(chain)
                if bid is not None:
                    self._prefix_cache.move_to_end(chain)
                    self._pin(bid)
                else:
                    bid = self._restore_page(chain)
                    if bid is None:
                        break
                held.append(bid)
                bids.append(bid)
                F += 1
        finally:
            for bid in held:
                self._release(bid)
        return F, bids

    # ---------------------------------------------------- tiered kv store --

    def attach_kv_store(self, store):
        """Attach (or with None detach) a ``kv_store.TieredKVStore``:
        eviction demotes pages into it, admission restores from it."""
        if store is not None and not self.prefix_caching:
            raise ValueError(
                "kv_store needs enable_prefix_cache=True — pages are "
                "addressed by prefix-cache chain digests")
        self.kv_store = store
        return store

    def kv_page_meta(self):
        """The portable page signature, the reference's for the same
        engine: ``["kv1", block size, bucket ladder, [[dtype name,
        per-block shape], ...]]`` with numpy's dtype names and each
        leaf's (L, bs, …) block shape.  Two engines exchange pages iff
        their metas match (the ladder seeds the chains' pads)."""
        if self._kv_meta is None:
            self._kv_meta = ["kv1", self.bs, list(self.buckets),
                             [[_NP_DTYPE_NAMES[leaf.dtype],
                               [int(leaf.shape[0])]
                               + [int(s) for s in leaf.shape[2:]]]
                              for leaf in cache_leaves(self.caches)]]
        return self._kv_meta

    def _gather_page(self, bid: int):
        """Block ``bid`` of every pool leaf, device → host in ONE copy (the
        leaves' bytes packed on the device first).  Returns the leaves as
        numpy arrays (a bfloat16 leaf as its raw uint16 words)."""
        leaves = cache_leaves(self.caches)
        raw = torch.cat([leaf[:, bid].reshape(-1).view(torch.uint8)
                         for leaf in leaves]).cpu().numpy()
        out, o = [], 0
        for leaf in leaves:
            shape = (leaf.shape[0],) + tuple(leaf.shape[2:])
            n = int(np.prod(shape)) * leaf.element_size()
            out.append(raw[o:o + n].view(_NP_STORAGE[leaf.dtype])
                       .reshape(shape))
            o += n
        return tuple(out)

    def _scatter_page(self, bid: int, payload):
        """Write one page's leaves into pool block ``bid``, in place: one
        host → device copy of the packed bytes, then a copy into each
        leaf's block view.  The pools keep their storage — the engine's
        CUDA graphs hold its address."""
        leaves = cache_leaves(self.caches)
        raw = np.concatenate([np.ascontiguousarray(a).reshape(-1)
                              .view(np.uint8) for a in payload])
        dev = torch.from_numpy(raw).to(self.device)
        o = 0
        for leaf in leaves:
            blk = leaf[:, bid]
            n = blk.numel() * leaf.element_size()
            blk.copy_(dev[o:o + n].view(leaf.dtype).view(blk.shape))
            o += n

    def _page(self, chain, bid: int) -> KVPage:
        """Block ``bid`` as a portable page under ``chain``."""
        meta = self.kv_page_meta()
        return KVPage(chain, self._gather_page(bid), meta,
                      dtypes=[d for d, _ in meta[3]])

    def _demote_page(self, chain, bid: int):
        """Move one evicted block's content into the store (one host sync
        a demotion).  A failing store degrades to dropping the page
        (recompute stays correct)."""
        try:
            page = self._page(chain, bid)
            self.kv_store.put(page)
        except Exception:  # noqa: BLE001 — a broken store must never take
            # the allocator down; dropping the page is always safe
            logging.getLogger(__name__).exception(
                "kv_store demotion failed; page dropped")
            return
        self._stats.add("kvstore_demoted_blocks")
        if self.tracer is not None:
            self.tracer.emit("kvstore", what="demote",
                             chain=chain_hex(chain)[:16],
                             bytes=page.nbytes,
                             engine=type(self).__name__)

    def _restore_page(self, chain) -> Optional[int]:
        """Restore one lower-tier page into a freshly allocated block;
        returns the block id (held at refs 1 by the allocation — the
        caller releases) or None on a store miss or a dry pool."""
        page = self.kv_store.lookup(chain, meta=self.kv_page_meta())
        if page is None or isinstance(page.payload, bytes):
            return None
        got = self._alloc_blocks(1)
        if got is None:
            return None          # pool dry: the page stays in the store
        bid = got[0]
        self._scatter_page(bid, page.payload)
        self._prefix_cache[chain] = bid
        self._key_of[bid] = chain
        self._stats.add("kvstore_restored_blocks")
        if self.tracer is not None:
            self.tracer.emit("kvstore", what="restore",
                             chain=chain_hex(chain)[:16],
                             bytes=page.nbytes,
                             engine=type(self).__name__)
        return bid

    def export_prefix_pages(self, prompt) -> list:
        """The prompt's resident pages (its bucket's first P/bs - 1 blocks,
        the depth ``_lookup_prefix`` restores to) as ``KVPage`` objects in
        chain order: the pool first, then the store; stops at the first
        miss.  Empty without the prefix cache."""
        if not self.prefix_caching:
            return []
        prompt = [int(t) for t in prompt]
        if not prompt:
            return []
        try:
            P = select_bucket(len(prompt), self.buckets)
        except ValueError:
            return []
        pad = P - len(prompt)
        pages = []
        for chain in self._chain_keys([0] * pad + prompt, pad,
                                      max(P // self.bs - 1, 0)):
            bid = self._prefix_cache.get(chain)
            if bid is not None:
                pages.append(self._page(chain, bid))
                continue
            if self.kv_store is not None:
                page = self.kv_store.lookup(chain, meta=self.kv_page_meta())
                if page is not None:
                    pages.append(page)
                    continue
            break
        return pages

    def _warmup_kvio(self):
        """The page gather and scatter, run once before traffic: a round
        trip through the trash block 0, which nothing reads, writing back
        the bytes just read."""
        self._scatter_page(0, self._gather_page(0))

    def _register_prompt_blocks(self, slot, ids, pad, P):
        """Publish the slot's (now complete) prompt blocks into the prefix
        cache.  First writer wins: a chain already cached keeps its block,
        and this slot's copy stays private."""
        if not self.prefix_caching:
            return
        for i, chain in enumerate(self._chain_keys(ids, pad,
                                                   P // self.bs)):
            bid = int(self._table[slot, i])
            if chain not in self._prefix_cache and bid not in self._key_of:
                self._prefix_cache[chain] = bid
                self._key_of[bid] = chain

    def flush_prefix(self) -> int:
        """Free every UNREFERENCED cached prefix block from the pool
        (blocks pinned by live requests stay): with a ``kv_store`` each is
        demoted into it first, without one its content is dropped (the
        reference raises there).  Returns the count freed."""
        n = 0
        for chain, bid in list(self._prefix_cache.items()):
            if self._refs.get(bid, 0) != 0:
                continue
            del self._prefix_cache[chain]
            del self._key_of[bid]
            if self.kv_store is not None:
                self._demote_page(chain, bid)
            self._free.append(bid)
            n += 1
        return n

    def prefix_index(self):
        """``{chain_hex: tier}``: the pool's chains as ``"hbm"``, the
        store's DRAM and disk tiers merged under them."""
        idx = {chain_hex(c): "hbm" for c in self._prefix_cache}
        if self.kv_store is not None:
            for c, tier in self.kv_store.index().items():
                idx.setdefault(chain_hex(c), tier)
        return idx

    def prefix_match(self, prompt):
        """How many leading blocks of ``prompt`` are resident, a pure read
        (no LRU touch, no pin, no restore): ``hbm`` counts the leading
        pool blocks, ``total`` the leading blocks in any tier."""
        out = {"hbm": 0, "total": 0, "tiers": []}
        prompt = [int(t) for t in prompt]
        if not self.prefix_caching or not prompt:
            return out
        try:
            P = select_bucket(len(prompt), self.buckets)
        except ValueError:
            return out
        pad = P - len(prompt)
        leading_hbm = True
        for chain in self._chain_keys([0] * pad + prompt, pad,
                                      max(P // self.bs - 1, 0)):
            if chain in self._prefix_cache:
                tier = "hbm"
            else:
                tier = (self.kv_store.tier_of(chain)
                        if self.kv_store is not None else None)
                if tier is None:
                    break
            leading_hbm = leading_hbm and tier == "hbm"
            out["hbm"] += leading_hbm
            out["total"] += 1
            out["tiers"].append(tier)
        return out

    def _retire(self, slot: int):
        super()._retire(slot)
        self._free_slot_blocks(slot)

    def _release_cancelled_slot(self, slot: int):
        """Release the slot's blocks as retirement would: decode growth
        frees outright, cached prompt blocks drop their pin and linger
        evictable."""
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
        if self.tracer is not None:
            self.tracer.request_event(req.id, "preempted",
                                      slot=int(victim))
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

    def _before_first_capture(self):
        """Reserve the paged decode kernel's workspace on the capture
        stream for the widest table (``reserve_workspace``), for every
        floating-point pool the kernel walks."""
        for c in self._paged_decode_configs():
            if getattr(c, "kv_cache_dtype", None) == "int8":
                continue                   # int8 pools take the gather path
            nh = c.num_attention_heads
            reserve_workspace(self.device, self._capture_stream.cuda_stream,
                              self.S, nh, c.hidden_size // nh,
                              getattr(torch, c.compute_dtype).itemsize,
                              self.bs, self.MB)

    def _paged_decode_configs(self):
        """Configs of the models whose pools the paged decode kernel walks
        inside this engine's programs."""
        return [self.model.config]

    def _prefill_extra(self, slot, P):
        return (self._table[slot, :P // self.bs],)

    def _seg_extra(self, slot):
        return (self._table[slot],)

    def _store_prompt_kv(self, slot, P, new, live, blkrow):
        """A prefill's fresh k/v (L, 1, P, …), cut into blocks, into the
        slot's first P/bs pool blocks ``blkrow`` (already ensured; inert
        operands give a zero row: trash)."""
        nblk = P // self.bs
        idx = blkrow.long()

        def put(pool, n):
            pool[:, idx] = n.reshape((n.shape[0], nblk, self.bs)
                                     + tuple(n.shape[3:]))

        for pool, n in zip(self.caches, new):
            _map_planes(put, pool, n)

    def _suffix_prefill(self, slot, toks, t0, pad, tab):
        """Chunk prefill over the pools: gather the slot's table view
        (``tab``, its (MB,) table row), embed+decode the ``toks`` (n,)
        chunk at positions [t0, t0+n) (``t0`` a (1,) tensor) through the
        chunk path (attending to everything the table already holds),
        scatter the span back.  Returns the chunk's hidden states."""
        bs = self.bs
        tab = tab.long()

        def take(p):
            g = p[:, tab]                        # (L, MB, bs, …)
            return g.reshape((g.shape[0], g.shape[1] * g.shape[2])
                             + tuple(g.shape[3:]))[:, None]

        def view(pool):
            return (tuple(take(p) for p in pool) if isinstance(pool, tuple)
                    else take(pool))

        m = self.model
        ck_s, cv_s = view(self.caches[0]), view(self.caches[1])
        h = m._embed_chunk(toks[None], t0, pad_lens=pad)
        h, _ = m.decode_step(h, (ck_s, cv_s), t0, pad_lens=pad)
        span = t0.long() + torch.arange(toks.shape[0], device=self.device)
        pb = tab[torch.div(span, bs, rounding_mode="floor").clamp(
            max=tab.shape[0] - 1)]
        off = span % bs
        # an inert clock past max_len reads a clamped row (into trash)
        src = span.clamp(max=tab.shape[0] * bs - 1)

        def put(pool, v):
            pool[:, pb, off] = v[:, 0, src]

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

    def _decode_key(self, extra_shapes):
        return f"decode:{extra_shapes[0][1]}"

    def _warmup_tasks(self):
        """The shared prefill/segment enumeration plus one decode program
        per table width: ``pow2_grid(MB)`` is the exact set ``_view_cols``
        can select.  Prefix-hit programs (``cpre:{P}:{F}``) are built on
        first dispatch: their grid depends on the data."""
        return self._prefill_seg_tasks() + [
            self._task(f"decode:{C}",
                       partial(self._build_decode, ((self.S, C),)))
            for C in pow2_grid(self.MB)] + self._kvio_tasks()

    def _kvio_tasks(self):
        """``kvio`` rides every prefix-caching grid, store or not: a
        replica without a store still gathers pages to export them.  It
        builds no program (the gather and scatter are plain copies)."""
        return ([WarmupTask("kvio", self._warmup_kvio)]
                if self.prefix_caching else [])

    def _decode_caches(self, active, table, pools=None):
        """Both pools (the engine's own, or ``pools``) wrapped in
        ``PagedKV`` over the sync's C table columns.  INACTIVE rows are
        zeroed so their writes — whose clamped column lookup could alias
        another request's real block — land in the trash block instead."""
        pools = self.caches if pools is None else pools
        tb = torch.where(active[:, None], table, 0)
        return PagedKV(pools[0], tb), PagedKV(pools[1], tb)

    # --------------------------------------------------------- scheduling --

    def _reserve_slot(self, slot, P, pad, ids, chunked):
        """A prefix hit pins the cached chain and takes fresh blocks for
        the suffix (taken when the suffix fits one chunk, which bypasses
        chunked admission); otherwise whole-bucket admission needs its
        P/bs blocks NOW and chunked admission grows per segment.  A dry
        pool defers admission (None) — decoding slots retire and free
        blocks.  Returns the cached depth F (0 on the cold path)."""
        F, hit = (self._lookup_prefix(ids, pad, P)
                  if self.prefix_caching else (0, []))
        suffix = P - F * self.bs
        if F > 0 and (self.prefill_chunk is None
                      or suffix <= self.prefill_chunk):
            for bid in hit:                      # pin before eviction runs
                self._pin(bid)
            fresh = self._alloc_blocks(suffix // self.bs)
            if fresh is None:
                for bid in hit:
                    self._release(bid)
                return None
            self._table[slot, :F] = hit
            self._table[slot, F:F + len(fresh)] = fresh
            self._nblk[slot] = P // self.bs
            self._stats.set("blocks_high_water",
                            max(self.blocks_high_water, self.blocks_in_use))
            self._stats.add("prefix_hits")
            self._stats.add("prefix_blocks_reused", F)
        else:
            F = 0
            if not chunked and not self._ensure_blocks(slot, P):
                return None
        self._seq += 1
        self._admit_seq[slot] = self._seq
        return F

    def _build_cpre(self, P, F):
        """Program ``cpre:{P}:{F}``: prefix-hit admission of bucket P with
        F cached blocks — operands ids (P,), (slot, pad, t0, live) and the
        slot's (MB,) table row."""
        t0s = F * self.bs

        def fn(ids, meta, tab):
            slot, pad, t0, live = self._meta(meta)
            h = self._suffix_prefill(slot, ids[t0s:], t0, pad, tab)
            self._seed_presence(slot, ids[None], pad, live)
            return self._first_token(h[:, -1:], slot, live)

        return self._program(f"cpre:{P}:{F}", fn, [(P,), (4,), (self.MB,)],
                             [np.zeros(P), [0, 0, self.max_len, 0],
                              np.zeros(self.MB)])

    def _run_cached_prefill(self, slot, req, P, pad, ids, F):
        """Prefix-hit admission: run only the suffix [F·bs, P) through the
        chunk path, attending to the shared prefix through the slot's
        table; the presence row seeds from the FULL prompt."""
        tok0 = self._dispatch(f"cpre:{P}:{F}", partial(self._build_cpre, P, F),
                              ids, (slot, pad, F * self.bs, 1),
                              self._table[slot])
        self._register_prompt_blocks(slot, ids, pad, P)
        self._activate(slot, req, P, pad, int(tok0))

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

    def add_request(self, prompt, max_new_tokens: int, on_token=None,
                    trace_ctx=None, **sampling) -> int:
        """Queue a prompt (the base contract); refuses a request the pool
        could never hold.  A preempted request keeps its id, so its replay
        events stay on the same trace."""
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
                                   on_token=on_token, trace_ctx=trace_ctx,
                                   **sampling)

    METRICS_SCHEMA = {
        "blocks_in_use": ("gauge", float),
        "blocks_high_water": ("gauge", float),
        "blocks_allocated": ("counter", float),
        "blocks_released": ("counter", float),
        "preemptions": ("counter", float),
        # present only with enable_prefix_cache=True:
        "blocks_cached": ("gauge", float),
        "prefix_hits": ("counter", float),
        "prefix_blocks_reused": ("counter", float),
        # present only with an attached kv_store (tiered page store):
        "kvstore_restored_blocks": ("counter", float),
        "kvstore_demoted_blocks": ("counter", float),
    }

    def metrics(self):
        m = super().metrics()
        m["blocks_in_use"] = float(self.blocks_in_use)
        m["blocks_high_water"] = float(self.blocks_high_water)
        m["blocks_allocated"] = float(self._stats.value("blocks_allocated"))
        m["blocks_released"] = float(self._stats.value("blocks_released"))
        m["preemptions"] = float(self.preemptions)
        if self.prefix_caching:
            m["blocks_cached"] = float(self._evictable_count())
            m["prefix_hits"] = float(self.prefix_hits)
            m["prefix_blocks_reused"] = float(self.prefix_blocks_reused)
        if self.kv_store is not None:
            m["kvstore_restored_blocks"] = float(
                self._stats.value("kvstore_restored_blocks"))
            m["kvstore_demoted_blocks"] = float(
                self._stats.value("kvstore_demoted_blocks"))
        return m




class RaggedPagedContinuousBatchingEngine(PagedContinuousBatchingEngine):
    """Continuous batching where each scheduler step is ONE mixed
    prefill+decode ragged pack (see the module docstring).

    ``token_budget`` rows per step (default ``max_slots`` × rows a slot —
    K+1 with a draft, else 1 — plus the largest prompt bucket) must cover
    every decode slot; prompts longer than the remaining budget prefill
    across several steps.  Outputs are greedy-exact against the reference
    engine for the same weights and arrival schedule, fp and int8 pools
    alike.

    ``draft_model`` (a port ``GPTModel`` on the engine's device, same
    vocabulary) and ``draft_k`` turn on speculative decoding inside the
    pack (module docstring); its pool shares the target's tables and
    allocator.  The port's models hold their own weights, so
    ``draft_params`` exists for signature parity only: it must be None or
    ``draft_model.state_dict()``.  Speculation is greedy-only: sampling,
    per-request planes, the repetition penalty and ``min_new_tokens``
    raise.  ``add_request(spec=False)`` opts one request out.
    """

    def __init__(self, model, max_slots: int, max_len: int,
                 token_budget: Optional[int] = None, draft_model=None,
                 draft_params=None, draft_k: int = 4, **kw):
        if kw.get("prefill_chunk") is not None:
            raise ValueError(
                "the ragged engine chunks prefill via token_budget; "
                "prefill_chunk is the bucketed engines' knob")
        if int(kw.pop("ticks_per_sync", 1)) != 1:
            raise NotImplementedError(
                "the ragged engine syncs every step — amortize dispatch "
                "with token_budget, not ticks_per_sync")
        if not hasattr(model, "decode_ragged"):
            raise NotImplementedError(
                f"{type(model).__name__} has no decode_ragged path — use "
                f"PagedContinuousBatchingEngine")
        self.draft_model = draft_model
        self.K = int(draft_k)
        if draft_model is not None:
            dc = draft_model.config
            if dc.vocab_size != model.config.vocab_size:
                raise ValueError(
                    f"draft vocab ({dc.vocab_size}) != target vocab "
                    f"({model.config.vocab_size})")
            if max_len > dc.max_position_embeddings:
                raise ValueError(
                    f"max_len {max_len} exceeds the DRAFT's "
                    f"max_position_embeddings "
                    f"({dc.max_position_embeddings})")
            if self.K < 1:
                raise ValueError("draft_k must be >= 1")
            if not hasattr(draft_model, "decode_ragged"):
                raise NotImplementedError(
                    f"{type(draft_model).__name__} has no decode_ragged "
                    f"path — the spec step ingests the pack into the draft "
                    f"pool through it")
            if draft_params is not None:
                own = draft_model.state_dict()
                if not (hasattr(draft_params, "keys")
                        and set(draft_params) == set(own)
                        and all(torch.is_tensor(draft_params[n])
                                and draft_params[n].data_ptr()
                                == v.data_ptr() for n, v in own.items())):
                    raise ValueError(
                        "draft_params must be None or draft_model."
                        "state_dict(): the port's models hold their own "
                        "weights")
            # the acceptance rule compares ARGMAX predictions, so sampling
            # and the logits processors are out of scope
            if kw.get("per_request_sampling"):
                raise NotImplementedError(
                    "ragged speculation is greedy-only; "
                    "per_request_sampling is the plain engines' knob")
            if not kw.get("greedy", True):
                raise NotImplementedError(
                    "ragged speculation is greedy-only (the acceptance "
                    "rule is the longest argmax-matching prefix)")
            if float(kw.get("repetition_penalty", 1.0)) != 1.0 \
                    or int(kw.get("min_new_tokens", 0) or 0) != 0:
                raise NotImplementedError(
                    "ragged speculation does not support "
                    "repetition_penalty/min_new_tokens yet")
        super().__init__(model, max_slots, max_len, **kw)
        rows_per_slot = self.K + 1 if draft_model is not None else 1
        tb = (int(token_budget) if token_budget is not None
              else int(max_slots) * rows_per_slot + max(self.buckets))
        if tb < int(max_slots):
            raise ValueError(
                f"token_budget ({tb}) must cover every decode slot "
                f"(max_slots={max_slots})")
        self.token_budget = tb
        # per-slot speculation flag (set at admission from the request's
        # spec flag) and the add_request validation seam
        self._spec_slot = np.zeros(self.S, bool)
        self._pending_spec: Optional[bool] = None
        if draft_model is not None:
            d_dev = next(draft_model.parameters()).device
            if d_dev != self.device:
                raise ValueError(f"the draft's parameters live on {d_dev}, "
                                 f"the engine runs on {self.device}")
            self.draft_caches = self._build_pool(dc)

    _TICK_COUNTERS = (PagedContinuousBatchingEngine._TICK_COUNTERS
                      + ("tokens_drafted", "tokens_accepted"))

    METRICS_SCHEMA = {
        "ragged_steps": ("counter", float),
        "mixed_steps": ("counter", float),
        # present only with a draft model (ragged speculation):
        "spec_rounds": ("counter", int),
        "tokens_drafted": ("counter", int),
        "tokens_accepted": ("counter", int),
        "acceptance_rate": ("gauge", float),
        "accepted_tokens_per_s": ("gauge", float),
    }

    @property
    def ragged_steps(self) -> int:
        return int(self._stats.value("ragged_steps"))

    @property
    def mixed_steps(self) -> int:
        """Steps that carried prefill AND decode rows."""
        return int(self._stats.value("mixed_steps"))

    @property
    def spec_rounds(self) -> int:
        """Steps that carried at least one slot's draft+verify rows."""
        return int(self._stats.value("spec_rounds"))

    # the legacy speculative engines' name for it
    rounds = spec_rounds

    @property
    def tokens_drafted(self) -> int:
        return int(self._stats.value("tokens_drafted"))

    @property
    def tokens_accepted(self) -> int:
        return int(self._stats.value("tokens_accepted"))

    @property
    def acceptance_rate(self) -> float:
        return self.tokens_accepted / max(self.tokens_drafted, 1)

    def metrics(self):
        m = super().metrics()
        m["ragged_steps"] = float(self.ragged_steps)
        m["mixed_steps"] = float(self.mixed_steps)
        if self.draft_model is not None:
            dt = max(time.monotonic() - self._started, 1e-9)
            m["spec_rounds"] = self.spec_rounds
            m["tokens_drafted"] = self.tokens_drafted
            m["tokens_accepted"] = self.tokens_accepted
            m["acceptance_rate"] = float(self.acceptance_rate)
            m["accepted_tokens_per_s"] = self.tokens_accepted / dt
        return m

    # --------------------------------------------------------- scheduling --

    def _positions_needed(self, P: int, mnt: int) -> int:
        spec = (self._pending_spec if self._pending_spec is not None
                else self.draft_model is not None)
        if self.draft_model is not None and spec:
            # budget 1 completes at admission; otherwise the LAST round can
            # start at t = P + mnt - 2 and write its K+1-wide verify chunk
            return P if mnt == 1 else P + mnt + self.K - 1
        return super()._positions_needed(P, mnt)

    def add_request(self, prompt, max_new_tokens: int, on_token=None,
                    spec: Optional[bool] = None, trace_ctx=None,
                    **sampling) -> int:
        """The base contract plus the per-request speculation flag:
        ``spec=None`` speculates iff the engine has a draft model,
        ``spec=False`` opts this request out (plain decode rows in the same
        steps), ``spec=True`` needs a draft.  The flag changes how fast a
        request decodes, never its tokens."""
        if spec and self.draft_model is None:
            raise ValueError("add_request(spec=True) needs an engine "
                             "constructed with draft_model=")
        eff = (self.draft_model is not None) if spec is None else bool(spec)
        self._pending_spec = eff
        try:
            rid = super().add_request(prompt, max_new_tokens,
                                      on_token=on_token,
                                      trace_ctx=trace_ctx, **sampling)
        finally:
            self._pending_spec = None
        self._queue[-1].spec = eff        # the base just appended it
        return rid

    def _set_planes(self, slot, req):
        super()._set_planes(slot, req)
        self._spec_slot[slot] = bool(getattr(req, "spec", False))

    def _admit(self):
        """Admission reserves a slot and, on a prefix hit, pins the cached
        chain — no device work and no block allocation happen here (beyond
        seeding the presence row); the prompt's rows flow into later
        ragged steps as budget and blocks allow."""
        free = self._free_slots()
        while self._queue and free:
            slot = free.pop(0)
            req = self._queue.pop(0)
            P = select_bucket(len(req.prompt), self.buckets)
            pad = P - len(req.prompt)
            ids = [0] * pad + req.prompt
            F, hit = (self._lookup_prefix(ids, pad, P)
                      if self.prefix_caching else (0, []))
            if F:
                for bid in hit:                  # pin before eviction runs
                    self._pin(bid)
                self._table[slot, :F] = hit
                self._nblk[slot] = F
                self._stats.add("prefix_hits")
                self._stats.add("prefix_blocks_reused", F)
            self._seq += 1
            self._admit_seq[slot] = self._seq
            self._set_planes(slot, req)
            self._pad[slot] = pad
            self._t[slot] = 0
            # presence seeds from the FULL prompt (shared prefix tokens
            # count for the penalty although their rows never run)
            self._seed_presence(slice(slot, slot + 1),
                                self._i32([req.prompt]), None)
            self._filling[slot] = {"req": req, "ids": ids, "pad": pad,
                                   "P": P, "filled": F * self.bs}

    def _build_pack(self):
        """Assemble one step's flattened ragged pack: all active decode
        rows first (block coverage grown via _prepare_decode, preempting
        the youngest when dry), then prefill chunks oldest-first into the
        remaining budget (a dry pool shrinks the chunk — the filler stalls
        while decode retirements free blocks).  Returns None when there is
        nothing to run.

        With a draft model, a speculating slot claims K extra rows right
        after its next-token row — the verify chunk [prev, d_0..d_{K-1}]
        at kv positions [t, t+K]; the proposals' values are filled in on
        the device.  Speculation is per slot and opportunistic: a tight
        budget, a dry pool or no room left in max_len makes the slot a
        plain decode row for this step."""
        T = self.token_budget
        if self._active.any():
            self._prepare_decode()
        toks = np.zeros(T, np.int32)
        row_seq = np.full(T, -1, np.int32)
        row_pos = np.full(T, -1, np.int32)
        sample_rows = np.zeros(self.S, np.int32)
        sample_active = np.zeros(self.S, bool)
        spec_row0 = np.zeros(self.S, np.int32)
        spec_active = np.zeros(self.S, bool)
        K = self.K if self.draft_model is not None else 0
        n = 0
        dec_slots = [int(s) for s in np.flatnonzero(self._active)]
        for idx, slot in enumerate(dec_slots):
            toks[n] = self._tok[slot]
            row_seq[n] = slot
            row_pos[n] = self._t[slot]
            sample_rows[slot] = n
            sample_active[slot] = True
            n += 1
            remaining = len(dec_slots) - idx - 1   # slots still owed a row
            t = int(self._t[slot])
            if (K and self._spec_slot[slot]
                    and t + K + 1 <= self.max_len
                    and n + K + remaining <= T
                    and self._ensure_blocks(slot, t + K + 1)):
                row_seq[n:n + K] = slot
                row_pos[n:n + K] = t + 1 + np.arange(K)
                spec_row0[slot] = n
                spec_active[slot] = True
                n += K
        fill_adv = {}
        for slot in sorted(self._filling,
                           key=lambda s: int(self._admit_seq[s])):
            if n >= T:
                break
            st = self._filling[slot]
            want = min(st["P"] - st["filled"], T - n)
            have = int(self._nblk[slot])
            if have * self.bs < st["filled"] + want:
                # grant what free + evictable blocks cover in ONE
                # transactional request
                grantable = len(self._free) + self._evictable_count()
                need = -(-(st["filled"] + want) // self.bs) - have
                take = min(need, grantable)
                if take > 0:
                    self._ensure_blocks(slot, (have + take) * self.bs)
            m = min(want, int(self._nblk[slot]) * self.bs - st["filled"])
            if m <= 0:
                continue
            f = st["filled"]
            toks[n:n + m] = st["ids"][f:f + m]
            row_seq[n:n + m] = slot
            row_pos[n:n + m] = f + np.arange(m)
            n += m
            fill_adv[slot] = m
            if f + m == st["P"]:
                # the prompt's last row yields the first-token hidden state
                sample_rows[slot] = n - 1
                sample_active[slot] = True
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
        return (toks, row_seq, row_pos, C, sample_rows, sample_active,
                dec_slots, fill_adv, spec_row0, spec_active)

    def _step_impl(self):
        """One scheduler round: admit, pack, run the ragged step (the
        speculative one with a draft model), unpack sampled tokens (decode
        slots advance; completed prompts activate with their first
        token)."""
        self._admit()
        pack = self._build_pack()
        if pack is None:
            return
        (toks, row_seq, row_pos, C, sample_rows, sample_active, dec_slots,
         fill_adv, spec_row0, spec_active) = pack
        if self.draft_model is not None:
            return self._run_spec_pack(toks, row_seq, row_pos, C,
                                       sample_rows, dec_slots, fill_adv,
                                       spec_row0, spec_active)
        if self.tracer is not None:
            self._note_pack(len(dec_slots), fill_adv, C)
        emitted0 = np.asarray(
            [len(self._slot_req[s].generated) if self._active[s] else 0
             for s in range(self.S)], np.int32)
        ntok = self._run_pack(toks, row_seq, row_pos, C, sample_rows,
                              sample_active, emitted0)
        self._stats.add("ragged_steps")
        for slot in dec_slots:
            self._t[slot] += 1
            self._tok[slot] = int(ntok[slot])
            self._record(slot, int(ntok[slot]))
            # room safety net (admission-validated budgets never trigger)
            if self._active[slot] and int(self._t[slot]) + 1 > self.max_len:
                self._retire(slot)
        self._advance_fills(fill_adv, ntok)

    def _note_pack(self, n_dec, fill_adv, C, spec_rows=None):
        """The tick notes of one ragged pack: decode rows, prefill rows,
        the budget they used, the budget and table width, and with a draft
        the speculative rows (tracing on only)."""
        pf = int(sum(fill_adv.values()))
        note = self._tick_note
        note["decode_rows"] = note.get("decode_rows", 0) + n_dec
        if spec_rows is not None:
            note["spec_rows"] = note.get("spec_rows", 0) + spec_rows
        note["prefill_tokens"] = note.get("prefill_tokens", 0) + pf
        note["budget_used"] = note.get("budget_used", 0) + n_dec \
            + (spec_rows or 0) + pf
        note["token_budget"] = self.token_budget
        note["table_cols"] = C

    def _advance_fills(self, fill_adv, first):
        """Advance each filling slot by its rows of this step; a completed
        prompt publishes its blocks and activates with its first token
        ``first[slot]``."""
        for slot, m in fill_adv.items():
            st = self._filling[slot]
            st["filled"] += m
            if st["filled"] == st["P"]:
                del self._filling[slot]
                self._register_prompt_blocks(slot, st["ids"], st["pad"],
                                             st["P"])
                self._activate(slot, st["req"], st["P"], st["pad"],
                               int(first[slot]))

    def _plan(self, row_seq, row_pos, pads):
        """The pack's ``ragged_plan``, built on the host (it depends on the
        rows and pads only) and shipped with the other operands."""
        return ragged_plan(torch.from_numpy(np.asarray(row_seq, np.int32)),
                           torch.from_numpy(np.asarray(row_pos, np.int32)),
                           torch.from_numpy(np.asarray(pads, np.int32))
                           ).numpy()

    def _inert_rows(self, C):
        """Inert pack rows for a C-wide program: every row on slot 0, whose
        table row is zero (writes land in trash block 0), at positions
        across the table; nothing sampled.  Returns (row_seq, row_pos,
        pads, plan)."""
        T = self.token_budget
        seq = np.zeros(T, np.int32)
        pos = np.minimum(np.arange(T), C * self.bs - 1).astype(np.int32)
        pads = np.zeros(self.S, np.int32)
        return seq, pos, pads, self._plan(seq, pos, pads)

    def _build_ragged(self, C):
        """Program ``ragged_step:{T}:{C}``: the device half of a plain step
        — embed → all layers → head over the S sampled rows →
        ``_sample_tail`` (only sampled rows join their presence rows);
        returns the (S,) tokens.  Rows of slots with nothing to sample
        read a dummy row (computed, ignored)."""
        T, S = self.token_budget, self.S
        m = self.model

        def fn(toks_d, seq_d, pos_d, pad_d, samp_d, sact_d, emit_d, table,
               plan):
            h = m._embed_ragged(toks_d, seq_d, pos_d, pad_d)
            h, _ = m.decode_ragged(h, self.caches, table, seq_d, pos_d,
                                   pad_d, plan)
            logits = m.decode_logits(h[0, samp_d.long()][:, None])[:, -1]
            return self._sample_tail(logits, None, emit_d, sact_d.bool())

        seq, pos, pads, plan = self._inert_rows(C)
        z = np.zeros(S, np.int32)
        return self._program(
            f"ragged_step:{T}:{C}", fn,
            [(T,)] * 3 + [(S,)] * 4 + [(S, C), plan.shape],
            [np.zeros(T), seq, pos, pads, z, z, z, np.zeros((S, C)), plan])

    def _run_pack(self, toks, row_seq, row_pos, C, sample_rows,
                  sample_active, emitted0):
        """A plain step's program on one host→device copy of its operands
        (the plan built here), then one device→host read of the (S,)
        tokens."""
        T = self.token_budget
        ntok = self._dispatch(
            f"ragged_step:{T}:{C}", partial(self._build_ragged, C), toks,
            row_seq, row_pos, self._pad, sample_rows, sample_active,
            emitted0, self._table[:, :C],
            self._plan(row_seq, row_pos, self._pad))
        return ntok.cpu().numpy()

    def _warmup_tasks(self):
        """One program per (token_budget, table width): ``pow2_grid(MB)``
        is every width ``_build_pack`` can select, so a warmed engine
        never builds a program while it serves.  With a draft model the
        fused draft+verify program takes the plain one's place, bucket for
        bucket."""
        T = self.token_budget
        if self.draft_model is not None:
            kind, build = "ragged_spec", self._build_spec
        else:
            kind, build = "ragged_step", self._build_ragged
        return [self._task(f"{kind}:{T}:{C}", partial(build, C))
                for C in pow2_grid(self.MB)] + self._kvio_tasks()

    def _paged_decode_configs(self):
        return ([] if self.draft_model is None
                else [self.draft_model.config])

    # ------------------------------------------- speculative ragged step --

    def _run_spec_pack(self, toks, row_seq, row_pos, C, sample_rows,
                       dec_slots, fill_adv, spec_row0, spec_active):
        """Run one speculative step and unpack: a speculating slot advances
        by its accepted count + 1, plain decode slots and completing
        prompts by their one greedy token (``block[:, 0]``)."""
        K = self.K
        n_spec = int(spec_active.sum())
        if self.tracer is not None:
            self._note_pack(len(dec_slots), fill_adv, C, n_spec * K)
        lead, block = self._spec_step(toks, row_seq, row_pos, C,
                                      sample_rows, spec_row0, spec_active)
        self._stats.add("ragged_steps")
        if n_spec:
            self._stats.add("spec_rounds")
            self._stats.add("tokens_drafted", n_spec * K)
        for slot in dec_slots:
            m = int(lead[slot]) + 1 if spec_active[slot] else 1
            if spec_active[slot]:
                self._stats.add("tokens_accepted", int(lead[slot]))
            for j in range(m):
                if not self._active[slot]:
                    break              # retired/cancelled mid-round:
                self._t[slot] += 1     # discard the round's tail
                self._tok[slot] = int(block[slot, j])
                self._record(slot, int(block[slot, j]))
            if self._active[slot]:
                if int(self._t[slot]) + 1 > self.max_len:
                    self._retire(slot)         # room safety net
                elif spec_active[slot]:
                    self._rollback_blocks(slot)
        self._advance_fills(fill_adv, block[:, 0])

    def _rollback_blocks(self, slot: int):
        """Free the slot's table columns past the accepted clock: blocks
        that only ever held rejected draft k/v.  Prompt and prefix blocks
        sit below the clock and are never touched."""
        keep = -(-int(self._t[slot]) // self.bs)
        have = int(self._nblk[slot])
        if have <= keep:
            return
        for c in range(have - 1, keep - 1, -1):
            self._release(int(self._table[slot, c]))
            self._table[slot, c] = 0
        self._nblk[slot] = keep

    def _build_spec(self, C):
        """Program ``ragged_spec:{T}:{C}``: the device half of a
        speculative step — (1) the draft proposes K greedy tokens a slot
        with ``decode_step`` over its pool (``_decode_caches`` gates the
        table to speculating rows: the others write to trash; it runs
        every step, whether or not a slot speculates), (2) the proposals
        are scattered into the pack (a non-speculating slot's into the
        scratch row T, past the pack), (3) the target runs the whole pack,
        (4) the draft takes in the same pack, (5) ``greedy_verify`` over
        each slot's K+1 rows (a plain slot gathers its one row K+1 times;
        its lead is forced to 0).  Returns (S, K+2): the lead, then the
        token block."""
        K, S, T = self.K, self.S, self.token_budget
        m, dm = self.model, self.draft_model

        def fn(toks_x, seq_d, pos_d, pad_d, tok_d, t_d, sact_d, grows_d,
               drow_d, table, plan):
            spec = sact_d.bool()
            d = self._draft_propose(tok_d, t_d, pad_d, spec, table)
            toks_x[drow_d.long()] = d.reshape(-1).to(toks_x.dtype)
            toks_d = toks_x[:T]
            h = m._embed_ragged(toks_d, seq_d, pos_d, pad_d)
            h, _ = m.decode_ragged(h, self.caches, table, seq_d, pos_d,
                                   pad_d, plan)
            hd = dm._embed_ragged(toks_d, seq_d, pos_d, pad_d)
            dm.decode_ragged(hd, self.draft_caches, table, seq_d, pos_d,
                             pad_d, plan)
            h_s = h[0, grows_d.long().view(S, K + 1)]       # (S, K+1, H)
            tpred = torch.argmax(m.decode_logits(h_s), -1)  # (S, K+1)
            lead, block = greedy_verify(d, tpred, active=spec)
            return torch.cat([lead[:, None].to(block.dtype), block], 1)

        seq, pos, pads, plan = self._inert_rows(C)
        z = np.zeros(S, np.int32)
        return self._program(
            f"ragged_spec:{T}:{C}", fn,
            [(T + 1,), (T,), (T,)] + [(S,)] * 4
            + [(S * (K + 1),), (S * K,), (S, C), plan.shape],
            [np.zeros(T + 1), seq, pos, pads, z, z, z,
             np.zeros(S * (K + 1)), np.full(S * K, T), np.zeros((S, C)),
             plan])

    def _spec_step(self, toks, row_seq, row_pos, C, sample_rows, spec_row0,
                   spec_active):
        """A speculative step's program on one host→device copy of its
        operands (the plan built here: it depends on rows and pads only),
        then one device→host read of (lead, block)."""
        K, S, T = self.K, self.S, self.token_budget
        sl = np.flatnonzero(spec_active)
        # proposal j of slot s goes to pack row spec_row0[s] + j; the
        # other slots' proposals to the scratch row T
        drow = np.full((S, K), T, np.int32)
        drow[sl] = spec_row0[sl][:, None] + np.arange(K)
        grows = sample_rows[:, None] \
            + np.arange(K + 1)[None] * spec_active[:, None]
        out = self._dispatch(
            f"ragged_spec:{T}:{C}", partial(self._build_spec, C),
            np.append(toks, 0), row_seq, row_pos, self._pad, self._tok,
            self._t, spec_active, grows, drow, self._table[:, :C],
            self._plan(row_seq, row_pos, self._pad)).cpu().numpy()
        return out[:, 0], out[:, 1:]

    def _draft_propose(self, tok, t, pads, spec, table):
        """K greedy draft steps over the draft pool from each slot's last
        token at its clock; non-speculating rows see a zeroed table and
        write to trash.  Returns (S, K) proposals."""
        dm = self.draft_model
        caches = self._decode_caches(spec, table, pools=self.draft_caches)
        d = []
        for i in range(self.K):
            h = dm._embed_one(tok, t + i, pad_lens=pads)
            h, _ = dm.decode_step(h, caches, t + i, pad_lens=pads)
            tok = torch.argmax(dm.decode_logits(h)[:, -1], -1)
            d.append(tok)
        return torch.stack(d, 1)


# ---------------------------------------------------------------------------
# the legacy speculative engines — deprecated shims over the ragged engine
# ---------------------------------------------------------------------------

_SPEC_SHIM_WARNED: set = set()


def _warn_spec_shim(name: str):
    """Warn ONCE per legacy engine class."""
    if name in _SPEC_SHIM_WARNED:
        return
    _SPEC_SHIM_WARNED.add(name)
    warnings.warn(
        f"{name} is deprecated: speculative decoding runs inside "
        f"RaggedPagedContinuousBatchingEngine (draft_model=/draft_k= "
        f"constructor args); this shim maps the legacy constructor onto "
        f"it", DeprecationWarning, stacklevel=3)


class SpeculativeBatchingEngine(RaggedPagedContinuousBatchingEngine):
    """DEPRECATED shim: the legacy contiguous speculative engine's
    constructor (no storage knobs) mapped onto the ragged engine, with a
    block size derived from max_len and the bucket ladder.  Outputs keep
    the greedy contract; ``rounds`` reports the speculative rounds."""

    _SUPPORTED_CACHE_KW = frozenset({"tracer"})

    def __init__(self, model, draft_model, max_slots: int, max_len: int,
                 draft_k: int = 4, prompt_buckets=None, eos_token_id=None,
                 generator=None, draft_params=None, device=None,
                 **cache_kw):
        _warn_spec_shim(type(self).__name__)
        bad = set(cache_kw) - self._SUPPORTED_CACHE_KW
        if bad:
            raise NotImplementedError(
                f"{type(self).__name__} does not support {sorted(bad)}")
        buckets = (_default_buckets(max_len) if prompt_buckets is None
                   else sorted(set(int(b) for b in prompt_buckets)))
        # the largest block size dividing max_len and every bucket
        bs = math.gcd(int(max_len), *[int(b) for b in buckets])
        super().__init__(model, max_slots, max_len, draft_model=draft_model,
                         draft_params=draft_params, draft_k=draft_k,
                         prompt_buckets=buckets, eos_token_id=eos_token_id,
                         generator=generator, block_size=bs, device=device,
                         **cache_kw)


class PagedSpeculativeBatchingEngine(SpeculativeBatchingEngine):
    """DEPRECATED shim: the legacy paged speculative engine's constructor
    mapped onto the ragged engine, which already keeps the draft pool
    behind the target's tables and allocator.  ``prefill_chunk`` is
    accepted and dropped: the ragged engine chunks by token_budget."""

    _SUPPORTED_CACHE_KW = frozenset({"block_size", "num_blocks",
                                     "enable_prefix_cache",
                                     "prefill_chunk", "tracer"})

    def __init__(self, model, draft_model, max_slots: int, max_len: int,
                 draft_k: int = 4, prompt_buckets=None, eos_token_id=None,
                 generator=None, draft_params=None, device=None,
                 block_size: int = 16, num_blocks=None, **kw):
        _warn_spec_shim(type(self).__name__)
        bad = set(kw) - self._SUPPORTED_CACHE_KW
        if bad:
            raise NotImplementedError(
                f"{type(self).__name__} does not support {sorted(bad)}")
        kw.pop("prefill_chunk", None)
        RaggedPagedContinuousBatchingEngine.__init__(
            self, model, max_slots, max_len, draft_model=draft_model,
            draft_params=draft_params, draft_k=draft_k,
            prompt_buckets=prompt_buckets, eos_token_id=eos_token_id,
            generator=generator, block_size=block_size,
            num_blocks=num_blocks, device=device, **kw)

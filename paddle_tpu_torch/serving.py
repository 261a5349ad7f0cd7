"""Continuous-batching serving over a contiguous KV cache (a subset of
``paddle_tpu/serving.py``).

Requests join and leave a running decode batch at any scheduler round:

- one global KV cache of ``max_slots`` rows (a slot = one in-flight
  request, layout (num_layers, S, max_len, nh, hd) — slot is the batch
  index), updated in place;
- admission prefills ONE slot's cache region (prompts are left-padded to
  their bucket; ``pad_lens`` masks pad keys and shifts positions), whole
  or in ``prefill_chunk`` segments interleaved with everyone's decode;
- every decode sync runs ``ticks_per_sync`` ticks over all S slots with
  per-row cache clocks, keeps the tokens on the device and reads the
  (k, S) block back once; inactive slots are carried inert: their clock is
  frozen and their stale writes land at positions a future occupant
  overwrites before it can ever read them (decode at position u writes u
  before attending <= u).

``ContinuousBatchingEngine`` also holds the host-side lifecycle every
engine shares — validation, slots, admission bookkeeping, token recording
with EOS/budget retirement, cancellation, counters; the paged engines
(``serving_paged``) replace the cache storage and the device programs::

    eng = ContinuousBatchingEngine(model, max_slots=8, max_len=256)
    rid = eng.add_request([12, 71, 9], max_new_tokens=32)
    while eng.pending():          # interleaves admission + batched decode
        eng.step()
    out = eng.pop_finished()[rid]

Greedy by default; temperature/top-k/top-p sampling draws from the
engine's ``torch.Generator``.  ``repetition_penalty`` and
``min_new_tokens`` run engine-wide through a per-slot (S, V) presence
plane on the device (seeded at admission from the prompt) and per-row EOS
windows; with ``per_request_sampling=True`` every sampler knob becomes a
per-request ``add_request`` argument carried in per-slot planes, and one
sampler call per tick serves any mixture of configs.

Every device step is a PROGRAM (``jit/programs.py``): the admission
prefill per bucket (``prefill:{P}``), the prefill segments
(``seg:{chunk}:{first}{last}``) and the decode sync (``decode``; the paged
engine's ``decode:{C}`` per table width).  The slot, pad, ids, clocks and
table rows are the program's int32 operands, so one program serves every
slot; on a card a program is one CUDA graph, replayed as one launch.
``compile_grid()`` names every program the engine can dispatch and
``warmup()`` builds them before traffic, so a warmed engine serves with
zero program-cache misses.  Programs are cached per engine (a graph binds
this engine's pools), not per model as in the reference.

With ``tracer=`` (a ``telemetry.Tracer``) every engine emits the
reference's tick, compile and request events, host-side only: the same
programs and CUDA graphs run with or without it.
"""

from __future__ import annotations

import itertools
import logging
import threading
import time
from functools import partial
from typing import Dict, List, Optional

import numpy as np
import torch

from . import resolve_device
from .jit.bucketing import select_bucket
from .jit.programs import GraphProgram, WarmupTask, run_warmup, warmup_async
from .models._decode import (apply_repetition_penalty, make_row_sampler,
                             make_token_sampler, seed_presence,
                             suppress_eos, suppress_eos_rows,
                             validate_sampler_args)
from .utils.stats import StatRegistry, stat_add
from .utils.stats import prometheus_text as _prometheus_text

__all__ = ["ContinuousBatchingEngine", "Request"]


class _FirstDispatchTimer:
    """A freshly built program whose FIRST dispatch — a call, or the
    ``compile()`` a warmup task makes — is wall-timed and reported through
    ``report(seconds)``; later dispatches go straight through.  Installed
    only on a cache miss with a tracer attached.  The timing adds no
    device synchronisation: on a card the eager run and the capture
    synchronise on their own, so the wall ends at the first replay's
    launch.  ``report`` runs after the dispatch, so the capture never
    happens under a tracer lock."""

    __slots__ = ("prog", "report", "done")

    def __init__(self, prog, report):
        self.prog = prog
        self.report = report
        self.done = False

    def _timed(self, fn, *a):
        if self.done:
            return fn(*a)
        t0 = time.perf_counter()
        out = fn(*a)
        self.done = True
        self.report(time.perf_counter() - t0)
        return out

    def __call__(self, *host):
        return self._timed(self.prog, *host)

    def compile(self):
        return self._timed(self.prog.compile)


def _event_label(key: str) -> str:
    """A program's label in telemetry events: the reference's
    ``program_label`` of its key — the kind and its leading sizes.  A
    segment program's first/last flags are bools in the reference's key,
    which end the label (task ``seg:8:01``, event ``seg:8``)."""
    return key.rsplit(":", 1)[0] if key.startswith("seg:") else key


def _default_buckets(max_len: int) -> List[int]:
    return [b for b in (16, 32, 64, 128, 256, 512, 1024)
            if b <= max_len] or [int(max_len)]


class Request:
    """One in-flight generation request (host-side bookkeeping)."""

    def __init__(self, rid: int, prompt: List[int], max_new_tokens: int):
        self.id = rid
        self.prompt = list(prompt)
        self.max_new_tokens = int(max_new_tokens)
        self.generated: List[int] = []
        self.done = False
        self.enqueued_at = time.monotonic()
        self.first_token_at: Optional[float] = None
        self.finished_at: Optional[float] = None
        self.on_token = None          # optional streaming callback

    def __repr__(self):
        return (f"Request(id={self.id}, prompt_len={len(self.prompt)}, "
                f"generated={len(self.generated)}, done={self.done})")


def _map_planes(fn, big, new):
    """Apply ``fn(big_plane, new_plane)`` to a cache and its update, plane
    by plane (int8 caches pair a value plane with a scale plane one rank
    short)."""
    if isinstance(big, tuple):
        for b, n in zip(big, new):
            fn(b, n)
    else:
        fn(big, new)


class ContinuousBatchingEngine:
    """Slot-scheduled continuous batching over a ``CausalDecoderMixin``
    model, on a contiguous cache (the paged subclasses replace the storage
    and the device programs).

    ``max_slots`` bounds concurrent requests; ``max_len`` bounds
    prompt+generation positions per request.  ``prompt_buckets`` quantizes
    prompt lengths (prompts are left-padded to their bucket).  ``device``
    defaults to ``cuda`` and must hold the model's parameters.

    ``ticks_per_sync``: decode ticks between host synchronizations.  1 =
    retire/admit after every token (lowest latency); k > 1 amortizes the
    host round trip over k tokens — tokens a request emits past its
    EOS/budget inside a chunk are discarded on the host, and a slot
    retires when it lacks room for a FULL chunk.  Greedy outputs are
    identical for any k.

    ``prefill_chunk``: admission prefills at most this many prompt
    positions per scheduler round (must divide every bucket it chunks), so
    one long prompt cannot stall every running request's decode for a full
    prefill.  None = whole-bucket prefill in one round.

    ``repetition_penalty`` / ``min_new_tokens``: ``generate()``'s logits
    processors, engine-wide — a per-slot (S, V) presence plane lives on
    the device beside the cache (reset and seeded from the prompt at
    admission), and EOS windows are per row (each request's own emission
    count).

    ``per_request_sampling``: the sampler knobs (``temperature``,
    ``top_k``, ``top_p``, ``greedy``, ``repetition_penalty``,
    ``min_new_tokens``, ``eos_token_id``) become per-request
    ``add_request`` arguments, the constructor's values their defaults;
    they ride per-slot planes, so one sampler call a tick serves any
    mixture.

    ``tracer``: an optional ``telemetry.Tracer``; the engine then emits
    per-tick, per-compile and per-request events (host-side only — the
    programs and their CUDA graphs are identical with or without it).
    None (the default) keeps the scheduler hot path at one attribute
    check: no event allocation, no tracer lock."""

    _SAMPLING_KEYS = ("temperature", "top_k", "top_p", "greedy",
                      "repetition_penalty", "min_new_tokens",
                      "eos_token_id")

    def __init__(self, model, max_slots: int, max_len: int,
                 prompt_buckets=None, temperature: float = 1.0,
                 top_k: Optional[int] = None, top_p: Optional[float] = None,
                 greedy: bool = True, eos_token_id: Optional[int] = None,
                 generator: Optional[torch.Generator] = None,
                 ticks_per_sync: int = 1,
                 prefill_chunk: Optional[int] = None,
                 repetition_penalty: float = 1.0, min_new_tokens: int = 0,
                 per_request_sampling: bool = False, device=None,
                 tracer=None):
        self.device = resolve_device(device)
        c = model.config
        p_dev = next(model.parameters()).device
        if p_dev != self.device:
            raise ValueError(f"the model's parameters live on {p_dev}, the "
                             f"engine runs on {self.device}; move the "
                             f"model first")
        if max_len > c.max_position_embeddings:
            raise ValueError(f"max_len {max_len} exceeds "
                             f"max_position_embeddings "
                             f"({c.max_position_embeddings})")
        if generator is None:
            generator = torch.Generator(device=p_dev).manual_seed(0)
        validate_sampler_args(c.vocab_size, top_k, top_p, greedy, generator)
        self.per_request = bool(per_request_sampling)
        # classic mode: the knobs ARE the engine-wide sampler, and greedy
        # argmax would ignore them; per-request mode takes them as request
        # DEFAULTS a greedy=False request may inherit
        if not self.per_request and greedy and (
                top_k is not None
                or (top_p is not None and float(top_p) != 1.0)
                or float(temperature) != 1.0):
            raise ValueError(
                "temperature/top_k/top_p have no effect under greedy "
                "decoding (the engine default) — pass greedy=False to "
                "sample, or drop the knobs")
        self.repetition_penalty = float(repetition_penalty)
        self.min_new_tokens = int(min_new_tokens)
        if self.repetition_penalty <= 0:
            raise ValueError("repetition_penalty must be > 0")
        if self.min_new_tokens > 0 and eos_token_id is None:
            raise ValueError("min_new_tokens needs eos_token_id")
        if eos_token_id is not None and \
                not 0 <= eos_token_id < c.vocab_size:
            raise ValueError(f"eos_token_id {eos_token_id} outside vocab "
                             f"(size {c.vocab_size})")
        self.model = model
        self.generator = generator
        self.S = int(max_slots)
        self.max_len = int(max_len)
        if prompt_buckets is None:
            prompt_buckets = _default_buckets(max_len)
        self.buckets = sorted(set(int(b) for b in prompt_buckets))
        self.eos_token_id = eos_token_id
        self.ticks_per_sync = int(ticks_per_sync)
        if self.ticks_per_sync < 1:
            raise ValueError("ticks_per_sync must be >= 1")
        self.prefill_chunk = None if prefill_chunk is None \
            else int(prefill_chunk)
        if self.prefill_chunk is not None:
            if self.prefill_chunk < 1:
                raise ValueError("prefill_chunk must be >= 1")
            # only buckets that actually chunk (b > chunk) need to divide;
            # smaller buckets take the whole-bucket path untouched
            chunked = [b for b in self.buckets if b > self.prefill_chunk]
            bad = [b for b in chunked if b % self.prefill_chunk]
            if bad:
                raise ValueError(
                    f"prefill_chunk ({self.prefill_chunk}) must divide "
                    f"every prompt bucket it chunks; doesn't divide {bad}")
            if chunked and max(chunked) + self.ticks_per_sync > self.max_len:
                # a filling slot's stale decode writes park in the strip
                # [max_len - ticks_per_sync, max_len); it must sit ABOVE
                # the largest chunked bucket or parking would clobber the
                # prompt region being filled (see _admit)
                raise ValueError(
                    f"chunked prefill needs max_len >= largest chunked "
                    f"bucket ({max(chunked)}) + ticks_per_sync "
                    f"({self.ticks_per_sync}) as a stale-write parking "
                    f"strip; max_len is {self.max_len}")
        self._sample_sig = (float(temperature),
                            None if top_k is None else int(top_k),
                            None if top_p is None else float(top_p), greedy,
                            self.repetition_penalty, self.min_new_tokens,
                            eos_token_id if self.min_new_tokens > 0 else None)
        self._sample = make_token_sampler(*self._sample_sig[:4])
        self._track = self.repetition_penalty != 1.0
        if self.per_request:
            # presence is always tracked: any request may carry a penalty
            self._track = True
            self._row_sample = make_row_sampler()
            self._plane_defaults = (
                float(temperature), 0 if top_k is None else int(top_k),
                2.0 if top_p is None else float(top_p), bool(greedy),
                self.repetition_penalty, self.min_new_tokens,
                -1 if eos_token_id is None else int(eos_token_id))
            # (temperature, top_k, top_p, greedy, penalty, min_new, eos) a
            # slot; every value is exact in fp32, so one copy ships them
            self._r_planes = np.zeros((7, self.S), np.float32)
            self._r_planes[:] = np.asarray([1.0, 0, 2.0, 1, 1.0, 0, -1],
                                           np.float32)[:, None]
            # the planes' device copy: ONE buffer, overwritten in place
            # after an admission changed them (a graph reads its address)
            self._planes_buf = torch.empty((7, self.S), dtype=torch.float32,
                                           device=self.device)
            self._planes_dirty = True
        self._presence = (torch.zeros((self.S, c.vocab_size),
                                      dtype=torch.bool, device=self.device)
                          if self._track else None)
        self.caches = self._alloc_caches()
        # per-slot host state
        self._slot_req: List[Optional[Request]] = [None] * self.S
        self._t = np.zeros(self.S, np.int32)         # next kv position
        self._pad = np.zeros(self.S, np.int32)       # left-pad length
        self._tok = np.zeros(self.S, np.int32)       # last sampled token
        self._active = np.zeros(self.S, bool)
        self._filling: Dict[int, dict] = {}          # slot -> prefill state
        self._queue: List[Request] = []
        self._finished: Dict[int, List[int]] = {}
        self._ids = itertools.count()
        # observability: a private registry per engine (concurrent engines
        # must not alias counters), the tracer's per-tick notes, and the
        # attached memory ledger (telemetry_memory.MemoryLedger)
        self.tracer = tracer
        self._stats = StatRegistry()
        self._started = time.monotonic()
        self._tick_note: Dict[str, object] = {}
        self._memory = None
        # programs: a per-engine cache, plain-int counters (reported by
        # metrics()), one graph memory pool and capture stream on a card,
        # and the lock step() and warmup tasks share
        self._programs: Dict[str, GraphProgram] = {}
        self._compile_hits = 0
        self._compile_misses = 0
        self._graph_pool = None
        self._capture_stream = None
        self._lock = threading.RLock()

    def _alloc_caches(self):
        """Cache storage seam: one (L, S, max_len, nh, hd) row per slot;
        the paged subclass replaces this with a block pool + tables."""
        return self.model.init_cache(self.S, self.max_len)

    # ----------------------------------------------------------- programs --

    def _cached_prog(self, key: str, build):
        """The engine's program ``key`` (its label), built by ``build()``
        on a miss; every fetch counts a hit or a miss (``_note_prog``).
        The cache keeps the bare program; only the local return may be
        timing-wrapped."""
        prog = self._programs.get(key)
        hit = prog is not None
        if not hit:
            prog = self._programs[key] = build()
        return self._note_prog(key, hit, prog)

    def _note_prog(self, key: str, hit: bool, prog):
        """Program-cache accounting: two plain-int counters (always), and
        with a tracer attached the program's label joins the tick's
        ``programs``, a hit counts on the tracer and a miss returns
        ``prog`` wrapped so its first dispatch reports the compile
        event."""
        if hit:
            self._compile_hits += 1
        else:
            self._compile_misses += 1
        tr = self.tracer
        if tr is None:
            return prog
        label = _event_label(key)
        self._tick_note.setdefault("programs", []).append(label)
        name = type(self).__name__
        if hit:
            tr.compile_event(name, label, True)
            return prog
        self._tick_note["compiles"] = \
            self._tick_note.get("compiles", 0) + 1
        return _FirstDispatchTimer(
            prog, lambda dt: tr.compile_event(name, label, False, dt))

    def attach_ledger(self, ledger):
        """Route this engine's wall clock into a ``telemetry_ledger
        .RunLedger``: tick walls feed ``compute`` and compile-miss walls
        ``compile``, through the attached tracer's event stream
        (``Tracer.set_ledger``).  Requires a ``tracer=``."""
        if self.tracer is None:
            raise ValueError(
                "attach_ledger needs a tracer: construct the engine with "
                "tracer=Tracer() — the ledger consumes its event stream")
        self.tracer.set_ledger(ledger)
        return ledger

    def attach_memory(self, ledger):
        """Register this engine's device tensors with a
        ``telemetry_memory.MemoryLedger``: the model's parameters → the
        ``params`` pool, the KV caches → ``kv_pages`` (the hbm tier of
        the census).  ``metrics()`` then carries ``memory_device_bytes`` /
        ``memory_host_bytes``.  The caches are updated in place, so the
        registration stays current; :meth:`refresh_memory` re-registers
        (the reference rebuilds its caches every tick and needs it before
        a census)."""
        self._memory = ledger
        if self.tracer is not None and getattr(ledger, "_tracer", None) \
                is None:
            ledger.set_tracer(self.tracer)
        self.refresh_memory()
        return ledger

    def refresh_memory(self):
        """Re-register the parameters and the KV caches with the attached
        memory ledger (no-op without one — one attribute check)."""
        ml = self._memory
        if ml is None:
            return
        ml.register_tree("params", dict(self.model.named_parameters()),
                         name=f"engine{id(self)}.params")
        caches = getattr(self, "caches", None)
        if caches is not None:
            ml.register_tree("kv_pages", caches,
                             name=f"engine{id(self)}.kv")

    def _note(self, key: str, value=1):
        """Accumulate one per-tick telemetry field (no-op when tracing is
        off — a single attribute check)."""
        if self.tracer is None:
            return
        self._tick_note[key] = self._tick_note.get(key, 0) + value

    def _program(self, label, fn, shapes, inert) -> GraphProgram:
        """A program over this engine's graph pool, capture stream and
        generator (``jit/programs.py``)."""
        pool = stream = None
        if self.device.type == "cuda":
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
                self._capture_stream = torch.cuda.Stream(self.device)
                self._before_first_capture()
            pool, stream = self._graph_pool, self._capture_stream
        return GraphProgram(label, fn, shapes, inert, device=self.device,
                            pool=pool, stream=stream,
                            generator=self.generator)

    def _before_first_capture(self):
        """Seam run once before the engine's first program on a card: size
        what launches inside graphs reuse (the paged engines reserve the
        paged decode kernel's workspace on the capture stream)."""

    def _dispatch(self, key: str, build, *host):
        """Fetch program ``key`` and run it on the host operands ``host``
        (the sampling planes' device buffer refreshed first when an
        admission changed them)."""
        prog = self._cached_prog(key, build)
        if self.per_request and self._planes_dirty:
            self._planes_buf.copy_(torch.from_numpy(self._r_planes))
            self._planes_dirty = False
        return prog(*host)

    def _plane_operands(self):
        """The per-slot sampling planes, read from their device buffer:
        temperature, top_k, top_p, greedy, penalty, min_new_tokens, eos
        (-1 = none)."""
        d = self._planes_buf
        return (d[0], d[1].long(), d[2], d[3].bool(), d[4], d[5].int(),
                d[6].long())

    def _sample_tail(self, logits32, slots=None, emitted=None,
                     update=None):
        """The sampling sequence every path shares — penalty → EOS window →
        draw → presence update — over (R, V) fp32 logits of the slots
        ``slots`` (an (R,) index tensor; None = all S).  ``emitted`` (R,)
        counts each row's tokens so far (None = 0, a prompt's first token);
        ``update`` (R,) bool picks the rows whose draw joins their presence
        row (None = all).  ONE copy for whole-bucket prefill, the last
        prefill segment, the decode tick and the ragged pack, so their
        processors cannot drift.  Returns (R,) int64 tokens."""
        pres = self._presence
        if pres is not None and slots is not None:
            pres = pres[slots]              # rows written back below
        if self.per_request:
            temp, topk, topp, greedy, rpv, mnv, eosv = (
                p if slots is None else p[slots]
                for p in self._plane_operands())
            l2 = apply_repetition_penalty(logits32, pres, rpv)
            l2 = suppress_eos_rows(l2, eosv, (mnv > 0) if emitted is None
                                   else emitted < mnv)
            tok = self._row_sample(l2[:, None, :], self.generator, temp,
                                   topk, topp, greedy)
        else:
            rp, min_new, eos = self._sample_sig[4:]
            l2 = logits32
            if self._track:
                l2 = apply_repetition_penalty(l2, pres, rp)
            if min_new > 0:
                l2 = suppress_eos(l2, eos, True if emitted is None
                                  else emitted < min_new)
            tok = self._sample(l2[:, None, :], self.generator)
        if pres is not None:
            col = tok[:, None]
            mark = (torch.ones_like(col, dtype=torch.bool) if update is None
                    else pres.gather(1, col) | update[:, None])
            pres.scatter_(1, col, mark)
            if slots is not None:
                self._presence[slots] = pres
        return tok

    def _first_token(self, h_last, slot, live):
        """Sample the first token of the slot ``slot`` (a (1,) index) from
        its prompt's last hidden state (1, 1, H) through ``_sample_tail``,
        its presence row updated where ``live`` (1,) holds: shared by
        whole-bucket prefill, the last prefill segment and prefix-hit
        admission.  Returns a (1,) device tensor."""
        return self._sample_tail(self.model.decode_logits(h_last)[:, -1],
                                 slots=slot, update=live)

    def _seed_presence(self, slot, ids, pad, live=None):
        """Reset the presence row of ``slot`` (an index or a slice) and
        seed it from a prompt's (1, n) ids, the first ``pad`` (a (1,)
        tensor or None) positions excluded — only where ``live`` (1,) bool
        holds, when given; no-op without a presence plane."""
        if self._presence is not None:
            seed = seed_presence(ids, self.model.config.vocab_size, pad)
            if live is not None:
                seed = torch.where(live[:, None], seed, self._presence[slot])
            self._presence[slot] = seed

    def _i32(self, values):
        return torch.tensor(values, dtype=torch.int32, device=self.device)

    @staticmethod
    def _meta(meta):
        """A program's (slot, pad, [t0,] live) operand vector."""
        return (meta[0:1].long(),) + tuple(meta[i:i + 1]
                                           for i in range(1, len(meta) - 1)) \
            + (meta[-1:].bool(),)

    def _build_prefill(self, P):
        """Program ``prefill:{P}``: the admission prefill of one bucket —
        operands ids (P,), (slot, pad, live) and the storage's own
        (``_prefill_extra``)."""
        extra = [e.shape for e in self._prefill_extra(0, P)]

        def fn(ids, meta, *rest):
            slot, pad, live = self._meta(meta)
            h, new = self.model.prefill(ids[None], P, pad_lens=pad)
            self._store_prompt_kv(slot, P, new, live, *rest)
            self._seed_presence(slot, ids[None], pad, live)
            return self._first_token(h[:, -1:], slot, live)

        return self._program(f"prefill:{P}", fn, [(P,), (3,), *extra],
                             [np.zeros(P), np.zeros(3)]
                             + [np.zeros(s) for s in extra])

    def _prefill_extra(self, slot, P):
        """Seam: the storage's own prefill operands for the slot (the
        paged engines' block row)."""
        return ()

    def _run_admission_prefill(self, slot, req, P, pad, ids):
        """Prefill ONE request (left-padded to bucket length P) into slot
        ``slot``'s cache storage and activate it with its first token."""
        tok0 = self._dispatch(f"prefill:{P}", partial(self._build_prefill, P),
                              ids, (slot, pad, 1),
                              *self._prefill_extra(slot, P))
        self._register_prompt_blocks(slot, ids, pad, P)
        self._activate(slot, req, P, pad, int(tok0))

    def _register_prompt_blocks(self, slot, ids, pad, P):
        """Seam run once a slot's prompt k/v is complete, before its first
        token is recorded (the paged engines publish the prompt's blocks
        to their prefix cache)."""

    def _store_prompt_kv(self, slot, P, new, live):
        """A prefill's fresh caches (L, 1, P, …) into the cache region
        [0, P) of the slot ``slot`` (a (1,) index), where ``live`` (1,)
        holds (seam: the paged subclass scatters them into the slot's pool
        blocks)."""
        def put(big, n):
            keep = live.view((1,) * n.dim())
            big[:, slot, :P] = torch.where(keep, n.to(big.dtype),
                                           big[:, slot, :P])

        for big, n in zip(self.caches, new):
            _map_planes(put, big, n)

    def _build_seg(self, first, last):
        """Program ``seg:{chunk}:{first}{last}``: one prefill segment of
        ``prefill_chunk`` tokens — operands the tokens, (slot, pad, t0,
        live) and the storage's own (``_seg_extra``); the first segment
        resets the slot's presence row, the last samples its first
        token."""
        seg, V = self.prefill_chunk, self.model.config.vocab_size
        extra = [e.shape for e in self._seg_extra(0)]

        def fn(toks, meta, *rest):
            slot, pad, t0, live = self._meta(meta)
            h = self._suffix_prefill(slot, toks, t0, pad, *rest)
            if self._presence is not None:
                row = self._presence[slot]
                # the segment's prompt tokens, pad positions excluded
                seen = seed_presence(toks[None], V, pad - t0)
                new = seen if first else row | seen
                self._presence[slot] = torch.where(live[:, None], new, row)
            return self._first_token(h[:, -1:], slot, live) if last else ()

        return self._program(
            f"seg:{seg}:{int(first)}{int(last)}", fn,
            [(seg,), (4,), *extra],
            [np.zeros(seg), [0, 0, self.max_len, 0]]
            + [np.zeros(s) for s in extra])

    def _seg_extra(self, slot):
        """Seam: the storage's own segment operands for the slot (the
        paged engines' table row)."""
        return ()

    def _run_fill_segment(self, slot, st, i, last):
        """One prefill SEGMENT for one slot: ``prefill_chunk`` prompt
        tokens at [t0, t0+seg) through ``_suffix_prefill``.  Returns the
        first token as a (1,) device tensor on the last segment, else ()
        (no host sync until activation)."""
        seg = self.prefill_chunk
        t0 = i * seg
        first = i == 0
        return self._dispatch(
            f"seg:{seg}:{int(first)}{int(last)}",
            partial(self._build_seg, first, last),
            st["ids"][t0:t0 + seg], (slot, st["pad"], t0, 1),
            *self._seg_extra(slot))

    def _suffix_prefill(self, slot, toks, t0, pad):
        """Embed the ``toks`` (n,) chunk at positions [t0, t0+n) (``t0`` a
        (1,) tensor) and run it through the chunk decode path
        (``cached_attention``'s k-query form) over a copy of the cache row
        of the slot ``slot`` (a (1,) index), written back whole: a segment
        costs B=1 work, and a clock past ``max_len`` writes nothing.
        Returns the chunk's hidden states."""
        def take(c):
            return (tuple(p[:, slot] for p in c) if isinstance(c, tuple)
                    else c[:, slot])

        m = self.model
        rows = (take(self.caches[0]), take(self.caches[1]))
        h = m._embed_chunk(toks[None], t0, pad_lens=pad)
        h, _ = m.decode_step(h, rows, t0, pad_lens=pad)
        for big, row in zip(self.caches, rows):
            _map_planes(lambda b, r: b.index_copy_(1, slot, r), big, row)
        return h

    def _decode_tick(self, caches, tok, t, pads, active, emitted):
        """One decode tick over all S slots (embed → decode_step →
        ``_sample_tail``), shared by the contiguous and paged decode syncs
        so the scheduling semantics cannot drift between cache layouts.
        ``emitted`` (S,) counts each slot's tokens before this tick.
        Inactive slots carry their token unchanged and leave their
        presence row alone (their stale cache writes are never read — see
        the module docstring)."""
        m = self.model
        h = m._embed_one(tok, t, pad_lens=pads)
        h, _ = m.decode_step(h, caches, t, pad_lens=pads)
        ntok = self._sample_tail(m.decode_logits(h)[:, -1], None, emitted,
                                 active)
        return torch.where(active, ntok.to(tok.dtype), tok)

    def _decode_caches(self, active):
        """The caches one decode sync runs over (seam: the paged subclass
        wraps its pools and the sync's table in ``PagedKV``)."""
        return self.caches

    def _build_decode(self, extra_shapes):
        """Program ``decode`` (the paged engine's ``decode:{C}``): one
        ``ticks_per_sync`` sync — operands the (5, S) per-slot state
        (token, clock, pad, active, tokens emitted) and the storage's own
        (``_decode_extra_operands``); returns the (k, S) token block.
        Inert: no slot active, clocks at ``max_len`` (writes dropped)."""
        S, k = self.S, self.ticks_per_sync
        extra = [tuple(s) for s in extra_shapes]

        def fn(state, *rest):
            tok, ts, pads, act, emitted = state
            active = act.bool()
            caches = self._decode_caches(active, *rest)
            blk = []
            for i in range(k):
                tok = self._decode_tick(caches, tok, ts + i, pads, active,
                                        emitted + i)
                blk.append(tok)
            return torch.stack(blk)

        inert = np.zeros((5, S), np.int32)
        inert[1] = self.max_len
        return self._program(self._decode_key(extra), fn, [(5, S)] + extra,
                             [inert] + [np.zeros(s) for s in extra])

    def _decode_key(self, extra_shapes):
        """The decode program's label for these storage operand shapes."""
        return "decode"

    # ------------------------------------------------------------- warmup --

    def compile_grid(self) -> List[str]:
        """Labels of every program this engine can dispatch — the grid
        ``warmup()`` builds, the reference's letter for letter."""
        return [t.label for t in self._warmup_tasks()]

    def warmup(self, cache_dir=None, max_workers: int = 1,
               block: bool = True):
        """Build the engine's whole program grid before traffic, so no
        request waits for a capture: each program runs once eagerly on
        inert operands (every write lands where nothing reads, the
        generator's state is restored) and, on a card, is captured as a
        CUDA graph.  Live state — caches and pools outside trash block 0,
        presence, sampling planes, the generator, every stat — stays as it
        was, so a warmed engine serves token for token what a cold one
        would.  Returns the report ``{"programs", "wall_s", "tasks",
        "cache_dir"}``; ``block=False`` runs on a background thread and
        returns its Future (``step()`` runs between tasks, and a request
        it serves builds what it needs first).  With a tracer attached the
        run sits in an ``expected_compiles`` window over the grid's labels
        (its compile events are tagged ``expected`` and never arm the
        recompile-storm warning).  ``cache_dir`` and ``max_workers > 1``
        raise (``ROADMAP.md`` §C)."""
        tasks = self._warmup_tasks()
        kw = dict(tracer=self.tracer, cache_dir=cache_dir,
                  max_workers=max_workers, lock=self._lock)
        if block:
            return run_warmup(tasks, **kw)
        return warmup_async(tasks, **kw)

    def _task(self, label, build):
        return WarmupTask(label,
                          lambda: self._cached_prog(label, build).compile())

    def _prefill_seg_tasks(self):
        """Prefill-bucket and segment tasks — one enumeration shared by
        the contiguous and paged grids."""
        tasks = []
        chunk = self.prefill_chunk
        for P in self.buckets:
            if chunk is not None and P > chunk:
                continue                  # chunked buckets use seg programs
            tasks.append(self._task(f"prefill:{P}",
                                    partial(self._build_prefill, P)))
        if chunk is not None:
            combos = sorted({(i == 0, i == P // chunk - 1)
                             for P in self.buckets if P > chunk
                             for i in range(P // chunk)})
            for first, last in combos:
                tasks.append(self._task(
                    f"seg:{chunk}:{int(first)}{int(last)}",
                    partial(self._build_seg, first, last)))
        return tasks

    def _warmup_tasks(self):
        return self._prefill_seg_tasks() + [
            self._task("decode", partial(self._build_decode, ()))]

    # --------------------------------------------------------- scheduling --

    def add_request(self, prompt, max_new_tokens: int, on_token=None,
                    trace_ctx=None, **sampling) -> int:
        """Queue a prompt; returns the request id.  Admission happens inside
        ``step()`` whenever a slot is free.

        ``trace_ctx``: an optional ``telemetry.TraceContext`` minted by the
        caller; it binds the request id to that trace in the attached
        tracer, so every request-timeline event carries its trace_id
        (host-side metadata only).

        ``on_token(request_id, token, done)``: optional streaming callback,
        invoked on the host as each token is accepted.  ``cancel`` ends
        the stream with one ``on_token(request_id, None, True)`` call.

        With ``per_request_sampling=True`` the ``sampling`` keywords
        (``_SAMPLING_KEYS``) override the constructor's values for this
        request; otherwise any of them raises."""
        prompt = [int(t) for t in prompt]
        if not prompt:
            raise ValueError("empty prompt")
        if int(max_new_tokens) <= 0:
            raise ValueError("max_new_tokens must be >= 1")
        P = select_bucket(len(prompt), self.buckets)
        need = self._positions_needed(P, int(max_new_tokens))
        if need > self.max_len:
            raise ValueError(
                f"bucketed prompt ({len(prompt)} -> bucket {P}) needs "
                f"{need} cache positions for max_new_tokens="
                f"{max_new_tokens}; exceeds max_len ({self.max_len})")
        req = Request(next(self._ids), prompt, max_new_tokens)
        req.sampling = self._resolve_sampling(sampling)
        req.on_token = on_token
        self._queue.append(req)
        if self.tracer is not None:
            if trace_ctx is not None:
                self.tracer.bind_trace(req.id, trace_ctx)
            self.tracer.request_event(req.id, "queued",
                                      prompt_len=len(prompt))
        return req.id

    def _resolve_sampling(self, overrides):
        """Merge per-request overrides onto the engine defaults and
        validate; returns the plane-encoded tuple (None in classic mode,
        where any override is an error)."""
        unknown = set(overrides) - set(self._SAMPLING_KEYS)
        if unknown:
            raise TypeError(f"unknown add_request kwargs: {sorted(unknown)}")
        given = {k: v for k, v in overrides.items() if v is not None}
        if not self.per_request:
            if given:
                raise ValueError(
                    f"per-request sampling params {sorted(given)} need "
                    f"per_request_sampling=True")
            return None
        V = self.model.config.vocab_size
        t, k, p, g, rp, mn, eos = self._plane_defaults
        if "temperature" in given:
            t = float(given["temperature"])
            if t <= 0:
                raise ValueError("temperature must be > 0 (use greedy=True "
                                 "for deterministic decoding)")
        if "top_k" in given:
            k = int(given["top_k"])
            validate_sampler_args(V, k, None, True, None)
        if "top_p" in given:
            p = float(given["top_p"])
            validate_sampler_args(V, None, p, True, None)
        if "greedy" in given:
            g = bool(given["greedy"])
        if "repetition_penalty" in given:
            rp = float(given["repetition_penalty"])
            if rp <= 0:
                raise ValueError("repetition_penalty must be > 0")
        if "min_new_tokens" in given:
            mn = int(given["min_new_tokens"])
            if mn < 0:
                raise ValueError("min_new_tokens must be >= 0")
        if "eos_token_id" in given:
            eos = int(given["eos_token_id"])
            if not 0 <= eos < V:
                raise ValueError(f"eos_token_id {eos} outside vocab "
                                 f"(size {V})")
        if mn > 0 and eos < 0:
            raise ValueError("min_new_tokens needs an eos_token_id "
                             "(engine default or per-request)")
        # sampling-only knobs under an effective greedy flag would decode
        # argmax silently; neutral values (temperature 1, top_p 1) pass
        if g and (("temperature" in given and t != 1.0)
                  or "top_k" in given
                  or ("top_p" in given and p != 1.0)):
            raise ValueError(
                "temperature/top_k/top_p have no effect under greedy "
                "decoding — pass greedy=False with them (or construct the "
                "engine with greedy=False)")
        return (t, k, p, g, rp, mn, eos)

    def _set_planes(self, slot, req):
        """Write the request's effective sampler config into the slot's
        column of the per-request planes (no-op in classic mode).  Runs at
        admission, before the first token samples through the planes —
        the one admission choke point every engine passes, so it also
        emits the ``admitted`` transition."""
        if self.tracer is not None:
            self.tracer.request_event(req.id, "admitted", slot=int(slot))
        if not self.per_request:
            return
        self._r_planes[:, slot] = np.asarray(req.sampling, np.float32)
        self._planes_dirty = True

    def _positions_needed(self, P: int, mnt: int) -> int:
        """Worst-case cache positions a request occupies — the bucket plus
        CHUNK-ROUNDED decode: the first token comes from prefill (no decode
        position), the remaining budget-1 tokens consume ceil((budget-1)/k)
        * k positions (decode advances k ticks per sync; pad slots occupy
        physical positions)."""
        k = self.ticks_per_sync
        return P + -(-(mnt - 1) // k) * k

    @property
    def decode_syncs(self) -> int:
        """Decode syncs run so far (``ticks_per_sync`` ticks each)."""
        return int(self._stats.value("decode_syncs"))

    def pending(self) -> bool:
        return bool(self._queue) or bool(self._active.any()) \
            or bool(self._filling)

    def pop_finished(self) -> Dict[int, List[int]]:
        out, self._finished = self._finished, {}
        return out

    def _free_slots(self):
        return [s for s in range(self.S)
                if not self._active[s] and s not in self._filling]

    def _admit(self):
        free = self._free_slots()
        while self._queue and free:
            slot, req = free[0], self._queue[0]
            P = select_bucket(len(req.prompt), self.buckets)
            pad = P - len(req.prompt)
            ids = [0] * pad + req.prompt
            chunked = (self.prefill_chunk is not None
                       and P > self.prefill_chunk)
            F = self._reserve_slot(slot, P, pad, ids, chunked)
            if F is None:
                break                  # defer admission (FIFO preserved)
            free.pop(0)
            self._queue.pop(0)
            self._set_planes(slot, req)
            if F:
                # prefix-cache hit: only the suffix past F blocks runs
                self._note("prefill_tokens", P - F * self.bs)
                self._run_cached_prefill(slot, req, P, pad, ids, F)
                continue
            if chunked:
                # chunked admission: segments run one per scheduler round,
                # interleaved with everyone else's decode.  PARK the slot's
                # decode clock in the strip above every chunked bucket:
                # the batched decode sync stale-writes EVERY row at its
                # clock each tick (inactive ones included), and unlike
                # whole-bucket prefill — which overwrites [0, P) after any
                # stale write — segments land progressively, so a stale
                # write at the old clock (0 for a fresh slot) would corrupt
                # already-filled prompt positions.  The parking strip is
                # overwritten by the occupant's own decode before it can
                # ever be read (write-before-read induction); in the paged
                # engine its table entry stays at trash (0) while the slot
                # fills, so the stale writes land in trash.
                self._t[slot] = self.max_len - self.ticks_per_sync
                self._filling[slot] = {"req": req, "ids": ids, "pad": pad,
                                       "P": P, "seg": 0,
                                       "nseg": P // self.prefill_chunk}
                continue
            self._note("prefill_tokens", P)
            self._run_admission_prefill(slot, req, P, pad, ids)

    def _reserve_slot(self, slot, P, pad, ids, chunked):
        """Admission seam: claim what the slot's occupant needs before its
        prefill (the paged subclass takes the prompt's blocks, or maps a
        cached prefix).  Returns None to defer the admission, else the
        number of leading prompt blocks already cached (0 here)."""
        return 0

    def _fill_segments(self):
        """Run ONE prefill segment for every filling slot (round-robin
        progress: a long prompt advances without stalling decode)."""
        seg = self.prefill_chunk
        for slot, st in list(self._filling.items()):
            if slot not in self._filling:      # preempted earlier in the loop
                continue
            i = st["seg"]
            last = i == st["nseg"] - 1
            if not self._reserve_segment(slot, (i + 1) * seg):
                continue
            tok0 = self._run_fill_segment(slot, st, i, last)
            self._note("prefill_tokens", seg)
            if last:
                del self._filling[slot]
                self._register_prompt_blocks(slot, st["ids"], st["pad"],
                                             st["P"])
                # the only host-device sync of the whole fill
                self._activate(slot, st["req"], st["P"], st["pad"],
                               int(tok0))
            else:
                st["seg"] += 1

    def _reserve_segment(self, slot, upto) -> bool:
        """Segment seam: make room for the slot's positions [0, upto) (the
        paged subclass grows the table); False stalls the segment."""
        return True

    def _activate(self, slot, req, P, pad, tok0):
        req.first_token_at = time.monotonic()   # tok0 exists: TTFT point
        if self.tracer is not None:
            self.tracer.request_event(req.id, "first_token",
                                      slot=int(slot))
        self._slot_req[slot] = req
        self._t[slot] = P
        self._pad[slot] = pad
        self._tok[slot] = tok0
        self._active[slot] = True
        self._record(slot, tok0)

    def _record(self, slot: int, tok: int):
        """Append a token to the slot's request; retire on EOS/budget."""
        req = self._slot_req[slot]
        req.generated.append(tok)
        if self.tracer is not None:
            self.tracer.request_event(req.id, "token", token=int(tok))
        eos = req.sampling[6] if self.per_request else self.eos_token_id
        done = len(req.generated) >= req.max_new_tokens \
            or (eos is not None and eos >= 0 and tok == eos)
        if req.on_token is not None:
            try:
                req.on_token(req.id, tok, done)
            except Exception:  # noqa: BLE001 — a user callback must not
                # desync host state mid-step; log and continue
                logging.getLogger(__name__).exception(
                    "on_token callback failed for request %d", req.id)
        # the callback may have cancel()ed this very request
        if done and self._slot_req[slot] is not None:
            self._retire(slot)

    def _retire(self, slot: int):
        req = self._slot_req[slot]
        req.done = True
        req.finished_at = time.monotonic()
        self._finished[req.id] = list(req.generated)
        self._slot_req[slot] = None
        self._active[slot] = False
        n = len(req.generated)
        stat_add("serving_requests_finished")
        stat_add("serving_tokens_emitted", n)
        s = self._stats
        s.add("requests_finished")
        s.add("tokens_emitted", n)
        s.add("ttft_seconds_sum", req.first_token_at - req.enqueued_at)
        s.add("latency_seconds_sum", req.finished_at - req.enqueued_at)
        if self.tracer is not None:
            self.tracer.request_event(req.id, "retired", tokens=n)

    def cancel(self, rid: int) -> bool:
        """Cancel one in-flight request (queued, mid-prefill or decoding)
        and release every resource it holds; host bookkeeping only.
        Cancelled requests never appear in ``pop_finished()``; a streaming
        consumer gets one terminal ``on_token(rid, None, True)``.  Returns
        True iff the request was found in flight."""
        for i, req in enumerate(self._queue):
            if req.id == rid:
                del self._queue[i]
                self._finalize_cancel(req)
                return True
        for slot, st in list(self._filling.items()):
            if st["req"].id == rid:
                del self._filling[slot]
                self._release_cancelled_slot(slot)
                self._finalize_cancel(st["req"])
                return True
        for slot, req in enumerate(self._slot_req):
            if req is not None and req.id == rid:
                self._slot_req[slot] = None
                self._active[slot] = False
                self._release_cancelled_slot(slot)
                self._finalize_cancel(req)
                return True
        return False

    def _release_cancelled_slot(self, slot: int):
        """Free what a cancelled occupant held (seam: the paged engines
        release the slot's KV blocks)."""

    def _finalize_cancel(self, req: Request):
        req.done = True
        req.finished_at = time.monotonic()
        self._stats.add("requests_cancelled")
        stat_add("serving_requests_cancelled")
        if self.tracer is not None:
            self.tracer.request_event(req.id, "cancelled",
                                      tokens=len(req.generated))
        if req.on_token is not None:
            try:
                req.on_token(req.id, None, True)   # terminal end-of-stream
            except Exception:  # noqa: BLE001 — same contract as _record
                logging.getLogger(__name__).exception(
                    "on_token cancel signal failed for request %d", req.id)

    _TICK_COUNTERS = ("tokens_emitted", "requests_finished")

    def step(self):
        """One scheduler round (``_step_impl``) under the engine's lock
        (warmup tasks take it too).  With ``tracer=None`` this is one
        attribute check and a tail call; with a tracer the round is
        bracketed by tick telemetry — host wall, queue depth, counter
        deltas, packed rows, program labels.  An escaping exception counts
        ``step_errors`` (and, traced, lands as an ``engine_error`` event)
        before it propagates."""
        with self._lock:
            tr = self.tracer
            if tr is None:
                try:
                    return self._step_impl()
                except Exception:
                    self._stats.add("step_errors")
                    raise
            return self._traced_step(tr)

    def _traced_step(self, tr):
        t0 = time.perf_counter()
        self._tick_note = {}
        s = self._stats
        base = {k: s.value(k) for k in self._TICK_COUNTERS}
        try:
            return self._step_impl()
        except Exception as e:
            s.add("step_errors")
            tr.emit("engine_error", what="step_error",
                    engine=type(self).__name__, error=repr(e))
            raise
        finally:
            fields = {k: s.value(k) - base[k] for k in self._TICK_COUNTERS}
            fields.update(self._tick_gauges())
            fields.update(self._tick_note)
            self._tick_note = {}
            tr.tick(type(self).__name__, time.perf_counter() - t0,
                    queue_depth=len(self._queue),
                    active=int(self._active.sum()),
                    filling=len(self._filling), **fields)

    def _tick_gauges(self) -> Dict[str, float]:
        """Instantaneous per-tick gauges (subclass hook; only consulted
        when tracing is on)."""
        return {}

    def _step_impl(self):
        """One scheduler round: admit waiting requests into free slots, run
        one prefill segment per filling slot, then ``ticks_per_sync``
        batched decode ticks, and retire finished requests from the
        returned token block."""
        self._admit()
        if self._filling:
            self._fill_segments()
        if not self._active.any():
            return
        res = self._run_decode()
        if res is None:
            return
        active_before, blk = res                   # blk (k, S)
        for slot in np.flatnonzero(active_before):
            for j in range(self.ticks_per_sync):
                if not self._active[slot]:
                    break  # retired mid-chunk: discard the chunk's tail
                self._t[slot] += 1
                self._tok[slot] = blk[j, slot]
                self._record(int(slot), int(blk[j, slot]))
            # room is a CHUNK-boundary concern: a surviving slot must fit a
            # whole next chunk.  Admission-validated budgets always do; this
            # is the safety net against inconsistent slot state, truncating
            # rather than writing past the cache.
            if self._active[slot] and \
                    int(self._t[slot]) + self.ticks_per_sync > self.max_len:
                self._retire(int(slot))

    def _prepare_decode(self) -> bool:
        """Pre-sync hook: the paged subclass grows block tables here
        (preempting when the pool is dry).  False = nothing left to
        decode."""
        return True

    def _decode_extra_operands(self):
        """Extra int32 host arrays one decode sync ships to the device
        with its per-slot state, handed to ``_decode_caches`` (the paged
        subclass passes its block table)."""
        return ()

    def _run_decode(self):
        """One ``ticks_per_sync`` decode sync over the engine's cache
        storage: the decode program on one host→device copy of every int32
        operand, k shared ticks whose tokens stay on the device, one
        device→host read of the (k, S) block.  Returns (active_before,
        block) or None if no slot could decode."""
        if not self._prepare_decode():
            return None
        self._stats.add("decode_syncs")
        active_before = self._active.copy()
        self._note("decode_rows", int(active_before.sum()))
        extra = self._decode_extra_operands()
        emitted0 = np.asarray([len(r.generated) if r is not None else 0
                               for r in self._slot_req], np.int32)
        state = np.stack([self._tok, self._t, self._pad,
                          active_before.astype(np.int32), emitted0])
        shapes = tuple(e.shape for e in extra)
        blk = self._dispatch(self._decode_key(shapes),
                             partial(self._build_decode, shapes), state,
                             *extra)
        return active_before, blk.cpu().numpy()

    # metrics() contract: {key: (kind, pytype)}; kind "counter" =
    # monotonic over the engine's lifetime, "gauge" = instantaneous or
    # derived.  Keys never change meaning; subclasses extend.
    METRICS_SCHEMA = {
        "requests_finished": ("counter", int),
        "requests_cancelled": ("counter", int),
        "tokens_emitted": ("counter", int),
        "mean_ttft_s": ("gauge", float),
        "mean_latency_s": ("gauge", float),
        "tokens_per_sec": ("gauge", float),
        "compile_hits": ("counter", int),
        "compile_misses": ("counter", int),
        "step_errors": ("counter", int),
        # present only with attach_memory(MemoryLedger):
        "memory_device_bytes": ("gauge", float),
        "memory_host_bytes": ("gauge", float),
    }

    @classmethod
    def metrics_schema(cls) -> Dict[str, tuple]:
        """The ``metrics()`` schema of this engine class, merged over the
        MRO: every key metrics() returns, with its kind and type;
        conditional keys may be absent from a given metrics() dict but
        never change meaning."""
        out: Dict[str, tuple] = {}
        for klass in reversed(cls.__mro__):
            out.update(klass.__dict__.get("METRICS_SCHEMA", {}))
        return out

    def metrics(self) -> Dict[str, float]:
        """Finished/cancelled request counts, tokens, mean time to first
        token, mean request latency, lifetime tokens/s, step errors, the
        program cache's hits and misses, and with a memory ledger attached
        its device and host byte totals.  Schema: ``metrics_schema()``."""
        s = self._stats
        nreq = int(s.value("requests_finished"))
        n = max(nreq, 1)
        toks = int(s.value("tokens_emitted"))
        dt = max(time.monotonic() - self._started, 1e-9)
        out = {"requests_finished": nreq,
               "requests_cancelled": int(s.value("requests_cancelled")),
               "tokens_emitted": toks,
               "mean_ttft_s": float(s.value("ttft_seconds_sum")) / n,
               "mean_latency_s": float(s.value("latency_seconds_sum")) / n,
               "tokens_per_sec": toks / dt,
               "compile_hits": self._compile_hits,
               "compile_misses": self._compile_misses,
               "step_errors": int(s.value("step_errors"))}
        if self._memory is not None:
            totals = self._memory.memory_snapshot()["totals"]
            out["memory_device_bytes"] = float(totals["device_bytes"])
            out["memory_host_bytes"] = float(totals["host_bytes"])
        return out

    def prometheus_text(self, namespace: str = "paddle_tpu_serving") -> str:
        """Prometheus text exposition of this engine's registry plus the
        ``metrics()`` values not stored as raw registry stats, each typed
        per ``metrics_schema()`` (compile counts stay counters, means and
        throughput are gauges)."""
        raw = set(self._stats.snapshot())
        schema = self.metrics_schema()
        gauges, counters = {}, {}
        for k, v in self.metrics().items():
            if k in raw:
                continue
            (counters if schema[k][0] == "counter" else gauges)[k] = v
        return _prometheus_text(self._stats, namespace=namespace,
                                extra_gauges=gauges,
                                extra_counters=counters)

    def run_to_completion(self, max_ticks: Optional[int] = None
                          ) -> Dict[int, List[int]]:
        """Drive step() until every queued request finishes; returns
        {request_id: generated tokens}."""
        ticks = 0
        while self.pending():
            self.step()
            ticks += 1
            if max_ticks is not None and ticks > max_ticks:
                raise RuntimeError(f"not done after {max_ticks} ticks")
        return self.pop_finished()

"""Serving and training telemetry (the port's counterpart of
``paddle_tpu/telemetry.py``): a bounded ring-buffer structured-event
tracer for the continuous-batching engines, and ``TrainMonitor`` over it
for the train step.

The serving engines (``serving`` / ``serving_paged``) accept a
``tracer=Tracer()`` at construction and then emit host-side events on
every scheduler tick, program-cache access and request state transition.
The tracer is a pure observer: it adds no operand to any program and no
device synchronisation (a tick's host wall already holds its device time,
since every step reads its tokens back), every engine replays the same
CUDA graphs with a tracer as without, and with ``tracer=None`` (the
default) the engines' hot path performs a single attribute check — no
event allocation, no lock.

Event kinds (each event is one flat JSON-serializable dict) — the
reference's, field for field:

``tick``     one scheduler round: ``engine`` (class name), ``dur_s``
             (host wall), ``queue_depth``, ``active``, ``filling``, the
             per-tick deltas of the engine counters (``tokens_emitted``,
             ``requests_finished``; the paged engines add
             ``blocks_allocated``/``blocks_released``/``preemptions``/
             ``prefix_hits`` and the gauge ``blocks_in_use``; speculation
             ``tokens_drafted``/``tokens_accepted``), plus what the engine
             packed: ``decode_rows``, ``prefill_tokens``,
             ``budget_used``/``token_budget``/``table_cols`` (ragged),
             ``spec_rows`` (ragged speculation), ``programs`` (the labels
             of the programs dispatched, e.g. ``ragged_step:12:4``) and
             ``compiles`` (program-cache misses paid inside the tick).
``compile``  one program-cache MISS: ``key`` (label), ``wall_s`` (host
             wall of the program's first dispatch: on a card the eager
             run on the capture stream, the CUDA-graph capture and the
             first replay's launch), ``engine``, ``provenance`` (``cold``;
             graphs are never loaded from disk) and ``expected`` (True
             inside an ``expected_compiles`` warmup window).  Hits are
             counter-only (``compile_hits``, plus the tick's ``programs``).
``request``  one request state transition: ``rid`` plus ``what`` in
             ``queued`` → ``admitted`` → ``first_token`` → ``token`` →
             (``preempted`` → ``admitted`` → …) → ``retired`` |
             ``cancelled``.
``kvstore``  one tiered-store page movement (``what`` ``demote`` /
             ``restore`` from the engines, ``promote``/``evict`` from the
             store itself).

Exports: ``dump_jsonl(path)`` (one event per line, then one ``timeline``
line per request), ``to_chrome_trace()`` (``{"traceEvents": …}``, engine
spans on the rows ``torch.profiler``'s Chrome export can sit beside),
``prometheus_text()`` (the tracer registry: tick/TTFT/inter-token/compile
histograms and counters), ``request_summary()`` (exact p50/p95/p99 TTFT
and inter-token latency over the retained timelines) and ``summary()``.

Recompile visibility: every program-cache miss after the first completed
tick, outside a warmup window, counts as a post-warmup recompile; at
``recompile_warn_threshold`` of them the tracer logs ONE warning.

Training side (``TrainMonitor``): ``train_step`` (host dispatch wall,
``examples``/``tokens``), ``sync`` (a device-blocked host wait and the
loss it fetched — the numerics watchdog reads it), ``watchdog``
(``non_finite`` / ``loss_spike``), ``hbm`` (a live-tensor byte census)
and ``aggregate``.  ``instrument_train_step`` wraps a
step: its first call synchronises the card once and becomes the compile
event; later calls add no synchronisation.

A ``telemetry_ledger.RunLedger`` attaches through ``set_ledger``: tick,
compile, train_step and sync durations forward into its wall-clock
buckets behind one attribute check.

Differences from the reference (``ROADMAP.md`` §C): program cost
attribution (``attribute_cost=True``, XLA cost analysis) has no
counterpart and raises, so ``mfu_summary`` reports no cost recorded.
``TrainMonitor.aggregate`` reduces through ``distributed.fleet.metrics
.all_reduce_metrics`` (the identity in a single process).  What has no
producer in the port yet is left out until its producer comes: the AMP
scaler feed (``observe_scaler``, ``amp`` events), compile-provenance
resolution
(``expected_compiles(provenance_resolver=)``: every miss is ``cold``)
and per-program costs (``record_cost``, ``compile_event(cost=)``).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import json
import logging
import os
import threading
import time
import uuid
from typing import Any, Callable, Dict, List, Optional, Tuple

from .telemetry_memory import _leaves_with_path
from .utils.stats import (DEFAULT_TIME_BUCKETS, StatRegistry,
                          prometheus_text as _stats_prometheus_text)

__all__ = ["Tracer", "RequestTimeline", "RequestTraceIndex", "TraceContext",
           "TrainMonitor", "program_label", "chrome_trace_from_jsonl",
           "instrument_train_step", "set_active_monitor", "current_monitor"]

_PCTS = (50.0, 95.0, 99.0)


class TraceContext:
    """W3C-style trace identity for ONE request across sources.

    ``trace_id`` names the whole end-to-end request (minted once, at the
    gateway's ``submit()``); ``span_id`` names one unit of work under it
    (the gateway's root request span, or one engine attempt); ``parent_
    span_id`` links a child span to its parent.  The context is pure
    host-side metadata: it rides tracer events (``Tracer.bind_trace``
    attaches it to every request-timeline event for a rid) and NEVER
    becomes an operand of a program — the programs and their keys are
    the same with or without one.

    The gateway mints the root at admission and a fresh CHILD per engine
    dispatch (including quarantine-reroute re-dispatches), so a request
    that crosses replicas leaves one trace with one span per attempt —
    :class:`RequestTraceIndex` stitches them back together."""

    __slots__ = ("trace_id", "span_id", "parent_span_id")

    def __init__(self, trace_id: str, span_id: str,
                 parent_span_id: Optional[str] = None):
        self.trace_id = str(trace_id)
        self.span_id = str(span_id)
        self.parent_span_id = (None if parent_span_id is None
                               else str(parent_span_id))

    @classmethod
    def root(cls) -> "TraceContext":
        """Mint a fresh root context (new trace_id, no parent)."""
        return cls(uuid.uuid4().hex[:16], uuid.uuid4().hex[:8], None)

    def child(self) -> "TraceContext":
        """Mint a child span under this one (same trace_id)."""
        return TraceContext(self.trace_id, uuid.uuid4().hex[:8],
                            self.span_id)

    def to_dict(self) -> Dict[str, Any]:
        return {"trace_id": self.trace_id, "span_id": self.span_id,
                "parent_span_id": self.parent_span_id}

    def __repr__(self):
        return (f"TraceContext(trace_id={self.trace_id!r}, "
                f"span_id={self.span_id!r}, "
                f"parent_span_id={self.parent_span_id!r})")


def program_label(key) -> str:
    """Short display label for an engine program-cache key: the kind tag
    plus its leading shape/bucket ints — the full key embeds the engine
    signature tuple, which is noise at event granularity."""
    if not isinstance(key, tuple) or not key:
        return str(key)
    parts = [str(key[0])]
    for k in key[1:]:
        if isinstance(k, bool) or not isinstance(k, int):
            break
        parts.append(str(k))
    return ":".join(parts)


def _percentiles(samples) -> Optional[Dict[str, float]]:
    if not samples:
        return None
    import numpy as np
    arr = np.asarray(samples, dtype=float)
    out = {f"p{int(p)}": float(np.percentile(arr, p)) for p in _PCTS}
    out["mean"] = float(arr.mean())
    out["max"] = float(arr.max())
    out["count"] = int(arr.size)
    return out


class RequestTimeline:
    """Host-side latency timeline of ONE request.  All timestamps are the
    tracer's monotonic clock (seconds since tracer construction).  A
    preemption closes the current attempt: streamed tokens are discarded
    (mirroring the engine's documented ``on_token(rid, None, False)``
    reset signal) and TTFT restarts measuring at the ORIGINAL queued_at —
    the replayed prefill is not double-counted, the request simply has one
    TTFT: queued → the first token that was never rolled back."""

    __slots__ = ("rid", "prompt_len", "queued_at", "admitted_at",
                 "first_token_at", "token_times", "preempted_spans",
                 "retired_at", "replays", "tokens_delivered")

    def __init__(self, rid: int, queued_at: float, prompt_len: int = 0):
        self.rid = rid
        self.prompt_len = prompt_len
        self.queued_at = queued_at
        self.admitted_at: Optional[float] = None
        self.first_token_at: Optional[float] = None
        self.token_times: List[float] = []
        self.preempted_spans: List[List[Optional[float]]] = []
        self.retired_at: Optional[float] = None
        self.replays = 0
        self.tokens_delivered = 0

    @property
    def ttft_s(self) -> Optional[float]:
        if self.first_token_at is None:
            return None
        return self.first_token_at - self.queued_at

    def inter_token_s(self) -> List[float]:
        return [b - a for a, b in zip(self.token_times,
                                      self.token_times[1:])]

    def spans(self) -> List[Dict[str, Any]]:
        """Named (start, end) spans for trace export; open spans end at
        the last known timestamp."""
        out = []
        last = max([self.queued_at] + self.token_times
                   + [t for t in (self.admitted_at, self.first_token_at,
                                  self.retired_at) if t is not None]
                   + [s[1] for s in self.preempted_spans
                      if s[1] is not None])

        def span(name, a, b):
            if a is not None:
                out.append({"name": name, "start": a,
                            "end": b if b is not None else last})

        span("queued", self.queued_at, self.admitted_at)
        span("prefill", self.admitted_at, self.first_token_at)
        span("decode", self.first_token_at, self.retired_at)
        for s in self.preempted_spans:
            span("preempted", s[0], s[1])
        return out

    def to_dict(self) -> Dict[str, Any]:
        return {"rid": self.rid, "prompt_len": self.prompt_len,
                "queued_at": self.queued_at, "admitted_at": self.admitted_at,
                "first_token_at": self.first_token_at,
                "retired_at": self.retired_at, "replays": self.replays,
                "tokens_delivered": self.tokens_delivered,
                "ttft_s": self.ttft_s,
                "preempted_spans": [list(s) for s in self.preempted_spans]}


class Tracer:
    """Bounded structured-event tracer (see module docstring).

    ``capacity`` bounds the event ring buffer (oldest events drop;
    ``events_dropped`` counts them) and the retained COMPLETED request
    timelines.  All mutation happens under one lock — engines only touch it
    when a tracer is attached, so the acceptance contract "``step()`` takes
    no tracer lock when tracing is off" holds by construction.
    """

    def __init__(self, capacity: int = 4096,
                 registry: Optional[StatRegistry] = None,
                 recompile_warn_threshold: int = 8,
                 logger: Optional[logging.Logger] = None,
                 attribute_cost: bool = False,
                 peak_flops: Optional[float] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        if attribute_cost:
            raise NotImplementedError(
                "attribute_cost=True: program cost attribution reads XLA's "
                "cost analysis, which has no counterpart in the port "
                "(ROADMAP.md §C)")
        self.capacity = int(capacity)
        self._lock = threading.Lock()
        self._events: collections.deque = collections.deque(
            maxlen=self.capacity)
        self._live: Dict[int, RequestTimeline] = {}
        self._done: collections.deque = collections.deque(
            maxlen=self.capacity)
        self.registry = registry if registry is not None else StatRegistry()
        self._t0 = time.monotonic()
        self.events_dropped = 0
        self.recompile_warn_threshold = int(recompile_warn_threshold)
        self._post_warm_misses = 0
        self._warned_storm = False
        self._ticks = 0
        self._warmup_depth = 0            # expected_compiles nesting
        self._expected_keys = None        # warmup-grid labels, or None=all
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)
        # optional goodput ledger (telemetry_ledger.RunLedger): event
        # durations forward into its wall-clock buckets behind ONE
        # attribute check — None (the default) adds nothing.
        # _ledger_compiles logs (ts, wall) of forwarded compile misses so
        # tick() can subtract compile wall paid INSIDE the tick from its
        # compute attribution (the buckets must stay non-overlapping)
        self._ledger = None
        self._ledger_compiles: List[Tuple[float, float]] = []
        # optional SLO monitor (telemetry_slo.SLOMonitor): TTFT/inter-token
        # samples and terminal counts forward into its windowed stores
        # behind ONE attribute check — None (the default) adds nothing
        self._slo = None
        # request-trace plumbing: rid -> TraceContext, attached to every
        # request-timeline event while bound (gateway.submit mints the
        # trace, engine.add_request binds it here)
        self._trace_binds: Dict[int, TraceContext] = {}
        # peak_flops (default from PADDLE_TPU_PEAK_FLOPS) is reported by
        # mfu_summary; no program cost is ever recorded in the port
        if peak_flops is None:
            env = os.environ.get("PADDLE_TPU_PEAK_FLOPS")
            peak_flops = float(env) if env else None
        self.peak_flops = (None if not peak_flops
                           else float(peak_flops))
        # histograms live in the registry so prometheus_text() exports them
        self.registry.histogram("tick_seconds", DEFAULT_TIME_BUCKETS)
        self.registry.histogram("ttft_seconds", DEFAULT_TIME_BUCKETS)
        self.registry.histogram("inter_token_seconds", DEFAULT_TIME_BUCKETS)
        self.registry.histogram("compile_seconds", DEFAULT_TIME_BUCKETS)

    # ------------------------------------------------------------- clock --

    @property
    def t0(self) -> float:
        """This tracer's epoch on the process ``time.monotonic`` clock.
        Event ``ts`` values are seconds since it — ``t0 + ts`` puts
        events from DIFFERENT tracers (gateway + N engines) on one
        comparable timebase, which is what cross-source trace stitching
        (:class:`RequestTraceIndex`) aligns by."""
        return self._t0

    def now(self) -> float:
        return time.monotonic() - self._t0

    def last_event_age_s(self) -> Optional[float]:
        """Seconds since the newest ring event (None when empty) — an O(1)
        liveness peek that never copies the ring."""
        with self._lock:
            if not self._events:
                return None
            return max(0.0, self.now() - self._events[-1]["ts"])

    # ------------------------------------------------------------ ledger --

    #: event kind → RunLedger bucket for durations forwarded by set_ledger.
    #: sync IS device-blocked wait (the host waited on device compute);
    #: profiler_step is deliberately absent — a loop that is both monitor-
    #: instrumented and profiler-paced must not attribute the same wall
    #: time twice (the same double-count rule the counters follow).
    _LEDGER_BUCKETS = {"train_step": "host_dispatch", "sync": "compute"}

    def set_ledger(self, ledger):
        """Attach (or with None detach) a ``telemetry_ledger.RunLedger``:
        tick walls feed ``compute``, compile-miss walls feed ``compile``,
        train_step dispatch feeds ``host_dispatch`` and sync waits feed
        ``compute`` — the tracer becomes the ledger's event source with no
        new instrumentation and one attribute check when detached."""
        self._ledger = ledger
        return ledger

    def set_slo(self, slo):
        """Attach (or with None detach) a ``telemetry_slo.SLOMonitor``:
        TTFT samples (on retirement — the surviving attempt, the same
        one-sample-per-request semantics the histogram follows),
        inter-token samples, and terminal counts (retired / cancelled /
        preempted) forward into its windowed stores.  One attribute
        check when detached."""
        self._slo = slo
        return slo

    # ----------------------------------------------------- trace context --

    def bind_trace(self, rid: int, ctx: Optional[TraceContext]):
        """Bind a :class:`TraceContext` to a request id: every subsequent
        request-timeline event for ``rid`` carries its trace_id/span_id/
        parent_span_id, so cross-source stitching can reassemble the
        end-to-end request.  The binding is dropped when the timeline
        closes (retired/cancelled); ``ctx=None`` unbinds explicitly."""
        with self._lock:
            if ctx is None:
                self._trace_binds.pop(rid, None)
            else:
                self._trace_binds[rid] = ctx

    def trace_of(self, rid: int) -> Optional[TraceContext]:
        with self._lock:
            return self._trace_binds.get(rid)

    # ----------------------------------------------------------- ingest --

    def _append(self, ev: Dict[str, Any]):
        if len(self._events) == self.capacity:
            self.events_dropped += 1
        self._events.append(ev)

    def emit(self, kind: str, **fields):
        """Append one structured event (adds ``kind`` and ``ts``)."""
        ev = {"kind": kind, "ts": self.now()}
        ev.update(fields)
        with self._lock:
            self._append(ev)
        led = self._ledger
        if led is not None:
            bucket = self._LEDGER_BUCKETS.get(kind)
            if bucket is not None:
                led.record(bucket, float(fields.get("dur_s", 0.0)))
        return ev

    def tick(self, engine: str, dur_s: float, **fields):
        """One scheduler round; observes the tick-duration histogram and
        arms the post-warmup recompile accounting.  Engines add free-form
        composition fields; the ragged spec engine notes ``spec_rows``
        (draft+verify rows packed this tick) next to ``decode_rows``/
        ``prefill_tokens``, and its per-engine registry carries the
        acceptance counters (``tokens_drafted``/``tokens_accepted``) whose
        per-tick deltas ride the tick event."""
        self.registry.add("ticks")
        self.registry.observe("tick_seconds", dur_s)
        with self._lock:
            self._ticks += 1
            ev = {"kind": "tick", "ts": self.now(), "engine": engine,
                  "dur_s": dur_s}
            ev.update(fields)
            self._append(ev)
        led = self._ledger
        if led is not None:
            # a scheduler tick's host wall is device-driving time — the
            # serving-side ``compute`` bucket.  Compile misses paid INSIDE
            # this tick already went to the ``compile`` bucket
            # (compile_event), so their wall is subtracted here — the
            # ledger's buckets are non-overlapping by contract
            now = self.now()
            start = now - dur_s
            with self._lock:
                inside = [w for ts, w in self._ledger_compiles
                          if ts >= start]
                # entries older than this tick happened BETWEEN ticks
                # (warmup etc.) and never overlap a tick wall — drop them
                self._ledger_compiles = []
            led.record(
                "compute",
                max(0.0, dur_s - sum(min(w, dur_s) for w in inside)))
        return ev

    @contextlib.contextmanager
    def expected_compiles(self, keys=None):
        """Mark a warmup window (``jit.programs.run_warmup`` wraps its
        run in one):
        program-cache misses inside it that belong to the warmup grid are
        EXPECTED — they are tagged ``expected: true`` and never count
        toward the recompile-storm warning.

        ``keys``: the grid's program labels (``WarmupTask.label``); with
        a background warmup (``warmup_async``) live traffic compiles
        CONCURRENTLY with the window, and only grid programs may be
        excused — a real recompile storm must still arm the warning.
        None = every miss in the window is expected (single-purpose
        tracer, the blocking-warmup case).  Re-entrant; keys installed by
        the outermost entry win."""
        with self._lock:
            self._warmup_depth += 1
            if keys is not None and self._expected_keys is None:
                self._expected_keys = frozenset(keys)
                keys_installed = True
            else:
                keys_installed = False
        try:
            yield self
        finally:
            with self._lock:
                self._warmup_depth -= 1
                if keys_installed:
                    self._expected_keys = None

    @staticmethod
    def _in_grid(label: str, keys) -> bool:
        """Whether an event label names a declared warmup task.  Task
        labels may carry MORE trailing segments than program_label keeps
        (e.g. task ``seg:8:01`` vs event label ``seg:8`` — bools end the
        label's int run), so a task extending the label also matches."""
        return label in keys \
            or any(k.startswith(label + ":") for k in keys)

    def compile_event(self, engine: str, key, hit: bool,
                      wall_s: float = 0.0):
        """One program-cache access.  HITS are counter-only (several per
        tick at steady state — ring events for them would evict the tick/
        request history that summary() percentiles read); MISSES get a
        ring event, and misses after the first completed tick count toward
        the recompile-storm warning — unless they fall inside an
        ``expected_compiles`` warmup window.  A miss's ``provenance`` is
        ``cold`` (built in process): the port loads no program from
        disk."""
        reg = self.registry
        if hit:
            reg.add("compile_hits")
            return None
        label = program_label(key)
        with self._lock:
            keys = self._expected_keys
            expected = self._warmup_depth > 0 and (
                keys is None or self._in_grid(label, keys))
        reg.add("compile_misses")
        reg.add("compile_cold")
        reg.observe("compile_seconds", wall_s)
        reg.add("compile_wall_seconds_sum", wall_s)
        warn = False
        with self._lock:
            ev = {"kind": "compile", "ts": self.now(), "engine": engine,
                  "key": label, "hit": False, "wall_s": wall_s,
                  "provenance": "cold", "expected": expected}
            if self._ticks > 0 and not expected:
                self._post_warm_misses += 1
                if (self._post_warm_misses >= self.recompile_warn_threshold
                        and not self._warned_storm):
                    self._warned_storm = True
                    warn = True
            self._append(ev)
        led = self._ledger
        if led is not None:
            led.record("compile", wall_s)
            with self._lock:
                self._ledger_compiles.append((ev["ts"], wall_s))
        if warn:
            self._log.warning(
                "recompile storm: %d program-cache misses after warmup "
                "(latest: %s) — shape/bucket churn is forcing fresh "
                "program builds on the serving path",
                self._post_warm_misses, label)
        return ev

    def request_event(self, rid: int, what: str, **fields):
        """One request state transition (see module docstring for the
        ``what`` vocabulary); maintains the per-request timeline and the
        TTFT / inter-token histograms.  Events for a rid with a bound
        :class:`TraceContext` carry its trace_id/span_id/parent_span_id;
        with an attached SLO monitor, TTFT/inter-token samples and
        terminal counts forward into its windowed stores."""
        ts = self.now()
        slo = self._slo
        slo_obs: List[Tuple[str, float]] = []
        slo_cnt: List[str] = []
        with self._lock:
            ctx = self._trace_binds.get(rid)
            tl = self._live.get(rid)
            if tl is None and what == "queued":
                tl = self._live[rid] = RequestTimeline(
                    rid, ts, fields.get("prompt_len", 0))
            elif tl is None:
                # transition for an untracked request (tracer attached
                # mid-flight): open a timeline so spans stay well-formed
                tl = self._live[rid] = RequestTimeline(rid, ts)
            if what == "admitted":
                tl.admitted_at = ts
                for s in tl.preempted_spans:
                    if s[1] is None:
                        s[1] = ts          # replay wait ends at readmission
            elif what == "first_token":
                # NOT observed into the histogram here: a later preemption
                # would roll this attempt back, and the TTFT histogram must
                # carry one sample per request (the surviving attempt) —
                # observation happens at "retired"
                tl.first_token_at = ts
            elif what == "token":
                # live observation: rolled-back attempts stay in the
                # histogram (the client really waited those intervals);
                # request_summary() excludes them (token_times reset on
                # preemption)
                if tl.token_times:
                    self.registry.observe("inter_token_seconds",
                                          ts - tl.token_times[-1])
                    if slo is not None:
                        slo_obs.append(("itl_s", ts - tl.token_times[-1]))
                tl.token_times.append(ts)
                tl.tokens_delivered += 1
            elif what == "preempted":
                # the engine's on_token(rid, None, False) reset: the
                # streamed prefix is void — spans record the attempt, the
                # timeline's live token state starts over so TTFT and ITL
                # never mix pre- and post-replay attempts
                tl.replays += 1
                tl.preempted_spans.append([ts, None])
                tl.first_token_at = None
                tl.admitted_at = None
                tl.token_times = []
                tl.tokens_delivered = 0
                self.registry.add("requests_preempted")
                if slo is not None:
                    slo_cnt.append("requests_preempted")
            elif what == "retired":
                tl.retired_at = ts
                if tl.ttft_s is not None:
                    self.registry.observe("ttft_seconds", tl.ttft_s)
                    if slo is not None:
                        slo_obs.append(("ttft_s", tl.ttft_s))
                self.registry.add("requests_retired")
                if slo is not None:
                    slo_cnt.append("requests_retired")
                self._live.pop(rid, None)
                self._done.append(tl)
                self._trace_binds.pop(rid, None)
            elif what == "cancelled":
                # engine.cancel(): terminal — the timeline closes like a
                # retirement but contributes NO TTFT histogram sample (the
                # histograms describe completed service; cancels are
                # counted, not averaged in)
                tl.retired_at = ts
                self.registry.add("requests_cancelled")
                if slo is not None:
                    slo_cnt.append("requests_cancelled")
                self._live.pop(rid, None)
                self._done.append(tl)
                self._trace_binds.pop(rid, None)
            ev = {"kind": "request", "ts": ts, "rid": rid, "what": what}
            if ctx is not None:
                ev.update(ctx.to_dict())
            ev.update(fields)
            self._append(ev)
        if slo is not None:
            for metric, v in slo_obs:
                slo.observe(metric, v)
            for metric in slo_cnt:
                slo.count(metric)
        return ev

    # ---------------------------------------------------------- queries --

    def events(self, kind: Optional[str] = None) -> List[Dict[str, Any]]:
        with self._lock:
            evs = list(self._events)
        if kind is None:
            return evs
        return [e for e in evs if e["kind"] == kind]

    def timelines(self, include_live: bool = True) -> List[RequestTimeline]:
        with self._lock:
            out = list(self._done)
            if include_live:
                out.extend(self._live.values())
        return out

    def request_summary(self) -> Dict[str, Any]:
        """Exact percentile summary over the retained timelines: p50/p95/
        p99 TTFT (queued → surviving first token) and inter-token latency
        (consecutive accepted tokens of one request, replay attempts
        excluded)."""
        tls = self.timelines()
        ttfts = [tl.ttft_s for tl in tls if tl.ttft_s is not None]
        itl: List[float] = []
        for tl in tls:
            itl.extend(tl.inter_token_s())
        return {"requests_tracked": len(tls),
                "requests_retired": sum(1 for tl in tls
                                        if tl.retired_at is not None),
                "replays": sum(tl.replays for tl in tls),
                "ttft_s": _percentiles(ttfts),
                "inter_token_s": _percentiles(itl)}

    def summary(self) -> Dict[str, Any]:
        """One JSON-able snapshot: tick histogram, compile counters, and
        request percentiles — the BENCH-round telemetry attachment."""
        ticks = self.events("tick")
        reg = self.registry
        gw = self.events("gateway")
        gw_summary = None
        if gw:
            counts: Dict[str, int] = {}
            for ev in gw:
                counts[ev.get("what", "?")] = \
                    counts.get(ev.get("what", "?"), 0) + 1
            gw_summary = {
                "events": counts,
                "queue_s": _percentiles(
                    [ev["queue_s"] for ev in gw
                     if ev.get("what") == "dispatch"
                     and ev.get("queue_s") is not None]),
            }
        kv = self.events("kvstore")
        kv_summary = None
        if kv:
            kv_counts: Dict[str, int] = {}
            for ev in kv:
                kv_counts[ev.get("what", "?")] = \
                    kv_counts.get(ev.get("what", "?"), 0) + 1
            kv_summary = {
                "events": kv_counts,
                # bytes that completed a migration (the transfer-volume
                # headline; per-chunk accounting rides the gateway's
                # paddle_tpu_kvstore_* counters)
                "migrated_bytes": sum(
                    ev.get("bytes", 0) for ev in kv
                    if ev.get("what") == "migrate_done"),
            }
        tr_ev = self.events("train_resilience")
        tr_summary = None
        if tr_ev:
            tr_counts: Dict[str, int] = {}
            for ev in tr_ev:
                tr_counts[ev.get("what", "?")] = \
                    tr_counts.get(ev.get("what", "?"), 0) + 1
            tr_summary = {
                "events": tr_counts,
                # the newest durably-committed step (resume point truth)
                "last_commit_step": max(
                    (ev.get("step", -1) for ev in tr_ev
                     if ev.get("what") == "save_commit"), default=None),
            }
        out = {
            "ticks": len(ticks),
            "ticks_total": int(reg.value("ticks")),
            "tick_wall_s": _percentiles([e["dur_s"] for e in ticks]),
            "compile": {
                "hits": int(reg.value("compile_hits")),
                "misses": int(reg.value("compile_misses")),
                "wall_s": float(reg.value("compile_wall_seconds_sum")),
                "post_warmup_misses": self._post_warm_misses,
                # provenance split: cold = built in process, disk =
                # loaded from a persistent cache (never, in the port)
                "cold": int(reg.value("compile_cold")),
                "disk": int(reg.value("compile_disk")),
            },
            "requests": self.request_summary(),
            "mfu": self.mfu_summary(),
            "events_dropped": self.events_dropped,
        }
        if gw_summary is not None:     # only gateway-fed tracers carry it
            out["gateway"] = gw_summary
        if kv_summary is not None:     # only kv-tiering-fed tracers
            out["kvstore"] = kv_summary
        if tr_summary is not None:     # only checkpoint/supervisor-fed
            out["train_resilience"] = tr_summary
        return out

    def mfu_summary(self) -> Dict[str, Any]:
        """The reference's MFU/roofline section with no program cost
        recorded: the port has no cost source (XLA's cost analysis;
        ``ROADMAP.md`` §C), so FLOPs and bytes are zero and every rate is
        None; ``peak_flops`` is reported as configured.  Reading the
        reference's three cost counters registers them at 0, so the
        exposition carries the reference's metric names."""
        reg = self.registry
        for name in ("model_flops_total", "model_bytes_total",
                     "model_flops_wall_seconds"):
            reg.value(name)
        return {
            "model_flops_total": 0.0,
            "model_bytes_total": 0.0,
            "model_flops_per_s": None,
            "arithmetic_intensity": None,
            "peak_flops": self.peak_flops,
            "mfu": None,
            "programs_costed": 0,
        }

    # ---------------------------------------------------------- exports --

    def dump_jsonl(self, path: str) -> int:
        """One event per line (ring-buffer order), then one ``timeline``
        line per retained request; returns the number of lines written."""
        evs = self.events()
        tls = self.timelines()
        n = 0
        with open(path, "w") as f:
            for ev in evs:
                f.write(json.dumps(ev) + "\n")
                n += 1
            for tl in tls:
                f.write(json.dumps({"kind": "timeline", **tl.to_dict()})
                        + "\n")
                n += 1
        return n

    def to_chrome_trace(self) -> Dict[str, Any]:
        """Chrome-trace JSON: scheduler ticks and compiles as complete
        ("X") events, request timelines as per-request span rows — the
        ``{"traceEvents": [...]}`` form ``torch.profiler``'s Chrome export
        also writes, so both open in one Perfetto tab."""
        return events_to_chrome(self.events(),
                                [tl for tl in self.timelines()])

    def write_chrome_trace(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_chrome_trace(), f)

    def prometheus_text(self, namespace: str = "paddle_tpu_serving") -> str:
        # the reference's MFU gauges appear only with a recorded cost, never
        # in the port; mfu_summary registers its counters as it does there
        self.mfu_summary()
        return _stats_prometheus_text(self.registry, namespace=namespace)


# --------------------------------------------------------------------------
# cross-source request-trace stitching
# --------------------------------------------------------------------------


# gateway event `what` → stitched-trace request status.  ONE map for
# both RequestTraceIndex.recent() and .trace() — a new gateway event
# added here shows the same status on /requests and /request/<id>.
_GATEWAY_STATUS = {"submit": "queued", "dispatch": "dispatched",
                   "shed": "shed", "expired": "expired",
                   "cancel": "cancelled", "failed": "failed",
                   "finish": "finished", "reroute": "queued"}


class RequestTraceIndex:
    """Assemble per-request span trees ACROSS tracer sources.

    A gateway-fronted request leaves fragments in several ring buffers:
    the gateway tracer holds submit/shed/dispatch/reroute/finish events,
    and each replica engine's tracer holds that attempt's request
    timeline (queued → admitted → first_token → token* → retired).  All
    of them carry the same ``trace_id`` (:class:`TraceContext`), and this
    index stitches them back into ONE tree:

    - the **root span** is the gateway request (submit → terminal);
    - each engine **attempt span** (one per dispatch, reroutes included)
      is the child the gateway minted at dispatch time;
    - the attempt's **phase spans** (queued / prefill / decode, plus
      preempt markers) are synthetic children of the attempt.

    The index is a pure PULL reader: it holds references to tracers and
    scans their bounded rings on demand, so it costs
    nothing until queried and is bounded by the rings it reads.
    Timestamps are re-based onto one shared timeline via each tracer's
    ``t0`` epoch; the stitched output reports seconds since the trace's
    first event."""

    def __init__(self, sources=()):
        # attach happens at wiring time but the ops scrape thread scans
        # concurrently; held only for list ops, never across a ring read
        self._sources_lock = threading.Lock()
        self._sources: List[Tuple[str, Any]] = []  # guarded-by: _sources_lock
        for src in sources:
            if isinstance(src, tuple):
                self.add_source(src[1], src[0])
            else:
                self.add_source(src)

    def add_source(self, tracer, name: Optional[str] = None
                   ) -> "RequestTraceIndex":
        """Attach one event source: a ``Tracer`` or anything wrapping one
        (``TrainMonitor``, an engine with ``.tracer``, a gateway)."""
        inner = getattr(tracer, "tracer", tracer)
        if not (hasattr(inner, "events") and hasattr(inner, "t0")):
            raise TypeError(
                f"unsupported trace source: {type(tracer).__name__} "
                f"(want a Tracer or something carrying one)")
        with self._sources_lock:
            self._sources.append(
                (name or f"source{len(self._sources)}", inner))
        return self

    # ------------------------------------------------------------- scans --

    def _scan(self, trace_id: Optional[str] = None
              ) -> List[Tuple[str, Dict[str, Any], float]]:
        """(source, event, absolute_ts) for every ring event carrying a
        trace_id (optionally one specific trace)."""
        out = []
        with self._sources_lock:          # snapshot; ring reads outside
            sources = list(self._sources)
        for name, tr in sources:
            t0 = tr.t0
            for ev in tr.events():
                tid = ev.get("trace_id")
                if tid is None or (trace_id is not None
                                   and tid != trace_id):
                    continue
                out.append((name, ev, t0 + ev["ts"]))
        out.sort(key=lambda x: x[2])
        return out

    def recent(self, n: int = 64) -> List[Dict[str, Any]]:
        """Summaries of the most recent traces (newest first): trace_id,
        gateway id, last-known status, replicas touched, span/event
        counts — the ``GET /requests`` ring."""
        traces: Dict[str, Dict[str, Any]] = {}
        order: List[str] = []
        for source, ev, ats in self._scan():
            tid = ev["trace_id"]
            t = traces.get(tid)
            if t is None:
                t = traces[tid] = {"trace_id": tid, "first_ts": ats,
                                   "last_ts": ats, "events": 0,
                                   "status": None, "gid": None,
                                   "replicas": []}
                order.append(tid)
            t["events"] += 1
            t["last_ts"] = max(t["last_ts"], ats)
            if ev.get("kind") == "gateway":
                what = ev.get("what")
                if t["gid"] is None and ev.get("gid") is not None:
                    t["gid"] = ev.get("gid")
                rep = ev.get("replica")
                if rep is not None and rep not in t["replicas"]:
                    t["replicas"].append(rep)
                status = _GATEWAY_STATUS.get(what)
                if status is not None:
                    t["status"] = status
        order.sort(key=lambda tid: traces[tid]["last_ts"], reverse=True)
        out = []
        for tid in order[:max(int(n), 1)]:
            t = traces[tid]
            out.append(dict(t, duration_s=t["last_ts"] - t["first_ts"]))
        return out

    def trace(self, trace_id: str) -> Optional[Dict[str, Any]]:
        """The full stitched timeline of one trace: a flat span list
        (every span carries ``span_id`` + ``parent_span_id``; only the
        root has no parent) plus the raw cross-source event sequence.
        None when no source holds any event for the id."""
        scanned = self._scan(trace_id)
        if not scanned:
            return None
        base = scanned[0][2]

        def rel(ats):
            return round(ats - base, 6)

        spans: List[Dict[str, Any]] = []
        events = []
        root_id = None
        root_start = root_end = None
        status = None
        gid = None
        # attempt spans keyed by the dispatch-minted span_id
        attempts: Dict[str, Dict[str, Any]] = {}
        marks: Dict[str, Dict[str, float]] = {}   # span_id -> phase stamps

        for source, ev, ats in scanned:
            events.append(dict(ev, source=source, ts_abs=rel(ats)))
            sid = ev.get("span_id")
            kind = ev.get("kind")
            if kind == "gateway":
                what = ev.get("what")
                if gid is None and ev.get("gid") is not None:
                    gid = ev.get("gid")
                if what == "submit":
                    root_id = sid
                    root_start = ats
                    status = "queued"
                elif what == "dispatch":
                    att = attempts.get(sid)
                    if att is None:
                        att = attempts[sid] = {
                            "name": f"attempt@{ev.get('replica')}",
                            "span_id": sid,
                            "parent_span_id": ev.get("parent_span_id"),
                            "replica": ev.get("replica"),
                            "source": source, "start": ats, "end": ats,
                            "queue_s": ev.get("queue_s")}
                    else:
                        # the engine's own queued event can precede the
                        # gateway's dispatch event on the shared timebase;
                        # the dispatch is still the naming authority
                        att["name"] = f"attempt@{ev.get('replica')}"
                        att["replica"] = ev.get("replica")
                        att["queue_s"] = ev.get("queue_s")
                        att["start"] = min(att["start"], ats)
                    status = "dispatched"
                elif what in _GATEWAY_STATUS:
                    # submit/dispatch were consumed by the branches above
                    status = _GATEWAY_STATUS[what]
                    root_end = ats
                if root_start is None:
                    root_start = ats          # shed-before-submit safety
                root_end = ats if root_end is None else max(root_end, ats)
            elif kind == "request" and sid is not None:
                att = attempts.get(sid)
                if att is None:
                    att = attempts[sid] = {
                        "name": f"attempt@{source}", "span_id": sid,
                        "parent_span_id": ev.get("parent_span_id"),
                        "replica": None, "source": source,
                        "start": ats, "end": ats, "queue_s": None}
                att["source"] = source
                att["start"] = min(att["start"], ats)
                att["end"] = max(att["end"], ats)
                st = marks.setdefault(sid, {})
                what = ev.get("what")
                if what in ("queued", "admitted", "first_token",
                            "retired", "cancelled"):
                    st[what] = ats
                elif what == "preempted":
                    st.setdefault("preempts", []).append(ats)
                root_end = ats if root_end is None else max(root_end, ats)

        if root_id is None:
            # no gateway submit event in scope (engine-only trace): use
            # the attempts' shared parent as the root anchor
            parents = {a["parent_span_id"] for a in attempts.values()}
            root_id = next(iter(parents)) if len(parents) == 1 else None
        spans.append({"name": "request", "span_id": root_id,
                      "parent_span_id": None, "source": "gateway",
                      "start_s": rel(root_start if root_start is not None
                                     else base),
                      "end_s": rel(root_end if root_end is not None
                                   else base)})
        for sid, att in attempts.items():
            spans.append({"name": att["name"], "span_id": sid,
                          "parent_span_id": att["parent_span_id"],
                          "source": att["source"],
                          "replica": att["replica"],
                          "start_s": rel(att["start"]),
                          "end_s": rel(att["end"])})
            st = marks.get(sid, {})
            for phase, a_key, b_key in (("queued", "queued", "admitted"),
                                        ("prefill", "admitted",
                                         "first_token"),
                                        ("decode", "first_token", None)):
                a = st.get(a_key)
                if a is None:
                    continue
                b = st.get(b_key) if b_key is not None else None
                if b is None:
                    b = st.get("retired", st.get("cancelled", att["end"]))
                spans.append({"name": phase,
                              "span_id": f"{sid}:{phase}",
                              "parent_span_id": sid,
                              "source": att["source"],
                              "start_s": rel(a), "end_s": rel(b)})
            for i, p in enumerate(st.get("preempts", [])):
                spans.append({"name": "preempted",
                              "span_id": f"{sid}:preempt{i}",
                              "parent_span_id": sid,
                              "source": att["source"],
                              "start_s": rel(p), "end_s": rel(p)})
        return {
            "trace_id": trace_id,
            "gid": gid,
            "status": status,
            "duration_s": rel(root_end if root_end is not None else base),
            "replicas": sorted({s.get("replica") for s in spans
                                if s.get("replica") is not None}),
            "spans": spans,
            "events": events,
        }


# --------------------------------------------------------------------------
# training-side instrumentation
# --------------------------------------------------------------------------

_active_monitor: Optional["TrainMonitor"] = None


def set_active_monitor(monitor: Optional["TrainMonitor"]
                       ) -> Optional["TrainMonitor"]:
    """Install the process-wide active TrainMonitor (or None) and return the
    previous one.  Consumers that cannot be threaded a handle —
    ``Profiler.step`` — report through this; everything else takes an
    explicit ``monitor=``."""
    global _active_monitor
    prev = _active_monitor
    _active_monitor = monitor
    return prev


def current_monitor() -> Optional["TrainMonitor"]:
    return _active_monitor


class TrainMonitor:
    """Training-side instrumentation layer over the ring-buffer ``Tracer``.

    One monitor observes ONE training run: per-step host wall vs
    device-blocked time, throughput counters, compile events, a numerics
    watchdog (NaN/Inf + loss-spike, fed from loss values the caller was
    fetching anyway), a live-tensor HBM census, and aggregation of the
    step counters.  It shares the Tracer's
    zero-cost-off contract: every producer guards on ``monitor is None`` /
    ``current_monitor() is None`` — a single attribute/None check — and the
    monitor never adds operands to a compiled program.

    Exports ride the underlying tracer: ``dump_jsonl`` / ``to_chrome_trace``
    / ``prometheus_text`` (namespace ``paddle_tpu_train``) / ``summary()``.
    """

    def __init__(self, tracer: Optional[Tracer] = None, capacity: int = 4096,
                 spike_factor: float = 10.0, spike_min_steps: int = 5,
                 ema_decay: float = 0.9,
                 logger: Optional[logging.Logger] = None,
                 attribute_cost: bool = False,
                 peak_flops: Optional[float] = None):
        self.tracer = tracer if tracer is not None else Tracer(
            capacity=capacity, logger=logger,
            attribute_cost=attribute_cost, peak_flops=peak_flops)
        self.registry = self.tracer.registry
        self.spike_factor = float(spike_factor)
        self.spike_min_steps = int(spike_min_steps)
        self.ema_decay = float(ema_decay)
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)
        self._step_idx = 0
        self._loss_ema: Optional[float] = None
        self._loss_n = 0
        self.last_loss: Optional[float] = None
        self._warned_non_finite = False
        self._comm_policy: Optional[str] = None
        self.registry.histogram("step_seconds", DEFAULT_TIME_BUCKETS)
        self.registry.histogram("device_blocked_seconds",
                                DEFAULT_TIME_BUCKETS)
        # bucketize compile attribution baseline (jit/bucketing.py bumps the
        # GLOBAL stat; summary() reports the delta over this run)
        from .utils.stats import get_stat
        self._bucket_compiles0 = int(get_stat("bucketize_bucket_compiles"))

    # --------------------------------------------------------- lifecycle --
    def activate(self) -> "TrainMonitor":
        """Install as the process-wide active monitor (``Profiler.step``
        routing).  Also usable as a context manager."""
        self._prev_active = set_active_monitor(self)
        return self

    def deactivate(self):
        set_active_monitor(getattr(self, "_prev_active", None))

    __enter__ = activate

    def __exit__(self, *exc):
        self.deactivate()
        return False

    def set_ledger(self, ledger):
        """Forward this monitor's event durations into a
        ``telemetry_ledger.RunLedger`` (step dispatch → ``host_dispatch``,
        device-blocked syncs → ``compute``, compiles → ``compile``); None
        detaches.  See ``Tracer.set_ledger``."""
        return self.tracer.set_ledger(ledger)

    # ------------------------------------------------------------ ingest --
    def record_step(self, wall_s: float, trainer: str = "train",
                    examples: int = 0, tokens: int = 0,
                    loss: Optional[float] = None, **fields):
        """One train step.  ``wall_s`` is HOST dispatch wall (the chain is
        async — device-blocked time is what ``record_sync`` measures);
        ``loss``, when given, must already be a host scalar (never fetch
        one just to pass it here — that would add the sync this layer is
        contractually not allowed to add)."""
        reg = self.registry
        reg.add("train_steps")
        if examples:
            reg.add("train_examples", int(examples))
        if tokens:
            reg.add("train_tokens", int(tokens))
        reg.observe("step_seconds", wall_s)
        self._step_idx += 1
        ev = self.tracer.emit("train_step", trainer=trainer,
                              step=self._step_idx, dur_s=wall_s,
                              examples=int(examples), tokens=int(tokens),
                              **fields)
        if loss is not None:
            self.observe_loss(loss)
        return ev

    def record_sync(self, wall_s: float, loss: Optional[float] = None):
        """One host↔device synchronization (typically the log-cadence loss
        fetch): ``wall_s`` is the blocked host wait; the fetched ``loss``
        feeds the numerics watchdog for free."""
        self.registry.add("train_syncs")
        self.registry.observe("device_blocked_seconds", wall_s)
        ev = self.tracer.emit("sync", dur_s=wall_s,
                              **({} if loss is None else {"loss": float(loss)}))
        if loss is not None:
            self.observe_loss(loss)
        return ev

    def record_profiler_step(self, wall_s: float, samples: int = 0):
        """One ``Profiler.step`` span.  Kept on SEPARATE counters/kind
        (``profiler_steps``/``profiler_step_seconds``/``profiler_step``
        events) so a loop that is both monitor-instrumented and
        profiler-paced never double-counts into ``train_steps`` or the
        step-wall percentiles."""
        self.registry.add("profiler_steps")
        if samples:
            self.registry.add("profiler_samples", int(samples))
        self.registry.observe("profiler_step_seconds", wall_s)
        return self.tracer.emit("profiler_step", dur_s=wall_s,
                                examples=int(samples))

    def record_compile(self, key, wall_s: float):
        """One compiled-program build paid by the training loop (the first
        call of an instrumented step)."""
        return self.tracer.compile_event("train", key, False, wall_s)

    # ---------------------------------------------------------- watchdog --
    def observe_loss(self, loss) -> Optional[str]:
        """Numerics watchdog over an already-fetched host loss scalar.
        Returns the alarm kind (``non_finite``/``loss_spike``) or None.
        NaN/Inf logs ONE warning per monitor (the storm-dial convention);
        spikes never fold into the EMA, so a plateau shift re-fires until
        the caller intervenes."""
        loss = float(loss)
        self.last_loss = loss
        if loss != loss or loss in (float("inf"), float("-inf")):
            self.registry.add("watchdog_non_finite")
            self.tracer.emit("watchdog", what="non_finite", loss=loss,
                             step=self._step_idx)
            if not self._warned_non_finite:
                self._warned_non_finite = True
                self._log.warning(
                    "numerics watchdog: non-finite loss (%r) at step %d",
                    loss, self._step_idx)
            return "non_finite"
        ema = self._loss_ema
        if (ema is not None and self._loss_n >= self.spike_min_steps
                and abs(loss) > self.spike_factor * max(abs(ema), 1e-12)):
            self.registry.add("watchdog_loss_spikes")
            self.tracer.emit("watchdog", what="loss_spike", loss=loss,
                             ema=ema, step=self._step_idx)
            return "loss_spike"
        self._loss_ema = loss if ema is None \
            else self.ema_decay * ema + (1.0 - self.ema_decay) * loss
        self._loss_n += 1
        return None

    # -------------------------------------------------------- HBM census --
    def hbm_census(self, params=None, opt=None) -> Dict[str, int]:
        """Live-tensor byte census: every live tensor storage is
        classified param / opt-state / other against the passed trees
        (nested dicts, lists and tuples of tensors; views of one storage
        count once).  The walk lives in
        ``telemetry_memory.live_tensor_census`` — the single accounting
        point.  Gauges land on the registry with ``set_max``-tracked
        peaks; returns the census dict.  Never called inside a step (a
        graph capture may be in flight there)."""
        from .telemetry_memory import live_tensor_census

        walk = live_tensor_census({"params": params, "opt": opt})
        counts = {"params_bytes": walk["params_bytes"],
                  "opt_bytes": walk["opt_bytes"],
                  "other_bytes": walk["other_bytes"]}
        n_arrays = walk["arrays"]
        total = walk["total_bytes"]
        reg = self.registry
        for k, v in counts.items():
            reg.set(f"hbm_{k}", v)
        reg.set("hbm_live_bytes", total)
        reg.set("hbm_live_arrays", n_arrays)
        reg.set_max("hbm_peak_bytes", total)   # the ONE high-water source
        census = dict(counts, total_bytes=total, arrays=n_arrays,
                      peak_bytes=int(reg.value("hbm_peak_bytes")))
        self.tracer.emit("hbm", step=self._step_idx, **census)
        return census

    # ------------------------------------------------------- aggregation --
    def record_comm(self, policy: str, pre_bytes: int, post_bytes: int,
                    **fields):
        """One gradient-communication accounting event (the
        ``distributed.grad_comm`` policy layer): ``pre_bytes`` is the
        fp32-baseline wire estimate for this step's reduction,
        ``post_bytes`` the active policy's.  Pure host arithmetic from
        tree shapes — never a device sync."""
        pre, post = int(pre_bytes), int(post_bytes)
        reg = self.registry
        reg.add("comm_steps")
        reg.add("comm_pre_bytes", pre)
        reg.add("comm_post_bytes", post)
        self._comm_policy = policy
        return self.tracer.emit(
            "comm", policy=policy, pre_bytes=pre, post_bytes=post,
            savings=(pre / post if post else None), step=self._step_idx,
            **fields)

    def aggregate(self) -> Dict[str, Any]:
        """Cross-rank reduction of the step counters (ONE batched
        collective per reduction op via ``fleet.metrics
        .all_reduce_metrics``): global examples/tokens per second over the
        slowest replica's wall, plus per-replica straggler skew (max
        replica step-wall over the mean).  Identity in a single process
        (skew 1.0).  Every rank of the default group calls it."""
        from .distributed import env
        from .distributed.fleet.metrics.metric import all_reduce_metrics

        reg = self.registry
        wall = float(reg.histogram("step_seconds").snapshot()["sum"])
        local = {"steps": float(reg.value("train_steps")),
                 "examples": float(reg.value("train_examples")),
                 "tokens": float(reg.value("train_tokens")),
                 "step_wall_s": wall}
        sums = all_reduce_metrics(local, "sum")
        maxs = all_reduce_metrics({"step_wall_s": wall}, "max")
        world = max(int(env.get_world_size()), 1)
        wall_max = maxs["step_wall_s"]
        wall_mean = sums["step_wall_s"] / world
        out = {
            "world": world,
            "steps": sums["steps"],
            "examples": sums["examples"],
            "tokens": sums["tokens"],
            "global_examples_per_sec": (sums["examples"] / wall_max
                                        if wall_max > 0 else None),
            "global_tokens_per_sec": (sums["tokens"] / wall_max
                                      if wall_max > 0 else None),
            "straggler_skew": (wall_max / wall_mean
                               if wall_mean > 0 else None),
        }
        self.tracer.emit("aggregate", **out)
        return out

    # ----------------------------------------------------------- queries --
    def events(self, kind: Optional[str] = None):
        return self.tracer.events(kind)

    def summary(self) -> Dict[str, Any]:
        """One JSON-able snapshot of the run: step-wall percentiles, device-blocked
        percentiles, throughput, compile counts, watchdog counters, HBM
        peaks, and ``mfu`` None: no step cost is recorded in the port."""
        from .utils.stats import get_stat
        reg = self.registry
        step_evs = self.events("train_step")
        sync_evs = self.events("sync")
        step_sum = float(reg.histogram("step_seconds").snapshot()["sum"])
        sync_sum = float(
            reg.histogram("device_blocked_seconds").snapshot()["sum"])
        wall = step_sum + sync_sum
        tokens = int(reg.value("train_tokens"))
        examples = int(reg.value("train_examples"))
        return {
            "steps": int(reg.value("train_steps")),
            "step_wall_s": _percentiles([e["dur_s"] for e in step_evs]),
            "device_blocked_s": _percentiles(
                [e["dur_s"] for e in sync_evs]),
            "examples_per_sec": (examples / wall
                                 if wall > 0 and examples else None),
            "tokens_per_sec": (tokens / wall
                               if wall > 0 and tokens else None),
            "compile": {
                "misses": int(reg.value("compile_misses")),
                "hits": int(reg.value("compile_hits")),
                "wall_s": float(reg.value("compile_wall_seconds_sum")),
                "cold": int(reg.value("compile_cold")),
                "disk": int(reg.value("compile_disk")),
                "bucket_compiles": int(
                    get_stat("bucketize_bucket_compiles"))
                - self._bucket_compiles0,
            },
            "watchdog": {
                "non_finite": int(reg.value("watchdog_non_finite")),
                "loss_spikes": int(reg.value("watchdog_loss_spikes")),
                "last_loss": self.last_loss,
                "loss_ema": self._loss_ema,
            },
            "hbm": {
                "peak_bytes": int(reg.value("hbm_peak_bytes")),
                "params_bytes": int(reg.value("hbm_params_bytes")),
                "opt_bytes": int(reg.value("hbm_opt_bytes")),
                "other_bytes": int(reg.value("hbm_other_bytes")),
            },
            "comm": self._comm_summary(),
            "mfu": None,
            "events_dropped": self.tracer.events_dropped,
        }

    def _comm_summary(self) -> Optional[Dict[str, Any]]:
        """Aggregate grad-comm accounting (None when no policy reported):
        total pre/post wire bytes over the run and their ratio."""
        if self._comm_policy is None:
            return None
        reg = self.registry
        pre = int(reg.value("comm_pre_bytes"))
        post = int(reg.value("comm_post_bytes"))
        return {
            "policy": self._comm_policy,
            "steps": int(reg.value("comm_steps")),
            "pre_bytes": pre,
            "post_bytes": post,
            "savings": (round(pre / post, 3) if post else None),
        }

    # ----------------------------------------------------------- exports --
    def dump_jsonl(self, path: str) -> int:
        return self.tracer.dump_jsonl(path)

    def to_chrome_trace(self) -> Dict[str, Any]:
        return self.tracer.to_chrome_trace()

    def write_chrome_trace(self, path: str):
        self.tracer.write_chrome_trace(path)

    def prometheus_text(self, namespace: str = "paddle_tpu_train") -> str:
        return self.tracer.prometheus_text(namespace=namespace)


def _default_batch_info(args) -> Tuple[int, int]:
    """(examples, tokens) heuristic for an instrumented step's call args:
    the LARGEST tensor among the non-state args is the input batch — its
    leading dim is examples; for 2-D (token-id) inputs tokens is
    batch × seq, otherwise 0 (an image batch has no token count)."""
    best = None
    for _p, leaf in _leaves_with_path(list(args[1:])):
        shape = leaf.shape
        if len(shape) < 1:
            continue
        size = 1
        for d in shape:
            size *= int(d)
        if best is None or size > best[0]:
            best = (size, shape)
    if best is None:
        return 0, 0
    shape = best[1]
    examples = int(shape[0])
    tokens = examples * int(shape[1]) if len(shape) == 2 else 0
    return examples, tokens


def instrument_train_step(step: Callable, monitor: Optional[TrainMonitor],
                          name: str = "train",
                          batch_info: Optional[Callable] = None,
                          comm: Optional[Dict[str, Any]] = None) -> Callable:
    """Wrap a train-step callable with per-call TrainMonitor timing.

    ``monitor=None`` returns ``step`` UNCHANGED — the builders'
    zero-cost-off contract (no wrapper frame, no checks).  With a
    monitor, each call times host dispatch wall; the FIRST call
    synchronises the card its outputs live on (``torch.cuda.synchronize``;
    nothing on the CPU) and is recorded as this step's compile event ONLY
    (kernel builds, lazy casts and the first run — it never pollutes the
    step_seconds percentiles), so steady-state calls add NO
    synchronisation and ``train_steps`` counts post-warmup steps.  The
    wrapper is ``functools.wraps`` of the step: it calls the same object
    with the same arguments.

    ``comm``: optional ``{"policy", "pre_bytes", "post_bytes"}`` (a
    ``grad_comm`` policy's wire estimate for one step's reduction): each
    steady-state call also records a ``comm`` event.

    With an active ``telemetry_memory.MemoryLedger`` the returned state is
    re-registered after every call — one ``is None`` check when no ledger
    is active."""
    if monitor is None:
        return step
    import torch
    first = [True]

    def _reregister_state(out):
        from .telemetry_memory import current_memory_ledger
        ml = current_memory_ledger()
        if ml is None:
            return
        state = out[0] if isinstance(out, tuple) and out else out
        if isinstance(state, dict):
            ml.register_train_state(state, name=name)

    def _sync(out):
        devs = {t.device for _p, t in _leaves_with_path(out)
                if t.device.type == "cuda"}
        for d in devs:
            torch.cuda.synchronize(d)

    @functools.wraps(step)
    def wrapped(*args, **kwargs):
        t0 = time.perf_counter()
        out = step(*args, **kwargs)
        _reregister_state(out)
        if first[0]:
            # the first call builds what the step needs (kernel libraries,
            # lazily cast weights) inside its dispatch — it becomes ONLY
            # the compile event, never a train_step sample, so step
            # percentiles and throughput measure steady state
            first[0] = False
            _sync(out)
            monitor.record_compile((f"{name}_step",),
                                   time.perf_counter() - t0)
            return out
        examples, tokens = (batch_info(args, kwargs)
                            if batch_info is not None
                            else _default_batch_info(args))
        monitor.record_step(time.perf_counter() - t0, trainer=name,
                            examples=examples, tokens=tokens)
        if comm is not None:
            monitor.record_comm(**comm)
        return out

    return wrapped


_PID = "paddle_tpu.serving"
_TRAIN_PID = "paddle_tpu.train"


def events_to_chrome(events: List[Dict[str, Any]],
                     timelines: Optional[List[Any]] = None
                     ) -> Dict[str, Any]:
    """Convert tracer events (+ optional timelines) to Chrome-trace JSON.
    Used by ``Tracer.to_chrome_trace`` and by ``chrome_trace_from_jsonl``
    for offline conversion of a JSONL dump."""
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": _PID,
         "args": {"name": _PID}},
        {"name": "process_name", "ph": "M", "pid": _TRAIN_PID,
         "args": {"name": _TRAIN_PID}},
    ]
    for ev in events:
        us = ev["ts"] * 1e6
        if ev["kind"] == "tick":
            args = {k: v for k, v in ev.items()
                    if k not in ("kind", "ts", "dur_s")}
            out.append({"name": "tick", "cat": "scheduler", "ph": "X",
                        "pid": _PID, "tid": "scheduler",
                        "ts": us - ev.get("dur_s", 0.0) * 1e6,
                        "dur": ev.get("dur_s", 0.0) * 1e6, "args": args})
        elif ev["kind"] == "compile":
            if ev.get("hit"):
                continue                      # hits are noise on a timeline
            dur = ev.get("wall_s", 0.0) * 1e6
            out.append({"name": f"compile:{ev.get('key', '?')}",
                        "cat": "compile", "ph": "X", "pid": _PID,
                        "tid": "compile", "ts": us - dur, "dur": dur,
                        "args": {"engine": ev.get("engine")}})
        elif ev["kind"] == "request":
            out.append({"name": ev.get("what", "?"), "cat": "request",
                        "ph": "i", "s": "t", "pid": _PID,
                        "tid": f"req:{ev.get('rid')}", "ts": us,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("kind", "ts")}})
            if ev.get("what") == "admitted" and ev.get("span_id"):
                # flow FINISH: the engine end of the gateway's dispatch
                # arrow — same id (the dispatch-minted span) on both
                # sides, so Perfetto draws gateway row → engine row even
                # across merged multi-replica trace files
                out.append({"name": "request", "cat": "trace", "ph": "f",
                            "bp": "e", "id": ev["span_id"], "pid": _PID,
                            "tid": f"req:{ev.get('rid')}", "ts": us,
                            "args": {"trace_id": ev.get("trace_id")}})
        elif ev["kind"] == "gateway":
            # gateway actions are instants on their own scheduler row —
            # shed/reroute/drain markers line up against ticks and request
            # spans in the same Perfetto view
            out.append({"name": f"gateway:{ev.get('what', '?')}",
                        "cat": "gateway", "ph": "i", "s": "t",
                        "pid": _PID, "tid": "gateway", "ts": us,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("kind", "ts")}})
            if ev.get("what") == "dispatch" and ev.get("span_id"):
                # flow START keyed by the dispatch span id (see the
                # request-event "f" above)
                out.append({"name": "request", "cat": "trace", "ph": "s",
                            "id": ev["span_id"], "pid": _PID,
                            "tid": "gateway", "ts": us,
                            "args": {"trace_id": ev.get("trace_id"),
                                     "replica": ev.get("replica")}})
        elif ev["kind"] == "slo":
            # SLO alert transitions: instants on their own row, lined up
            # against the serving ticks they indict
            out.append({"name": f"slo:{ev.get('what', '?')}"
                        f":{ev.get('objective', '?')}",
                        "cat": "slo", "ph": "i", "s": "t",
                        "pid": _PID, "tid": "slo", "ts": us,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("kind", "ts")}})
        elif ev["kind"] in ("train_step", "sync", "profiler_step"):
            args = {k: v for k, v in ev.items()
                    if k not in ("kind", "ts", "dur_s")}
            dur = ev.get("dur_s", 0.0) * 1e6
            out.append({"name": ev["kind"], "cat": "train", "ph": "X",
                        "pid": _TRAIN_PID, "tid": ev["kind"],
                        "ts": us - dur, "dur": dur, "args": args})
        elif ev["kind"] in ("watchdog", "hbm", "aggregate", "comm"):
            name = ev.get("what", ev["kind"])
            out.append({"name": f"{ev['kind']}:{name}"
                        if "what" in ev else ev["kind"],
                        "cat": "train", "ph": "i", "s": "t",
                        "pid": _TRAIN_PID, "tid": ev["kind"], "ts": us,
                        "args": {k: v for k, v in ev.items()
                                 if k not in ("kind", "ts")}})
    for tl in timelines or []:
        spans = tl.spans() if hasattr(tl, "spans") else _dict_spans(tl)
        rid = tl.rid if hasattr(tl, "rid") else tl.get("rid")
        for sp in spans:
            out.append({"name": sp["name"], "cat": "request", "ph": "X",
                        "pid": _PID, "tid": f"req:{rid}",
                        "ts": sp["start"] * 1e6,
                        "dur": max(sp["end"] - sp["start"], 0.0) * 1e6,
                        "args": {"rid": rid}})
    return {"traceEvents": out, "displayTimeUnit": "ms"}


def _dict_spans(tl: Dict[str, Any]) -> List[Dict[str, Any]]:
    """Span reconstruction for a ``timeline`` dict read back from JSONL
    (same shape RequestTimeline.spans produces)."""
    stamps = [tl.get("queued_at"), tl.get("admitted_at"),
              tl.get("first_token_at"), tl.get("retired_at")]
    stamps += [t for s in tl.get("preempted_spans", []) for t in s]
    known = [t for t in stamps if t is not None]
    last = max(known) if known else 0.0
    out = []
    for name, a, b in (("queued", tl.get("queued_at"), tl.get("admitted_at")),
                       ("prefill", tl.get("admitted_at"),
                        tl.get("first_token_at")),
                       ("decode", tl.get("first_token_at"),
                        tl.get("retired_at"))):
        if a is not None:
            out.append({"name": name, "start": a,
                        "end": b if b is not None else last})
    for s in tl.get("preempted_spans", []):
        if s and s[0] is not None:
            out.append({"name": "preempted", "start": s[0],
                        "end": s[1] if s[1] is not None else last})
    return out


def chrome_trace_from_jsonl(path: str) -> Dict[str, Any]:
    """Offline conversion: read a ``dump_jsonl`` file back into the same
    Chrome-trace JSON ``Tracer.to_chrome_trace`` produces live."""
    events: List[Dict[str, Any]] = []
    timelines: List[Dict[str, Any]] = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            ev = json.loads(line)
            if ev.get("kind") == "timeline":
                timelines.append(ev)
            else:
                events.append(ev)
    return events_to_chrome(events, timelines)

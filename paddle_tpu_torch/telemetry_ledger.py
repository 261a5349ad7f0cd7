"""Goodput ledger: exhaustive wall-clock attribution for one run (the
port's copy of ``paddle_tpu/telemetry_ledger.py``).

:class:`RunLedger` partitions a run's elapsed wall clock **exhaustively**
into non-overlapping buckets:

==================== =====================================================
bucket               wall time spent …
==================== =====================================================
``compute``          device-blocked (the host waited on device results:
                     a loss fetch, a serving scheduler tick)
``data_wait``        blocked on the input pipeline
``host_dispatch``    host-side step dispatch wall (Python + launches)
``compile``          building a program: kernel libraries, lazy casts,
                     the eager run and CUDA-graph capture of its first
                     dispatch
``checkpoint_save``  writing a checkpoint
``checkpoint_restore`` reading one back
``comm``             host-level collective exchanges
``eval``             an evaluation pass (an exclusive span)
``unattributed``     the remainder — elapsed minus everything above
==================== =====================================================

Buckets sum to elapsed wall time by construction (``unattributed`` is the
remainder; over-attribution is surfaced as ``overflow_s`` instead of being
hidden), and ``goodput = compute / elapsed``.  The producer is the
telemetry event stream — ``Tracer.set_ledger`` forwards tick, compile,
train_step and sync durations with one attribute check — plus any seam
that reports through the process-wide active ledger
(:func:`set_active_ledger` / :func:`current_ledger` / :func:`ledger_span`).
Everything is zero-cost when no ledger is active: one ``is None`` check
per seam.  :meth:`RunLedger.aggregate` reduces across ranks through
``distributed.fleet.metrics.all_reduce_metrics``.

The :class:`FlightRecorder` closes the post-mortem gap: installed, it
dumps the attached tracers' ring buffers, the ledgers' snapshots and
every thread's stack to a crash directory on abnormal exit (unhandled
exception, SIGTERM, or a hard fault via ``faulthandler``).
"""

from __future__ import annotations

import atexit
import collections
import contextlib
import faulthandler
import json
import logging
import os
import signal as _signal
import sys
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

__all__ = ["RunLedger", "FlightRecorder", "BUCKETS", "set_active_ledger",
           "current_ledger", "ledger_span", "chrome_counters_from_dump"]

#: The exhaustive bucket taxonomy, in display order.  ``unattributed`` is
#: derived (elapsed − attributed), never recorded directly.
BUCKETS: Tuple[str, ...] = (
    "compute", "data_wait", "host_dispatch", "compile", "checkpoint_save",
    "checkpoint_restore", "comm", "eval", "unattributed")

_ATTRIBUTED = tuple(b for b in BUCKETS if b != "unattributed")

_EPS = 1e-12


class RunLedger:
    """Exhaustive wall-clock attribution for one run (module docstring).

    ``capacity`` bounds the retained ``(ts, bucket, dur)`` sample series
    (the chrome counter track / flight-recorder payload); the per-bucket
    totals are exact regardless.  All mutation is under one lock;
    ``record`` is a dict add + deque append — cheap enough for per-batch
    seams, and seams only reach it when a ledger is active.
    """

    def __init__(self, capacity: int = 4096,
                 logger: Optional[logging.Logger] = None,
                 clock: Optional[Callable[[], float]] = None):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self._lock = threading.Lock()
        # injectable clock so sim hosts attribute against SIM elapsed time
        # (a real-clock denominator under sim-second compute makes goodput
        # meaningless); real runs keep time.monotonic
        self._clock = time.monotonic if clock is None else clock
        self._t0 = self._clock()
        self._closed_at: Optional[float] = None
        self._sec: Dict[str, float] = {b: 0.0 for b in _ATTRIBUTED}
        self._n: Dict[str, int] = {b: 0 for b in _ATTRIBUTED}
        self._series: collections.deque = collections.deque(maxlen=capacity)
        self._tls = threading.local()      # per-thread exclusive-span stack
        self._prev_active: Optional["RunLedger"] = None
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)

    # ------------------------------------------------------------- clock --
    def now(self) -> float:
        return self._clock() - self._t0

    def elapsed_s(self) -> float:
        if self._closed_at is not None:
            return self._closed_at - self._t0
        return self._clock() - self._t0

    def close(self):
        """Freeze elapsed time (idempotent).  Later ``record`` calls are
        dropped — the run is over; a closed ledger is a stable artifact."""
        with self._lock:
            if self._closed_at is None:
                self._closed_at = self._clock()

    def reset(self):
        """Clear all attribution and restart the elapsed clock — what
        ``GoodputCallback`` does at train begin so ``elapsed`` measures
        exactly the fit window, not construction-to-fit dead time."""
        with self._lock:
            self._t0 = self._clock()
            self._closed_at = None
            self._sec = {b: 0.0 for b in _ATTRIBUTED}
            self._n = {b: 0 for b in _ATTRIBUTED}
            self._series.clear()

    # ------------------------------------------------------------ ingest --
    def record(self, bucket: str, dur_s: float, count: int = 1):
        """Attribute ``dur_s`` seconds of wall clock to ``bucket``.

        Inside an *exclusive* span (see :meth:`span`) records for OTHER
        buckets on the same thread are absorbed — their wall time is
        already covered by the enclosing span, and double-attribution
        would break the buckets-sum-to-elapsed invariant."""
        # validate against the static schema, not the live dict — reading
        # self._sec here would race reset()'s locked rebind of it
        if bucket not in _ATTRIBUTED:
            raise ValueError(f"unknown bucket {bucket!r}; one of {_ATTRIBUTED}")
        excl = getattr(self._tls, "exclusive", None)
        if excl and excl[-1] != bucket:
            return
        if dur_s < 0.0:
            dur_s = 0.0
        with self._lock:
            if self._closed_at is not None:
                return
            self._sec[bucket] += dur_s
            self._n[bucket] += count
            self._series.append((self._clock() - self._t0, bucket, dur_s))

    @contextlib.contextmanager
    def span(self, bucket: str, exclusive: bool = False):
        """Context manager attributing the block's wall time to ``bucket``.
        ``exclusive=True`` additionally absorbs same-thread records for
        other buckets inside the block (``Model.evaluate`` uses it: the
        eval loop's data waits and fetches ARE eval time)."""
        # validate against the static schema, not the live dict — reading
        # self._sec here would race reset()'s locked rebind of it
        if bucket not in _ATTRIBUTED:
            raise ValueError(f"unknown bucket {bucket!r}; one of {_ATTRIBUTED}")
        if exclusive:
            stack = getattr(self._tls, "exclusive", None)
            if stack is None:
                stack = self._tls.exclusive = []
            stack.append(bucket)
        t0 = time.perf_counter()
        try:
            yield self
        finally:
            dur = time.perf_counter() - t0
            if exclusive:
                self._tls.exclusive.pop()
            self.record(bucket, dur)

    # ----------------------------------------------------------- queries --
    def snapshot(self) -> Dict[str, Any]:
        """One JSON-able snapshot.  Invariant: ``sum(buckets_s.values())``
        equals ``elapsed_s`` whenever ``overflow_s`` is 0 (and exceeds it
        by exactly ``overflow_s`` otherwise — over-attribution is shown,
        never silently clipped into a lie)."""
        with self._lock:
            sec = dict(self._sec)
            counts = dict(self._n)
        elapsed = self.elapsed_s()
        attributed = sum(sec.values())
        unattributed = max(0.0, elapsed - attributed)
        overflow = max(0.0, attributed - elapsed)
        buckets = dict(sec, unattributed=unattributed)
        denom = max(elapsed, _EPS)
        return {
            "elapsed_s": elapsed,
            "goodput": sec["compute"] / denom,
            "buckets_s": buckets,
            "fractions": {b: v / denom for b, v in buckets.items()},
            "counts": counts,
            "overflow_s": overflow,
            "closed": self._closed_at is not None,
        }

    def goodput(self) -> float:
        return self.snapshot()["goodput"]

    def aggregate(self) -> Dict[str, Any]:
        """Cross-rank roll-up via ``fleet.metrics.all_reduce_metrics`` —
        ONE batched collective per reduction op (sum + max), never one per
        bucket: global goodput (fleet compute seconds over fleet elapsed
        seconds) and per-bucket straggler skew (max replica seconds over
        the mean; 1.0 = perfectly balanced, None = bucket empty
        everywhere).  Identity in a single process."""
        from .distributed import env
        from .distributed.fleet.metrics.metric import all_reduce_metrics

        snap = self.snapshot()
        local = {b: float(snap["buckets_s"][b]) for b in BUCKETS}
        local["elapsed_s"] = float(snap["elapsed_s"])
        sums = all_reduce_metrics(local, "sum")
        maxs = all_reduce_metrics(local, "max")
        world = max(int(env.get_world_size()), 1)
        skew = {}
        for b in BUCKETS:
            mean = sums[b] / world
            skew[b] = (maxs[b] / mean) if mean > _EPS else None
        return {
            "world": world,
            "goodput": sums["compute"] / max(sums["elapsed_s"], _EPS),
            "buckets_s": {b: sums[b] for b in BUCKETS},
            "elapsed_s_max": maxs["elapsed_s"],
            "straggler_skew": skew,
        }

    # ----------------------------------------------------------- exports --
    def prometheus_text(self, namespace: str = "paddle_tpu_ledger") -> str:
        """Text exposition of the snapshot: per-bucket second gauges,
        ``goodput``, ``elapsed_seconds``, ``overflow_seconds``, and
        per-bucket event counters."""
        from .utils.stats import StatRegistry, prometheus_text as _pt
        snap = self.snapshot()
        gauges = {"goodput": snap["goodput"],
                  "elapsed_seconds": snap["elapsed_s"],
                  "overflow_seconds": snap["overflow_s"]}
        for b, v in snap["buckets_s"].items():
            gauges[f"{b}_seconds"] = v
        counters = {f"{b}_events": n for b, n in snap["counts"].items()}
        return _pt(StatRegistry(), namespace=namespace,
                   extra_gauges=gauges, extra_counters=counters)

    def to_dict(self) -> Dict[str, Any]:
        """Snapshot + retained sample series — the ``dump_json`` payload
        and the flight-recorder artifact."""
        with self._lock:
            series = [[ts, b, dur] for ts, b, dur in self._series]
        return {"kind": "ledger", "snapshot": self.snapshot(),
                "series": series}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def to_chrome_counters(self, pid: str = "paddle_tpu.ledger"
                           ) -> List[Dict[str, Any]]:
        """Chrome-trace counter ("C") events: the cumulative per-bucket
        seconds after each retained sample — a stacked counter track that
        merges next to the tracer's span rows in Perfetto."""
        return chrome_counters_from_dump(self.to_dict(), pid=pid)

    # ---------------------------------------------------------- lifecycle --
    def activate(self) -> "RunLedger":
        """Install as the process-wide active ledger (the seam
        ``ledger_span`` reports through).  Also a context manager."""
        self._prev_active = set_active_ledger(self)
        return self

    def deactivate(self):
        set_active_ledger(self._prev_active)
        self._prev_active = None

    __enter__ = activate

    def __exit__(self, *exc):
        self.deactivate()
        return False


def chrome_counters_from_dump(data: Dict[str, Any],
                              pid: str = "paddle_tpu.ledger"
                              ) -> List[Dict[str, Any]]:
    """``RunLedger.to_dict()`` / ``dump_json`` payload → chrome counter
    events (offline twin of ``to_chrome_counters``)."""
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": pid}}]
    cum = {b: 0.0 for b in _ATTRIBUTED}
    for ts, bucket, dur in data.get("series", []):
        if bucket in cum:
            cum[bucket] += dur
        out.append({"name": "ledger_seconds", "ph": "C", "pid": pid,
                    "ts": float(ts) * 1e6,
                    "args": {b: round(v, 6) for b, v in cum.items()}})
    return out


# --------------------------------------------------------------------------
# process-wide active ledger
# --------------------------------------------------------------------------

_active_ledger: Optional[RunLedger] = None


def set_active_ledger(ledger: Optional[RunLedger]) -> Optional[RunLedger]:
    """Install the process-wide active ledger (or None) and return the
    previous one.  Seams that cannot be threaded a handle report through
    this (``ledger_span``); everything else takes an explicit ledger."""
    global _active_ledger
    prev = _active_ledger
    _active_ledger = ledger
    return prev


def current_ledger() -> Optional[RunLedger]:
    return _active_ledger


@contextlib.contextmanager
def ledger_span(bucket: str, exclusive: bool = False):
    """``span`` on the active ledger; a no-op context when none is active
    (the one-check-zero-cost contract every seam shares)."""
    led = _active_ledger
    if led is None:
        yield None
        return
    with led.span(bucket, exclusive=exclusive):
        yield led


# --------------------------------------------------------------------------
# flight recorder
# --------------------------------------------------------------------------

class FlightRecorder:
    """Crash-dump hook: on abnormal exit, write the attached tracers' ring
    buffers, the attached ledgers' snapshots, and every thread's stack to
    ``crash_dir`` — the post-mortem keeps the last N seconds of events
    instead of dying with the process.

    Three triggers, all installed by :meth:`install`:

    - **unhandled exception** — chains ``sys.excepthook`` (dump first,
      then the previous hook prints the traceback as usual);
    - **signals** (default SIGTERM, the preemption/oom-killer notice) —
      dump, then chain the previous handler (or re-raise the default so
      the process still dies with the right status);
    - **hard faults** — ``faulthandler.enable`` onto a file in the crash
      dir, so segfaults/deadlock ``SIGABRT`` leave native-level stacks the
      Python hooks can never see.

    ``dump()`` never raises (a crash handler that crashes destroys the
    evidence it exists to preserve); every failure is logged and skipped.
    ``uninstall()`` restores all hooks — tests rely on it.
    """

    def __init__(self, crash_dir: str, sources=(),
                 logger: Optional[logging.Logger] = None):
        self.crash_dir = str(crash_dir)
        # dump() runs on signal/excepthook paths while the main thread may
        # still be attaching sources; the lock is held only for list ops,
        # never across a source dump, so the crash path can't deadlock
        self._sources_lock = threading.Lock()
        self._sources: List[Tuple[str, Any]] = []  # guarded-by: _sources_lock
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)
        self._installed = False
        self._prev_excepthook = None
        self._prev_signals: Dict[int, Any] = {}
        self._fh_file = None
        self._dumped = False
        # pinned bound methods: attribute access creates a FRESH bound
        # method each time, so identity checks against self._excepthook
        # would never match what was installed
        self._hook = self._excepthook
        self._sig_hook = self._signal_handler
        for src in sources:
            self.add_source(src)

    def add_source(self, obj, name: Optional[str] = None) -> "FlightRecorder":
        """Attach a dump source: a ``Tracer``/``TrainMonitor`` (anything
        with ``dump_jsonl``), a ``RunLedger`` or ``telemetry_memory
        .MemoryLedger`` (``to_dict``), or anything with
        ``gateway_snapshot``.  Sources exposing ``forensics()`` (the
        memory ledger) additionally get an OOM-forensics section —
        ``<name>-forensics.json`` with top pools, recent growth, and the
        largest live tensors with tree paths."""
        if not (hasattr(obj, "dump_jsonl") or hasattr(obj, "to_dict")
                or hasattr(obj, "gateway_snapshot")):
            raise TypeError(f"unsupported flight-recorder source: {obj!r}")
        with self._sources_lock:
            self._sources.append((name or f"{type(obj).__name__.lower()}"
                                  f"{len(self._sources)}", obj))
        return self

    # ------------------------------------------------------------- hooks --
    def install(self, signals=(_signal.SIGTERM,),
                enable_faulthandler: bool = True) -> "FlightRecorder":
        if self._installed:
            return self
        os.makedirs(self.crash_dir, exist_ok=True)
        if enable_faulthandler:
            try:
                self._fh_file = open(
                    os.path.join(self.crash_dir, "faulthandler.log"), "a")
                faulthandler.enable(file=self._fh_file)
            except (OSError, RuntimeError) as e:
                self._log.warning("flight recorder: faulthandler not "
                                  "enabled: %s", e)
        self._prev_excepthook = sys.excepthook
        sys.excepthook = self._hook
        for sig in signals:
            try:
                self._prev_signals[sig] = _signal.signal(
                    sig, self._sig_hook)
            except (ValueError, OSError) as e:
                # not the main thread, or an unblockable signal — the other
                # triggers still cover the exit
                self._log.warning("flight recorder: cannot hook signal "
                                  "%s: %s", sig, e)
        self._installed = True
        return self

    def uninstall(self):
        if not self._installed:
            return
        if sys.excepthook is self._hook:
            sys.excepthook = self._prev_excepthook
        for sig, prev in self._prev_signals.items():
            try:
                if _signal.getsignal(sig) is self._sig_hook:
                    _signal.signal(sig, prev)
            except (ValueError, OSError):
                pass
        self._prev_signals.clear()
        if self._fh_file is not None:
            try:
                faulthandler.disable()
                self._fh_file.close()
            except (OSError, RuntimeError):
                pass
            self._fh_file = None
        self._installed = False

    def _excepthook(self, exc_type, exc, tb):
        self.dump(f"unhandled {exc_type.__name__}: {exc}", _auto=True)
        prev = self._prev_excepthook or sys.__excepthook__
        prev(exc_type, exc, tb)

    def _signal_handler(self, signum, frame):
        self.dump(f"signal {_signal.Signals(signum).name}", _auto=True)
        prev = self._prev_signals.get(signum)
        if callable(prev):
            prev(signum, frame)
        elif prev != _signal.SIG_IGN:
            # restore the default disposition and re-raise so the process
            # exits with the conventional signal status
            _signal.signal(signum, _signal.SIG_DFL)
            os.kill(os.getpid(), signum)

    # -------------------------------------------------------------- dump --
    def dump(self, reason: str = "manual", _auto: bool = False
             ) -> Optional[str]:
        """Write one crash dump; returns its directory (or None when the
        dump itself failed).  Only the FIRST automatic trigger dumps (an
        excepthook and a signal firing for the same death must not
        overwrite each other); manual calls always dump, each into its
        own directory."""
        if _auto and self._dumped:
            return None
        try:
            stamp = time.strftime("%Y%m%d-%H%M%S", time.gmtime())
            base = os.path.join(self.crash_dir,
                                f"crash-{stamp}-{os.getpid()}")
            out = base
            n = 1
            while os.path.exists(out):    # same-second dumps get own dirs
                out = f"{base}-{n}"
                n += 1
            os.makedirs(out, exist_ok=True)
            meta = {"reason": reason, "pid": os.getpid(),
                    "time_unix": time.time(),
                    "argv": list(sys.argv)}
            with open(os.path.join(out, "meta.json"), "w") as f:
                json.dump(meta, f, indent=2)
            with open(os.path.join(out, "threads.txt"), "w") as f:
                faulthandler.dump_traceback(file=f, all_threads=True)
            with self._sources_lock:      # snapshot; dump outside the lock
                sources = list(self._sources)
            for name, src in sources:
                try:
                    if hasattr(src, "dump_jsonl"):
                        src.dump_jsonl(os.path.join(out, f"{name}.jsonl"))
                    elif hasattr(src, "gateway_snapshot"):
                        with open(os.path.join(out, f"{name}.json"),
                                  "w") as f:
                            json.dump(src.gateway_snapshot(), f)
                    elif hasattr(src, "to_dict"):
                        with open(os.path.join(out, f"{name}.json"),
                                  "w") as f:
                            json.dump(src.to_dict(), f)
                    if hasattr(src, "forensics"):
                        # the OOM post-mortem section: small, human-first
                        # (top pools / recent growth / largest arrays),
                        # separate from the full series payload above
                        with open(os.path.join(
                                out, f"{name}-forensics.json"), "w") as f:
                            json.dump(src.forensics(), f, indent=2)
                except Exception as e:
                    self._log.warning("flight recorder: source %s failed "
                                      "to dump: %s", name, e)
            self._dumped = True
            self._log.warning("flight recorder: dumped %d source(s) to %s "
                              "(%s)", len(sources), out, reason)
            return out
        except Exception as e:
            self._log.warning("flight recorder: dump failed: %s", e)
            return None

    # a module-level convenience: install-and-forget with atexit cleanup of
    # the faulthandler file handle (NOT an exit dump — normal exits are not
    # crashes; the excepthook/signal triggers decide abnormality)
    @classmethod
    def install_default(cls, crash_dir: str, sources=()) -> "FlightRecorder":
        fr = cls(crash_dir, sources=sources).install()
        atexit.register(fr.uninstall)
        return fr

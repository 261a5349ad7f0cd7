"""Runtime stats registry (the port's copy of ``paddle_tpu/utils/stats.py``):
named monotonic counters and gauges that any subsystem bumps cheaply,
fixed-bucket histograms, and one Prometheus text exposition for all of
them.  The serving engines and each ``TieredKVStore`` keep a private
``StatRegistry`` (concurrent owners never alias each other's counts); the
process keeps the global one behind ``stat_add``; ``telemetry`` exports
either.  ``device_memory_stats`` delegates to the memory ledger's
``device_allocator_stats`` (the one accounting point for the CUDA caching
allocator's numbers) and ``op_summary`` joins the profiler's
``RecordEvent`` table.
"""

from __future__ import annotations

import bisect
import re
import threading
from typing import Dict, List, Optional, Sequence, Tuple

__all__ = ["StatRegistry", "Histogram", "stat_registry", "stat_add",
           "stat_sub", "get_stat", "get_all_stats", "device_memory_stats",
           "op_summary", "prometheus_text", "prom_sample",
           "DEFAULT_TIME_BUCKETS"]

# Prometheus-style latency buckets (seconds): sub-ms ticks through
# multi-second compiles land in distinct buckets.
DEFAULT_TIME_BUCKETS: Tuple[float, ...] = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5,
    1.0, 2.5, 5.0, 10.0, 30.0)


class _Stat:
    __slots__ = ("name", "value", "lock", "kind")

    def __init__(self, name: str, kind: str = "counter"):
        self.name = name
        self.value = 0
        self.lock = threading.Lock()
        self.kind = kind                 # "counter" (monotonic) or "gauge"

    def increase(self, v):
        with self.lock:
            self.value += v

    def decrease(self, v):
        with self.lock:
            self.value -= v
            self.kind = "gauge"          # a decremented stat is not monotonic

    def set(self, v):
        with self.lock:
            self.value = v
            self.kind = "gauge"

    def set_max(self, v):
        with self.lock:
            if v > self.value:
                self.value = v
            self.kind = "gauge"

    def reset(self):
        with self.lock:
            self.value = 0


class Histogram:
    """Fixed-bound cumulative-bucket histogram (the Prometheus model):
    ``observe`` is O(log buckets) under a lock; ``percentile`` is a
    bucket-resolution estimate (exact sample percentiles live in the
    telemetry tracer, which keeps the raw events)."""

    __slots__ = ("name", "bounds", "counts", "total", "count", "lock")

    def __init__(self, name: str, bounds: Sequence[float] = None):
        self.name = name
        self.bounds = tuple(sorted(bounds if bounds is not None
                                   else DEFAULT_TIME_BUCKETS))
        self.counts = [0] * (len(self.bounds) + 1)   # last = +Inf overflow
        self.total = 0.0
        self.count = 0
        self.lock = threading.Lock()

    def observe(self, v: float):
        i = bisect.bisect_left(self.bounds, v)
        with self.lock:
            self.counts[i] += 1
            self.total += v
            self.count += 1

    def snapshot(self) -> Dict[str, object]:
        with self.lock:
            return {"bounds": self.bounds, "counts": tuple(self.counts),
                    "sum": self.total, "count": self.count}

    def percentile(self, q: float) -> Optional[float]:
        """Upper bound of the bucket holding the q-quantile (0 <= q <= 1);
        None when empty.  Overflow observations report the largest bound."""
        with self.lock:
            if self.count == 0:
                return None
            target = q * self.count
            acc = 0
            for i, c in enumerate(self.counts):
                acc += c
                if acc >= target and c:
                    return (self.bounds[i] if i < len(self.bounds)
                            else self.bounds[-1])
            return self.bounds[-1]

    def reset(self):
        with self.lock:
            self.counts = [0] * (len(self.bounds) + 1)
            self.total = 0.0
            self.count = 0


class StatRegistry:
    """Named counters/gauges + histograms (reference monitor.h:77).  The
    process-wide instance backs ``stat_add``; serving engines hold private
    instances so concurrent engines don't alias each other's counters."""

    def __init__(self):
        self._stats: Dict[str, _Stat] = {}
        self._hists: Dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> _Stat:
        with self._lock:
            if name not in self._stats:
                self._stats[name] = _Stat(name)
            return self._stats[name]

    def add(self, name: str, value=1):
        self.get(name).increase(value)

    def sub(self, name: str, value=1):
        self.get(name).decrease(value)

    def set(self, name: str, value):
        """Gauge write: the stat's current value becomes ``value`` and its
        exported type becomes gauge (non-monotonic)."""
        self.get(name).set(value)

    def set_max(self, name: str, value):
        """High-water gauge: keeps the max ever written (HBM peaks)."""
        self.get(name).set_max(value)

    def value(self, name: str):
        return self.get(name).value

    def histogram(self, name: str, bounds: Sequence[float] = None
                  ) -> Histogram:
        with self._lock:
            if name not in self._hists:
                self._hists[name] = Histogram(name, bounds)
            return self._hists[name]

    def observe(self, name: str, value: float,
                bounds: Sequence[float] = None):
        self.histogram(name, bounds).observe(value)

    def snapshot(self) -> Dict[str, float]:
        with self._lock:
            return {n: s.value for n, s in sorted(self._stats.items())}

    def histograms(self) -> Dict[str, Dict[str, object]]:
        with self._lock:
            hists = list(self._hists.items())
        return {n: h.snapshot() for n, h in sorted(hists)}

    def kinds(self) -> Dict[str, str]:
        with self._lock:
            return {n: s.kind for n, s in sorted(self._stats.items())}

    def reset(self, name: Optional[str] = None):
        if name is not None:
            self.get(name).reset()  # auto-create like get()/value()
            return
        with self._lock:
            targets = list(self._stats.values())
            hists = list(self._hists.values())
        for s in targets:
            s.reset()
        for h in hists:
            h.reset()


_registry = StatRegistry()


def stat_registry() -> StatRegistry:
    return _registry


def stat_add(name: str, value=1):
    """STAT_ADD macro analog."""
    _registry.add(name, value)


def stat_sub(name: str, value=1):
    _registry.sub(name, value)


def get_stat(name: str):
    return _registry.value(name)


def get_all_stats() -> Dict[str, float]:
    return _registry.snapshot()


_METRIC_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(namespace: str, name: str) -> str:
    n = _METRIC_NAME_RE.sub("_", name)
    return f"{namespace}_{n}" if namespace else n


def _fmt(v) -> str:
    f = float(v)
    return str(int(f)) if f == int(f) else repr(f)


def prom_sample(name: str, value) -> str:
    """One exposition sample line ``name value``: the shared line
    renderer behind every ``prometheus_text`` emitter."""
    return f"{name} {_fmt(value)}"


def prometheus_text(registry: Optional[StatRegistry] = None,
                    namespace: str = "paddle_tpu",
                    extra_gauges: Optional[Dict[str, float]] = None,
                    extra_counters: Optional[Dict[str, float]] = None
                    ) -> str:
    """Prometheus text exposition (format 0.0.4) of one registry: counters
    and gauges from their recorded kind, histograms as cumulative
    ``_bucket``/``_sum``/``_count`` series.  ``extra_gauges`` /
    ``extra_counters`` let a caller append derived values (e.g.
    ``engine.metrics()`` means and compile counts) without registering
    them, typed to match their documented kind."""
    reg = registry if registry is not None else _registry
    lines: List[str] = []
    kinds = reg.kinds()
    for name, value in reg.snapshot().items():
        pn = _prom_name(namespace, name)
        lines.append(f"# TYPE {pn} {kinds.get(name, 'counter')}")
        lines.append(prom_sample(pn, value))
    for name, h in reg.histograms().items():
        pn = _prom_name(namespace, name)
        lines.append(f"# TYPE {pn} histogram")
        acc = 0
        for bound, c in zip(h["bounds"], h["counts"]):
            acc += c
            # a bucket's only label is its float bound: nothing to escape
            lines.append(f'{pn}_bucket{{le="{bound}"}} {_fmt(acc)}')
        lines.append(f'{pn}_bucket{{le="+Inf"}} {_fmt(h["count"])}')
        lines.append(prom_sample(f"{pn}_sum", h["sum"]))
        lines.append(prom_sample(f"{pn}_count", h["count"]))
    for extras, kind in ((extra_gauges, "gauge"),
                         (extra_counters, "counter")):
        for name, value in (extras or {}).items():
            pn = _prom_name(namespace, name)
            lines.append(f"# TYPE {pn} {kind}")
            lines.append(prom_sample(pn, value))
    return "\n".join(lines) + "\n"


def device_memory_stats(device_index: int = 0) -> Dict[str, int]:
    """Per-device allocator stats of the CUDA caching allocator under the
    reference's key names; ``{}`` on the CPU.  Delegates to
    ``telemetry_memory.device_allocator_stats``, the one accounting point
    for raw allocator reads (lazy import: stats stays a leaf module)."""
    from ..telemetry_memory import device_allocator_stats
    return device_allocator_stats(device_index)


def op_summary(top: int = 20) -> List[Tuple[str, int, float]]:
    """(name, calls, total seconds) rows from the profiler's RecordEvent
    aggregation, sorted by total time — the op-summary table view of the
    reference's profiler output."""
    from .. import profiler
    rows = [(n, int(c), float(t))
            for n, (c, t) in profiler.snapshot_events().items()]
    rows.sort(key=lambda r: -r[2])
    return rows[:top]

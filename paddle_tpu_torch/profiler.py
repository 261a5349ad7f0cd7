"""Host-side profiler (the port's copy of ``paddle_tpu/profiler.py``):
``RecordEvent`` regions aggregated into a (calls, total seconds) table,
``start_profiler``/``stop_profiler`` around a region of interest with the
table reported at the stop, and the new-style ``Profiler`` with
``step(num_samples)``, which also routes each step span into the active
``telemetry.TrainMonitor``.

Host timing only: the reference also writes an XPlane device trace from
``start_profiler``; the port's device traces come from ``torch.profiler``
in the harness that wants one (``chip_smoke.py``), never from here
(``ROADMAP.md`` §C).
"""

from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from collections import defaultdict
from typing import Callable, Dict, Optional, Tuple

__all__ = ["Profiler", "RecordEvent", "start_profiler", "stop_profiler",
           "reset_profiler", "profiler", "summary", "snapshot_events"]

_events = defaultdict(lambda: [0, 0.0])  # name -> [count, total_s]
# RecordEvent exits on callback/loader threads mutate _events concurrently
# with summary() readers
_events_lock = threading.Lock()
_active_dir: Optional[str] = None
_log = logging.getLogger(__name__)


class RecordEvent:
    """Time a host-side region into the summary table (the reference's
    ``platform::RecordEvent`` RAII)."""

    def __init__(self, name: str):
        self.name = name
        self._t0 = 0.0

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        with _events_lock:
            rec = _events[self.name]
            rec[0] += 1
            rec[1] += dt
        return False

    # fluid/profiler API aliases
    begin = __enter__

    def end(self):
        self.__exit__(None, None, None)


def start_profiler(log_dir: str = "./profiler_log", state: str = "All",
                   tracer_option: str = "Default"):
    """Open a profiling region (``state``/``tracer_option`` accepted for
    API parity); ``log_dir`` is created and named in the stop report."""
    global _active_dir
    if _active_dir is not None:
        return
    os.makedirs(log_dir, exist_ok=True)
    _active_dir = log_dir


def stop_profiler(sorted_key: str = "total",
                  profile_path: Optional[str] = None,
                  on_summary: Optional[Callable[[str], None]] = None):
    """Close the region and report the aggregated event table through
    ``on_summary(text)`` when given, else the module logger (library code
    does not print)."""
    global _active_dir
    if _active_dir is None:
        return
    text = (summary(sorted_key) + f"\n[profiler] trace written to "
            f"{_active_dir} (host event table only)")
    if on_summary is not None:
        on_summary(text)
    else:
        _log.info("%s", text)
    _active_dir = None


def reset_profiler():
    """Clear the aggregated host-event table."""
    with _events_lock:
        _events.clear()


def snapshot_events() -> Dict[str, Tuple[int, float]]:
    """Consistent copy of the aggregated {name: (calls, total_s)} table —
    the accessor ``utils.stats.op_summary`` joins on."""
    with _events_lock:
        return {n: (int(c), float(t)) for n, (c, t) in _events.items()}


@contextlib.contextmanager
def profiler(state: str = "All", sorted_key: str = "total",
             profile_path: str = "./profiler_log"):
    """``start_profiler`` … ``stop_profiler`` as a context manager."""
    start_profiler(profile_path, state)
    try:
        yield
    finally:
        stop_profiler(sorted_key)


def summary(sorted_key: str = "total") -> str:
    """Aggregated host-event table, sorted by ``total``, ``calls`` or
    ``ave``."""
    rows = [(name, c, tot, tot / max(c, 1))
            for name, (c, tot) in snapshot_events().items()]
    key = {"total": 2, "calls": 1, "ave": 3}.get(sorted_key, 2)
    rows.sort(key=lambda r: r[key], reverse=True)
    lines = [f"{'Event':<40}{'Calls':>8}{'Total(s)':>12}{'Avg(s)':>12}"]
    lines += [f"{n:<40}{c:>8}{t:>12.4f}{a:>12.6f}" for n, c, t, a in rows]
    return "\n".join(lines)


class Profiler:
    """New-style API: ``Profiler(on_trace_ready=...)`` with
    start/stop/step."""

    def __init__(self, targets=None, scheduler=None, on_trace_ready=None,
                 log_dir: str = "./profiler_log", timer_only: bool = False):
        self.log_dir = log_dir
        self.timer_only = timer_only
        self.on_trace_ready = on_trace_ready
        self._step_times = []
        self._step_samples = []
        self._last = None

    def start(self):
        if not self.timer_only:
            start_profiler(self.log_dir)
        self._last = time.perf_counter()
        return self

    def step(self, num_samples: Optional[int] = None):
        """Mark a step boundary.  ``num_samples`` is recorded —
        ``step_info()`` reports items/sec over the timed spans.  With an
        active ``telemetry.TrainMonitor`` (``set_active_monitor``) the
        span is also routed there (``record_profiler_step``)."""
        now = time.perf_counter()
        if self._last is not None:
            dt = now - self._last
            self._step_times.append(dt)
            self._step_samples.append(0 if num_samples is None
                                      else int(num_samples))
            from .telemetry import current_monitor
            mon = current_monitor()
            if mon is not None:
                mon.record_profiler_step(dt, samples=int(num_samples or 0))
        self._last = now

    def stop(self):
        if not self.timer_only:
            stop_profiler()
        if self.on_trace_ready is not None:
            self.on_trace_ready(self)

    def step_info(self) -> str:
        if not self._step_times:
            return "no steps recorded"
        import numpy as np
        ts = np.asarray(self._step_times)
        info = (f"steps={len(ts)} avg={ts.mean()*1e3:.2f}ms "
                f"p50={np.percentile(ts,50)*1e3:.2f}ms "
                f"p99={np.percentile(ts,99)*1e3:.2f}ms")
        samples = sum(self._step_samples)
        if samples:
            info += f" ips={samples / ts.sum():.2f}"
        return info

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False

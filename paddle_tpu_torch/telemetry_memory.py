"""Memory ledger: exhaustive byte attribution for device and host pools
(the port's counterpart of ``paddle_tpu/telemetry_memory.py``).

:class:`MemoryLedger` partitions bytes the way the goodput ledger
(``telemetry_ledger.RunLedger``) partitions seconds:

==========================  ==============================================
pool                        bytes held by …
==========================  ==============================================
``params``                  model parameter trees (incl. buffers)
``optimizer_state``         optimizer slot trees (incl. AMP scaler state)
``grads_comm_buffers``      gradient / collective staging state
``kv_pages``                paged-attention KV: per tier — ``hbm``
                            (device-resident pools), ``dram`` / ``disk``
                            (the TieredKVStore's host tiers)
``executables``             serialized compiled programs (host-side)
``activations_workspace``   live intermediates registered explicitly
``other``                   the residual — live tensors nothing registered
==========================  ==============================================

Two spaces, two source kinds:

- **device**: refreshed by :meth:`MemoryLedger.census` — ONE walk of the
  process's live tensors on the ledger's device (``gc.get_objects()``; off
  the hot path, and never inside a step, where a graph capture may be in
  flight), each tensor STORAGE counted once (views of one storage dedupe
  by ``untyped_storage().data_ptr()``) and classified against the
  registered trees (trainers register state through
  ``register_train_state``; engines through ``attach_memory``).  The
  residual lands in ``other``: ``sum(pool device bytes) == census total``
  by construction.  On a card the census also reports
  ``torch.cuda.memory_allocated()``: CUDA-graph pools, tensors held only
  inside C++ (autograd, graph outputs not referenced from Python) and
  allocator rounding sit there, outside the tensor walk.
- **host**: event-driven ``account()`` deltas at the allocation sites
  (``kv_store`` tier transitions), mirrored per KV tier.

Peaks are ``set_max``-style watermarks (global per space and per pool);
every new watermark appends to a bounded ring and, with a tracer
attached, emits a ``memory`` event.  :meth:`forensics` is the OOM
post-mortem payload (top pools, recent growth, largest tensors with tree
paths, allocator stats); ``FlightRecorder`` writes it beside its dump.

This module is the single accounting point for raw memory introspection
(the tensor walk and ``torch.cuda.memory_stats``).  Everything is
zero-cost when no ledger is active: one ``is None`` check per seam
(:func:`current_memory_ledger` / :func:`account_bytes`).  The module
imports no torch at module level (``kv_store`` imports it).
"""

from __future__ import annotations

import collections
import gc
import json
import logging
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

__all__ = ["MemoryLedger", "POOLS", "SPACES", "KV_TIERS",
           "set_active_memory_ledger", "current_memory_ledger",
           "account_bytes", "live_tensor_census", "device_allocator_stats",
           "chrome_counters_from_memory_dump"]

#: The exhaustive pool taxonomy, in display order.  ``other`` is the
#: census residual — live tensors nothing registered — never written to
#: directly.
POOLS: Tuple[str, ...] = (
    "params", "optimizer_state", "grads_comm_buffers", "kv_pages",
    "executables", "activations_workspace", "other")

SPACES: Tuple[str, ...] = ("device", "host")

#: KV page tiers (kv_store.py's ladder): ``hbm`` is device space, the
#: host tiers mirror the TieredKVStore's DRAM/disk byte counters.
KV_TIERS: Tuple[str, ...] = ("hbm", "dram", "disk")

#: state-dict key → pool, for ``register_train_state`` (the train step
#: builders' ``state0`` layout: distributed/spmd.py)
_STATE_KEY_POOL = {"params": "params", "buffers": "params",
                   "opt": "optimizer_state", "scaler": "optimizer_state",
                   "comm_e": "grads_comm_buffers"}

#: how many largest-storage rows a census retains for forensics
_TOP_ARRAYS = 8

#: ``torch.cuda.memory_stats`` key → the reference's allocator key
#: (``ROADMAP.md`` §C): only keys with a counterpart are reported
_ALLOCATOR_KEYS = {"allocated_bytes.all.current": "bytes_in_use",
                   "allocated_bytes.all.peak": "peak_bytes_in_use",
                   "reserved_bytes.all.current": "bytes_reserved",
                   "reserved_bytes.all.peak": "peak_bytes_reserved",
                   "allocation.all.allocated": "num_allocs"}


def _leaves_with_path(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(path, tensor) for every tensor leaf of nested dicts, lists and
    tuples, paths spelled as the reference's ``keystr`` (``['opt'][0]``)."""
    import torch
    if isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves_with_path(v, f"{path}[{k!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, f"{path}[{i}]")


def _storage(t) -> Optional[Tuple[Tuple[str, int], int]]:
    """``((device, storage data_ptr), storage bytes)`` of a tensor; None
    for a tensor without a plain storage (meta, sparse) or an empty
    one."""
    try:
        st = t.untyped_storage()
        ptr, n = st.data_ptr(), st.nbytes()
    except (RuntimeError, NotImplementedError):
        return None
    if not ptr or not n:
        return None
    return (str(t.device), ptr), int(n)


def _tensor_bytes(t) -> int:
    return int(t.numel()) * int(t.element_size())


def _default_device(trees) -> str:
    """The device a census walks: the first tensor's of ``trees``, else
    the current card's, else the CPU."""
    import torch
    for tree in trees:
        for _p, t in _leaves_with_path(tree):
            return str(t.device)
    if torch.cuda.is_available():
        return f"cuda:{torch.cuda.current_device()}"
    return "cpu"


def _live_storages(device: str) -> Dict[Tuple[str, int], Dict[str, Any]]:
    """ONE walk over the process's live tensors on ``device``: every
    distinct storage with its bytes and its largest tensor (the view a
    forensics row names)."""
    import torch
    out: Dict[Tuple[str, int], Dict[str, Any]] = {}
    for obj in gc.get_objects():
        # type(), not isinstance(): a proxy's __class__ may warn or raise
        if not issubclass(type(obj), torch.Tensor):
            continue
        try:
            if str(obj.device) != device:
                continue
        except RuntimeError:
            continue
        got = _storage(obj)
        if got is None:
            continue
        key, n = got
        row = out.get(key)
        if row is None:
            out[key] = {"bytes": n, "tensor": obj}
        elif _tensor_bytes(obj) > _tensor_bytes(row["tensor"]):
            row["tensor"] = obj
    return out


def live_tensor_census(groups: Dict[str, Any]) -> Dict[str, int]:
    """One walk over the live tensor storages on the groups' device (the
    first tensor's; with none, the current card's or the CPU),
    classifying each by storage into the named groups (``{name:
    tree}``); unmatched storages land in ``other``.
    Returns ``{<name>_bytes: ..., other_bytes: ..., total_bytes: ...,
    arrays: ...}`` (``arrays`` counts storages) — the shared classifier
    behind ``TrainMonitor.hbm_census`` and :meth:`MemoryLedger.census`."""
    dev = _default_device(groups.values())
    owner: Dict[Tuple[str, int], str] = {}
    for name, tree in groups.items():
        for _p, t in _leaves_with_path(tree):
            got = _storage(t)
            if got is not None:
                owner.setdefault(got[0], name)
    counts = {f"{name}_bytes": 0 for name in groups}
    counts["other_bytes"] = 0
    live = _live_storages(dev)
    for key, row in live.items():
        name = owner.get(key)
        counts[f"{name}_bytes" if name is not None else "other_bytes"] += \
            row["bytes"]
    counts["total_bytes"] = sum(counts.values())
    counts["arrays"] = len(live)
    return counts


def device_allocator_stats(device_index: int = 0) -> Dict[str, int]:
    """Per-device stats of the CUDA caching allocator under the
    reference's key names (``bytes_in_use``, ``peak_bytes_in_use``,
    ``bytes_reserved``, ``peak_bytes_reserved``, ``num_allocs``, and
    ``bytes_limit`` from the card's total memory).  THE authority for the
    raw ``torch.cuda.memory_stats`` call — ``utils.stats
    .device_memory_stats`` delegates here.  Empty dict without a card
    (the CPU), as the reference's is there."""
    import torch
    if not torch.cuda.is_available() \
            or device_index >= torch.cuda.device_count():
        return {}
    raw = torch.cuda.memory_stats(device_index)
    out = {ref: int(raw[k]) for k, ref in _ALLOCATOR_KEYS.items()
           if k in raw}
    out["bytes_limit"] = int(
        torch.cuda.get_device_properties(device_index).total_memory)
    return out


class MemoryLedger:
    """Exhaustive byte attribution across :data:`POOLS` (module
    docstring).  ``capacity`` bounds the retained ``(ts, space, pool,
    bytes)`` sample series (the chrome counter track / flight-recorder
    payload); ``ring`` bounds the watermark-crossing event ring.  All
    mutation is under one lock; ``account`` is a dict add — cheap enough
    for per-page kv seams, and seams only reach it when a ledger is
    active.  The census walks the live tensors of the first registered
    tensor's device (with nothing registered, the current card's or the
    CPU)."""

    def __init__(self, capacity: int = 4096, ring: int = 256,
                 tracer=None, logger: Optional[logging.Logger] = None):
        if capacity < 1 or ring < 1:
            raise ValueError("capacity and ring must be >= 1")
        self._lock = threading.Lock()
        self._t0 = time.monotonic()
        self._bytes: Dict[Tuple[str, str], int] = {
            (s, p): 0 for s in SPACES for p in POOLS}
        self._peak: Dict[Tuple[str, str], int] = dict(self._bytes)
        self._peak_total: Dict[str, int] = {s: 0 for s in SPACES}
        self._kv_tiers: Dict[str, int] = {t: 0 for t in KV_TIERS}
        self._kv_tier_peak: Dict[str, int] = {t: 0 for t in KV_TIERS}
        self._trees: Dict[str, Dict[str, Any]] = {}   # name -> registration
        self._series: collections.deque = collections.deque(maxlen=capacity)
        self._ring: collections.deque = collections.deque(maxlen=ring)
        self._n_watermarks = 0
        self._n_census = 0
        self._largest: List[Dict[str, Any]] = []
        self._per_device: Dict[str, int] = {}
        self._census_meta: Optional[Dict[str, Any]] = None
        self._device: Optional[str] = None   # the first registration's
        self._tracer = tracer
        self._prev_active: Optional["MemoryLedger"] = None
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)

    # ------------------------------------------------------------- clock --
    def now(self) -> float:
        return time.monotonic() - self._t0

    def set_tracer(self, tracer):
        """Attach a ``telemetry.Tracer``: watermark crossings emit
        ``memory`` events into its ring, so OOM approach survives in the
        flight recorder next to tick/compile spans."""
        self._tracer = tracer
        return self

    # ------------------------------------------------------ registration --
    def register_tree(self, pool: str, tree, name: Optional[str] = None,
                      ) -> str:
        """Register a tree's tensors (nested dicts, lists, tuples) under
        ``pool`` for census classification (device space), by storage:
        views of one storage register it once.  Re-registering a ``name``
        replaces the previous registration (the ``instrument_train_step``
        seam re-registers the state every step).  Returns the
        registration name."""
        if pool not in POOLS or pool == "other":
            raise ValueError(f"unknown pool {pool!r}; one of "
                             f"{[p for p in POOLS if p != 'other']}")
        ids: Dict[Tuple[str, int], Tuple[str, int]] = {}
        first = None
        for path, leaf in _leaves_with_path(tree):
            first = first or str(leaf.device)
            got = _storage(leaf)
            if got is not None:
                ids.setdefault(got[0], (path, got[1]))
        name = name or f"{pool}{len(self._trees)}"
        with self._lock:
            self._trees[name] = {"pool": pool, "ids": ids}
            if self._device is None and first is not None:
                self._device = first
        return name

    def unregister_tree(self, name: str) -> bool:
        with self._lock:
            return self._trees.pop(name, None) is not None

    def register_train_state(self, state: Dict[str, Any],
                             name: str = "train_state") -> str:
        """Register a trainer ``state`` dict by its conventional top-level
        keys (params/buffers → params, opt/scaler → optimizer_state,
        comm_e → grads_comm_buffers; unknown keys ride along as params'
        siblings are not invented — they stay unregistered and show up in
        ``other``, which is the honest place for state this table does
        not understand)."""
        buckets: Dict[str, list] = {}
        for key, sub in state.items():
            pool = _STATE_KEY_POOL.get(key)
            if pool is not None:
                buckets.setdefault(pool, []).append((key, sub))
        for pool, subs in buckets.items():
            self.register_tree(pool, dict(subs), name=f"{name}.{pool}")
        # drop pools this state no longer carries (a re-registered state
        # without comm_e must not leave stale ids classifying)
        with self._lock:
            stale = [n for n in self._trees
                     if n.startswith(f"{name}.") and
                     n.split(".", 1)[1] not in buckets]
            for n in stale:
                del self._trees[n]
        return name

    # ------------------------------------------------------------ ingest --
    def account(self, pool: str, delta: int, space: str = "host",
                tier: Optional[str] = None):
        """Attribute a byte delta to ``pool`` in ``space`` (the
        event-driven path: kv tier transitions, executable-cache blob
        writes).  ``tier`` additionally mirrors the delta onto a KV tier
        counter.  Negative deltas release; totals clamp at zero (a
        release crossing zero indicates a missed account and is logged
        once per ledger rather than going negative silently)."""
        if pool not in POOLS:
            raise ValueError(f"unknown pool {pool!r}; one of {POOLS}")
        if space not in SPACES:
            raise ValueError(f"unknown space {space!r}; one of {SPACES}")
        if tier is not None and tier not in KV_TIERS:
            raise ValueError(f"unknown kv tier {tier!r}; one of {KV_TIERS}")
        events = []
        with self._lock:
            key = (space, pool)
            new = self._bytes[key] + int(delta)
            if new < 0:
                self._log.warning(
                    "memory ledger: %s/%s released below zero (delta %d); "
                    "clamping — an allocation site is not accounting",
                    space, pool, delta)
                new = 0
            self._bytes[key] = new
            if tier is not None:
                t = max(0, self._kv_tiers[tier] + int(delta))
                self._kv_tiers[tier] = t
                if t > self._kv_tier_peak[tier]:
                    self._kv_tier_peak[tier] = t
            events = self._note_locked(space, pool, new)
        self._emit_events(events)

    def set_bytes(self, pool: str, value: int, space: str = "host",
                  tier: Optional[str] = None):
        """Absolute-value twin of :meth:`account` for sources that track
        their own totals (the kv store's tier counters on snapshot
        resync)."""
        with self._lock:
            cur = self._bytes[(space, pool)] if tier is None \
                else self._kv_tiers[tier]
        self.account(pool, int(value) - cur, space=space, tier=tier)

    def _note_locked(self, space: str, pool: str, total: int):
        """Record one sample and any watermark crossings (caller holds
        the lock).  Returns tracer events to emit outside the lock."""
        ts = time.monotonic() - self._t0
        self._series.append((ts, space, pool, total))
        events = []
        if total > self._peak[(space, pool)]:
            prev = self._peak[(space, pool)]
            self._peak[(space, pool)] = total
            self._n_watermarks += 1
            ev = {"ts": round(ts, 6), "space": space, "pool": pool,
                  "bytes": total, "prev_bytes": prev}
            self._ring.append(ev)
            events.append(ev)
        space_total = sum(v for (s, _p), v in self._bytes.items()
                          if s == space)
        if space_total > self._peak_total[space]:
            self._peak_total[space] = space_total
        return events

    def _emit_events(self, events):
        tr = self._tracer
        if tr is None or not events:
            return
        for ev in events:
            tr.emit("memory", what="watermark", **ev)

    # ------------------------------------------------------------ census --
    def census(self) -> Dict[str, Any]:
        """Refresh the device-space pools from ONE walk of the live
        tensors on the ledger's device: every storage is classified
        against the registered trees; the residual is ``other``.  Pool
        bytes are storage bytes (what the device holds; views count
        once); ``logical`` keeps the largest tensor of each storage beside
        it.  Also refreshes per-device totals and the largest-storage
        forensics rows, and on a card reads ``torch.cuda
        .memory_allocated()`` (``allocated_bytes``; None on the CPU).
        Conservation: ``sum(pools.values()) == total_bytes`` by
        construction.  Never called inside a step."""
        import torch

        with self._lock:
            id_pool: Dict[Tuple[str, int], Tuple[str, str]] = {}
            for reg in self._trees.values():
                pool = reg["pool"]
                for k, (path, _b) in reg["ids"].items():
                    id_pool[k] = (pool, path)
            dev = self._device or _default_device(())
        pools = {p: 0 for p in POOLS}
        logical = {p: 0 for p in POOLS}
        rows: List[Dict[str, Any]] = []
        live = _live_storages(dev)
        for key, row in live.items():
            pool, path = id_pool.get(key, ("other", None))
            t = row["tensor"]
            pools[pool] += row["bytes"]
            logical[pool] += _tensor_bytes(t)
            rows.append({"pool": pool, "path": path, "bytes": row["bytes"],
                         "shape": list(t.shape),
                         "dtype": str(t.dtype).replace("torch.", "")})
        del live
        rows.sort(key=lambda r: -r["bytes"])
        total = sum(pools.values())
        per_device = {dev: total}
        allocated = (int(torch.cuda.memory_allocated(dev))
                     if torch.device(dev).type == "cuda" else None)
        n_arrays = len(rows)
        events = []
        with self._lock:
            for p in POOLS:
                self._bytes[("device", p)] = pools[p]
                events.extend(self._note_locked("device", p, pools[p]))
            hbm_kv = pools["kv_pages"]
            self._kv_tiers["hbm"] = hbm_kv
            if hbm_kv > self._kv_tier_peak["hbm"]:
                self._kv_tier_peak["hbm"] = hbm_kv
            self._largest = rows[:_TOP_ARRAYS]
            self._per_device = per_device
            self._n_census += 1
            self._census_meta = {"ts": round(time.monotonic() - self._t0, 6),
                                 "arrays": n_arrays, "total_bytes": total,
                                 "other_bytes": pools["other"],
                                 "allocated_bytes": allocated}
        self._emit_events(events)
        census = {"pools": pools, "logical": logical,
                  "per_device": per_device, "total_bytes": total,
                  "logical_total_bytes": sum(logical.values()),
                  "arrays": n_arrays, "largest": rows[:_TOP_ARRAYS],
                  "allocated_bytes": allocated}
        tr = self._tracer
        if tr is not None:
            tr.emit("memory", what="census", arrays=n_arrays,
                    total_bytes=total,
                    **{f"{p}_bytes": v for p, v in pools.items()})
        return census

    # ----------------------------------------------------------- queries --
    def memory_snapshot(self) -> Dict[str, Any]:
        """One JSON-able snapshot: per-pool live and peak bytes in both
        spaces, KV tier bytes, per-device totals from the last census, and
        the tail of the watermark ring — the schema the tests pin.
        Invariant:
        ``sum(pool device_bytes) == totals.device_bytes`` (``other`` is
        the census residual, so conservation holds by construction)."""
        with self._lock:
            by = dict(self._bytes)
            peak = dict(self._peak)
            pools = {p: {"device_bytes": by[("device", p)],
                         "host_bytes": by[("host", p)],
                         "device_peak_bytes": peak[("device", p)],
                         "host_peak_bytes": peak[("host", p)]}
                     for p in POOLS}
            totals = {
                "device_bytes": sum(by[("device", p)] for p in POOLS),
                "host_bytes": sum(by[("host", p)] for p in POOLS),
                "device_peak_bytes": self._peak_total["device"],
                "host_peak_bytes": self._peak_total["host"],
            }
            return {
                "pools": pools,
                "kv_tiers": {t: {"bytes": self._kv_tiers[t],
                                 "peak_bytes": self._kv_tier_peak[t]}
                             for t in KV_TIERS},
                "totals": totals,
                "per_device": dict(self._per_device),
                "census": dict(self._census_meta)
                if self._census_meta else None,
                "counts": {"watermarks": self._n_watermarks,
                           "census_runs": self._n_census,
                           "registered_trees": len(self._trees)},
                "watermarks": list(self._ring)[-16:],
            }

    def forensics(self, window: int = 64) -> Dict[str, Any]:
        """The OOM post-mortem payload the flight recorder writes as a
        dump section: pools ranked by live bytes, recent growth per pool
        over the last ``window`` retained samples, the largest live
        arrays (with tree paths) from the last census, the watermark
        ring, and the allocator's own stats where the backend exposes
        them.  Never raises — a crash handler that crashes destroys the
        evidence."""
        try:
            with self._lock:
                by = dict(self._bytes)
                series = list(self._series)[-window:]
                largest = list(self._largest)
                ring = list(self._ring)
            top = sorted(
                ({"space": s, "pool": p, "bytes": v}
                 for (s, p), v in by.items() if v > 0),
                key=lambda r: -r["bytes"])
            first_seen: Dict[Tuple[str, str], int] = {}
            last_seen: Dict[Tuple[str, str], int] = {}
            for ts, space, pool, total in series:
                key = (space, pool)
                first_seen.setdefault(key, total)
                last_seen[key] = total
            growth = [{"space": s, "pool": p,
                       "delta_bytes": last_seen[(s, p)] - first_seen[(s, p)]}
                      for (s, p) in last_seen
                      if last_seen[(s, p)] != first_seen[(s, p)]]
            growth.sort(key=lambda r: -r["delta_bytes"])
            try:
                alloc = device_allocator_stats()
            except Exception as e:  # pragma: no cover - backend-specific
                alloc = {"error": repr(e)}
            return {"top_pools": top, "recent_growth": growth,
                    "largest_arrays": largest, "watermarks": ring,
                    "allocator": alloc}
        except Exception as e:  # pragma: no cover - crash-path guard
            self._log.warning("memory ledger: forensics failed: %s", e)
            return {"error": repr(e)}

    # ----------------------------------------------------------- exports --
    def prometheus_text(self, namespace: str = "paddle_tpu_memory") -> str:
        """Text exposition of the snapshot: per-pool live/peak byte gauges
        in both spaces, per-tier KV bytes, space totals, and event
        counters."""
        from .utils.stats import StatRegistry, prometheus_text as _pt
        snap = self.memory_snapshot()
        gauges: Dict[str, float] = {}
        for p, row in snap["pools"].items():
            for field, v in row.items():
                gauges[f"{p}_{field}"] = v
        for t, row in snap["kv_tiers"].items():
            gauges[f"kv_{t}_bytes"] = row["bytes"]
            gauges[f"kv_{t}_peak_bytes"] = row["peak_bytes"]
        for field, v in snap["totals"].items():
            gauges[f"total_{field}"] = v
        if snap["census"]:
            gauges["live_arrays"] = snap["census"]["arrays"]
        counters = {"watermark_events_total": snap["counts"]["watermarks"],
                    "census_runs_total": snap["counts"]["census_runs"]}
        return _pt(StatRegistry(), namespace=namespace,
                   extra_gauges=gauges, extra_counters=counters)

    def to_dict(self) -> Dict[str, Any]:
        """Snapshot + retained sample series + forensics — the
        ``dump_json`` payload and the flight-recorder artifact."""
        with self._lock:
            series = [[ts, s, p, b] for ts, s, p, b in self._series]
        return {"kind": "memory", "snapshot": self.memory_snapshot(),
                "series": series, "forensics": self.forensics()}

    def dump_json(self, path: str):
        with open(path, "w") as f:
            json.dump(self.to_dict(), f)

    def to_chrome_counters(self, pid: str = "paddle_tpu.memory"
                           ) -> List[Dict[str, Any]]:
        """Chrome-trace counter ("C") events: per-pool live bytes after
        each retained sample, one stacked track per space — merges next
        to the tracer's span rows."""
        return chrome_counters_from_memory_dump(self.to_dict(), pid=pid)

    # ---------------------------------------------------------- lifecycle --
    def activate(self) -> "MemoryLedger":
        """Install as the process-wide active memory ledger (the seam the
        kv_store and train-step instrumentation reports through).  Also a
        context manager."""
        self._prev_active = set_active_memory_ledger(self)
        return self

    def deactivate(self):
        set_active_memory_ledger(self._prev_active)
        self._prev_active = None

    __enter__ = activate

    def __exit__(self, *exc):
        self.deactivate()
        return False


def chrome_counters_from_memory_dump(data: Dict[str, Any],
                                     pid: str = "paddle_tpu.memory"
                                     ) -> List[Dict[str, Any]]:
    """``MemoryLedger.to_dict()`` / ``dump_json`` payload → chrome counter
    events (offline twin of ``to_chrome_counters``).  One counter track
    per space
    so device HBM and host bytes stack separately on the timeline."""
    out: List[Dict[str, Any]] = [
        {"name": "process_name", "ph": "M", "pid": pid,
         "args": {"name": pid}}]
    cur: Dict[str, Dict[str, int]] = {s: {} for s in SPACES}
    for ts, space, pool, total in data.get("series", []):
        if space not in cur:
            continue
        cur[space][pool] = total
        out.append({"name": f"{space}_memory_bytes", "ph": "C", "pid": pid,
                    "ts": float(ts) * 1e6,
                    "args": dict(cur[space])})
    return out


# --------------------------------------------------------------------------
# process-wide active memory ledger
# --------------------------------------------------------------------------

_active_memory: Optional[MemoryLedger] = None


def set_active_memory_ledger(ledger: Optional[MemoryLedger]
                             ) -> Optional[MemoryLedger]:
    """Install the process-wide active memory ledger (or None) and return
    the previous one — the ``set_active_ledger`` convention.  Seams that
    cannot be threaded a handle (kv tier transitions, the per-step state
    re-registration) report through this."""
    global _active_memory
    prev = _active_memory
    _active_memory = ledger
    return prev


def current_memory_ledger() -> Optional[MemoryLedger]:
    return _active_memory


def account_bytes(pool: str, delta: int, space: str = "host",
                  tier: Optional[str] = None):
    """``account`` on the active ledger; a no-op when none is active (the
    one-check-zero-cost contract every seam shares)."""
    led = _active_memory
    if led is None:
        return
    led.account(pool, delta, space=space, tier=tier)

"""Tiered KV page store and migration planner (the port's copy of
``paddle_tpu/kv_store.py``; numpy and the standard library only, so it
imports neither torch nor anything of the JAX package).

- :class:`KVPage` — ONE pool block's k/v for every layer, addressed by its
  prefix-cache chain digest (the paged engines' rolling blake2b over the
  pad and the tokens), with the metadata that makes it portable: block
  size, bucket ladder, each leaf's dtype name and shape (int8 pools ship
  their fp32 scale planes as just another leaf).  Pages are byte-compatible
  with the reference's: ``to_bytes`` writes the same ``KVPG1`` container,
  and either package reads the other's.  Without ``ml_dtypes`` a 16-bit
  float leaf that numpy cannot name (``bfloat16``) is carried as its raw
  16-bit words (``uint16``) under its own dtype name.
- :class:`TieredKVStore` — host DRAM (an LRU, byte-capped) over disk (one
  file a page, byte-capped): ``put`` lands in DRAM and demotes the LRU tail
  to disk past the budget (or drops it with no disk tier); ``lookup``
  promotes a disk hit back into DRAM; a corrupt or mismatched page is a
  MISS, never a wrong page.  ``tier_of``/``index`` are pure reads.
- :class:`PageMigration` — the byte-budgeted, restartable page-transfer
  schedule between replicas.

Every tier transition resyncs the active ``telemetry_memory.MemoryLedger``'s
``kv_pages`` host pool and its dram/disk tiers; ``tracer`` is anything with
``.emit(kind, **fields)`` (a ``telemetry.Tracer``).  The device-side
gather and scatter of a page live with the engines in
``serving_paged.py``.
"""

from __future__ import annotations

import collections
import hashlib
import io
import json
import logging
import os
import threading
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from .telemetry_memory import current_memory_ledger
from .utils.stats import StatRegistry, prometheus_text as _prometheus_text

__all__ = ["KVPage", "TieredKVStore", "PageMigration", "chain_hex"]

#: tier labels, warmest first — the routing plane's vocabulary
TIERS = ("hbm", "dram", "disk")


def chain_hex(chain) -> str:
    """JSON-able form of a chain key: digest chains render as hex, the
    sim engines' string chains as-is — ONE spelling for every
    index/snapshot consumer."""
    if isinstance(chain, (bytes, bytearray)):
        return bytes(chain).hex()
    return str(chain)


class KVPage:
    """One portable KV block: ``chain`` (the prefix-cache chain digest),
    ``payload`` (a tuple of numpy arrays — one per cache-pool leaf, so
    int8 value planes and their fp32 scale planes ride together — or
    raw ``bytes`` for host-only simulation pages), and ``meta`` (the
    JSON-able signature the producing engine emits from
    ``kv_page_meta()``: block size plus per-leaf dtype/shape).  Pages
    with mismatched meta never restore — a store shared across engine
    configs serves only compatible pages.

    ``dtypes`` names each leaf's dtype (default: the arrays' own).  A
    ``bfloat16`` leaf is held as its raw ``uint16`` words with the name
    ``"bfloat16"`` here, so pages need no ``ml_dtypes``."""

    __slots__ = ("chain", "payload", "meta", "dtypes")

    def __init__(self, chain, payload, meta, dtypes=None):
        if not isinstance(chain, (bytes, str)):
            # chains must survive the disk tier's serialization losslessly
            # (the integrity check compares them); digests are bytes, the
            # sim engines use strings
            raise TypeError(f"chain must be bytes or str, got "
                            f"{type(chain).__name__}")
        if isinstance(payload, (bytes, bytearray)):
            payload = bytes(payload)
            dtypes = None
        else:
            payload = tuple(np.asarray(a) for a in payload)
            dtypes = (tuple(str(a.dtype) for a in payload) if dtypes is None
                      else tuple(str(d) for d in dtypes))
            for a, d in zip(payload, dtypes):
                if a.dtype.itemsize != _resolve_dtype(d).itemsize:
                    raise ValueError(f"a {a.dtype} leaf cannot carry "
                                     f"{d!r} values")
        self.chain = chain
        self.payload = payload
        self.meta = _freeze_meta(meta)
        self.dtypes = dtypes

    @property
    def nbytes(self) -> int:
        if isinstance(self.payload, bytes):
            return len(self.payload)
        return int(sum(a.nbytes for a in self.payload))

    # --------------------------------------------------- serialization --
    # raw bytes + an explicit per-array (dtype name, shape) header, NOT
    # np.savez: savez round-trips ml_dtypes extension dtypes (bfloat16,
    # fp8) as raw void '|V2' arrays, which the meta check cannot catch
    # (it compares dtype STRINGS, which survive) — the broken payload
    # would then crash the engine mid-restore instead of missing.

    def to_bytes(self) -> bytes:
        """Self-describing page bytes: the chain, meta and payload
        round-trip bit-exactly for EVERY dtype (extension dtypes
        included) — the disk tier's on-disk format."""
        head = {"chain": chain_hex(self.chain),
                "chain_is_digest": isinstance(self.chain, bytes),
                "meta": self.meta}
        chunks: List[bytes] = []
        if isinstance(self.payload, bytes):
            head["kind"] = "bytes"
            chunks.append(self.payload)
            head["arrays"] = [len(self.payload)]
        else:
            head["kind"] = "arrays"
            specs = []
            for a, d in zip(self.payload, self.dtypes):
                raw = np.ascontiguousarray(a).tobytes()
                specs.append([d, list(a.shape), len(raw)])
                chunks.append(raw)
            head["arrays"] = specs
        hbytes = json.dumps(head).encode("utf-8")
        buf = io.BytesIO()
        buf.write(b"KVPG1")
        buf.write(len(hbytes).to_bytes(8, "little"))
        buf.write(hbytes)
        for raw in chunks:
            buf.write(raw)
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, data: bytes) -> "KVPage":
        if data[:5] != b"KVPG1":
            raise ValueError("not a KVPage container")
        hlen = int.from_bytes(data[5:13], "little")
        head = json.loads(data[13:13 + hlen].decode("utf-8"))
        chain = (bytes.fromhex(head["chain"])
                 if head["chain_is_digest"] else head["chain"])
        off = 13 + hlen
        if head["kind"] == "bytes":
            (n,) = head["arrays"]
            payload: Any = data[off:off + n]
            if len(payload) != n:
                raise ValueError("truncated KVPage payload")
        else:
            arrays, names = [], []
            for dtype_name, shape, n in head["arrays"]:
                raw = data[off:off + n]
                if len(raw) != n:
                    raise ValueError("truncated KVPage payload")
                arrays.append(np.frombuffer(
                    raw, dtype=_resolve_dtype(dtype_name))
                    .reshape(shape))
                names.append(dtype_name)
                off += n
            return cls(chain, tuple(arrays), head["meta"], dtypes=names)
        return cls(chain, payload, head["meta"])

    def __repr__(self):
        return (f"KVPage(chain={chain_hex(self.chain)[:12]}…, "
                f"nbytes={self.nbytes})")


#: storage of the float dtypes numpy cannot name without ml_dtypes (the
#: port's pools hold fp32, fp16, bf16 or int8)
_RAW_WORDS = {"bfloat16": np.uint16}


def _resolve_dtype(name: str) -> np.dtype:
    """The numpy storage dtype of a leaf's dtype name: the dtype itself, or
    for ``_RAW_WORDS`` names the unsigned word of the same width (the bits
    are kept, the name rides beside them in ``KVPage.dtypes``)."""
    if name in _RAW_WORDS:          # even where ml_dtypes could name it
        return np.dtype(_RAW_WORDS[name])
    return np.dtype(name)


def _freeze_meta(meta):
    """Meta comparison must survive a JSON round trip (the disk tier):
    normalize tuples/lists to the JSON list form once, at construction,
    so ``page.meta == engine.kv_page_meta()`` after ``_freeze_meta`` on
    both sides is tier-independent."""
    return json.loads(json.dumps(meta))


class TieredKVStore:
    """Host-DRAM-over-disk page store (module docstring).

    ``dram_capacity_bytes`` bounds the DRAM tier; inserting past it
    demotes LRU pages to disk (``disk_dir``) or drops them when no disk
    tier is configured.  ``disk_capacity_bytes`` (optional) bounds the
    disk tier by evicting its oldest pages.  ``tracer``: optional, any
    object with ``.emit(kind, **fields)`` — demote/promote/evict emit
    structured ``kvstore`` events.  All methods are thread-safe (a
    serving thread and metric scrapes may share one store)."""

    def __init__(self, *, dram_capacity_bytes: int = 256 << 20,
                 disk_dir: Optional[str] = None,
                 disk_capacity_bytes: Optional[int] = None,
                 tracer=None, logger: Optional[logging.Logger] = None):
        if int(dram_capacity_bytes) < 1:
            raise ValueError("dram_capacity_bytes must be >= 1")
        if disk_capacity_bytes is not None and int(disk_capacity_bytes) < 1:
            raise ValueError("disk_capacity_bytes must be >= 1")
        self.dram_capacity_bytes = int(dram_capacity_bytes)
        self.disk_dir = None if disk_dir is None else str(disk_dir)
        self.disk_capacity_bytes = (None if disk_capacity_bytes is None
                                    else int(disk_capacity_bytes))
        self.tracer = tracer
        self._log = logger if logger is not None \
            else logging.getLogger(__name__)
        self._lock = threading.Lock()
        self._dram: "collections.OrderedDict[Any, KVPage]" = \
            collections.OrderedDict()
        self._dram_bytes = 0
        # chain -> (path, nbytes); insertion order is the disk LRU
        self._disk: "collections.OrderedDict[Any, Tuple[str, int]]" = \
            collections.OrderedDict()
        self._disk_bytes = 0
        self._stats = StatRegistry()
        if self.disk_dir is not None:
            os.makedirs(self.disk_dir, exist_ok=True)

    # ------------------------------------------------------------ write --

    def put(self, page: KVPage) -> str:
        """Insert (or refresh) one page into the DRAM tier, demoting the
        DRAM LRU tail past capacity; returns the tier the page landed
        in (``"dram"`` — a page larger than the whole DRAM budget goes
        straight to disk, or is dropped without one)."""
        if not isinstance(page, KVPage):
            raise TypeError(f"put() wants a KVPage, got "
                            f"{type(page).__name__}")
        with self._lock:
            try:
                self._stats.add("puts")
                if page.nbytes > self.dram_capacity_bytes:
                    # same same-chain cleanup as the normal path: a stale
                    # DRAM copy left behind would SHADOW the fresh disk
                    # page on every later lookup
                    old = self._dram.pop(page.chain, None)
                    if old is not None:
                        self._dram_bytes -= old.nbytes
                    if self._spill_to_disk(page):
                        return "disk"
                    self._stats.add("evictions_dram")
                    return "dropped"
                old = self._dram.pop(page.chain, None)
                if old is not None:
                    self._dram_bytes -= old.nbytes
                self._drop_disk(page.chain)   # DRAM copy supersedes disk
                self._dram[page.chain] = page
                self._dram_bytes += page.nbytes
                self._enforce_dram()
                return "dram"
            finally:
                self._sync_memory()

    def _enforce_dram(self):
        while self._dram_bytes > self.dram_capacity_bytes and self._dram:
            chain, page = self._dram.popitem(last=False)      # LRU first
            self._dram_bytes -= page.nbytes
            if self._spill_to_disk(page):
                self._stats.add("demotions_disk")
                self._emit("demote", chain=chain_hex(chain),
                           bytes=page.nbytes, to="disk")
            else:
                self._stats.add("evictions_dram")
                self._emit("evict", chain=chain_hex(chain),
                           bytes=page.nbytes, tier="dram")

    def _spill_to_disk(self, page: KVPage) -> bool:
        if self.disk_dir is None:
            return False
        # file name = fixed-length digest of the chain, never a
        # truncation: long string chains (the sim engines') share
        # leading text, and truncated names would collide — the later
        # page overwriting the earlier and the integrity check then
        # deleting BOTH as corrupt
        fname = hashlib.blake2b(chain_hex(page.chain).encode("utf-8"),
                                digest_size=24).hexdigest()
        path = os.path.join(self.disk_dir, fname + ".kvpage")
        try:
            data = page.to_bytes()
            with open(path, "w+b") as f:
                f.write(data)
        except OSError as e:
            self._log.warning("kv_store: disk demotion failed (%r) — "
                              "page dropped", e)
            return False
        old = self._disk.pop(page.chain, None)
        if old is not None:
            self._disk_bytes -= old[1]
        self._disk[page.chain] = (path, len(data))
        self._disk_bytes += len(data)
        while (self.disk_capacity_bytes is not None
               and self._disk_bytes > self.disk_capacity_bytes
               and self._disk):
            victim, (vpath, vbytes) = self._disk.popitem(last=False)
            self._disk_bytes -= vbytes
            self._remove_file(vpath)
            self._stats.add("evictions_disk")
            self._emit("evict", chain=chain_hex(victim), bytes=vbytes,
                       tier="disk")
        return True

    def _drop_disk(self, chain):
        entry = self._disk.pop(chain, None)
        if entry is not None:
            self._disk_bytes -= entry[1]
            self._remove_file(entry[0])

    def _remove_file(self, path: str):
        try:
            os.remove(path)
        except OSError as e:
            self._log.debug("kv_store: stale page file %s not removed: %r",
                            path, e)

    # ------------------------------------------------------------- read --

    def lookup(self, chain, meta=None) -> Optional[KVPage]:
        """Fetch one page: a DRAM hit touches the LRU; a disk hit loads,
        verifies, and PROMOTES the page back into DRAM.  ``meta``
        (optional): the consumer's ``kv_page_meta()`` — a mismatch is a
        counted miss, never a wrong-shaped restore.  A corrupt disk page
        is dropped and counted; the caller recomputes."""
        frozen = None if meta is None else _freeze_meta(meta)
        with self._lock:
            page = self._dram.get(chain)
            if page is not None:
                if frozen is not None and page.meta != frozen:
                    self._stats.add("meta_mismatches")
                    return None
                self._dram.move_to_end(chain)
                self._stats.add("hits_dram")
                return page
            entry = self._disk.get(chain)
            if entry is None:
                self._stats.add("misses")
                return None
            path, nbytes = entry
            try:
                with open(path, "rb") as f:
                    page = KVPage.from_bytes(f.read())
                if page.chain != chain:
                    raise ValueError("chain mismatch in page file")
            except Exception as e:  # noqa: BLE001 — a corrupt page must
                # degrade to a MISS (recompute is always correct), never
                # to a wrong-page restore
                self._log.warning("kv_store: corrupt page %s dropped: %r",
                                  chain_hex(chain)[:16], e)
                self._disk.pop(chain, None)
                self._disk_bytes -= nbytes
                self._remove_file(path)
                self._stats.add("corrupt_pages")
                self._stats.add("misses")
                self._sync_memory()
                return None
            if frozen is not None and page.meta != frozen:
                self._stats.add("meta_mismatches")
                return None
            if page.nbytes > self.dram_capacity_bytes:
                # an oversized page stays disk-resident (put() sent it
                # straight there for the same reason): promoting it
                # would flush the ENTIRE warm DRAM tier before spilling
                # it right back out
                self._stats.add("hits_disk")
                return page
            # promote: disk -> DRAM (the file is dropped; DRAM is now
            # the authoritative copy and may re-demote later)
            self._disk.pop(chain, None)
            self._disk_bytes -= nbytes
            self._remove_file(path)
            self._dram[chain] = page
            self._dram_bytes += page.nbytes
            self._stats.add("hits_disk")
            self._stats.add("promotions")
            self._emit("promote", chain=chain_hex(chain),
                       bytes=page.nbytes)
            self._enforce_dram()
            self._sync_memory()
            return page

    def tier_of(self, chain) -> Optional[str]:
        """Which tier holds ``chain`` right now (``"dram"``/``"disk"``/
        None) — a PURE read: no LRU touch, no promotion.  The routing
        plane's primitive (the gateway's prefix-affinity read is
        documented as side-effect-free)."""
        with self._lock:
            if chain in self._dram:
                return "dram"
            if chain in self._disk:
                return "disk"
            return None

    def index(self) -> Dict[Any, str]:
        """``{chain: tier}`` over every resident page — the engine's
        ``prefix_index()`` merges this under its HBM entries."""
        with self._lock:
            out = {chain: "dram" for chain in self._dram}
            for chain in self._disk:
                out.setdefault(chain, "disk")
            return out

    def drop(self, chain) -> bool:
        """Remove one page from every tier; True when anything was
        resident."""
        with self._lock:
            page = self._dram.pop(chain, None)
            if page is not None:
                self._dram_bytes -= page.nbytes
            had_disk = chain in self._disk
            self._drop_disk(chain)
            self._sync_memory()
            return page is not None or had_disk

    # -------------------------------------------------------- telemetry --

    def _emit(self, what: str, **fields):
        if self.tracer is None:
            return
        self.tracer.emit("kvstore", what=what, **fields)

    def _sync_memory(self):
        """Mirror the tier byte totals into the active memory ledger
        (``telemetry_memory``): every tier transition resyncs the
        ``kv_pages`` host pool and its dram/disk tier counters as
        absolute values, so the ledger cannot drift from the store's own
        accounting.  One attribute check when no ledger is active."""
        ml = current_memory_ledger()
        if ml is None:
            return
        ml.set_bytes("kv_pages", self._dram_bytes, space="host",
                     tier="dram")
        ml.set_bytes("kv_pages", self._disk_bytes, space="host",
                     tier="disk")

    def counters(self) -> Dict[str, float]:
        return dict(self._stats.snapshot())

    def hit_rate(self) -> Optional[float]:
        """Lower-tier hit rate: (dram + disk hits) / lookups; None
        before the first lookup."""
        s = self._stats
        hits = float(s.value("hits_dram")) + float(s.value("hits_disk"))
        total = hits + float(s.value("misses")) \
            + float(s.value("meta_mismatches"))
        return None if total == 0 else hits / total

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able live view — what ``GET /kvstore`` serves."""
        with self._lock:
            out = {
                "dram": {"pages": len(self._dram),
                         "bytes": self._dram_bytes,
                         "capacity_bytes": self.dram_capacity_bytes},
                "disk": {"pages": len(self._disk),
                         "bytes": self._disk_bytes,
                         "capacity_bytes": self.disk_capacity_bytes,
                         "dir": self.disk_dir},
            }
        out["counters"] = self.counters()
        out["hit_rate"] = self.hit_rate()
        return out

    def metrics(self) -> Dict[str, float]:
        out = self.counters()
        with self._lock:
            out["dram_pages"] = float(len(self._dram))
            out["dram_bytes"] = float(self._dram_bytes)
            out["disk_pages"] = float(len(self._disk))
            out["disk_bytes"] = float(self._disk_bytes)
        return out

    def prometheus_text(self, namespace: str = "paddle_tpu_kvstore") -> str:
        with self._lock:
            gauges = {"dram_pages": len(self._dram),
                      "dram_bytes": self._dram_bytes,
                      "disk_pages": len(self._disk),
                      "disk_bytes": self._disk_bytes}
        hr = self.hit_rate()
        if hr is not None:
            gauges["hit_rate"] = hr
        return _prometheus_text(self._stats, namespace=namespace,
                                extra_gauges=gauges)

    def __repr__(self):
        with self._lock:
            return (f"TieredKVStore(dram={len(self._dram)}p/"
                    f"{self._dram_bytes}B, disk={len(self._disk)}p/"
                    f"{self._disk_bytes}B)")


class PageMigration:
    """Budgeted page-transfer schedule (module docstring): ``advance()``
    once per scheduler tick returns the pages that finished transferring
    under ``bytes_per_tick`` (None = unbounded — everything in one
    tick).  A page wider than the budget spans multiple ticks (the
    partial progress is tracked in bytes); delivery is page-granular, so
    a consumer never sees half a page.  ``restart()`` rewinds the whole
    schedule for a fresh destination — pages live host-side in the plan,
    so resuming after a destination quarantine re-delivers everything
    (correctness over cleverness: the fallback is recompute, never a
    torn page)."""

    def __init__(self, pages: Iterable[KVPage],
                 bytes_per_tick: Optional[int] = None):
        self.pages: List[KVPage] = list(pages)
        if bytes_per_tick is not None and int(bytes_per_tick) < 1:
            raise ValueError("bytes_per_tick must be >= 1 (or None)")
        self.bytes_per_tick = (None if bytes_per_tick is None
                               else int(bytes_per_tick))
        self.total_bytes = sum(p.nbytes for p in self.pages)
        self._next = 0          # first undelivered page
        self._partial = 0       # bytes already moved of pages[_next]
        self.transferred_bytes = 0
        self.ticks = 0

    @property
    def done(self) -> bool:
        return self._next >= len(self.pages)

    @property
    def remaining_bytes(self) -> int:
        return self.total_bytes - self.transferred_bytes

    def advance(self) -> List[KVPage]:
        """One tick of transfer; returns pages that COMPLETED this tick
        (possibly empty while a wide page is mid-flight)."""
        if self.done:
            return []
        self.ticks += 1
        budget = (float("inf") if self.bytes_per_tick is None
                  else self.bytes_per_tick)
        delivered: List[KVPage] = []
        while self._next < len(self.pages) and budget > 0:
            page = self.pages[self._next]
            left = page.nbytes - self._partial
            step = min(left, budget)
            self._partial += step
            self.transferred_bytes += step
            budget -= step
            if self._partial >= page.nbytes:     # covers zero-byte pages
                delivered.append(page)
                self._next += 1
                self._partial = 0
            else:
                break           # budget exhausted mid-page
        return delivered

    def restart(self):
        """Rewind for a new destination (resumable-on-quarantine)."""
        self._next = 0
        self._partial = 0
        self.transferred_bytes = 0

    def to_dict(self) -> Dict[str, Any]:
        return {"pages": len(self.pages), "delivered": self._next,
                "total_bytes": self.total_bytes,
                "transferred_bytes": self.transferred_bytes,
                "ticks": self.ticks,
                "bytes_per_tick": self.bytes_per_tick}

    def __repr__(self):
        return (f"PageMigration({self._next}/{len(self.pages)} pages, "
                f"{self.transferred_bytes}/{self.total_bytes}B)")

"""The serving engines' compiled programs (counterpart of the warmup planner
of ``paddle_tpu/jit/aot.py``: ``WarmupTask``, ``run_warmup``,
``warmup_async``; and of the jitted program the reference's
``_cached_prog`` keeps per bucket).

A ``GraphProgram`` is one device step of an engine — a function of int32
operands that the host packs — in the form the device runs best:

- on a CUDA device, a CUDA graph: the step's whole device half is captured
  once and every later call is ONE replay, as a jitted XLA program is one
  dispatch.  A call copies its host operands into the graph's static
  buffer (one non-blocking host→device copy from one pinned staging
  buffer), replays, and returns the graph's static outputs; the caller
  reads them back before the next call of the same program.
- on the CPU, or on a card inside ``disable_graphs()``, the function
  itself, run eagerly on the operands shipped in one copy.

Capture rules every program function keeps: no host synchronisation and
no host→device copy of its own (every operand arrives through the static
buffer), and no state that a later capture may free.  Before the capture
the function runs once eagerly on the engine's inert operands, on the
capture stream (PyTorch's rule, and lazily built tensors — cast weights,
kernel workspaces — are then real before the graph records their
addresses); inert operands aim every write at a place the engine never
reads (trash block 0, clocks past ``max_len``, rows with no update), and
the engine's generator state is restored after the run and the capture.
Python's garbage is collected before a capture and not during it (a
collected graph or pinned buffer would make a call a capture forbids).
A capture that fails raises with the program's label: nothing falls back
to eager.

Kernel launches inside a capture are tallied, not counted
(``ops/_build.py`` ``note_launch``); each replay adds its program's tally
to the kernels' launch counters, so a counter still says how many times
its kernel ran.

Differences from the reference (``ROADMAP.md`` §C): a CUDA graph binds the
addresses of one engine's pools, so programs are cached per engine, not
per model; a graph cannot be saved across processes (``cache_dir``
raises; the kernels' libraries already persist under ``csrc/_build/``);
captures on one card are serial (``max_workers > 1`` raises).
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import gc
import logging
import time
from typing import Any, Callable, Dict, Optional, Sequence

import numpy as np
import torch

__all__ = ["GraphProgram", "WarmupTask", "disable_graphs", "graphs_enabled",
           "run_warmup", "warmup_async"]

_log = logging.getLogger(__name__)
_eager_depth = 0


@contextlib.contextmanager
def disable_graphs():
    """Run every program eagerly inside the block, on the card too (the
    counterpart of ``jax.disable_jit()``): for comparisons only."""
    global _eager_depth
    _eager_depth += 1
    try:
        yield
    finally:
        _eager_depth -= 1


def graphs_enabled(device) -> bool:
    """Whether programs on ``device`` run as CUDA graphs now."""
    return torch.device(device).type == "cuda" and _eager_depth == 0


class GraphProgram:
    """One engine step as a CUDA graph on a card, as its eager function
    elsewhere (module docstring).

    ``fn(*operands)`` takes int32 device tensors of ``shapes`` (in order)
    and returns a tensor or a tuple of tensors.  ``inert`` holds host
    arrays of the same shapes that leave the engine's live state as it
    was.  With no ``shapes`` the function takes no operands and a call
    copies nothing: its state lives in device tensors it reads and
    updates in place (``generate()``'s decode step, whose clock is one of
    them).  ``pool`` and ``stream`` are the engine's graph memory pool and
    capture stream; ``generator`` is the engine's sampling generator,
    registered with the graph and restored around the build."""

    def __init__(self, label: str, fn: Callable, shapes: Sequence,
                 inert: Sequence, *, device, pool=None, stream=None,
                 generator: Optional[torch.Generator] = None):
        self.label = str(label)
        self.fn = fn
        self.shapes = [tuple(int(d) for d in s) for s in shapes]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        if len(inert) != len(self.shapes):
            raise ValueError(f"{label}: {len(inert)} inert operands for "
                             f"{len(self.shapes)} shapes")
        self.inert = [np.asarray(a, np.int32).reshape(s)
                      for a, s in zip(inert, self.shapes)]
        self.device = torch.device(device)
        self.pool = pool
        self.stream = stream
        self.generator = generator
        self.graph = None
        self._static = None          # device int32 operands
        self._staging = None         # pinned host copy of them
        self._copied = None          # event: the staging buffer was read
        self._out = None
        self._tally: Dict[Any, int] = {}
        self._warm = False

    def _views(self, buf):
        if not self.shapes:
            return []
        return [p.view(s) for p, s in
                zip(torch.split(buf, self.sizes), self.shapes)]

    def _pack(self, host, into):
        o = 0
        for h, n, s in zip(host, self.sizes, self.shapes):
            a = np.asarray(h)
            if a.size != n:
                raise ValueError(f"{self.label}: operand of {a.size} "
                                 f"elements for shape {s}")
            into[o:o + n] = a.reshape(-1)
            o += n
        return into

    def _run_eager(self, host):
        if not self.shapes:
            with torch.no_grad():
                return self.fn()
        buf = torch.from_numpy(self._pack(
            host, np.empty(sum(self.sizes), np.int32))).to(self.device)
        with torch.no_grad():
            return self.fn(*self._views(buf))

    def _load(self, host):
        """Host operands into the static buffer: the staging buffer is
        rewritten only after the previous copy out of it has run."""
        if self._copied is not None:
            self._copied.synchronize()
        self._pack(host, self._staging_np)
        self._static.copy_(self._staging, non_blocking=True)
        self._copied.record()

    def _state(self):
        g = self.generator
        return None if g is None else g.get_state()

    def _restore(self, state):
        if state is not None:
            self.generator.set_state(state)

    def compile(self):
        """Build the program: one eager run on the inert operands and, on
        a card with graphs on, the capture.  Idempotent."""
        capture = graphs_enabled(self.device) and self.graph is None
        if self._warm and not capture:
            return
        state = self._state()
        try:
            if capture:
                self._capture()
            else:
                self._run_eager(self.inert)
            self._warm = True
        finally:
            self._restore(state)

    def _capture(self):
        from ..ops._build import take_capture_tally

        dev = self.device
        n = sum(self.sizes)
        with torch.cuda.device(dev):
            cs = self.stream if self.stream is not None \
                else torch.cuda.Stream(dev)
            self._static = torch.zeros(n, dtype=torch.int32, device=dev)
            self._staging = torch.empty(n, dtype=torch.int32,
                                        pin_memory=True)
            self._staging_np = self._staging.numpy()
            self._copied = torch.cuda.Event()
            self._load(self.inert)
            views = self._views(self._static)
            cs.wait_stream(torch.cuda.current_stream(dev))
            with torch.cuda.stream(cs), torch.no_grad():
                self.fn(*views)
            torch.cuda.current_stream(dev).wait_stream(cs)
            graph = torch.cuda.CUDAGraph()
            if self.generator is not None \
                    and self.generator.device.type == "cuda":
                graph.register_generator_state(self.generator)
            take_capture_tally()
            # garbage collected inside the capture could destroy another
            # program's graph or free pinned memory, calls a capture
            # forbids: collect now, and not again until the capture ends
            gc.collect()
            collecting = gc.isenabled()
            gc.disable()
            try:
                with torch.no_grad(), torch.cuda.graph(
                        graph, pool=self.pool, stream=cs,
                        capture_error_mode="thread_local"):
                    out = self.fn(*views)
            except Exception as e:
                take_capture_tally()
                raise RuntimeError(f"capturing program {self.label!r} "
                                   f"failed: {e}") from e
            finally:
                if collecting:
                    gc.enable()
            self._tally = take_capture_tally()
        self._out = out
        self.graph = graph

    def __call__(self, *host):
        if not graphs_enabled(self.device):
            return self._run_eager(host)
        if self.graph is None:
            self.compile()
        if self.shapes:
            self._load(host)
        self.graph.replay()
        for fn, k in self._tally.items():
            fn.launches += k
        return self._out


class WarmupTask:
    """One program to build before traffic: ``run()`` fetches it from the
    engine's cache and builds it (an eager run on inert operands and, on a
    card, its capture)."""

    __slots__ = ("label", "run")

    def __init__(self, label: str, run: Callable[[], None]):
        self.label = str(label)
        self.run = run

    def __repr__(self):
        return f"WarmupTask({self.label!r})"


def _refuse(cache_dir, max_workers):
    """The reference's warmup arguments graphs cannot honour.
    ``cache_dir``: a CUDA graph holds one process's device addresses and
    cannot be saved (``ROADMAP.md`` §C).  ``max_workers > 1``: captures
    on one card are serial (``ROADMAP.md`` §C)."""
    if cache_dir is not None:
        raise NotImplementedError(
            "warmup(cache_dir=...): CUDA graphs cannot be saved across "
            "processes (ROADMAP.md §C); the kernels' libraries already "
            "persist under paddle_tpu_torch/csrc/_build/")
    if max_workers is not None and int(max_workers) > 1:
        raise ValueError(
            f"warmup(max_workers={max_workers}): captures on one card are "
            f"serial (ROADMAP.md §C); use max_workers=1")


def run_warmup(tasks: Sequence[WarmupTask], *, tracer=None, cache_dir=None,
               max_workers: int = 1, lock=None,
               logger: Optional[logging.Logger] = None) -> Dict[str, Any]:
    """Execute a warmup plan, one task at a time, each under ``lock`` (the
    engine's step lock: a concurrent ``step()`` runs between tasks, never
    inside a capture).  With a ``tracer`` the whole run sits inside its
    ``expected_compiles`` window, scoped to this grid's labels (a request
    served concurrently by ``warmup_async`` still arms the recompile-storm
    warning).  Returns the reference's report: ``{"programs", "wall_s",
    "tasks": [{"label", "wall_s"}, ...], "cache_dir"}``."""
    _refuse(cache_dir, max_workers)
    log = logger if logger is not None else _log
    lock = lock if lock is not None else contextlib.nullcontext()
    ctx = (tracer.expected_compiles(keys={t.label for t in tasks})
           if tracer is not None else contextlib.nullcontext())
    t0 = time.perf_counter()
    results = []
    with ctx:
        for task in tasks:
            tt = time.perf_counter()
            with lock:
                task.run()
            results.append({"label": task.label,
                            "wall_s": time.perf_counter() - tt})
    wall = time.perf_counter() - t0
    log.info("warmup: %d programs in %.2fs", len(results), wall)
    return {"programs": len(results), "wall_s": wall, "tasks": results,
            "cache_dir": None}


def warmup_async(tasks: Sequence[WarmupTask], **kwargs
                 ) -> "concurrent.futures.Future":
    """``run_warmup`` on a background thread; returns the report's Future.
    Arguments are checked here, so a bad one raises at the call."""
    _refuse(kwargs.get("cache_dir"), kwargs.get("max_workers", 1))
    ex = concurrent.futures.ThreadPoolExecutor(
        max_workers=1, thread_name_prefix="warmup")
    fut = ex.submit(run_warmup, tasks, **kwargs)
    ex.shutdown(wait=False)
    return fut


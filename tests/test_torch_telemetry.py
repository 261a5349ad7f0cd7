"""Port parity for the serving telemetry (paddle_tpu_torch/telemetry.py,
utils/stats.py, profiler.py and the engine seams in serving.py /
serving_paged.py): the cases of the reference's ``tests/test_telemetry.py``
on the port.

The same requests run through the JAX engine with a JAX ``Tracer`` and
through the port's engine with the port's ``Tracer`` — the ragged,
ragged-speculative, bucketed paged and contiguous engines, cold and after
``warmup()``, one case that preempts, one that cancels and one with a
tiered store that demotes and restores pages.  The event streams must be
EQUAL once the clock fields (``ts``, ``dur_s``, ``wall_s``) are dropped:
kinds, per-request transitions with their token ids, every tick field
(counter deltas, packed rows, ``programs`` labels, ``compiles``), compile
misses with their ``expected`` flags, and ``kvstore`` events.  So must the
``request_summary()`` counts, ``metrics_schema()`` per engine class and the
metric names and types of ``prometheus_text()`` — but for the one
documented difference (the port's engines also count ``decode_syncs``,
``ROADMAP.md`` §C).  The JAX engines cache programs per model and the
port's per engine, so every JAX engine here gets a fresh model cache.

Then the reference's non-engine cases against the port's own ``Tracer``,
``StatRegistry``, ``Histogram`` and profiler, and the off path: with
``tracer=None`` no tracer method runs, and the program keys and streams
are those of a traced engine.  Models: two layers at width 64, vocabulary
256, fp32; the draft is the target's first layer."""

import functools
import json
import logging
import threading
import warnings

import jax.numpy as jnp
import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.kv_store import TieredKVStore as JStore
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.serving import ContinuousBatchingEngine as JContiguous
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPaged
from paddle_tpu.serving import PagedSpeculativeBatchingEngine as JPagedSpec
from paddle_tpu.serving import SpeculativeBatchingEngine as JSpec
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
from paddle_tpu.telemetry import Tracer as JTracer
from paddle_tpu.telemetry import program_label as j_program_label
from paddle_tpu_torch import profiler
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.kv_store import TieredKVStore as TStore
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.serving import ContinuousBatchingEngine as TContiguous
from paddle_tpu_torch.serving_paged import (
    PagedContinuousBatchingEngine as TPaged,
    PagedSpeculativeBatchingEngine as TPagedSpec,
    RaggedPagedContinuousBatchingEngine as TRagged,
    SpeculativeBatchingEngine as TSpec)
from paddle_tpu_torch.telemetry import (RequestTraceIndex, TraceContext,
                                        Tracer)
from paddle_tpu_torch.utils import stats

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            initializer_range=0.3, compute_dtype="float32")
# the last prompt takes bucket 16: two 8-token segments where chunked
REQS = [([5, 17, 3], 6), ([40, 2], 4), ([61], 5),
        (list(range(3, 14)), 5)]
BASE = dict(max_slots=2, max_len=32, prompt_buckets=[8, 16])

# kind -> (JAX class, port class, constructor kwargs, draft?)
KINDS = {
    "ragged": (JRagged, TRagged, dict(BASE, block_size=8, token_budget=12),
               False),
    "ragged_spec": (JRagged, TRagged,
                    dict(BASE, block_size=8, token_budget=12, draft_k=2),
                    True),
    "paged": (JPaged, TPaged, dict(BASE, block_size=8, prefill_chunk=8),
              False),
    "contiguous": (JContiguous, TContiguous, dict(BASE, prefill_chunk=8),
                   False),
}
# the clock fields: host walls and timestamps differ run to run
CLOCK = ("ts", "dur_s", "wall_s")


@functools.lru_cache(maxsize=None)
def _models():
    """(jax target, params, jax draft, draft params, port target, port
    draft) from one seeded numpy state."""
    paddle.seed(11)
    jm = JModel(JConfig(**TINY))
    params = {n: p._data for n, p in jm.named_parameters()}
    state = {n: np.asarray(v) for n, v in params.items()}
    dstate = {n: (v[:1] if n.startswith("blocks_") else v)
              for n, v in state.items()}
    dcfg = dict(TINY, num_layers=1)
    jd = JModel(JConfig(**dcfg))
    dparams = {n: jnp.asarray(dstate[n]) for n, _ in jd.named_parameters()}
    return (jm, params, jd, dparams,
            params_from_numpy(state, GPTConfig(**TINY), device="cpu"),
            params_from_numpy(dstate, GPTConfig(**dcfg), device="cpu"))


def _engine(kind, side, **extra):
    """A fresh engine; a JAX engine over an emptied model program cache
    (the port's cache is per engine)."""
    jcls, tcls, kw, draft = KINDS[kind]
    jm, params, jd, dparams, tm, td = _models()
    kw = dict(kw, **extra)
    if side == "jax":
        for m in (jm, jd):
            m.__dict__.pop("_serving_programs", None)
        if draft:
            kw.update(draft_model=jd, draft_params=dparams)
        return jcls(jm, params, **kw)
    if draft:
        kw.update(draft_model=td)
    return tcls(tm, device="cpu", **kw)


def _drive(eng, reqs, hook=None):
    """Queue every request and step to quiescence; ``hook(eng, step,
    rids)`` runs before each step.  Returns the streams in request order
    (None for a request that never finished)."""
    rids = [eng.add_request(p, n) for p, n in reqs]
    step = 0
    while eng.pending():
        if hook is not None:
            hook(eng, step, rids)
        eng.step()
        step += 1
        assert step < 400
    got = eng.pop_finished()
    return [got.get(r) for r in rids]


def _strip(events):
    return [{k: v for k, v in e.items() if k not in CLOCK} for e in events]


def _both(kind, reqs=REQS, warm=False, hook=None, **extra):
    """Serve ``reqs`` on the JAX and the port engine, each traced; returns
    ((jax engine, tracer, streams), (port engine, tracer, streams))."""
    out = []
    for side, tcls in (("jax", JTracer), ("port", Tracer)):
        tr = tcls()
        eng = _engine(kind, side, tracer=tr, **extra)
        if warm:
            eng.warmup()
        out.append((eng, tr, _drive(eng, reqs, hook)))
    return out


@functools.lru_cache(maxsize=None)
def _served(kind, warm):
    """``_both(kind, warm=warm)`` over ``REQS``, once per module: the
    stream and the exposition cases read the same finished serves."""
    return _both(kind, warm=warm)


def _prom_types(text):
    """{metric name: type} of a Prometheus exposition."""
    return {ln.split()[2]: ln.split()[3] for ln in text.splitlines()
            if ln.startswith("# TYPE")}


# ----------------------------------------------------------------------
# engine event streams: JAX vs port
# ----------------------------------------------------------------------

class TestEngineParity:
    @pytest.mark.parametrize("warm", [False, True], ids=["cold", "warm"])
    @pytest.mark.parametrize("kind", list(KINDS))
    def test_event_streams_equal(self, kind, warm):
        """Exact equality of the event streams without their clock fields
        (tolerance: none), cold (misses inside ticks) and after a warmup
        (misses tagged ``expected``, then only hits), and of the
        ``request_summary()`` counts."""
        (je, jt, js), (te, tt, ts) = _served(kind, warm)
        assert ts == js and None not in ts
        assert _strip(tt.events()) == _strip(jt.events())
        comp = tt.events("compile")
        assert comp and all(not e["hit"] for e in comp)
        assert all(e["expected"] == warm for e in comp)
        if warm:
            # every miss happened inside the warmup window
            assert te.metrics()["compile_misses"] == len(te.compile_grid()) \
                - ("kvio" in te.compile_grid())
        for key in ("requests_tracked", "requests_retired", "replays"):
            assert tt.request_summary()[key] == jt.request_summary()[key]
        for h in ("ttft_seconds", "inter_token_seconds"):
            assert tt.registry.histogram(h).snapshot()["count"] == \
                jt.registry.histogram(h).snapshot()["count"]
        assert tt.summary()["compile"] == {
            **jt.summary()["compile"],
            "wall_s": tt.summary()["compile"]["wall_s"]}

    def test_preemption_stream(self):
        """A pool too small for both requests: the youngest is preempted
        and replayed; the ``preempted`` transition, the replay's second
        ``admitted`` and the tick ``preemptions`` deltas agree, and the
        TTFT histogram holds one sample per retired request."""
        reqs = [([5, 17, 3], 14), ([40, 2], 14)]
        kw = dict(max_slots=2, num_blocks=3, prompt_buckets=[8],
                  prefill_chunk=None)
        (je, jt, js), (te, tt, ts) = _both("paged", reqs, **kw)
        assert ts == js and te.preemptions == je.preemptions >= 1
        assert _strip(tt.events()) == _strip(jt.events())
        whats = [e["what"] for e in tt.events("request")]
        assert "preempted" in whats
        assert sum(e.get("preemptions", 0) for e in tt.events("tick")) \
            == te.preemptions
        assert tt.request_summary()["replays"] == te.preemptions
        assert tt.registry.histogram("ttft_seconds").snapshot()["count"] \
            == len(reqs)

    def test_cancel_stream(self):
        """``cancel`` mid-decode and while queued: the terminal
        ``cancelled`` transitions (no TTFT sample) agree."""
        def hook(eng, step, rids):
            if step == 2:
                assert eng.cancel(rids[0])
                assert eng.cancel(rids[3])

        (je, jt, js), (te, tt, ts) = _both("ragged", hook=hook)
        assert ts == js and ts[0] is None and ts[3] is None
        assert _strip(tt.events()) == _strip(jt.events())
        assert int(tt.registry.value("requests_cancelled")) == 2
        assert tt.registry.histogram("ttft_seconds").snapshot()["count"] \
            == 2
        assert te.metrics()["requests_cancelled"] == 2

    def test_kvstore_demote_restore_stream(self, tmp_path):
        """A tiered store behind the paged engine: ``flush_prefix``
        demotes the cached prompt blocks (``kvstore`` ``demote``), the
        next request with the same prompt restores them (``restore``) —
        chains, bytes and order agree with the JAX engine's."""
        reqs = [(list(range(3, 14)), 3)]
        streams, events = [], []
        for side, tcls, scls in (("jax", JTracer, JStore),
                                 ("port", Tracer, TStore)):
            tr = tcls()
            store = scls(dram_capacity_bytes=1 << 20,
                         disk_dir=str(tmp_path / side), tracer=tr)
            eng = _engine("paged", side, tracer=tr, prefill_chunk=None,
                          enable_prefix_cache=True, kv_store=store)
            got = _drive(eng, reqs)
            eng.flush_prefix()
            got += _drive(eng, reqs)
            streams.append(got)
            events.append(tr.events())
        assert streams[0] == streams[1]
        assert _strip(events[1]) == _strip(events[0])
        kv = [e["what"] for e in events[1] if e["kind"] == "kvstore"
              and e.get("engine")]
        assert "demote" in kv and "restore" in kv


class TestSchemaAndExposition:
    @pytest.mark.parametrize("jcls,tcls", [
        (JContiguous, TContiguous), (JPaged, TPaged), (JRagged, TRagged),
        (JSpec, TSpec), (JPagedSpec, TPagedSpec)],
        ids=["contiguous", "paged", "ragged", "spec_shim",
             "paged_spec_shim"])
    def test_metrics_schema_equal(self, jcls, tcls):
        assert tcls.metrics_schema() == jcls.metrics_schema()

    @pytest.mark.parametrize("kind", list(KINDS))
    def test_prometheus_names_and_types(self, kind):
        """The engine's and the tracer's expositions: the same metric
        names with the same ``# TYPE``, but for ``decode_syncs`` — the
        port's engines with a decode sync count it, the reference's do
        not (``ROADMAP.md`` §C)."""
        (je, jt, _), (te, tt, _) = _served(kind, False)
        jp, tp = _prom_types(je.prometheus_text()), \
            _prom_types(te.prometheus_text())
        extra = ({"paddle_tpu_serving_decode_syncs"}
                 if kind in ("paged", "contiguous") else set())
        assert set(tp) - set(jp) == extra and set(jp) <= set(tp)
        assert {k: tp[k] for k in jp} == jp
        assert _prom_types(tt.prometheus_text()) == \
            _prom_types(jt.prometheus_text())

    @pytest.mark.parametrize("tcls,kw", [
        (TSpec, dict(max_slots=2, max_len=32, draft_k=2,
                     prompt_buckets=[8])),
        (TPagedSpec, dict(BASE, block_size=8, draft_k=2, prefill_chunk=8))],
        ids=["spec_shim", "paged_spec_shim"])
    def test_spec_shims_take_a_tracer(self, tcls, kw):
        """The legacy constructors pass ``tracer=`` through (the
        reference's ``_SUPPORTED_CACHE_KW``) and still refuse what they
        do not support."""
        _, _, _, _, tm, td = _models()
        tr = Tracer()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            eng = tcls(tm, td, device="cpu", tracer=tr, **kw)
            with pytest.raises(NotImplementedError):
                tcls(tm, td, device="cpu", temperature=0.5, **kw)
        assert None not in _drive(eng, REQS[:2])
        assert tr.events("tick") and eng.spec_rounds >= 1

    def test_metrics_match_schema(self):
        eng = _engine("ragged", "port", enable_prefix_cache=True)
        _drive(eng, REQS[:1])
        m = eng.metrics()
        schema = type(eng).metrics_schema()
        assert set(m) <= set(schema), set(m) - set(schema)
        for k, v in m.items():
            kind, pytype = schema[k]
            assert isinstance(v, pytype), (k, type(v))

    def test_engine_exposition_values(self):
        """The engine exposition parses back to its counters and typed
        gauges (tolerance: exact)."""
        eng = _engine("contiguous", "port")
        got = _drive(eng, REQS)
        vals = {ln.split()[0]: ln.split()[1]
                for ln in eng.prometheus_text().splitlines()
                if ln and not ln.startswith("#")}
        assert int(vals["paddle_tpu_serving_tokens_emitted"]) \
            == sum(len(g) for g in got)
        assert float(vals["paddle_tpu_serving_mean_ttft_s"]) > 0
        types = _prom_types(eng.prometheus_text())
        assert types["paddle_tpu_serving_compile_misses"] == "counter"
        assert types["paddle_tpu_serving_mean_ttft_s"] == "gauge"


class TestProgramLabels:
    @pytest.mark.parametrize("key,label", [
        (("prefill", 16, ("sig",)), "prefill:16"),
        (("seg", 8, True, False, ("sig",)), "seg:8:10"),
        (("decode", ("sig",)), "decode"),
        (("decode", 4, ("sig",)), "decode:4"),
        (("cpre", 16, 1, ("sig",)), "cpre:16:1"),
        (("ragged_step", 12, 4, ("sig",)), "ragged_step:12:4"),
        (("ragged_spec", 12, 2, ("sig",)), "ragged_spec:12:2")])
    def test_event_labels_agree(self, key, label):
        """The port's program keys are the reference's grid labels; their
        event labels are the reference's ``program_label`` of its keys
        (a segment's first/last flags end the label)."""
        from paddle_tpu_torch.serving import _event_label
        assert _event_label(label) == j_program_label(key)
        assert telemetry.program_label(key) == j_program_label(key)


# ----------------------------------------------------------------------
# the off path
# ----------------------------------------------------------------------

class TestOffPath:
    def test_tracing_off_takes_no_tracer_lock(self, monkeypatch):
        """Default engines never reach a tracer: every Tracer entry point
        is boobytrapped and a full serve (with a warmup) completes."""
        def boom(*a, **kw):
            raise AssertionError("tracer touched with tracing off")

        for meth in ("emit", "tick", "compile_event", "request_event",
                     "expected_compiles", "bind_trace"):
            monkeypatch.setattr(Tracer, meth, boom)
        for kind in KINDS:
            eng = _engine(kind, "port")
            assert eng.tracer is None
            eng.warmup()
            assert None not in _drive(eng, REQS)

    @pytest.mark.parametrize("kind", list(KINDS))
    def test_programs_and_streams_identical_with_tracing(self, kind):
        """Telemetry is a pure observer: the same program keys and the
        same token streams with and without a tracer."""
        off = _engine(kind, "port")
        on = _engine(kind, "port", tracer=Tracer())
        assert _drive(on, REQS) == _drive(off, REQS)
        assert set(on._programs) == set(off._programs)
        assert all(type(p) is type(off._programs[k])
                   for k, p in on._programs.items())

    def test_step_error_surfaces(self, monkeypatch):
        tr = Tracer()
        eng = _engine("contiguous", "port", tracer=tr)
        eng.add_request([1, 2], 3)

        def bad():
            raise RuntimeError("tick died")

        monkeypatch.setattr(eng, "_step_impl", bad)
        with pytest.raises(RuntimeError):
            eng.step()
        assert eng.metrics()["step_errors"] == 1
        err = tr.events("engine_error")
        assert len(err) == 1 and "tick died" in err[0]["error"]
        assert tr.events("tick")          # the tick still closes


# ----------------------------------------------------------------------
# the port's tracer on its own
# ----------------------------------------------------------------------

class TestTracer:
    def test_tick_accounting_and_export_roundtrip(self, tmp_path):
        """Every packed row is a decode row or a prefill row; the tick
        deltas sum to the tokens and requests; JSONL and Chrome exports
        round-trip (tolerance: exact)."""
        tr = Tracer()
        eng = _engine("ragged", "port", tracer=tr)
        got = _drive(eng, REQS)
        ticks = tr.events("tick")
        toks = sum(len(g) for g in got)
        assert sum(e.get("decode_rows", 0) for e in ticks) \
            == toks - len(REQS)
        assert sum(e.get("prefill_tokens", 0) for e in ticks) == 8 * 3 + 16
        assert sum(e["tokens_emitted"] for e in ticks) == toks
        for e in ticks:
            assert e.get("budget_used", 0) == e.get("decode_rows", 0) \
                + e.get("prefill_tokens", 0) <= eng.token_budget
        path = tmp_path / "events.jsonl"
        n = tr.dump_jsonl(str(path))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert len(lines) == n
        assert [ln for ln in lines if ln["kind"] != "timeline"] \
            == tr.events()
        assert telemetry.chrome_trace_from_jsonl(str(path)) \
            == tr.to_chrome_trace()
        ct = tr.to_chrome_trace()
        assert {"queued", "prefill", "decode"} <= {
            e["name"] for e in ct["traceEvents"]
            if e.get("cat") == "request" and e["ph"] == "X"}
        json.dumps(ct)
        s = tr.request_summary()
        for key in ("ttft_s", "inter_token_s"):
            p = s[key]
            assert p["p50"] <= p["p95"] <= p["p99"] <= p["max"]

    def test_ring_buffer_bounds_and_drop_count(self):
        tr = Tracer(capacity=8)
        for i in range(20):
            tr.emit("tick", i=i)
        assert len(tr.events()) == 8
        assert tr.events_dropped == 12
        assert tr.events()[0]["i"] == 12       # oldest dropped first

    def test_recompile_storm_warns_once(self, caplog):
        """Misses after the first tick past the threshold log ONE warning
        (the ragged engine builds a wider table width mid-run)."""
        tr = Tracer(recompile_warn_threshold=1)
        eng = _engine("ragged", "port", tracer=tr)
        with caplog.at_level(logging.WARNING,
                             logger="paddle_tpu_torch.telemetry"):
            _drive(eng, REQS)
        storm = [r for r in caplog.records
                 if "recompile storm" in r.getMessage()]
        assert len(storm) == 1
        assert tr.summary()["compile"]["post_warmup_misses"] >= 1

    def test_attribute_cost_raises(self):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            Tracer(attribute_cost=True)
        mfu = Tracer().mfu_summary()
        assert mfu["mfu"] is None and mfu["programs_costed"] == 0

    def test_trace_context_and_index(self):
        """A request's events carry its bound trace; the index stitches
        the engine-only trace into one root with one attempt and its
        phase spans."""
        tr = Tracer()
        eng = _engine("contiguous", "port", tracer=tr)
        root = TraceContext.root()
        ctx = root.child()
        rid = eng.add_request([5, 17, 3], 4, trace_ctx=ctx)
        eng.run_to_completion()
        evs = [e for e in tr.events("request") if e["rid"] == rid]
        assert evs and all(e["trace_id"] == root.trace_id for e in evs)
        assert tr.trace_of(rid) is None          # unbound at retirement
        idx = RequestTraceIndex([("engine", eng)])
        t = idx.trace(root.trace_id)
        names = [s["name"] for s in t["spans"]]
        assert names[0] == "request" and "decode" in names
        assert t["spans"][0]["span_id"] == root.span_id
        assert idx.recent()[0]["trace_id"] == root.trace_id
        with pytest.raises(TypeError):
            RequestTraceIndex([object()])


class TestStatsRegistry:
    def test_histogram_observe_and_percentile(self):
        reg = stats.StatRegistry()
        h = reg.histogram("lat", bounds=(0.01, 0.1, 1.0))
        for v in (0.005, 0.005, 0.05, 0.5, 5.0):
            h.observe(v)
        snap = h.snapshot()
        assert snap["count"] == 5
        assert snap["counts"] == (2, 1, 1, 1)
        assert abs(snap["sum"] - 5.56) < 1e-9
        assert h.percentile(0.5) == 0.1
        assert reg.histogram("lat") is h       # idempotent fetch
        reg.reset()
        assert h.snapshot()["count"] == 0

    def test_counter_gauge_kinds_in_exposition(self):
        reg = stats.StatRegistry()
        reg.add("reqs", 3)
        reg.set("depth", 7)
        reg.sub("inflight", 1)
        reg.set_max("peak", 5)
        reg.set_max("peak", 2)
        reg.observe("lat", 0.02, bounds=(0.01, 0.1))
        text = stats.prometheus_text(reg, namespace="t")
        assert "# TYPE t_reqs counter" in text and "t_reqs 3" in text
        assert "# TYPE t_depth gauge" in text and "t_depth 7" in text
        assert "# TYPE t_inflight gauge" in text
        assert "t_peak 5" in text
        assert "# TYPE t_lat histogram" in text
        assert 't_lat_bucket{le="0.1"} 1' in text
        assert 't_lat_bucket{le="+Inf"} 1' in text
        assert "t_lat_count 1" in text
        text2 = stats.prometheus_text(reg, namespace="t",
                                      extra_gauges={"mean ttft.s": 0.5},
                                      extra_counters={"hits": 2})
        assert "t_mean_ttft_s 0.5" in text2
        assert "# TYPE t_hits counter" in text2

    def test_global_registry(self):
        stats.stat_registry().reset("X_tel_t")
        stats.stat_add("X_tel_t", 2)
        stats.stat_sub("X_tel_t", 1)
        assert stats.get_stat("X_tel_t") == 1
        assert "X_tel_t" in stats.get_all_stats()

    def test_engines_feed_the_global_registry(self):
        before = stats.get_stat("serving_requests_finished")
        eng = _engine("contiguous", "port")
        _drive(eng, REQS[:2])
        assert stats.get_stat("serving_requests_finished") == before + 2

    def test_device_memory_stats_empty_on_cpu(self, monkeypatch):
        import torch
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert stats.device_memory_stats() == {}


class TestProfiler:
    def test_reset_and_snapshot(self):
        profiler.reset_profiler()
        with profiler.RecordEvent("tel_test_evt"):
            pass
        snap = profiler.snapshot_events()
        assert snap["tel_test_evt"][0] == 1
        assert "tel_test_evt" in profiler.summary()
        assert any(r[0] == "tel_test_evt" for r in stats.op_summary())
        profiler.reset_profiler()
        assert profiler.snapshot_events() == {}

    def test_record_event_thread_safety(self):
        profiler.reset_profiler()

        def work():
            for _ in range(200):
                with profiler.RecordEvent("tel_mt_evt"):
                    pass

        threads = [threading.Thread(target=work) for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert profiler.snapshot_events()["tel_mt_evt"][0] == 800
        profiler.reset_profiler()

    def test_stop_profiler_summary_routing(self, tmp_path, caplog):
        profiler.reset_profiler()
        seen = []
        profiler.start_profiler(str(tmp_path / "p1"))
        profiler.stop_profiler(on_summary=seen.append)
        assert len(seen) == 1 and "Event" in seen[0]
        with caplog.at_level(logging.INFO,
                             logger="paddle_tpu_torch.profiler"):
            profiler.start_profiler(str(tmp_path / "p2"))
            profiler.stop_profiler()
        assert any("trace written" in r.getMessage()
                   for r in caplog.records)

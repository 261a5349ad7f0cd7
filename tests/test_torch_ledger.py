"""Port parity for the goodput ledger and the flight recorder
(paddle_tpu_torch/telemetry_ledger.py): the cases of the reference's
``tests/test_ledger.py`` on the port, and a traced engine feeding a
ledger.

Buckets sum to elapsed wall time by construction (over-attribution shows
as ``overflow_s``); tracer and monitor durations land in their buckets; a
compile paid inside a tick is attributed to ``compile`` only, so a cold
traced serve keeps the buckets non-overlapping; ``ledger_span`` is a no-op
without an active ledger; ``aggregate`` is the single-process identity;
and ``FlightRecorder`` dumps the ring buffers, the ledger and the memory
ledger's forensics on an unhandled exception and on a signal — every test
that installs it uninstalls it in ``finally``.  Left out: the reference's
seams in ``hapi``, the DataLoader, ``reader``, checkpoint io and the fleet
metrics (no counterpart in the port yet, ROADMAP A7/A8)."""

import json
import signal
import sys
import threading
import time

import numpy as np
import pytest

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving_paged import \
    RaggedPagedContinuousBatchingEngine
from paddle_tpu_torch.telemetry import Tracer, TrainMonitor
from paddle_tpu_torch.telemetry_ledger import (BUCKETS, FlightRecorder,
                                               RunLedger,
                                               chrome_counters_from_dump,
                                               current_ledger, ledger_span)
from paddle_tpu_torch.telemetry_memory import MemoryLedger

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            compute_dtype="float32")


def _model():
    paddle.seed(9)
    jm = JModel(JConfig(**TINY))
    return params_from_numpy({n: np.asarray(p._data)
                              for n, p in jm.named_parameters()},
                             GPTConfig(**TINY), device="cpu")


class TestRunLedgerCore:
    def test_buckets_sum_to_elapsed_exactly(self):
        led = RunLedger()
        led.record("compute", 0.005)
        led.record("data_wait", 0.004)
        time.sleep(0.02)
        snap = led.snapshot()
        assert set(snap["buckets_s"]) == set(BUCKETS)
        assert sum(snap["buckets_s"].values()) == pytest.approx(
            snap["elapsed_s"], rel=1e-12)
        assert snap["overflow_s"] == 0.0
        assert snap["buckets_s"]["unattributed"] > 0
        assert snap["goodput"] == pytest.approx(
            0.005 / snap["elapsed_s"], rel=1e-6)
        assert snap["counts"]["compute"] == 1

    def test_overflow_is_reported_not_hidden(self):
        led = RunLedger()
        led.record("compute", 1e6)
        snap = led.snapshot()
        assert snap["overflow_s"] > 0
        assert snap["buckets_s"]["unattributed"] == 0.0
        assert sum(snap["buckets_s"].values()) == pytest.approx(
            snap["elapsed_s"] + snap["overflow_s"], rel=1e-9)

    def test_unknown_bucket_raises(self):
        led = RunLedger()
        with pytest.raises(ValueError):
            led.record("gpu_time", 1.0)
        with pytest.raises(ValueError):
            with led.span("nonsense"):
                pass
        with pytest.raises(ValueError):
            led.record("unattributed", 1.0)

    def test_span_and_exclusive_absorption(self):
        led = RunLedger()
        with led.span("eval", exclusive=True):
            led.record("data_wait", 5.0)       # absorbed: inside eval
            led.record("eval", 0.001)
            time.sleep(0.01)
        snap = led.snapshot()
        assert snap["buckets_s"]["data_wait"] == 0.0
        assert snap["buckets_s"]["eval"] >= 0.011
        done = threading.Event()

        def other():
            led.record("comm", 0.5)
            done.set()

        with led.span("eval", exclusive=True):
            t = threading.Thread(target=other)
            t.start()
            assert done.wait(5)
            t.join()
        assert led.snapshot()["buckets_s"]["comm"] == 0.5

    def test_close_freezes_and_reset_restarts(self):
        led = RunLedger()
        led.record("compute", 0.1)
        led.close()
        e1 = led.snapshot()["elapsed_s"]
        led.record("compute", 9.9)             # dropped: the run is over
        snap = led.snapshot()
        assert snap["elapsed_s"] == e1 and snap["closed"]
        assert snap["buckets_s"]["compute"] == pytest.approx(0.1)
        led.reset()
        snap = led.snapshot()
        assert snap["buckets_s"]["compute"] == 0.0 and not snap["closed"]

    def test_capacity_bounds_series_not_totals(self):
        led = RunLedger(capacity=4)
        for _ in range(10):
            led.record("compute", 0.01)
        d = led.to_dict()
        assert len(d["series"]) == 4
        assert d["snapshot"]["buckets_s"]["compute"] == pytest.approx(0.1)

    def test_prometheus_and_chrome_counters(self, tmp_path):
        led = RunLedger()
        led.record("compute", 0.2)
        led.record("data_wait", 0.3)
        txt = led.prometheus_text()
        assert "paddle_tpu_ledger_compute_seconds 0.2" in txt
        assert "# TYPE paddle_tpu_ledger_compute_events counter" in txt
        assert "# TYPE paddle_tpu_ledger_goodput gauge" in txt
        counters = [e for e in led.to_chrome_counters()
                    if e.get("ph") == "C"]
        assert counters[-1]["args"]["data_wait"] == pytest.approx(0.3)
        p = tmp_path / "ledger.json"
        led.dump_json(str(p))
        off = chrome_counters_from_dump(json.loads(p.read_text()))
        assert [e.get("args") for e in off if e.get("ph") == "C"] == \
            [e["args"] for e in counters]

    def test_aggregate_single_process_identity(self, tmp_path):
        led = RunLedger()
        led.record("compute", 0.4)
        agg = led.aggregate()
        assert agg["world"] == 1
        assert agg["buckets_s"]["compute"] == pytest.approx(0.4)
        assert agg["goodput"] == pytest.approx(
            0.4 / agg["elapsed_s_max"], rel=1e-6)
        assert agg["straggler_skew"]["compute"] == pytest.approx(1.0)
        assert agg["straggler_skew"]["checkpoint_save"] is None
        # under an initialised one-rank process group the cross-rank
        # reduction (ported) gives the same identity
        import paddle_tpu_torch.distributed as pdist
        led.close()
        pdist.init_parallel_env(backend="gloo",
                                init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            again = led.aggregate()
        finally:
            pdist.destroy_process_group()
        assert again["world"] == 1
        assert again["buckets_s"]["compute"] == pytest.approx(0.4)


class TestActiveLedger:
    def test_active_slot_install_restore(self):
        assert current_ledger() is None
        led = RunLedger()
        with led:
            assert current_ledger() is led
            inner = RunLedger()
            with inner:
                assert current_ledger() is inner
            assert current_ledger() is led
        assert current_ledger() is None

    def test_ledger_span(self):
        with ledger_span("compute") as led:
            assert led is None                 # no active ledger: no-op
        with RunLedger() as led:
            with ledger_span("checkpoint_save") as got:
                assert got is led
                time.sleep(0.005)
        assert led.snapshot()["buckets_s"]["checkpoint_save"] >= 0.005


class TestForwarding:
    def test_monitor_events_map_to_buckets(self):
        mon = TrainMonitor()
        led = RunLedger()
        mon.set_ledger(led)
        mon.record_compile(("step",), 0.5)
        mon.record_step(0.2, trainer="t", examples=2)
        mon.record_sync(0.1, loss=1.0)
        mon.record_profiler_step(9.0)          # deliberately NOT forwarded
        snap = led.snapshot()
        assert snap["buckets_s"]["compile"] == pytest.approx(0.5)
        assert snap["buckets_s"]["host_dispatch"] == pytest.approx(0.2)
        assert snap["buckets_s"]["compute"] == pytest.approx(0.1)
        mon.set_ledger(None)
        mon.record_step(5.0, trainer="t")
        assert led.snapshot()["buckets_s"]["host_dispatch"] == \
            pytest.approx(0.2)

    def test_in_tick_compile_wall_not_double_attributed(self):
        tr = Tracer()
        led = RunLedger()
        tr.set_ledger(led)
        tr.compile_event("Eng", "prefill:8", hit=False, wall_s=0.4)
        tr.tick("Eng", 0.5, queue_depth=0)
        snap = led.snapshot()
        assert snap["buckets_s"]["compile"] == pytest.approx(0.4)
        assert snap["buckets_s"]["compute"] == pytest.approx(0.1)
        # compiles BETWEEN ticks (warmup) never reduce a later tick
        tr.compile_event("Eng", "decode:4", hit=False, wall_s=9.0)
        time.sleep(0.02)
        tr.tick("Eng", 0.01, queue_depth=0)
        assert led.snapshot()["buckets_s"]["compute"] == pytest.approx(
            0.11, abs=1e-3)

    def test_engine_attach_ledger_requires_tracer(self):
        tmod = _model()
        eng = ContinuousBatchingEngine(tmod, max_slots=1, max_len=16,
                                       prompt_buckets=[8], device="cpu")
        with pytest.raises(ValueError):
            eng.attach_ledger(RunLedger())
        eng2 = ContinuousBatchingEngine(tmod, max_slots=1, max_len=16,
                                        prompt_buckets=[8], device="cpu",
                                        tracer=Tracer())
        led = eng2.attach_ledger(RunLedger())
        assert eng2.tracer._ledger is led

    def test_cold_serve_buckets_stay_non_overlapping(self):
        """A cold traced ragged serve: every compile wall lies inside a
        tick, goes to ``compile`` and comes off that tick's ``compute``,
        so nothing overflows elapsed."""
        tr = Tracer()
        eng = RaggedPagedContinuousBatchingEngine(
            _model(), max_slots=2, max_len=32, block_size=8,
            prompt_buckets=[8, 16], token_budget=12, device="cpu",
            tracer=tr)
        led = eng.attach_ledger(RunLedger())
        for p, n in (([5, 17, 3], 6), ([40, 2], 4), ([61], 5)):
            eng.add_request(p, n)
        eng.run_to_completion()
        snap = led.snapshot()
        comp = tr.events("compile")
        assert comp and all(not e["expected"] for e in comp)
        assert snap["counts"]["compile"] == len(comp)
        assert snap["buckets_s"]["compile"] == pytest.approx(
            sum(e["wall_s"] for e in comp), rel=1e-9)
        assert snap["counts"]["compute"] == len(tr.events("tick"))
        assert snap["overflow_s"] == 0.0
        assert snap["buckets_s"]["compute"] + \
            snap["buckets_s"]["compile"] <= snap["elapsed_s"]


class TestFlightRecorder:
    def _recorder(self, tmp_path, *extra):
        mon = TrainMonitor()
        mon.record_step(0.01, trainer="t", examples=1)
        led = RunLedger()
        led.record("compute", 0.2)
        return FlightRecorder(str(tmp_path / "crash"),
                              sources=[mon, led, *extra])

    def test_dump_on_raised_exception(self, tmp_path):
        ml = MemoryLedger()
        ml.account("executables", 64)
        fr = self._recorder(tmp_path, ml)
        prev_hook = sys.excepthook
        fr.install(signals=())
        try:
            assert sys.excepthook is not prev_hook
            try:
                raise RuntimeError("boom")
            except RuntimeError:
                # what the interpreter does on an unhandled exception
                sys.excepthook(*sys.exc_info())
        finally:
            fr.uninstall()
        assert sys.excepthook is prev_hook
        dumps = list((tmp_path / "crash").glob("crash-*"))
        assert len(dumps) == 1
        out = dumps[0]
        meta = json.loads((out / "meta.json").read_text())
        assert "RuntimeError" in meta["reason"]
        jsonl = (out / "trainmonitor0.jsonl").read_text().splitlines()
        assert any(json.loads(ln)["kind"] == "train_step" for ln in jsonl)
        ldump = json.loads((out / "runledger1.json").read_text())
        assert ldump["snapshot"]["buckets_s"]["compute"] == \
            pytest.approx(0.2)
        forensic = json.loads(
            (out / "memoryledger2-forensics.json").read_text())
        assert forensic["top_pools"][0]["pool"] == "executables"

    def test_signal_dump_chains_previous_handler(self, tmp_path):
        fr = self._recorder(tmp_path)
        hit = []
        prev = signal.signal(signal.SIGUSR1, lambda s, f: hit.append(s))
        try:
            fr.install(signals=(signal.SIGUSR1,), enable_faulthandler=False)
            signal.raise_signal(signal.SIGUSR1)
            assert hit == [signal.SIGUSR1]       # chained, process alive
            assert list((tmp_path / "crash").glob("crash-*"))
        finally:
            fr.uninstall()
            signal.signal(signal.SIGUSR1, prev)

    def test_auto_dump_once_manual_dumps_unique(self, tmp_path):
        fr = self._recorder(tmp_path)
        assert fr.dump("first", _auto=True) is not None
        assert fr.dump("second", _auto=True) is None   # deduped
        d1 = fr.dump("manual-1")
        d2 = fr.dump("manual-2")
        assert d1 is not None and d2 is not None and d1 != d2
        assert len(list((tmp_path / "crash").glob("crash-*"))) == 3

    def test_dump_never_raises_and_bad_source_rejected(self, tmp_path):
        class Bad:
            def dump_jsonl(self, path):
                raise OSError("disk gone")

        fr = FlightRecorder(str(tmp_path / "crash"), sources=[Bad()])
        assert fr.dump("manual") is not None
        with pytest.raises(TypeError):
            FlightRecorder(str(tmp_path), sources=[object()])

    def test_install_default_uninstalls(self, tmp_path):
        prev = sys.excepthook
        fr = FlightRecorder.install_default(str(tmp_path / "c"))
        try:
            assert sys.excepthook is not prev
        finally:
            fr.uninstall()
        assert sys.excepthook is prev

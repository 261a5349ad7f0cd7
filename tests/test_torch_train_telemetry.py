"""Port parity for the training telemetry (paddle_tpu_torch/telemetry.py
``TrainMonitor`` / ``instrument_train_step``, profiler.py ``Profiler.step``
and ``make_gpt_train_step(monitor=)``): the cases of the reference's
``tests/test_train_telemetry.py`` on the port.

``monitor=None`` returns the bare step; with a monitor, the GPT step's
first call is the only compile event (and the only synchronisation),
later calls are ``train_step`` samples with ``tokens`` = B·L, and the
losses equal the unmonitored step's exactly.  The monitored step's events,
clock fields dropped, equal the JAX ``make_gpt_train_step``'s on the same
numpy state.  Then the watchdog, the live-tensor census's byte split,
``Profiler.step`` routing, the single-process aggregate and the JSONL /
Prometheus / Chrome round trips.  Left out, waiting for their slices: the
reference's cases on ``hapi`` ``Model.fit`` and ``TelemetryCallback``
(ROADMAP A8), the AMP ``GradScaler`` (A8) and the LocalSGD builder (A7).
Model: two layers at width 64, vocabulary 256, fp32, B 2, L 16."""

import json
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.models.gpt import make_gpt_train_step as j_make_step
import paddle_tpu.optimizer as JO
from paddle_tpu.telemetry import TrainMonitor as JMonitor
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch import telemetry
from paddle_tpu_torch.models.gpt import (GPTConfig, make_gpt_train_step,
                                         params_from_numpy)
from paddle_tpu_torch.optimizer import opt_state_from_numpy
from paddle_tpu_torch.profiler import Profiler
from paddle_tpu_torch.telemetry import (TrainMonitor,
                                        chrome_trace_from_jsonl,
                                        current_monitor,
                                        instrument_train_step)

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            compute_dtype="float32")
B, L = 2, 16
CLOCK = ("ts", "dur_s", "wall_s")


def _state():
    paddle.seed(5)
    jm = JModel(JConfig(**TINY))
    return jm, {n: np.asarray(p._data) for n, p in jm.named_parameters()}


def _batches(n):
    rng = np.random.RandomState(0)
    return [(rng.randint(0, TINY["vocab_size"], (B, L)),
             rng.randint(0, TINY["vocab_size"], (B, L))) for _ in range(n)]


def _port_run(state, monitor, n=4):
    """n port steps from ``state``; returns (losses, step)."""
    tm = params_from_numpy(state, GPTConfig(**TINY), device="cpu")
    step, st = make_gpt_train_step(tm, TO.AdamW(3e-4), remat=False,
                                   monitor=monitor)
    losses = []
    for i, (x, y) in enumerate(_batches(n)):
        st, loss = step(st, i, 3e-4, torch.tensor(x), torch.tensor(y))
        losses.append(float(loss))
    return losses, step


def _hcg():
    from paddle_tpu.distributed import fleet
    strategy = fleet.DistributedStrategy()
    strategy.hybrid_configs = {"dp_degree": 1, "mp_degree": 1,
                               "pp_degree": 1}
    fleet.init(is_collective=True, strategy=strategy)
    return fleet.get_hybrid_communicate_group()


class _FakeCuda(torch.Tensor):
    """A CPU tensor that reports a card: lets the CPU test see which calls
    the instrumented step would synchronise."""

    @property
    def device(self):
        return torch.device("cuda", 0)


class TestOffPath:
    def test_monitor_none_returns_bare_step(self):
        def step(*a):
            return a

        assert instrument_train_step(step, None, "x") is step

    def test_gpt_step_without_monitor_never_touches_one(self, monkeypatch):
        def boom(*a, **kw):
            raise AssertionError("TrainMonitor touched with telemetry off")

        for meth in ("record_step", "record_sync", "record_compile",
                     "observe_loss", "hbm_census", "aggregate"):
            monkeypatch.setattr(TrainMonitor, meth, boom)
        _, state = _state()
        losses, _ = _port_run(state, None, n=2)
        assert all(np.isfinite(losses))


class TestMonitoredGPTStep:
    def test_compile_event_samples_and_identical_losses(self):
        """4 monitored steps: 1 compile event (the first call), 3
        ``train_step`` samples with examples B and tokens B·L; the losses
        equal the unmonitored step's exactly (tolerance: 0)."""
        _, state = _state()
        mon = TrainMonitor()
        on, _ = _port_run(state, mon)
        off, _ = _port_run(state, None)
        assert on == off
        comp = mon.events("compile")
        assert len(comp) == 1 and comp[0]["key"] == "gpt_step"
        assert comp[0]["wall_s"] > 0
        steps = mon.events("train_step")
        assert len(steps) == 3
        assert all(e["trainer"] == "gpt" and e["examples"] == B
                   and e["tokens"] == B * L for e in steps)
        s = mon.summary()
        assert s["steps"] == 3 and s["compile"]["misses"] == 1
        assert s["tokens_per_sec"] > 0 and s["mfu"] is None

    def test_events_match_the_reference(self):
        """The JAX monitored step's events, clock fields dropped, equal
        the port's (exact) — the same kinds, keys, steps and batch
        counts; the losses agree within 1e-5 relative."""
        jm, state = _state()
        jmon, tmon = JMonitor(), TrainMonitor()
        jstep, jst = j_make_step(jm, JO.AdamW(3e-4), _hcg(), remat=False,
                                 monitor=jmon)
        tm = params_from_numpy(state, GPTConfig(**TINY), device="cpu")
        tstep, tst = make_gpt_train_step(tm, TO.AdamW(3e-4), remat=False,
                                         monitor=tmon)
        tst["opt"] = opt_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, jst["opt"]), device="cpu")
        jl, tl = [], []
        for i, (x, y) in enumerate(_batches(4)):
            jst, loss = jstep(jst, jax.random.key(i), np.float32(3e-4),
                              jnp.asarray(x), jnp.asarray(y))
            jl.append(float(loss))
            tst, loss = tstep(tst, i, 3e-4, torch.tensor(x),
                              torch.tensor(y))
            tl.append(float(loss))
        np.testing.assert_allclose(tl, jl, rtol=1e-5)

        def strip(evs):
            return [{k: v for k, v in e.items() if k not in CLOCK}
                    for e in evs]

        assert strip(tmon.events()) == strip(jmon.events())

    def test_one_synchronisation_on_the_first_call(self, monkeypatch):
        """Only the first call synchronises the card its outputs live on;
        steady-state calls add none."""
        synced = []
        monkeypatch.setattr(torch.cuda, "synchronize",
                            lambda d=None: synced.append(d))
        out = torch.zeros(2).as_subclass(_FakeCuda)
        mon = TrainMonitor()
        step = instrument_train_step(lambda *a: ({"params": {}}, out), mon,
                                     "t")
        for _ in range(4):
            step({}, 0.1, torch.zeros(B, L, dtype=torch.long))
        assert synced == [torch.device("cuda", 0)]
        assert len(mon.events("compile")) == 1
        assert len(mon.events("train_step")) == 3


class TestWatchdog:
    def test_non_finite_fires_and_warns_once(self, caplog):
        mon = TrainMonitor()
        mon.observe_loss(1.0)
        with caplog.at_level(logging.WARNING,
                             logger="paddle_tpu_torch.telemetry"):
            assert mon.observe_loss(float("nan")) == "non_finite"
            assert mon.observe_loss(float("inf")) == "non_finite"
        warns = [r for r in caplog.records
                 if "numerics watchdog" in r.getMessage()]
        assert len(warns) == 1
        evs = mon.events("watchdog")
        assert [e["what"] for e in evs] == ["non_finite", "non_finite"]
        assert mon.summary()["watchdog"]["non_finite"] == 2

    def test_loss_spike_vs_ema(self):
        mon = TrainMonitor(spike_factor=10.0, spike_min_steps=5)
        for _ in range(6):
            assert mon.observe_loss(1.0) is None
        assert mon.observe_loss(50.0) == "loss_spike"
        ev = mon.events("watchdog")[-1]
        assert ev["loss"] == 50.0 and abs(ev["ema"] - 1.0) < 1e-9
        # the spike did not fold into the EMA: a second spike re-fires
        assert mon.observe_loss(50.0) == "loss_spike"
        assert mon.summary()["watchdog"]["loss_spikes"] == 2
        fresh = TrainMonitor(spike_min_steps=5)
        fresh.observe_loss(1.0)
        assert fresh.observe_loss(1000.0) is None


class TestHBMCensus:
    def test_byte_accounting_split(self):
        """Storage bytes by group (exact): a view of a registered tensor
        is not counted twice; the rest of the process's CPU tensors are
        ``other``."""
        mon = TrainMonitor()
        w = torch.ones(8, 4)
        params = {"w": w, "row": w[0]}                      # 128 B
        opt = {"m": torch.zeros(8, 4), "v": torch.zeros(4)}  # 144 B
        census = mon.hbm_census(params=params, opt=opt)
        assert census["params_bytes"] == 128
        assert census["opt_bytes"] == 144
        assert census["total_bytes"] == 272 + census["other_bytes"]
        assert census["peak_bytes"] == census["total_bytes"]
        assert mon.registry.value("hbm_params_bytes") == 128
        assert "# TYPE paddle_tpu_train_hbm_peak_bytes gauge" \
            in mon.prometheus_text()
        del params["w"], params["row"]
        c2 = mon.hbm_census(params=params, opt=opt)
        assert c2["params_bytes"] == 0
        assert c2["peak_bytes"] >= c2["total_bytes"]
        assert len(mon.events("hbm")) == 2


class TestAggregation:
    def test_single_process_identity(self):
        mon = TrainMonitor()
        mon.record_step(0.5, examples=4, tokens=64)
        mon.record_step(0.5, examples=4, tokens=64)
        agg = mon.aggregate()
        assert agg["world"] == 1 and agg["tokens"] == 128
        assert agg["global_tokens_per_sec"] == pytest.approx(128.0)
        assert agg["straggler_skew"] == pytest.approx(1.0)
        assert mon.events("aggregate")

    def test_initialised_process_group_raises(self, tmp_path):
        """Multi-rank aggregation is ported (``fleet.metrics
        .all_reduce_metrics``; tests/test_torch_dist_telemetry.py): under
        an initialised one-rank gloo group it no longer raises and
        reduces to the single-process identity."""
        import paddle_tpu_torch.distributed as pdist
        pdist.init_parallel_env(backend="gloo",
                                init_method=f"file://{tmp_path}/pg",
                                rank=0, world_size=1)
        try:
            mon = TrainMonitor()
            mon.record_step(0.5, examples=4, tokens=64)
            agg = mon.aggregate()
        finally:
            pdist.destroy_process_group()
        assert agg["world"] == 1 and agg["tokens"] == 64
        assert agg["straggler_skew"] == pytest.approx(1.0)


class TestProfilerStep:
    def test_num_samples_items_per_sec(self):
        prof = Profiler(timer_only=True)
        prof.start()
        for _ in range(3):
            prof.step(num_samples=32)
        prof.stop()
        info = prof.step_info()
        assert "steps=3" in info and "ips=" in info
        p2 = Profiler(timer_only=True)
        p2.start()
        p2.step()
        p2.stop()
        assert "ips=" not in p2.step_info()

    def test_routes_into_active_monitor(self):
        mon = TrainMonitor()
        with mon:
            assert current_monitor() is mon
            prof = Profiler(timer_only=True)
            prof.start()
            for _ in range(2):
                prof.step(num_samples=4)
            prof.stop()
        assert current_monitor() is None
        assert mon.events("train_step") == []
        evs = mon.events("profiler_step")
        assert len(evs) == 2 and all(e["examples"] == 4 for e in evs)
        assert mon.registry.value("profiler_steps") == 2
        assert mon.summary()["steps"] == 0


class TestExports:
    def test_jsonl_prometheus_roundtrip(self, tmp_path):
        mon = TrainMonitor()
        mon.record_step(0.01, trainer="t", examples=2, tokens=8)
        mon.record_sync(0.001, loss=1.5)
        mon.observe_loss(float("inf"))
        mon.hbm_census()
        path = tmp_path / "train.jsonl"
        n = mon.dump_jsonl(str(path))
        lines = [json.loads(ln) for ln in path.read_text().splitlines()]
        assert len(lines) == n
        assert {"train_step", "sync", "watchdog", "hbm"} <= {
            ln["kind"] for ln in lines}
        assert chrome_trace_from_jsonl(str(path)) == mon.to_chrome_trace()
        vals = {ln.split()[0]: ln.split()[1]
                for ln in mon.prometheus_text().splitlines()
                if ln and not ln.startswith("#") and "{" not in ln}
        assert int(vals["paddle_tpu_train_train_steps"]) == 1
        assert int(vals["paddle_tpu_train_train_tokens"]) == 8
        assert int(vals["paddle_tpu_train_watchdog_non_finite"]) == 1
        assert "paddle_tpu_train_step_seconds_count" in vals

    def test_chrome_train_rows(self):
        mon = TrainMonitor()
        mon.record_step(0.02, trainer="t")
        mon.observe_loss(float("nan"))
        train = [e for e in mon.to_chrome_trace()["traceEvents"]
                 if e.get("pid") == "paddle_tpu.train"]
        assert any(e["ph"] == "X" and e["name"] == "train_step"
                   for e in train)
        assert any(e["ph"] == "i" and e["name"] == "watchdog:non_finite"
                   for e in train)

    def test_default_batch_info_walks_nested_args(self):
        """The batch heuristic walks nested lists, tuples and dicts: the
        largest tensor past the state is the batch."""
        x = torch.zeros(3, 7, dtype=torch.long)
        args = ({"params": torch.zeros(100, 100)}, 0.1,
                [{"ids": x}], (torch.zeros(3),))
        assert telemetry._default_batch_info(args) == (3, 21)
        assert telemetry._default_batch_info(({}, 0.1)) == (0, 0)

"""Port parity for the multi-rank telemetry: ``TrainMonitor.aggregate``
and ``RunLedger.aggregate`` through ``fleet.metrics.all_reduce_metrics``,
``record_comm`` and ``instrument_train_step(comm=)``, against the JAX
package's ``telemetry.py`` / ``telemetry_ledger.py``.

Two gloo ranks (one spawn) record different step walls, tokens and ledger
buckets and aggregate.  The expected result is the reference's own
``aggregate`` over the same per-rank counters: the reference runs with
its ``all_reduce_metrics`` replaced by the reduction of the two ranks'
local dicts and a world of 2, so its formula (``telemetry.py:1409-1440``,
``telemetry_ledger.py:221``) computes the answer.  Floats within 1e-12
relative (the same sums in float64).  Each rank of a monitored dp 2 GPT
step under int8_ef counts its own rows and records one ``comm`` event a
steady-state step with the reference's byte figures.

The spawned ranks import this module, so it imports no JAX at its top.
"""

import gc
import os
import pickle
import sys

import numpy as np
import pytest
import torch

WALLS = {0: [0.5, 0.5, 0.25], 1: [0.75, 0.5, 1.0]}
BUCKETS = {0: {"compute": 0.4, "data_wait": 0.05},
           1: {"compute": 0.6, "comm": 0.2, "data_wait": 0.01}}
TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            compute_dtype="float32")
B, L = 8, 16


def _rank_main(rank, world, tmp):
    import datetime
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, fleet
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    from paddle_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                             make_gpt_train_step)
    import paddle_tpu_torch.optimizer as TO
    from paddle_tpu_torch.telemetry import TrainMonitor
    from paddle_tpu_torch.telemetry_ledger import RunLedger
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    mon = TrainMonitor()
    for w in WALLS[rank]:
        mon.record_step(w, examples=4, tokens=64 * (rank + 1))
    led = RunLedger()
    for b, v in BUCKETS[rank].items():
        led.record(b, v)
    led.close()
    out = {"mon": mon.aggregate(), "mon_events": mon.events("aggregate"),
           "led_snap": led.snapshot(), "led": led.aggregate()}
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    m = GPTModel(GPTConfig(**TINY), device="cpu",
                 generator=torch.Generator().manual_seed(0))
    mon2 = TrainMonitor()
    step, state = make_gpt_train_step(
        m, TO.AdamW(1e-3), fleet.get_hybrid_communicate_group(),
        remat=False, monitor=mon2, grad_comm="int8_ef")
    x = torch.tensor(np.random.RandomState(0).randint(0, 128, (B, L)))
    for _ in range(3):
        state, loss = step(state, 0, 1e-3, x, x)
    out["dp"] = {"comm": mon2.summary()["comm"],
                 "events": [{k: v for k, v in e.items() if k != "ts"}
                            for e in mon2.events("comm")],
                 "steps": [(e["examples"], e["tokens"])
                           for e in mon2.events("train_step")],
                 "agg": mon2.aggregate()}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("tel2")
    mp.start_processes(_rank_main, args=(2, str(tmp)), nprocs=2, join=True,
                       start_method="spawn")
    out = []
    for r in range(2):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


def _reference_reduction(monkeypatch, locals_by_op):
    """Make the reference's ``aggregate`` reduce over the ranks' local
    dicts: ``all_reduce_metrics(d, op)`` returns the op over every rank's
    dict with ``d``'s keys; the world is 2."""
    from paddle_tpu.distributed import env as jenv
    from paddle_tpu.distributed.fleet.metrics import metric

    def reduce(metrics, op="sum"):
        rows = locals_by_op(metrics)
        fn = {"sum": np.sum, "max": np.max, "min": np.min}[op]
        return {k: float(fn([r[k] for r in rows])) for k in metrics}

    monkeypatch.setattr(metric, "all_reduce_metrics", reduce)
    monkeypatch.setattr(jenv, "get_world_size", lambda: 2)


def _rel(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b), (set(a), set(b))
        for k in a:
            _rel(a[k], b[k])
    elif a is None or b is None:
        assert a is None and b is None
    else:
        assert a == pytest.approx(b, rel=1e-12), (a, b)


class TestAggregate:
    def test_train_monitor_matches_the_reference_formula(self, ranks,
                                                         monkeypatch):
        from paddle_tpu.telemetry import TrainMonitor as JMonitor
        mons = []
        for r in (0, 1):
            m = JMonitor()
            for w in WALLS[r]:
                m.record_step(w, examples=4, tokens=64 * (r + 1))
            mons.append(m)

        def locals_by_op(metrics):
            out = []
            for m in mons:
                reg = m.registry
                wall = float(reg.histogram("step_seconds").snapshot()["sum"])
                full = {"steps": float(reg.value("train_steps")),
                        "examples": float(reg.value("train_examples")),
                        "tokens": float(reg.value("train_tokens")),
                        "step_wall_s": wall}
                out.append(full)
            return out

        _reference_reduction(monkeypatch, locals_by_op)
        want = mons[0].aggregate()
        for rk in ranks:
            _rel(rk["mon"], want)
            assert rk["mon_events"][-1]["world"] == 2
        got = ranks[0]["mon"]
        assert got["world"] == 2 and got["steps"] == 6
        assert got["tokens"] == 3 * 64 + 3 * 128
        assert got["straggler_skew"] >= 1.0

    def test_run_ledger_matches_the_reference_formula(self, ranks,
                                                      monkeypatch):
        from paddle_tpu.telemetry_ledger import BUCKETS as JB
        from paddle_tpu.telemetry_ledger import RunLedger as JLedger
        snaps = [rk["led_snap"] for rk in ranks]

        def local(snap):
            d = {b: float(snap["buckets_s"][b]) for b in JB}
            d["elapsed_s"] = float(snap["elapsed_s"])
            return d

        _reference_reduction(monkeypatch,
                             lambda metrics: [local(s) for s in snaps])
        led = JLedger()
        led.snapshot = lambda: snaps[0]
        want = led.aggregate()
        for rk in ranks:
            _rel(rk["led"], want)
        assert want["world"] == 2
        assert want["buckets_s"]["compute"] == pytest.approx(1.0)


class TestComm:
    def test_dp_step_counts_its_rows_and_records_comm(self, ranks):
        from paddle_tpu_torch.distributed.grad_comm import wire_bytes
        from paddle_tpu_torch.models.gpt import GPTConfig, GPTModel
        m = GPTModel(GPTConfig(**TINY), device="cpu")
        wb = wire_bytes(dict(m.named_parameters()), "int8_ef")
        for rk in ranks:
            dp = rk["dp"]
            # the first call is the compile event: 2 steady-state steps
            assert dp["steps"] == [(B // 2, B * L // 2)] * 2
            assert len(dp["events"]) == 2
            assert dp["comm"] == {
                "policy": "int8_ef", "steps": 2,
                "pre_bytes": 2 * wb["pre_bytes"],
                "post_bytes": 2 * wb["post_bytes"],
                "savings": round(wb["pre_bytes"] / wb["post_bytes"], 3)}
            assert dp["agg"]["tokens"] == 2 * B * L and \
                dp["agg"]["world"] == 2

    def test_record_comm_events_and_summary_match_the_reference(self):
        from paddle_tpu.telemetry import TrainMonitor as JMonitor
        from paddle_tpu_torch.telemetry import TrainMonitor
        jm, tm = JMonitor(), TrainMonitor()
        for m in (jm, tm):
            assert m.summary()["comm"] is None
            m.record_step(0.1, examples=2, tokens=8)
            for pre, post in ((800, 203), (800, 203), (4096, 1040)):
                m.record_comm(policy="int8_ef", pre_bytes=pre,
                              post_bytes=post, note="x")
        strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}  # noqa
                             for e in evs]
        assert strip(tm.events("comm")) == strip(jm.events("comm"))
        assert tm.summary()["comm"] == jm.summary()["comm"]

    def test_instrumented_step_records_the_references_comm_events(self):
        """One device: the monitored GPT step under int8_ef records the
        same comm events as the reference's (bytes from the same tree)."""
        import jax
        import paddle_tpu as paddle
        from paddle_tpu.models.gpt import GPTConfig as JC
        from paddle_tpu.models.gpt import GPTModel as JG
        from paddle_tpu.models.gpt import make_gpt_train_step as jstep
        from paddle_tpu.optimizer import AdamW as JAdamW
        from paddle_tpu.telemetry import TrainMonitor as JMonitor
        from paddle_tpu.distributed import fleet
        from paddle_tpu_torch.models.gpt import (GPTConfig,
                                                 make_gpt_train_step,
                                                 params_from_numpy)
        import paddle_tpu_torch.optimizer as TO
        from paddle_tpu_torch.telemetry import TrainMonitor
        st = fleet.DistributedStrategy()
        st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1}
        fleet.init(is_collective=True, strategy=st)
        paddle.seed(3)
        jm_model = JG(JC(**TINY))
        weights = {n: np.asarray(p._data)
                   for n, p in jm_model.named_parameters()}
        jmon, tmon = JMonitor(), TrainMonitor()
        js, jst = jstep(jm_model, JAdamW(1e-3), fleet.get_hybrid_communicate_group(),
                        remat=False, monitor=jmon, grad_comm="int8_ef")
        ts, tst = make_gpt_train_step(
            params_from_numpy(weights, GPTConfig(**TINY), device="cpu"),
            TO.AdamW(1e-3), remat=False, monitor=tmon, grad_comm="int8_ef")
        x = np.random.RandomState(0).randint(0, 128, (2, 16))
        for _ in range(3):
            jst, _ = js(jst, jax.random.key(0), np.float32(1e-3), x, x)
            tst, _ = ts(tst, 0, 1e-3, torch.tensor(x), torch.tensor(x))
        strip = lambda evs: [{k: v for k, v in e.items() if k != "ts"}  # noqa
                             for e in evs]
        assert strip(tmon.events("comm")) == strip(jmon.events("comm"))
        assert len(tmon.events("comm")) == 2
        assert tmon.summary()["comm"] == jmon.summary()["comm"]
        assert "comm_e" in tst and "comm_e" in jst
        # the residuals agree but where a last-bit difference of the
        # gradient moved an element across an int8 rounding boundary
        d = np.abs(tst["comm_e"].numpy() - np.asarray(jst["comm_e"]))
        assert (d > 1e-6).mean() < 1e-3

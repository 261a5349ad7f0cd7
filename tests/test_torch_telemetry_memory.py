"""Port parity for the memory ledger (paddle_tpu_torch/telemetry_memory.py,
the engines' ``attach_memory`` and the tiered store's ``_sync_memory``):
the cases of the reference's ``tests/test_telemetry_memory.py`` on the
port, and its census against the JAX one.

The port's census walks the live tensors of the ledger's device once,
counts each storage once (views dedupe) and classifies it against the
registered trees; the rest is ``other``.  For the same tiny engine the
``params`` and ``kv_pages`` bytes must EQUAL the JAX ``MemoryLedger``'s
(tolerance: 0 bytes), and the store's DRAM and disk tiers must follow a
demote and a restore through the port's ``TieredKVStore`` exactly as the
JAX ledger follows the JAX store's.  Left out: the reference's
``ops_server`` endpoint and ``faults``-injection cases (no counterpart
module in the port yet, ROADMAP A6b).  Models: two layers at width 64,
vocabulary 256, fp32."""

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.kv_store import TieredKVStore as JStore
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPaged
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
from paddle_tpu.telemetry_memory import MemoryLedger as JLedger
import paddle_tpu_torch.optimizer as TO
from paddle_tpu_torch import telemetry_memory as tm
from paddle_tpu_torch.kv_store import KVPage, TieredKVStore
from paddle_tpu_torch.models.gpt import (GPTConfig, make_gpt_train_step,
                                         params_from_numpy)
from paddle_tpu_torch.serving import ContinuousBatchingEngine
from paddle_tpu_torch.serving_paged import (PagedContinuousBatchingEngine,
                                            RaggedPagedContinuousBatchingEngine)
from paddle_tpu_torch.telemetry import Tracer, TrainMonitor
from paddle_tpu_torch.telemetry_memory import (MemoryLedger, account_bytes,
                                               current_memory_ledger)

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            initializer_range=0.3, compute_dtype="float32")
ENGINE = dict(max_slots=2, max_len=32, prompt_buckets=[16], block_size=8)


def _pair():
    paddle.seed(3)
    jm = JModel(JConfig(**TINY))
    params = {n: p._data for n, p in jm.named_parameters()}
    state = {n: np.asarray(v) for n, v in params.items()}
    return jm, params, params_from_numpy(state, GPTConfig(**TINY),
                                         device="cpu")


class TestCensusVsReference:
    def test_params_and_kv_pages_equal_the_jax_census(self):
        """One ragged engine a package, a ledger attached to each: the
        census's ``params`` and ``kv_pages`` bytes are equal (tolerance:
        0), and equal the parameters' and pools' own bytes."""
        jm, params, tmod = _pair()
        jeng = JRagged(jm, params, **ENGINE)
        teng = RaggedPagedContinuousBatchingEngine(tmod, device="cpu",
                                                   **ENGINE)
        jml, tml = JLedger(), MemoryLedger()
        jeng.attach_memory(jml)
        teng.attach_memory(tml)
        jc, tc = jml.census(), tml.census()
        for pool in ("params", "kv_pages"):
            assert tc["pools"][pool] == jc["pools"][pool], pool
        assert tc["pools"]["params"] == sum(
            p.numel() * p.element_size() for p in tmod.parameters())
        assert tc["pools"]["kv_pages"] == sum(
            t.numel() * t.element_size() for t in teng.caches)
        assert sum(tc["pools"].values()) == tc["total_bytes"]
        assert tc["allocated_bytes"] is None           # no card
        m = teng.metrics()
        assert m["memory_device_bytes"] == float(tc["total_bytes"])
        assert "memory_host_bytes" in m
        assert "paddle_tpu_serving_memory_device_bytes" \
            in teng.prometheus_text()

    def test_tiers_follow_demote_and_restore(self, tmp_path):
        """The active ledger's DRAM/disk tiers track the store through a
        demotion (``flush_prefix``), a spill to disk and a restore — the
        same bytes as the JAX ledger over the JAX store (exact)."""
        jm, params, tmod = _pair()
        prompt = list(range(3, 17))
        snaps = []
        for side in ("jax", "port"):
            led = JLedger() if side == "jax" else MemoryLedger()
            with led:
                if side == "jax":
                    store = JStore(dram_capacity_bytes=9000,
                                   disk_dir=str(tmp_path / side))
                    eng = JPaged(jm, params, enable_prefix_cache=True,
                                 kv_store=store, **ENGINE)
                else:
                    store = TieredKVStore(dram_capacity_bytes=9000,
                                          disk_dir=str(tmp_path / side))
                    eng = PagedContinuousBatchingEngine(
                        tmod, device="cpu", enable_prefix_cache=True,
                        kv_store=store, **ENGINE)
                seen = []
                for other in (False, True):
                    eng.add_request(prompt, 3)
                    eng.run_to_completion()
                    eng.flush_prefix()
                    seen.append(led.memory_snapshot()["kv_tiers"])
                    if other:     # a different prompt spills to disk
                        eng.add_request([9] + prompt[1:], 3)
                        eng.run_to_completion()
                        eng.flush_prefix()
                        seen.append(led.memory_snapshot()["kv_tiers"])
                eng.add_request(prompt, 3)       # restores from the store
                eng.run_to_completion()
                seen.append(led.memory_snapshot()["kv_tiers"])
                assert seen[-1]["dram"]["bytes"] == store._dram_bytes
                assert seen[-1]["disk"]["bytes"] == store._disk_bytes
                assert eng.metrics()["kvstore_restored_blocks"] >= 1
            snaps.append([{t: v for t, v in s.items() if t != "hbm"}
                          for s in seen])
        assert snaps[1] == snaps[0]
        assert any(s["disk"]["bytes"] > 0 for s in snaps[1])


class TestConservation:
    def test_sum_of_pools_equals_census_total(self):
        ml = MemoryLedger()
        params = {"w": torch.ones(64, 64), "b": torch.ones(64)}
        stray = torch.ones(32, 32)          # deliberately unregistered
        ml.register_tree("params", params)
        walk = ml.census()
        assert sum(walk["pools"].values()) == walk["total_bytes"]
        assert walk["pools"]["params"] == (64 * 64 + 64) * 4
        assert walk["pools"]["other"] >= stray.numel() * 4
        snap = ml.memory_snapshot()
        assert sum(p["device_bytes"] for p in snap["pools"].values()) \
            == snap["totals"]["device_bytes"]

    def test_views_count_once(self):
        """A tree holding a tensor and views of it registers one storage;
        an unregistered view of a registered tensor stays in its pool."""
        ml = MemoryLedger()
        w = torch.ones(16, 16)
        ml.register_tree("params", {"w": w, "rows": [w[0], w[1:3]]})
        stray_view = w.view(-1)
        walk = ml.census()
        assert walk["pools"]["params"] == 16 * 16 * 4
        assert walk["logical"]["params"] == 16 * 16 * 4
        del stray_view

    def test_reregistration_replaces_and_unregister_demotes(self):
        ml = MemoryLedger()
        a = torch.ones(16, 16)
        ml.register_tree("params", {"a": a}, name="t")
        assert ml.census()["pools"]["params"] == a.numel() * 4
        ml.unregister_tree("t")
        walk = ml.census()
        assert walk["pools"]["params"] == 0
        assert walk["pools"]["other"] >= a.numel() * 4

    def test_register_train_state_key_table(self):
        ml = MemoryLedger()
        state = {"params": {"w": torch.ones(8)},
                 "opt": {"m": torch.ones(8)},
                 "comm_e": torch.ones(4)}
        ml.register_train_state(state, name="s")
        walk = ml.census()
        assert walk["pools"]["params"] == 32
        assert walk["pools"]["optimizer_state"] == 32
        assert walk["pools"]["grads_comm_buffers"] == 16
        ml.register_train_state({"params": state["params"],
                                 "opt": state["opt"]}, name="s")
        assert ml.census()["pools"]["grads_comm_buffers"] == 0

    def test_rejects_other_and_unknown_pools(self):
        ml = MemoryLedger()
        with pytest.raises(ValueError, match="unknown pool"):
            ml.register_tree("other", {})
        with pytest.raises(ValueError, match="unknown pool"):
            ml.account("nope", 1)
        with pytest.raises(ValueError, match="unknown kv tier"):
            ml.account("kv_pages", 1, tier="l2")


class TestWatermarks:
    def test_peaks_are_monotone_and_ring_records_crossings(self):
        ml = MemoryLedger()
        ml.account("executables", 1000)
        ml.account("executables", -600)
        ml.account("executables", 100)
        snap = ml.memory_snapshot()
        assert snap["pools"]["executables"]["host_bytes"] == 500
        assert snap["pools"]["executables"]["host_peak_bytes"] == 1000
        ml.account("executables", 5000)
        snap2 = ml.memory_snapshot()
        assert snap2["pools"]["executables"]["host_peak_bytes"] == 5500
        assert snap2["totals"]["host_peak_bytes"] >= \
            snap["totals"]["host_peak_bytes"]
        assert snap2["watermarks"]
        for ev in snap2["watermarks"]:
            assert ev["bytes"] > ev["prev_bytes"]

    def test_release_below_zero_clamps_with_warning(self, caplog):
        ml = MemoryLedger()
        with caplog.at_level("WARNING"):
            ml.account("executables", -100)
        assert ml.memory_snapshot()["pools"]["executables"]["host_bytes"] \
            == 0
        assert any("below zero" in r.message for r in caplog.records)

    def test_watermark_and_census_emit_tracer_events(self):
        tr = Tracer()
        ml = MemoryLedger(tracer=tr)
        ml.account("kv_pages", 4096, tier="dram")
        ev = [e for e in tr.events() if e["kind"] == "memory"][0]
        assert ev["what"] == "watermark" and ev["pool"] == "kv_pages"
        ml.census()
        assert tr.events("memory")[-1]["what"] == "census"


class TestTiersAndSeams:
    def test_set_bytes_tiers_sum_into_kv_pool(self):
        ml = MemoryLedger()
        ml.set_bytes("kv_pages", 1000, tier="dram")
        ml.set_bytes("kv_pages", 300, tier="disk")
        ml.set_bytes("kv_pages", 700, tier="dram")
        snap = ml.memory_snapshot()
        assert snap["kv_tiers"]["dram"]["bytes"] == 700
        assert snap["kv_tiers"]["dram"]["peak_bytes"] == 1000
        assert snap["kv_tiers"]["disk"]["bytes"] == 300
        assert snap["pools"]["kv_pages"]["host_bytes"] == 1000

    def test_kv_store_mutations_resync_tier_bytes(self):
        ml = MemoryLedger()
        with ml:
            st = TieredKVStore(dram_capacity_bytes=1 << 20)
            pg = KVPage(b"k" * 32, (np.ones((64,), np.float32),), ["m"])
            st.put(pg)
            assert ml.memory_snapshot()["kv_tiers"]["dram"]["bytes"] \
                == pg.nbytes
            st.drop(pg.chain)
            snap = ml.memory_snapshot()["kv_tiers"]["dram"]
            assert snap["bytes"] == 0 and snap["peak_bytes"] == pg.nbytes

    def test_kv_store_without_ledger_accounts_nothing(self):
        assert current_memory_ledger() is None
        st = TieredKVStore(dram_capacity_bytes=1 << 20)
        st.put(KVPage(b"q" * 32, (np.ones((8,), np.float32),), ["m"]))
        assert st.lookup(b"q" * 32, meta=["m"]) is not None

    def test_active_ledger_protocol(self):
        assert current_memory_ledger() is None
        ml = MemoryLedger()
        with ml:
            assert current_memory_ledger() is ml
            inner = MemoryLedger()
            with inner:
                assert current_memory_ledger() is inner
            assert current_memory_ledger() is ml
        assert current_memory_ledger() is None
        account_bytes("executables", 123)    # no active ledger: a no-op
        assert ml.memory_snapshot()["pools"]["executables"]["host_bytes"] \
            == 0

    def test_allocator_stats_empty_on_cpu(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        assert tm.device_allocator_stats() == {}

    def test_allocator_key_map(self, monkeypatch):
        """The CUDA allocator's keys under the reference's names."""
        raw = {"allocated_bytes.all.current": 10,
               "allocated_bytes.all.peak": 30,
               "reserved_bytes.all.current": 64,
               "reserved_bytes.all.peak": 128,
               "allocation.all.allocated": 7, "num_ooms": 0}

        class Props:
            total_memory = 1 << 30

        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
        monkeypatch.setattr(torch.cuda, "memory_stats", lambda i: raw)
        monkeypatch.setattr(torch.cuda, "get_device_properties",
                            lambda i: Props)
        assert tm.device_allocator_stats(0) == {
            "bytes_in_use": 10, "peak_bytes_in_use": 30,
            "bytes_reserved": 64, "peak_bytes_reserved": 128,
            "num_allocs": 7, "bytes_limit": 1 << 30}
        assert tm.device_allocator_stats(1) == {}


class TestExports:
    def test_prometheus_round_trip_preserves_conservation(self):
        ml = MemoryLedger()
        ml.register_tree("params", {"w": torch.ones(32, 32)})
        ml.census()
        ml.account("executables", 2048)
        gauges = {}
        for line in ml.prometheus_text().splitlines():
            if line.startswith("#") or not line.strip():
                continue
            name, val = line.rsplit(" ", 1)
            gauges[name] = float(val)
        total = gauges["paddle_tpu_memory_total_device_bytes"]
        summed = sum(v for k, v in gauges.items()
                     if k.endswith("_device_bytes")
                     and not k.endswith("peak_bytes")
                     and "total" not in k and "kv_" not in k)
        assert summed == total
        assert gauges["paddle_tpu_memory_executables_host_bytes"] == 2048
        assert gauges["paddle_tpu_memory_census_runs_total"] == 1

    def test_chrome_counters_one_track_per_space(self):
        ml = MemoryLedger()
        ml.account("executables", 100)
        ml.register_tree("params", {"w": torch.ones(8)})
        ml.census()
        counters = [e for e in ml.to_chrome_counters() if e.get("ph") == "C"]
        assert counters
        assert {e["name"] for e in counters} <= {"device_memory_bytes",
                                                 "host_memory_bytes"}
        offline = tm.chrome_counters_from_memory_dump(ml.to_dict())
        assert [e for e in offline if e.get("ph") == "C"] == counters

    def test_forensics_names_largest_storages_with_paths(self):
        ml = MemoryLedger()
        big = {"w": torch.ones(512, 512)}
        ml.register_tree("params", big, name="model")
        ml.census()
        f = ml.forensics()
        named = [r for r in f["largest_arrays"] if r["pool"] == "params"]
        assert named and named[0]["path"] == "['w']"
        assert named[0]["shape"] == [512, 512]
        assert named[0]["dtype"] == "float32"
        assert f["top_pools"] and f["allocator"] == {}


class TestTrainerSeam:
    def test_monitored_steps_reregister_state(self):
        """With an active ledger the monitored GPT step re-registers its
        state after every call: params and optimizer slots classify."""
        _, _, tmod = _pair()
        with MemoryLedger() as ml:
            step, st = make_gpt_train_step(tmod, TO.AdamW(1e-3),
                                           remat=False,
                                           monitor=TrainMonitor())
            x = torch.zeros(2, 8, dtype=torch.long)
            for i in range(2):
                st, _ = step(st, i, 1e-3, x, x)
            walk = ml.census()
        assert walk["pools"]["params"] == sum(
            p.numel() * 4 for p in tmod.parameters())
        assert walk["pools"]["optimizer_state"] > 0

    def test_engine_memory_keys_are_conditional(self):
        _, _, tmod = _pair()
        eng = ContinuousBatchingEngine(tmod, max_slots=2, max_len=32,
                                       device="cpu")
        assert eng._memory is None
        assert "memory_device_bytes" not in eng.metrics()
        ml = MemoryLedger()
        eng.attach_memory(ml)
        ml.census()
        m = eng.metrics()
        assert m["memory_device_bytes"] > 0 and "memory_host_bytes" in m

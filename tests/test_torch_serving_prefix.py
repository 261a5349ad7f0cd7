"""Port parity for the prefix cache (paddle_tpu_torch/serving_paged.py):
the cases of the reference's own prefix-cache tests, each run through the
port's bucketed paged engine and its ragged engine and through the JAX
engine of the same kind on the same weights and the same requests.  The
streams must be equal (and equal to solo ``generate()``), and so must
``prefix_hits``, ``prefix_blocks_reused`` and the allocator's counters;
the final pools agree within 4e-6 of their largest magnitude in fp32 (XLA
and PyTorch sum the CPU matmuls in other orders: 1.6e-6 is the largest
seen), and the int8 value planes exactly (their fp32 scale planes to the
same 4e-6), the trash block 0 left out."""

import gc

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPaged
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.serving_paged import (
    PagedContinuousBatchingEngine as TPaged,
    RaggedPagedContinuousBatchingEngine as TRagged)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX models when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            initializer_range=0.3, compute_dtype="float32")
ENGINES = {"paged": (JPaged, TPaged), "ragged": (JRagged, TRagged)}
LONG = list(range(3, 17))                     # 14 tokens -> bucket 16, pad 2
KINDS = pytest.mark.parametrize("kind", ["paged", "ragged"])


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: the
    suite runs six workers on the cores, and a worker spreading small
    ops over every core spends its time in OpenMP's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(**extra):
    paddle.seed(11)
    kw = dict(TINY, **extra)
    jm = JModel(JConfig(**kw))
    params = {n: p._data for n, p in jm.named_parameters()}
    state = {n: np.asarray(v) for n, v in params.items()}
    return (jm, params), params_from_numpy(state, GPTConfig(**kw),
                                           device="cpu")


@pytest.fixture(scope="module")
def fp32_pair():
    return _pair()


@pytest.fixture(scope="module")
def int8_pair():
    return _pair(kv_cache_dtype="int8")


def _engines(kind, pair, **kw):
    base = dict(max_slots=2, max_len=64, block_size=4, prompt_buckets=[16],
                enable_prefix_cache=True)
    base.update(kw)
    (jm, params), tm = pair
    return (ENGINES[kind][0](jm, params, **base),
            ENGINES[kind][1](tm, device="cpu", **base))


def _solo(pair, prompt, n):
    (jm, params), tm = pair
    want = np.asarray(jm.generate(params, jnp.asarray([prompt], jnp.int32),
                                  n))[0].tolist()
    assert tm.generate([prompt], n)[0].tolist() == want
    return want


def _run(eng, script):
    """``script``: a list of waves, each a list of (prompt, budget,
    steps to take after adding it); every wave runs to completion.
    Returns the streams in request order."""
    out = []
    for wave in script:
        rids = []
        for prompt, n, steps in wave:
            rids.append(eng.add_request(prompt, n))
            for _ in range(steps):
                eng.step()
        got = eng.run_to_completion(max_ticks=500)
        out += [got[r] for r in rids]
    return out


def _both(kind, pair, script, **kw):
    jeng, teng = _engines(kind, pair, **kw)
    want = _run(jeng, script)
    got = _run(teng, script)
    assert got == want
    for name in ("prefix_hits", "prefix_blocks_reused", "preemptions",
                 "blocks_high_water", "blocks_in_use"):
        assert getattr(teng, name) == getattr(jeng, name), name
    tm, jm_ = teng.metrics(), jeng.metrics()
    for name in ("blocks_allocated", "blocks_released", "blocks_cached"):
        assert tm[name] == jm_[name], name
    assert tm["blocks_allocated"] == tm["blocks_released"] > 0
    assert teng.blocks_in_use == len(teng._prefix_cache)
    assert all(teng._refs[b] == 0 for b in teng._prefix_cache.values())
    _same_pools(teng, jeng)
    return got, teng


def _same_pools(teng, jeng):
    for tc, jc in zip(teng.caches, jeng.caches):
        tc = tc if isinstance(tc, tuple) else (tc,)
        jc = jc if isinstance(jc, tuple) else (jc,)
        for tp, jp in zip(tc, jc):
            got = tp.float().numpy()[:, 1:]
            want = np.asarray(jp, np.float32)[:, 1:]
            if tp.dtype.is_floating_point:
                scale = max(float(np.abs(want).max()), 1.0)
                assert np.abs(got - want).max() <= 4e-6 * scale
            else:
                np.testing.assert_array_equal(got, want)


class TestPrefixCache:
    @KINDS
    def test_identical_prompt_hits_and_stays_lossless(self, fp32_pair,
                                                      kind):
        got, eng = _both(kind, fp32_pair, [[(LONG, 6, 0)], [(LONG, 6, 0)]])
        assert got[0] == got[1] == _solo(fp32_pair, LONG, 6)
        # bucket 16 / bs 4 -> 4 prompt blocks, the hit capped at 3
        assert eng.prefix_hits == 1 and eng.prefix_blocks_reused == 3
        assert eng.prefix_match(LONG) == {"hbm": 3, "total": 3,
                                          "tiers": ["hbm"] * 3}
        assert len(eng.prefix_index()) == 4

    @KINDS
    def test_common_prefix_same_length_shares(self, fp32_pair, kind):
        """The first 8 tokens shared; after the pad of 2, blocks 0-1
        match."""
        a = [7] * 2 + list(range(20, 32))
        b = a[:8] + list(range(70, 76))
        got, eng = _both(kind, fp32_pair, [[(a, 5, 0)], [(b, 5, 0)]])
        assert got[1] == _solo(fp32_pair, b, 5)
        assert eng.prefix_hits == 1 and eng.prefix_blocks_reused == 2

    @KINDS
    def test_different_pad_does_not_collide(self, fp32_pair, kind):
        a = list(range(5, 19))                 # len 14, pad 2
        b = list(range(5, 18))                 # len 13, pad 3
        got, eng = _both(kind, fp32_pair, [[(a, 5, 0)], [(b, 5, 0)]])
        assert got[1] == _solo(fp32_pair, b, 5)
        assert eng.prefix_hits == 0

    @KINDS
    def test_concurrent_sharing_and_refcounts(self, fp32_pair, kind):
        """Both slots decode over SHARED prompt blocks: retiring one must
        not free what the other reads; the cached blocks linger, every
        pin released."""
        got, eng = _both(kind, fp32_pair, [[(LONG, 4, 2), (LONG, 12, 0)]])
        assert got == [_solo(fp32_pair, LONG, 4), _solo(fp32_pair, LONG, 12)]
        assert eng.prefix_hits == 1
        assert eng.metrics()["blocks_cached"] > 0

    @KINDS
    def test_eviction_under_pressure(self, fp32_pair, kind):
        prompts = [list(range(i, i + 14)) for i in (3, 20, 40, 60)]
        got, eng = _both(kind, fp32_pair, [[(p, 4, 0) for p in prompts]],
                         num_blocks=8)
        for p, g in zip(prompts, got):
            assert g == _solo(fp32_pair, p, 4)
        assert eng.blocks_high_water <= 8

    @KINDS
    def test_preempted_request_rehits_its_own_prefix(self, fp32_pair,
                                                     kind):
        a, b = LONG, list(range(50, 64))
        got, eng = _both(kind, fp32_pair, [[(a, 24, 0), (b, 24, 0)]],
                         num_blocks=12, max_len=48)
        assert got == [_solo(fp32_pair, a, 24), _solo(fp32_pair, b, 24)]
        assert eng.preemptions >= 1 and eng.prefix_hits >= 1

    @KINDS
    def test_int8_pools(self, int8_pair, kind):
        got, eng = _both(kind, int8_pair, [[(LONG, 6, 0)], [(LONG, 6, 0)]])
        assert eng.prefix_hits == 1
        assert got[1] == _solo(int8_pair, LONG, 6)

    def test_chunked_admission_takes_the_suffix(self, fp32_pair):
        """A warm hit whose suffix fits one chunk skips chunked
        admission; the hit runs through the chunk path."""
        got, eng = _both("paged", fp32_pair,
                         [[(LONG, 5, 0)], [(LONG, 5, 0)]], prefill_chunk=4)
        assert got[0] == got[1] and eng.prefix_hits == 1

    @KINDS
    def test_flush_and_cancel_release_everything(self, fp32_pair, kind):
        """Cancel drops a live request's pins; ``flush_prefix`` then
        returns every cached block to the free list."""
        _, teng = _engines(kind, fp32_pair)
        teng.add_request(LONG, 6)
        teng.run_to_completion(max_ticks=100)
        rid = teng.add_request(LONG, 20)
        teng.step()
        teng.step()
        assert teng.prefix_hits == 1
        assert teng.flush_prefix() == 1        # the hit pins the other 3
        assert teng.cancel(rid)
        assert teng.blocks_in_use == len(teng._prefix_cache) == 3
        assert teng.flush_prefix() == 3
        m = teng.metrics()
        assert teng.blocks_in_use == 0 and teng.prefix_index() == {}
        assert m["blocks_allocated"] == m["blocks_released"]

    def test_kv_store_needs_the_prefix_cache(self, fp32_pair):
        """The reference's ValueError, word for word, on both engines."""
        (jm, params), tm = fp32_pair
        for jcls, tcls in ENGINES.values():
            msgs = []
            for make in (lambda: jcls(jm, params, max_slots=1, max_len=32,
                                      block_size=4, kv_store=object()),
                         lambda: tcls(tm, device="cpu", max_slots=1,
                                      max_len=32, block_size=4,
                                      kv_store=object())):
                with pytest.raises(ValueError,
                                   match="enable_prefix_cache") as e:
                    make()
                msgs.append(str(e.value))
            assert msgs[0] == msgs[1]

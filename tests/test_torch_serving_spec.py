"""Port parity for speculative decoding inside the ragged pack
(paddle_tpu_torch/serving_paged.py): the cases of the reference's own
speculative-engine tests, on the port's ragged engine with a draft and on
its two deprecated shims, against the JAX engines of the same kind on the
same weights.  Streams must be equal to JAX's and to solo ``generate()``
(the greedy contract; over int8 pools, to the plain engine), and
``spec_rounds``, ``tokens_drafted`` and ``tokens_accepted`` equal to
JAX's.  The draft is the target's first
layer alone (a draft that agrees with the target some of the time), or
the target itself (every proposal accepted)."""

import functools
import gc
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.serving import PagedSpeculativeBatchingEngine as JPagedSpec
from paddle_tpu.serving import SpeculativeBatchingEngine as JSpec
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.serving_paged import (
    PagedSpeculativeBatchingEngine as TPagedSpec,
    RaggedPagedContinuousBatchingEngine as TRagged,
    SpeculativeBatchingEngine as TSpec)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX models when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    _models.cache_clear()
    _solo_of.cache_clear()
    gc.collect()

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            initializer_range=0.3, compute_dtype="float32")
REQS = [([5, 17, 3], 10), ([40, 2], 6), ([61], 8), ([9, 9, 1], 7)]
LONG = list(range(3, 17))


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: the
    suite runs six workers on the cores, and a worker spreading small
    ops over every core spends its time in OpenMP's barriers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@functools.lru_cache(maxsize=None)
def _models(kv=None):
    """(jax target, params, jax draft, draft params, port target, port
    draft): the draft is the target's first layer."""
    paddle.seed(11)
    cfg = dict(TINY, kv_cache_dtype=kv)
    jm = JModel(JConfig(**cfg))
    params = {n: p._data for n, p in jm.named_parameters()}
    state = {n: np.asarray(v) for n, v in params.items()}
    dstate = {n: (v[:1] if n.startswith("blocks_") else v)
              for n, v in state.items()}
    dcfg = dict(cfg, num_layers=1)
    jd = JModel(JConfig(**dcfg))
    dparams = {n: jnp.asarray(dstate[n]) for n, _ in jd.named_parameters()}
    return (jm, params, jd, dparams,
            params_from_numpy(state, GPTConfig(**cfg), device="cpu"),
            params_from_numpy(dstate, GPTConfig(**dcfg), device="cpu"))


def _solo(p, n, kv=None):
    return list(_solo_of(tuple(p), n, kv))


@functools.lru_cache(maxsize=None)
def _solo_of(p, n, kv):
    """Solo greedy ``generate()`` of prompt ``p`` for ``n`` tokens, JAX's
    and the port's equal; each prompt and length runs once a module."""
    jm, params, _, _, tm, _ = _models(kv)
    want = np.asarray(jm.generate(params, jnp.asarray([list(p)], jnp.int32),
                                  n))[0].tolist()
    assert tm.generate([list(p)], n)[0].tolist() == want
    return tuple(want)


def _drive(eng, reqs, steps_after=()):
    rids = []
    for i, (p, n) in enumerate(reqs):
        rids.append(eng.add_request(p, n))
        if i in steps_after:
            eng.step()
    got = eng.run_to_completion(max_ticks=600)
    return [got[r] for r in rids]


def _same_counters(teng, jeng):
    for name in ("spec_rounds", "tokens_drafted", "tokens_accepted",
                 "ragged_steps", "preemptions", "prefix_hits",
                 "blocks_high_water"):
        assert getattr(teng, name) == getattr(jeng, name), name
    m = teng.metrics()
    assert m["blocks_allocated"] == m["blocks_released"] > 0
    assert teng.blocks_in_use == len(teng._prefix_cache)


def _ragged(kv=None, perfect=False, **kw):
    jm, params, jd, dparams, tm, td = _models(kv)
    if perfect:
        jd, dparams, td = jm, params, tm
    return (JRagged(jm, params, draft_model=jd, draft_params=dparams, **kw),
            TRagged(tm, draft_model=td, device="cpu", **kw))


def _shims(cls_pair, kv=None, **kw):
    jm, params, jd, dparams, tm, td = _models(kv)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return (cls_pair[0](jm, params, jd, dparams, **kw),
                cls_pair[1](tm, td, device="cpu", **kw))


class TestRaggedSpeculation:
    @pytest.mark.parametrize("K", [1, 4])
    def test_lossless_vs_solo(self, K):
        """Mixed budgets through 2 slots (retirement, reuse, rollback):
        every stream equals solo greedy, and the rounds and acceptance
        equal JAX's."""
        jeng, teng = _ragged(max_slots=2, max_len=48, draft_k=K,
                             prompt_buckets=[8], block_size=4)
        want = _drive(jeng, REQS)
        got = _drive(teng, REQS)
        assert got == want == [_solo(p, n) for p, n in REQS]
        _same_counters(teng, jeng)
        assert 0 < teng.tokens_accepted < teng.tokens_drafted
        assert teng.metrics()["acceptance_rate"] == teng.acceptance_rate

    def test_perfect_draft_takes_the_fewest_rounds(self):
        K, N = 3, 13
        jeng, teng = _ragged(perfect=True, max_slots=1, max_len=48,
                             draft_k=K, prompt_buckets=[8], block_size=4)
        reqs = [([5, 17, 3], N)]
        assert _drive(teng, reqs) == _drive(jeng, reqs) \
            == [_solo([5, 17, 3], N)]
        assert teng.spec_rounds == -(-(N - 1) // (K + 1))
        assert teng.acceptance_rate == 1.0
        _same_counters(teng, jeng)

    def test_spec_opt_out_and_plain_rows_share_steps(self):
        jeng, teng = _ragged(max_slots=2, max_len=48, draft_k=2,
                             prompt_buckets=[8], block_size=4)
        got = []
        for eng in (jeng, teng):
            r0 = eng.add_request(*REQS[0], spec=False)
            r1 = eng.add_request(*REQS[1])
            out = eng.run_to_completion(max_ticks=300)
            got.append([out[r0], out[r1]])
        assert got[0] == got[1] == [_solo(*REQS[0]), _solo(*REQS[1])]
        _same_counters(teng, jeng)

    def test_int8_pools(self):
        """int8 target AND draft pools through the shared tables.  The
        oracle is the plain engine on the same pools: solo ``generate()``
        attends its prompt unquantized, so an int8 serve may leave it."""
        kw = dict(max_slots=2, max_len=48, prompt_buckets=[8], block_size=8)
        jeng, teng = _ragged(kv="int8", draft_k=2, **kw)
        want = _drive(jeng, REQS[:3])
        plain = _drive(TRagged(_models("int8")[4], device="cpu", **kw),
                       REQS[:3])
        assert _drive(teng, REQS[:3]) == want == plain
        _same_counters(teng, jeng)


class TestShims:
    @pytest.mark.parametrize("K", [1, 4])
    def test_lossless_vs_solo_and_each_other(self, K):
        kw = dict(max_slots=2, max_len=48, draft_k=K, prompt_buckets=[8])
        jp, tp = _shims((JPagedSpec, TPagedSpec), block_size=4, **kw)
        jc, tc = _shims((JSpec, TSpec), **kw)
        want = [_solo(p, n) for p, n in REQS]
        for jeng, teng in ((jp, tp), (jc, tc)):
            assert _drive(jeng, REQS) == want
            assert _drive(teng, REQS) == want
            _same_counters(teng, jeng)
        assert tp.rounds == tc.rounds == jp.rounds

    def test_tight_pool_preempts_and_stays_exact(self):
        jeng, teng = _shims((JPagedSpec, TPagedSpec), max_slots=2,
                            max_len=48, draft_k=2, prompt_buckets=[8],
                            block_size=4, num_blocks=10)
        reqs = [([5, 17, 3], 24), ([40, 2], 24)]
        assert _drive(teng, reqs) == _drive(jeng, reqs) \
            == [_solo(p, n) for p, n in reqs]
        assert teng.preemptions >= 1 and teng.blocks_high_water <= 10
        _same_counters(teng, jeng)

    def test_prefix_hit_keeps_the_acceptance_schedule(self):
        """A cached prompt block holds BOTH models' k/v: a warm hit is
        lossless and takes as many rounds as the cold run."""
        jeng, teng = _shims((JPagedSpec, TPagedSpec), max_slots=2,
                            max_len=48, draft_k=2, prompt_buckets=[16],
                            block_size=4, enable_prefix_cache=True)
        for eng in (jeng, teng):
            assert _drive(eng, [(LONG, 8)]) == [_solo(LONG, 8)]
            cold = eng.rounds
            assert _drive(eng, [(LONG, 8)]) == [_solo(LONG, 8)]
            assert eng.prefix_hits == 1 and eng.prefix_blocks_reused == 3
            assert eng.rounds == 2 * cold
        _same_counters(teng, jeng)

    def test_concurrent_sharing_with_speculation(self):
        a = [7] * 2 + list(range(20, 32))
        b = a[:8] + list(range(70, 76))
        jeng, teng = _shims((JPagedSpec, TPagedSpec), max_slots=2,
                            max_len=48, draft_k=2, prompt_buckets=[16],
                            block_size=4, enable_prefix_cache=True)
        reqs = [(a, 6), (b, 10)]
        assert _drive(teng, reqs, steps_after=(0,)) \
            == _drive(jeng, reqs, steps_after=(0,)) \
            == [_solo(a, 6), _solo(b, 10)]
        assert teng.prefix_blocks_reused == 2
        _same_counters(teng, jeng)

    def test_int8_dual_pool_prefix(self):
        jeng, teng = _shims((JPagedSpec, TPagedSpec), kv="int8",
                            max_slots=2, max_len=48, draft_k=2,
                            prompt_buckets=[16], block_size=8,
                            enable_prefix_cache=True)
        reqs = [(LONG, 6)]
        got = []
        for eng in (jeng, teng):
            cold = _drive(eng, reqs)
            assert _drive(eng, reqs) == cold      # the warm hit
            got.append(cold)
        assert got[0] == got[1]
        assert teng.prefix_hits == 1
        _same_counters(teng, jeng)

    @pytest.mark.parametrize("prefix", [False, True])
    def test_chunked_prefix_and_speculation(self, prefix):
        """A long prompt fills over several steps while another request
        speculates; with the prefix cache on, the second identical prompt
        hits and keeps the cold run's round count."""
        kw = dict(max_slots=2, max_len=64, draft_k=2,
                  prompt_buckets=[4, 16] if not prefix else [16],
                  block_size=4, prefill_chunk=4,
                  enable_prefix_cache=prefix)
        jeng, teng = _shims((JPagedSpec, TPagedSpec), **kw)
        waves = ([[(LONG, 8)], [(LONG, 8)]] if prefix
                 else [[([40, 2], 20), (list(range(3, 19)), 8)]])
        for eng in (jeng, teng):
            for wave in waves:
                assert _drive(eng, wave) == [_solo(p, n) for p, n in wave]
        if prefix:
            assert teng.prefix_hits == 1
        _same_counters(teng, jeng)


class TestCancel:
    @pytest.mark.parametrize("paged", [False, True])
    def test_cancel_releases_shared_tables(self, paged):
        cls = (JPagedSpec, TPagedSpec) if paged else (JSpec, TSpec)
        extra = dict(block_size=4) if paged else {}
        jeng, teng = _shims(cls, max_slots=2, max_len=64, draft_k=2,
                            prompt_buckets=[8], **extra)
        outs = []
        for eng in (jeng, teng):
            sig = []
            r0 = eng.add_request([5, 17, 3], 20,
                                 on_token=lambda r, t, d: sig.append((t, d)))
            r1 = eng.add_request([40, 2], 6)
            eng.step()
            assert eng.cancel(r0)          # active mid-speculation
            assert sig[-1] == (None, True)
            got = eng.run_to_completion(max_ticks=200)
            assert sorted(got) == [r1]
            outs.append(got[r1])
            assert eng.metrics()["requests_cancelled"] == 1
        assert outs[0] == outs[1] == _solo([40, 2], 6)
        _same_counters(teng, jeng)
        assert teng.blocks_in_use == 0


class TestScopeGuards:
    def test_match_the_reference(self):
        jm, params, jd, dparams, tm, td = _models()
        base = dict(max_slots=2, max_len=48, prompt_buckets=[8],
                    block_size=4)
        for kw, err, match in [
                (dict(min_new_tokens=2, eos_token_id=3),
                 NotImplementedError, "min_new_tokens"),
                (dict(repetition_penalty=1.3), NotImplementedError,
                 "repetition_penalty"),
                (dict(greedy=False), NotImplementedError, "greedy-only"),
                (dict(per_request_sampling=True), NotImplementedError,
                 "per_request_sampling"),
                (dict(draft_k=0), ValueError, "draft_k")]:
            with pytest.raises(err, match=match):
                JRagged(jm, params, draft_model=jd, draft_params=dparams,
                        **base, **kw)
            with pytest.raises(err, match=match):
                TRagged(tm, draft_model=td, device="cpu", **base, **kw)
        with pytest.raises(NotImplementedError, match="prefill_chunk"):
            JSpec(jm, params, jd, dparams, max_slots=2, max_len=48,
                  prefill_chunk=4)
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", DeprecationWarning)
            with pytest.raises(NotImplementedError, match="prefill_chunk"):
                TSpec(tm, td, max_slots=2, max_len=48, prefill_chunk=4,
                      device="cpu")
        with pytest.raises(ValueError, match="spec=True"):
            TRagged(tm, device="cpu", **base).add_request([1], 4, spec=True)

    def test_draft_params_are_the_drafts_own(self):
        _, _, _, _, tm, td = _models()
        kw = dict(max_slots=1, max_len=48, block_size=4, device="cpu")
        TRagged(tm, draft_model=td, draft_params=td.state_dict(), **kw)
        with pytest.raises(ValueError, match="state_dict"):
            TRagged(tm, draft_model=td, draft_params=tm.state_dict(), **kw)

    def test_the_shims_warn(self):
        _, _, _, _, tm, td = _models()
        from paddle_tpu_torch import serving_paged
        serving_paged._SPEC_SHIM_WARNED.clear()
        with pytest.warns(DeprecationWarning, match="deprecated"):
            TSpec(tm, td, max_slots=1, max_len=48, device="cpu")

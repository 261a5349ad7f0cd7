"""Port parity for the serving engines' programs
(paddle_tpu_torch/jit/programs.py, serving.py, serving_paged.py): the cases
of the reference's engine-warmup tests on the port.  Each engine's
``compile_grid()`` must equal the JAX engine's for the same arguments,
letter for letter (the JAX grid's ``kvio`` left out: the tiered store is
not ported); ``warmup()`` must return the reference's report over that
grid; a warmed engine must serve with zero new program-cache misses and
the same streams as a cold port engine and the JAX engine; and warmup —
on the CPU each program's eager run on inert operands, the run that
precedes a capture on a card — must leave the live state as it was, mid-
serve too: pools outside trash block 0, presence, sampling planes, the
generator's state and every stat.  The models are two layers at width 64;
the draft is the target's first layer."""

import functools
import warnings

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
from paddle_tpu.jit.bucketing import pow2_grid as jax_pow2_grid
from paddle_tpu.models.gpt import GPTConfig as JConfig
from paddle_tpu.models.gpt import GPTModel as JModel
from paddle_tpu.serving import ContinuousBatchingEngine as JContiguous
from paddle_tpu.serving import PagedContinuousBatchingEngine as JPaged
from paddle_tpu.serving import PagedSpeculativeBatchingEngine as JPagedSpec
from paddle_tpu.serving import SpeculativeBatchingEngine as JSpec
from paddle_tpu.serving_paged import \
    RaggedPagedContinuousBatchingEngine as JRagged
from paddle_tpu_torch.jit.bucketing import pow2_grid
from paddle_tpu_torch.jit.programs import GraphProgram
from paddle_tpu_torch.models._decode import draw_categorical
from paddle_tpu_torch.models.gpt import GPTConfig, params_from_numpy
from paddle_tpu_torch.ops._build import note_launch
from paddle_tpu_torch.serving import ContinuousBatchingEngine as TContiguous
from paddle_tpu_torch.serving_paged import (
    PagedContinuousBatchingEngine as TPaged,
    PagedSpeculativeBatchingEngine as TPagedSpec,
    RaggedPagedContinuousBatchingEngine as TRagged,
    SpeculativeBatchingEngine as TSpec)

TINY = dict(vocab_size=256, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=128,
            initializer_range=0.3, compute_dtype="float32")
SHORT = [([5, 17, 3], 6), ([40, 2], 4), ([61], 5)]
# the last prompt takes bucket 16: two 8-token segments where chunked
LONG = SHORT + [(list(range(3, 14)), 5)]
BASE = dict(max_slots=2, max_len=32, prompt_buckets=[8, 16])

# kind -> (JAX class, port class, constructor kwargs, draft?, requests)
KINDS = {
    "ragged": (JRagged, TRagged,
               dict(BASE, block_size=8, token_budget=12), False, LONG),
    "ragged_spec": (JRagged, TRagged,
                    dict(BASE, block_size=8, token_budget=12, draft_k=2),
                    True, LONG),
    "paged": (JPaged, TPaged, dict(BASE, block_size=8, prefill_chunk=8),
              False, LONG),
    "contiguous": (JContiguous, TContiguous, dict(BASE, prefill_chunk=8),
                   False, LONG),
    "spec_shim": (JSpec, TSpec,
                  dict(max_slots=2, max_len=32, draft_k=2,
                       prompt_buckets=[8]), True, SHORT),
    "paged_spec_shim": (JPagedSpec, TPagedSpec,
                        dict(BASE, block_size=8, draft_k=2,
                             prefill_chunk=8), True, LONG),
}


@functools.lru_cache(maxsize=None)
def _models():
    """(jax target, params, jax draft, draft params, port target, port
    draft)."""
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
    jcls, tcls, kw, draft, _ = KINDS[kind]
    jm, params, jd, dparams, tm, td = _models()
    kw = dict(kw, **extra)
    shim = kind.endswith("_shim")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        if side == "jax":
            if shim:
                return jcls(jm, params, jd, dparams, **kw)
            if draft:
                kw.update(draft_model=jd, draft_params=dparams)
            return jcls(jm, params, **kw)
        if shim:
            return tcls(tm, td, device="cpu", **kw)
        if draft:
            kw.update(draft_model=td)
        return tcls(tm, device="cpu", **kw)


def _drive(eng, reqs, steps_before=None):
    """Queue every request and step to quiescence; ``steps_before=(n, f)``
    calls ``f()`` after the first n steps.  Returns the streams in request
    order."""
    rids = [eng.add_request(p, n) for p, n in reqs]
    step = 0
    while eng.pending():
        if steps_before is not None and step == steps_before[0]:
            steps_before[1]()
        eng.step()
        step += 1
    got = eng.pop_finished()
    return [got[r] for r in rids]


@functools.lru_cache(maxsize=None)
def _jax_streams(kind):
    return _drive(_engine(kind, "jax"), KINDS[kind][4])


@pytest.mark.parametrize("kind", list(KINDS))
def test_grid_matches_reference(kind):
    """The port's grid is the JAX engine's, letter for letter, without
    kvio; paged-engine grids hold one decode program per table width and
    the ragged grids one step program per width."""
    j, t = _engine(kind, "jax"), _engine(kind, "port")
    want = [lbl for lbl in j.compile_grid() if lbl != "kvio"]
    assert t.compile_grid() == want
    if kind in ("ragged", "ragged_spec", "paged", "paged_spec_shim"):
        j2 = _engine(kind, "jax", enable_prefix_cache=True)
        t2 = _engine(kind, "port", enable_prefix_cache=True)
        assert t2.compile_grid() == [lbl for lbl in j2.compile_grid()
                                     if lbl != "kvio"]
    if kind in ("ragged", "ragged_spec", "spec_shim", "paged_spec_shim"):
        name = "ragged_spec" if KINDS[kind][3] else "ragged_step"
        assert want == [f"{name}:{t.token_budget}:{C}"
                        for C in pow2_grid(t.MB)]
    if kind == "paged":
        assert want[-len(pow2_grid(t.MB)):] == [
            f"decode:{C}" for C in pow2_grid(t.MB)]


@pytest.mark.parametrize("kind", list(KINDS))
def test_warmed_engine_serves_cold_and_reference(kind):
    """THE acceptance assertions: the warmup report covers the grid in
    order, the served workload then adds zero program-cache misses, and
    the warmed engine's streams equal a cold port engine's and the JAX
    engine's."""
    reqs = KINDS[kind][4]
    cold = _drive(_engine(kind, "port"), reqs)
    assert cold == _jax_streams(kind)
    eng = _engine(kind, "port")
    report = eng.warmup()
    grid = eng.compile_grid()
    assert set(report) == {"programs", "wall_s", "tasks", "cache_dir"}
    assert report["programs"] == len(grid)
    assert [t["label"] for t in report["tasks"]] == grid
    assert report["cache_dir"] is None
    assert all(t["wall_s"] >= 0 for t in report["tasks"])
    misses = eng._compile_misses
    assert misses == len(grid)
    assert _drive(eng, reqs) == cold
    assert eng._compile_misses == misses
    m = eng.metrics()
    assert m["compile_misses"] == misses and m["compile_hits"] > 0


def _snapshot(eng):
    """Everything warmup must leave alone: pools outside trash block 0
    (contiguous caches whole), the draft's pools, presence, the sampling
    planes, the generator's state, every stat and the host clocks."""
    def planes(c):
        return [p.clone() for p in (c if isinstance(c, tuple) else (c,))]

    out = {}
    paged = hasattr(eng, "MB")
    for name in ("caches", "draft_caches"):
        for i, c in enumerate(getattr(eng, name, ())):
            for j, p in enumerate(planes(c)):
                out[f"{name}{i}.{j}"] = p[:, 1:] if paged else p
    if eng._presence is not None:
        out["presence"] = eng._presence.clone()
    if eng.per_request:
        out["planes"] = torch.from_numpy(eng._r_planes.copy())
        out["planes_dev"] = eng._planes_buf.clone()
    out["generator"] = eng.generator.get_state()
    for name in ("_t", "_tok", "_pad", "_active"):
        out[name] = torch.from_numpy(getattr(eng, name).copy())
    out["stats"] = dict(eng._stats._stats)
    return out


def _same(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if k == "stats":
            assert a[k] == b[k]
        else:
            assert torch.equal(a[k], b[k]), k


# sampled with a penalty through per-request planes where the engine
# allows it (speculation is greedy-only)
SAMPLED = dict(per_request_sampling=True, greedy=False, temperature=0.9,
               repetition_penalty=1.3,
               generator=None)


@pytest.mark.parametrize("kind", ["ragged", "paged", "contiguous",
                                  "ragged_spec"])
def test_warmup_mid_serve_leaves_live_state(kind):
    """A warmup between two steps of a serve leaves every piece of live
    state as it was, and the serve ends with the streams of a serve with
    no warmup — sampled draws included (the generator's state is
    restored)."""
    reqs = KINDS[kind][4]
    extra = {} if KINDS[kind][3] else SAMPLED

    def make():
        kw = dict(extra)
        if "generator" in kw:
            kw["generator"] = torch.Generator().manual_seed(5)
        return _engine(kind, "port", **kw)

    want = _drive(make(), reqs)
    eng = make()
    seen = {}

    def warm():
        seen["before"] = _snapshot(eng)
        eng.warmup()
        seen["after"] = _snapshot(eng)

    assert _drive(eng, reqs, steps_before=(3, warm)) == want
    _same(seen["before"], seen["after"])


def test_warmup_async_and_serving_meanwhile():
    """``warmup(block=False)`` returns a Future whose report matches the
    grid; requests served while it runs build what they need first, and
    every program is built once, whoever builds it."""
    reqs = KINDS["ragged"][4]
    want = _drive(_engine("ragged", "port"), reqs)
    eng = _engine("ragged", "port")
    fut = eng.warmup(block=False)
    got = _drive(eng, reqs)
    report = fut.result(timeout=120)
    grid = eng.compile_grid()
    assert got == want
    assert report["programs"] == len(grid)
    assert [t["label"] for t in report["tasks"]] == grid
    assert eng._compile_misses == len(grid)
    eng2 = _engine("contiguous", "port")
    report2 = eng2.warmup(block=False).result(timeout=120)
    assert [t["label"] for t in report2["tasks"]] == eng2.compile_grid()
    assert _drive(eng2, KINDS["contiguous"][4]) == _jax_streams("contiguous")
    assert eng2._compile_misses == len(eng2.compile_grid())


def test_warmup_arguments_the_port_cannot_honour_raise():
    eng = _engine("ragged", "port")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.warmup(cache_dir="/nonexistent")
    with pytest.raises(ValueError, match="ROADMAP"):
        eng.warmup(max_workers=2)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        eng.warmup(cache_dir="/nonexistent", block=False)
    assert eng._compile_misses == 0


def test_pow2_grid_is_the_reference():
    for cap in range(1, 70):
        assert pow2_grid(cap) == jax_pow2_grid(cap)
    with pytest.raises(ValueError):
        pow2_grid(0)


def test_draw_categorical_is_multinomial():
    """The sampler's draw is ``torch.multinomial``'s one-sample path
    written out: the same draws from the same generator state."""
    rng = np.random.RandomState(0)
    for seed in range(4):
        p = torch.softmax(torch.from_numpy(rng.randn(5, 97)) * 3, -1)
        p[:, :20] = 0
        a = torch.multinomial(p, 1, generator=torch.Generator()
                              .manual_seed(seed))[:, 0]
        b = draw_categorical(p, torch.Generator().manual_seed(seed))
        assert torch.equal(a, b)


def test_program_operands_and_launch_counting():
    """A CPU program runs its function on the packed operands (shapes
    checked); a launch outside a capture counts at once."""
    seen = []

    def fn(a, b):
        seen.append((a.clone(), b.clone()))
        return a.sum() + b.sum()

    prog = GraphProgram("p", fn, [(2, 3), (4,)],
                        [np.zeros((2, 3)), np.zeros(4)], device="cpu")
    prog.compile()
    assert seen[0][0].dtype == torch.int32 and seen[0][1].abs().sum() == 0
    out = prog(np.arange(6).reshape(2, 3), [1, 2, 3, 4])
    assert int(out) == 15 + 10
    assert seen[-1][0].shape == (2, 3)
    with pytest.raises(ValueError, match="elements"):
        prog(np.arange(5), [1, 2, 3, 4])

    def kernel():
        pass

    kernel.launches = 0
    note_launch(kernel)
    note_launch(kernel)
    assert kernel.launches == 2

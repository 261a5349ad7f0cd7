"""Port parity for ERNIE-MoE training over the expert (data) and model
axes (``paddle_tpu_torch/models/ernie_moe.py`` ``make_ernie_moe_train_step``
and ``make_sharded_ernie_moe_train_step`` with ``distributed/spmd.py``'s
mesh step) against the JAX package's jitted ``make_ernie_moe_train_step``
on its CPU mesh.

Arms (tiny ERNIE-MoE: vocab 128, H 64, 2 layers, 4 heads, 4 experts,
top-2, fp32, remat on, AdamW, B 4, L 16, 3 steps; experts overflow
their capacity): ep 2 (dp 2, two experts a rank), its sharded-init twin
and mp 2 on 2 gloo ranks; ep 4 and dp 2 × mp 2 on 4.
Each rank's losses and its parameter and slot shards (expert blocks
included) are held within 1e-4 relative (1e-5 absolute) of the
reference's losses and ``addressable_shards[r]``, as GPT's mesh arms are
(``tests/test_torch_gpt_tp.py``), but for parameter elements whose
gradient came under 1e-5 at some step, held to AdamW's 2·lr a step
(``_param_atol``).  The monitor counts each token once.  The
data's smallest gap between the first, second and third gate
probabilities over the three steps' routings (the reference's weights
before each step, routed by the port on one process) is held above 1e-5,
a hundred times the packages' fp32 difference.  Expert-sharded
checkpoints: the ep 2 ranks' ``CheckpointManager`` save loads bit-exact
in the reference's one-process manager, and the reference's save loads
bit-exact into each rank's shards.  The refusals that stay (a sep degree,
an expert axis the batch is not split over, a sharding degree beside the
expert axis, ZeRO with it) raise and name their ROADMAP item; a pipe
degree holds the pipe axis replicated.  The spawned ranks import this module, so it imports no JAX at its top.
"""

import datetime
import functools
import gc
import os
import pickle
import sys

import numpy as np
import pytest
import torch

from test_torch_dp import _close, _jshards, _np

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, num_experts=4, top_k=2,
            max_position_embeddings=32, initializer_range=0.2,
            compute_dtype="float32")
B, L, STEPS, LR = 4, 16, 3, 1e-3
TOL = (1e-4, 1e-5)
G_FLOOR = 1e-5      # the op tests' gradient tolerance (``_param_atol``)
GAP_MIN = 1e-5
EXPERTS = ("blocks_expert_w1", "blocks_expert_b1", "blocks_expert_w2",
           "blocks_expert_b2")

ARMS2 = {"ep2": {"dp_degree": 2}, "mp2": {"mp_degree": 2},
         "ep2_sharded": {"dp_degree": 2}}
ARMS4 = {"ep4": {"dp_degree": 4}, "dp2_mp2": {"dp_degree": 2, "mp_degree": 2}}
#: the reference arm each port arm is held against
REF = {"ep2_sharded": "ep2"}


def _batch():
    r = np.random.RandomState(0)
    return r.randint(0, 128, (B, L)), r.randint(0, 128, (B, L))


# ------------------------------------------------------- the port side --

def _port_arm(name, hc, init, tmp):
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models import ernie_moe as TE
    from paddle_tpu_torch.telemetry import TrainMonitor
    from paddle_tpu_torch.train_resilience import CheckpointManager
    import paddle_tpu_torch.optimizer as TO
    st = fleet.DistributedStrategy()
    st.hybrid_configs = hc
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    cfg = TE.ErnieMoeConfig(**TINY)
    mon = TrainMonitor()
    if name.endswith("_sharded"):
        step, state = TE.make_sharded_ernie_moe_train_step(
            cfg, TO.AdamW(LR), hcg, device="cpu", monitor=mon)
        # the reference draws its own initial weights: copy them in
        specs, mesh = step.layout.specs["params"], step.layout.mesh
        with torch.no_grad():
            for n, p in state["params"].items():
                p.copy_(local_shard(torch.from_numpy(init[n]), specs[n],
                                    mesh))
    else:
        m = TE.params_from_numpy(init, cfg, device="cpu")
        step, state = TE.make_ernie_moe_train_step(m, TO.AdamW(LR), hcg,
                                                   monitor=mon)
    x, y = (torch.tensor(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, LR, x, y)
        losses.append(float(loss))
    out = {"losses": losses, "state": _np(state),
           "mp_rank": hcg.get_model_parallel_rank(),
           "counted": [(e["examples"], e["tokens"])
                       for e in mon.events("train_step")],
           "state_bytes": per_device_state_bytes(state),
           "param_bytes": sum(p.numel() * 4
                              for p in state["params"].values()),
           "layout": step.layout.specs}
    if name == "ep2":
        CheckpointManager(os.path.join(tmp, "ck_ep2")).save(
            state, STEPS, shardings=step.layout)
    return out


def _rank_main(rank, world, tmp, arms):
    torch.set_num_threads(1)
    with np.load(os.path.join(tmp, "init.npz")) as f:
        init = dict(f)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {n: _port_arm(n, hc, init, tmp) for n, hc in arms.items()}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init, arms):
    """The ranks, started at once: the weights go through a file (a large
    argument would hold each start until the child reads its pipe)."""
    import torch.multiprocessing as mp
    np.savez(os.path.join(tmp, "init.npz"), **init)
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), arms),
                             nprocs=world, join=False, start_method="spawn")
    return ctx, world, tmp


def _finish(started):
    ctx, world, tmp = started
    while not ctx.join():
        pass
    out = []
    for r in range(world):
        with open(os.path.join(tmp, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out


# -------------------------------------------------------- the JAX side --

def _jax_hcg(hc):
    from paddle_tpu.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                         **hc}
    fleet.fleet.init(is_collective=True, strategy=st)
    return fleet.fleet.get_hybrid_communicate_group()


@functools.lru_cache(maxsize=None)
def _init():
    """The initial weights, the port's draw from seed 6 (the reference's
    own initializers would run eagerly, op by op).  Seed 5's draw puts two
    gate probabilities 3.8e-6 apart at the first step, under ``GAP_MIN``:
    the gap test below refuses such data rather than risk a near-tie."""
    from paddle_tpu_torch.models import ernie_moe as TE
    m = TE.ErnieMoeModel(TE.ErnieMoeConfig(**TINY), device="cpu",
                         generator=torch.Generator().manual_seed(6))
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The reference's model holding ``_init()``: built under
    ``jax.eval_shape`` (its initializers traced, not run; its RNG streams
    left as they were), once (its steps do not donate)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.models.ernie_moe import ErnieMoeConfig, ErnieMoeModel
    box, saved = [], jrng.get_rng_state()

    def build():
        box.append(ErnieMoeModel(ErnieMoeConfig(**TINY)))
        return 0

    try:
        jax.eval_shape(build)
    finally:
        jrng.set_rng_state(saved)
    for n, p in box[0].named_parameters():
        p._data = jnp.array(_init()[n], copy=True)
    return box[0]


@functools.lru_cache(maxsize=None)
def _jax_arm(name):
    import jax
    from paddle_tpu.models.ernie_moe import make_ernie_moe_train_step
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg({**ARMS2, **ARMS4}[name])
    step, state = make_ernie_moe_train_step(_jax_model(), AdamW(LR), hcg,
                                            remat=True, donate=False)
    x, y = _batch()
    losses, before, moments = [], [], []
    for _ in range(STEPS):
        before.append({n: np.asarray(jax.device_get(v))
                       for n, v in state["params"].items()})
        state, loss = step(state, np.float32(LR), x, y)
        losses.append(float(loss))
        moments.append(_second_moments(state, hcg.mesh))
    shards = _jshards(state, hcg.mesh)
    shards["moments"] = moments
    return losses, shards, state, hcg.mesh, before


def _second_moments(state, mesh):
    """{name: [rank r's block of AdamW's second moment]} of a reference
    state."""
    return {n: _jshards(s["moment2"], mesh)
            for n, s in state["opt"]["slots"].items()}


@functools.lru_cache(maxsize=None)
def _routing_of(name):
    """The smallest gap between the 1st, 2nd and 3rd gate probabilities
    over every token and layer of the three steps' routings (the port on
    one process, the reference's weights before each step), and whether
    an expert overflowed (a token dropped) in any of them."""
    from paddle_tpu_torch.models import ernie_moe as TE
    from paddle_tpu_torch.ops import moe as TM
    gaps, dropped, inner = [], [], TM.topk_gating_indices

    def record(logits, *a, **kw):
        p = torch.softmax(logits.float(), -1).sort(-1, descending=True)[0]
        gaps.append(float((p[:, :2] - p[:, 1:3]).min()))
        out = inner(logits, *a, **kw)
        dropped.append(bool((out[1] == out[4]).any()))
        return out

    TM.topk_gating_indices = record
    try:
        for params in _jax_arm(name)[4]:
            m = TE.params_from_numpy(params, TE.ErnieMoeConfig(**TINY),
                                     device="cpu")
            with torch.no_grad():
                m(torch.tensor(_batch()[0]), torch.tensor(_batch()[1]))
    finally:
        TM.topk_gating_indices = inner
    return min(gaps), any(dropped)


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def init():
    return _init()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("ep2"), init, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("ep4"), init, ARMS4)}


@pytest.fixture(scope="module")
def ranks2(started):
    return _finish(started[2])


@pytest.fixture(scope="module")
def ranks4(started):
    return _finish(started[4])


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    _jax_arm.cache_clear()
    _routing_of.cache_clear()
    _jax_model.cache_clear()
    _init.cache_clear()
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_losses_and_shards_match_the_jax_mesh(request, started, name):
    ref = REF.get(name, name)
    gap, dropped = _routing_of(ref)
    assert gap > GAP_MIN, (f"smallest gate gap {gap:.3e} <= {GAP_MIN}: a "
                           f"near-tie could route the packages apart")
    assert dropped          # the global capacity decides who is kept
    losses, jshards, *_ = _jax_arm(ref)
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    for r, rk in enumerate(ranks):
        _close(rk[name]["losses"], losses, *TOL, msg=f"losses rank {r}")
    _compare_shards([rk[name]["state"] for rk in ranks], jshards)


def _param_atol(moments, k, r):
    """Rank ``r``'s absolute tolerance for parameter ``k``, element by
    element: ``TOL``'s, or AdamW's 2·lr a step where the reference's own
    gradient at some step was under ``G_FLOOR`` (read back from its second
    moments, ``g_t² = (v_t − β2·v_{t−1}) / (1 − β2)``).  AdamW's step is
    lr·m/(√v + ε), which does not pin a gradient's sign or size where the
    gradient is within the tolerance the op tests hold gradients to
    (``tests/test_torch_moe_ep.py``, 1e-5): there the two packages'
    one-device steps already land up to 5.5e-5 apart (an expert weight
    whose step-2 gradient, 6e-6, differs by 12% after one step).  The key
    columns of ``qkv_b``, whose gradient is zero in exact arithmetic (a
    query's softmax ignores a shift shared by every key), are such
    elements."""
    v_prev, g_min = 0.0, None
    for step in moments:
        v = np.asarray(step[k][r], np.float64)
        g = np.sqrt(np.maximum(v - 0.999 * v_prev, 0.0) / (1 - 0.999))
        g_min = g if g_min is None else np.minimum(g_min, g)
        v_prev = v
    return np.where(g_min < G_FLOOR, 2 * LR * STEPS, TOL[1])


def _compare_shards(port_ranks, jstate):
    """Each rank's parameter and slot shards against the reference's
    blocks at its mesh position (``_noise_atol`` for the parameters)."""
    for key in ("params", "opt"):
        want = _flat(jstate[key])
        assert set(_flat(port_ranks[0][key])) == set(want), key
        for k, blocks in want.items():
            for r, rk in enumerate(port_ranks):
                a = np.asarray(_flat(rk[key])[k], np.float64)
                b = np.asarray(blocks[r], np.float64)
                assert a.shape == b.shape, (key, k, r)
                atol = (_param_atol(jstate["moments"], k, r)
                        if key == "params" else TOL[1])
                bad = np.abs(a - b) > atol + TOL[0] * np.abs(b)
                assert not bad.any(), (key, k, r, np.abs(a - b)[bad].max(),
                                       np.argwhere(bad)[:4].tolist())


@pytest.mark.parametrize("name", ["ep2", "ep4", "dp2_mp2"])
def test_a_rank_holds_its_expert_block(request, started, init, name):
    """Rank j holds experts [j·E/R, (j+1)·E/R) of every layer and their
    AdamW slots; a model rank holds its blocks of the attention half
    too."""
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    hc = {**ARMS2, **ARMS4}[name]
    dp, mp = hc.get("dp_degree", 1), hc.get("mp_degree", 1)
    for rk in ranks:
        layout = rk[name]["layout"]["params"]
        for n in EXPERTS:
            assert tuple(layout[n])[:2] == (None, "data"), (n, layout[n])
            assert rk[name]["state"]["params"][n].shape[1] == \
                TINY["num_experts"] // dp
    experts = sum(init[n].size * 4 for n in EXPERTS)
    split = sum(init[n].size * 4 for n in ("wte", "blocks_qkv_w",
                                           "blocks_qkv_b", "blocks_proj_w"))
    whole = sum(v.size * 4 for v in init.values())
    want = whole - experts + experts // dp - split + split // mp
    for rk in ranks:
        assert rk[name]["param_bytes"] == want
        assert rk[name]["state_bytes"] == 2 * want      # AdamW's two slots


@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_monitor_counts_each_token_once(request, started, name):
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    for step in range(STEPS - 1):   # the first call is the compile event
        got = [rk[name]["counted"][step] for rk in ranks]
        assert sum(e for e, _ in got) == B and sum(t for _, t in got) == B * L
        for rk, (e, t) in zip(ranks, got):
            assert (t > 0) == (rk[name]["mp_rank"] == 0)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat, leaf):
    out = {}
    for k, v in flat.items():
        *path, last = k.split("/")
        node = out
        for p in path:
            node = node.setdefault(p, {})
        node[last] = leaf(k, v)
    return out


def _rank_mesh(jmesh, r):
    from paddle_tpu_torch.distributed.topology import ProcessMesh
    return ProcessMesh(tuple(jmesh.shape), tuple(jmesh.shape.values()),
                       rank=r)


def _bits(x):
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.tobytes(), a.dtype.str, a.shape


def test_expert_sharded_managed_save_loads_bit_exact_in_reference(
        started, ranks2):
    import jax.numpy as jnp
    from paddle_tpu.train_resilience import CheckpointManager as JManager
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    *_, jmesh, _ = _jax_arm("ep2")
    root = os.path.join(str(started[2][2]), "ck_ep2")
    leaves = _flat(ranks2[0]["ep2"]["state"])
    specs = _flat(ranks2[0]["ep2"]["layout"])
    step, got = JManager(root).restore(_nest(leaves,
                                             lambda k, v: jnp.zeros(1)))
    got = _flat(got)
    assert step == STEPS and set(got) == set(leaves)
    split = 0
    for k in leaves:
        full = torch.from_numpy(np.array(got[k]))
        for r, rk in enumerate(ranks2):
            blk = local_shard(full, specs[k], _rank_mesh(jmesh, r)) \
                if full.dim() else full
            split += blk.shape != full.shape
            assert _bits(blk) == _bits(np.asarray(_flat(
                rk["ep2"]["state"])[k])), (k, r)
    assert split >= 2 * 3 * len(EXPERTS)     # params and both slots, 2 ranks


def test_reference_managed_save_loads_bit_exact_per_rank(ranks2, tmp_path):
    import jax
    from paddle_tpu.train_resilience import CheckpointManager as JManager
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    from paddle_tpu_torch.train_resilience import CheckpointManager
    _, _, jstate, jmesh, _ = _jax_arm("ep2")
    root = str(tmp_path / "jck_ep2")
    bundle = {"params": jstate["params"], "opt": jstate["opt"]}
    JManager(root).save(bundle, STEPS)
    full = {k: np.array(jax.device_get(v))
            for k, v in _flat(bundle).items()}
    specs = _flat(ranks2[0]["ep2"]["layout"])
    for r, rk in enumerate(ranks2):
        mine = {k: v for k, v in _flat(rk["ep2"]["state"]).items()
                if k in full}
        tmpl = _nest(mine, lambda k, v: torch.zeros(
            np.shape(v), dtype=torch.as_tensor(np.asarray(v)).dtype))
        step, got = CheckpointManager(root).restore(
            tmpl, shardings=tck.Layout(_nest(mine, lambda k, v: specs[k]),
                                       _rank_mesh(jmesh, r)))
        got = _flat(got)
        assert step == STEPS
        for k in mine:
            t = torch.from_numpy(full[k])
            want = local_shard(t, specs[k], _rank_mesh(jmesh, r)) \
                if t.dim() else t
            assert _bits(got[k]) == _bits(want), (k, r)


class _Degrees:
    """A hybrid group's degree getters and nothing else."""

    def __init__(self, **deg):
        self.deg = deg

    def __getattr__(self, name):
        key = {"get_data_parallel_world_size": "dp",
               "get_model_parallel_world_size": "mp",
               "get_sharding_parallel_world_size": "sharding",
               "get_sep_parallel_world_size": "sep",
               "get_pipe_parallel_world_size": "pp"}.get(name)
        if key is None:
            raise AttributeError(name)
        return lambda: self.deg.get(key, 1)


def test_refusals_that_stay_name_their_item():
    from paddle_tpu_torch.models import ernie_moe as TE
    import paddle_tpu_torch.optimizer as TO
    m = TE.ErnieMoeModel(TE.ErnieMoeConfig(**TINY), device="cpu")
    opt = TO.AdamW(LR)
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        TE.make_ernie_moe_train_step(m, opt, _Degrees(sep=2))
    # a pipe degree (ROADMAP A7c) holds the pipe axis replicated, as the
    # reference's step does: rank 0 of two stages keeps every weight whole
    from paddle_tpu_torch.distributed.topology import ProcessMesh
    two = _Degrees(pp=2)
    two.mesh = ProcessMesh(("data", "pipe", "sharding", "sep", "model"),
                           (1, 2, 1, 1, 1), rank=0)
    step, state = TE.make_ernie_moe_train_step(m, opt, two)
    assert "pipe" not in str(step.layout.specs)
    assert {n: p.shape for n, p in state["params"].items()} == \
        {n: p.shape for n, p in m.named_parameters()}
    on_model = TE.ErnieMoeModel(TE.ErnieMoeConfig(**TINY,
                                                  expert_axis="model"),
                                device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        TE.make_ernie_moe_train_step(on_model, opt, _Degrees(mp=2))
    with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
        TE.make_ernie_moe_train_step(m, opt, _Degrees(dp=2, sharding=2))
    for deg in (dict(dp=2), dict(mp=2)):
        with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
            TE.make_sharded_ernie_moe_train_step(
                TE.ErnieMoeConfig(**TINY), opt, _Degrees(**deg),
                zero_stage=1, device="cpu")

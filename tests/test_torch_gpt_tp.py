"""Port parity for GPT training over model and sep ranks
(``paddle_tpu_torch/models/gpt.py`` ``make_gpt_train_step`` with
``distributed/spmd.py``'s mesh step) against the JAX package's
``make_gpt_train_step`` on its CPU mesh.

Arms (tiny GPT: vocab 128, H 32, 2 layers, 4 heads, L 32, fp32, AdamW,
B 4, 3 steps): mp 2 (with and without a global-norm clip over the
blocks), sep 2 ring and sep 2 Ulysses on 2 gloo ranks; mp 4,
sep 4 ring, sep 4 Ulysses, dp 2 x mp 2, and dp 2 x sep 2 with ring,
Ulysses and the gathered sequence on 4.  Each rank's losses and its
parameter and slot shards are held against ``addressable_shards[r]`` of
the reference's state on the same mesh (losses and parameters within
1e-4; slots rtol 1e-4), and the model ranks' gradients of the
parameters they replicate are equal bit for bit.  Tensor-sharded
checkpoints (``distributed/checkpoint.py``): the mp 2 and sep 2 states
saved by the two ranks load bit-exact in the reference, and the
reference's mp 2 state loads bit-exact into each rank's shards.  The
refusals that stay (ZeRO and update sharding over model or sep ranks,
sharded init over sep ranks) raise and name their ROADMAP item, and a
pipe degree beside them runs the pipeline, whose ZeRO raises as the
reference's.  The spawned ranks import this module, so it imports no
JAX at its top.
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

from test_torch_dp import _close, _compare, _jshards, _np

TINY = dict(vocab_size=128, hidden_size=32, num_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            compute_dtype="float32")
B, L, STEPS, LR = 4, 32, 3, 1e-3
TOL = (1e-4, 1e-5)
SLOT_TOL = (1e-4, 1e-7)
#: the parameters every model rank holds whole
REPLICATED = ("wpe", "blocks_ln1_w", "blocks_ln1_b", "blocks_ln2_w",
              "blocks_ln2_b", "blocks_proj_b", "blocks_fc2_b", "lnf_w",
              "lnf_b")

ARMS2 = {"mp2": ({"mp_degree": 2}, None),
         # a global-norm clip over the model ranks' blocks
         "mp2_clip": ({"mp_degree": 2}, None),
         "sep2_ring": ({"sep_degree": 2}, "ring"),
         "sep2_ulysses": ({"sep_degree": 2}, "ulysses")}
ARMS4 = {"mp4": ({"mp_degree": 4}, None),
         "sep4_ring": ({"sep_degree": 4}, "ring"),
         "sep4_ulysses": ({"sep_degree": 4}, "ulysses"),
         "dp2_mp2": ({"dp_degree": 2, "mp_degree": 2}, None),
         "dp2_sep2": ({"dp_degree": 2, "sep_degree": 2}, "ring"),
         "dp2_sep2_ulysses": ({"dp_degree": 2, "sep_degree": 2}, "ulysses"),
         "dp2_sep2_gathered": ({"dp_degree": 2, "sep_degree": 2}, None)}
SAVED = ("mp2", "sep2_ring")
CLIP = 0.5


def _clip(name, nn):
    return nn.ClipGradByGlobalNorm(CLIP) if name.endswith("_clip") else None


def _batch():
    r = np.random.RandomState(0)
    return r.randint(0, 128, (B, L)), r.randint(0, 128, (B, L))


# ------------------------------------------------------- the port side --

def _port_arm(name, hc, mode, init, tmp):
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models import gpt as TG
    import paddle_tpu_torch.optimizer as TO
    st = fleet.DistributedStrategy()
    st.hybrid_configs = hc
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    import paddle_tpu_torch.nn as tnn
    m = TG.params_from_numpy(init, TG.GPTConfig(**TINY,
                                                sequence_parallel=mode),
                             device="cpu")
    opt = TO.AdamW(LR, grad_clip=_clip(name, tnn))
    grads, apply = [], opt._apply_update

    def recording(g, *a, **k):
        grads.append({n: _np(g[n]) for n in REPLICATED})
        return apply(g, *a, **k)
    opt._apply_update = recording
    from paddle_tpu_torch.telemetry import TrainMonitor
    mon = TrainMonitor()
    step, state = TG.make_gpt_train_step(m, opt, hcg, remat=False,
                                         monitor=mon)
    x, y = (torch.tensor(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, 0, LR, x, y)
        losses.append(float(loss))
    out = {"losses": losses, "state": _np(state), "grads": grads,
           "mp_rank": hcg.get_model_parallel_rank(),
           "sep_rank": hcg.get_sep_parallel_rank(),
           "counted": [(e["examples"], e["tokens"])
                       for e in mon.events("train_step")],
           "state_bytes": per_device_state_bytes(state),
           "param_bytes": sum(p.numel() * 4
                              for p in state["params"].values()),
           "layout": step.layout.specs}
    if name in SAVED:
        tck.save(state, os.path.join(tmp, f"ck_{name}"),
                 shardings=step.layout)
    return out


def _gather_full_over_tuples():
    """``gather_full`` of this rank's ``local_shard`` under specs whose
    entries name two axes (the last hybrid group: data x sep at 4 ranks,
    sep at 2) gives the whole tensor back."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding_rules import (
        PartitionSpec as P, gather_full, local_shard)
    mesh = fleet.get_hybrid_communicate_group().mesh
    full = torch.arange(8 * 12, dtype=torch.float32).reshape(8, 12)
    ok = []
    for spec in (P(("data", "sep"), None), P(None, ("sep", "data")),
                 P("sep", "data")):
        ok.append(torch.equal(gather_full(local_shard(full, spec, mesh),
                                          spec, mesh), full))
    return ok


def _topology():
    """A sep 2 x mp 2 group's layout on this rank: its mesh coordinates,
    getters, axis groups and batch groups, and a sum over each group."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.topology import GRAD_AXES
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"sep_degree": 2, "mp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    mesh = hcg.mesh
    batch, bidx = mesh.batch_group()
    grad, gidx = mesh.batch_group(GRAD_AXES)
    sums = {}
    for name, g in (("model", hcg.get_model_parallel_group()),
                    ("sep", hcg.get_sep_parallel_group()), ("grad", grad)):
        t = torch.tensor([float(hcg.get_global_rank())])
        sums[name] = float(C.all_reduce(t, group=g))
    return {"coord": dict(mesh.coord), "shape": dict(mesh.shape),
            "mp": (hcg.get_model_parallel_rank(),
                   hcg.get_model_parallel_world_size(),
                   hcg.get_model_parallel_group().ranks,
                   hcg.get_model_parallel_group_src_rank()),
            "sep": (hcg.get_sep_parallel_rank(),
                    hcg.get_sep_parallel_world_size(),
                    hcg.get_sep_parallel_group().ranks),
            "batch": (batch.ranks, bidx), "grad": (grad.ranks, gidx),
            "sums": sums, "mode": hcg.get_parallel_mode()}


def _rank_main(rank, world, tmp, init, arms):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {n: _port_arm(n, *spec, init, tmp) for n, spec in arms.items()}
    out["gather_full"] = _gather_full_over_tuples()
    if world == 4:
        out["topology"] = _topology()
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init, arms):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main,
                             args=(world, str(tmp), init, arms),
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


def _jax_init():
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTModel
    paddle.seed(11)
    return {n: np.asarray(jax.device_get(p._data))
            for n, p in GPTModel(GPTConfig(**TINY)).named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_arm(name):
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.models.gpt import GPTConfig, GPTModel, make_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    hc, mode = {**ARMS2, **ARMS4}[name]
    hcg = _jax_hcg(hc)
    paddle.seed(11)
    step, state = make_gpt_train_step(
        GPTModel(GPTConfig(**TINY, sequence_parallel=mode)),
        AdamW(LR, grad_clip=_clip(name, jnn)), hcg, remat=False)
    x, y = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax.random.key(0), np.float32(LR), x, y)
        losses.append(float(loss))
    return losses, _jshards(state, hcg.mesh), state, hcg.mesh


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("tp2"), init, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("tp4"), init, ARMS4)}


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
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_losses_and_shards_match_the_jax_mesh(request, started, name):
    losses, jshards, _, _ = _jax_arm(name)
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    for r, rk in enumerate(ranks):
        _close(rk[name]["losses"], losses, *TOL, msg=f"losses rank {r}")
    _compare([rk[name]["state"] for rk in ranks], jshards, ("params",),
             tol=TOL)
    _compare([rk[name]["state"] for rk in ranks], jshards, ("opt",),
             tol=SLOT_TOL)


@pytest.mark.parametrize("name", ["mp2", "mp2_clip", "mp4", "dp2_mp2"])
def test_model_ranks_agree_on_replicated_gradients(request, started, name):
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    hc = {**ARMS2, **ARMS4}[name][0]
    mp = hc["mp_degree"]
    for rk in ranks:
        assert len(rk[name]["grads"]) == STEPS
    for base in range(0, len(ranks), mp):
        group = ranks[base:base + mp]
        assert [rk[name]["mp_rank"] for rk in group] == list(range(mp))
        for step in range(STEPS):
            for n in REPLICATED:
                for rk in group[1:]:
                    np.testing.assert_array_equal(
                        rk[name]["grads"][step][n],
                        group[0][name]["grads"][step][n], err_msg=n)
    # a model rank holds 1/mp of the split weights and their slots
    one = sum(v.size * 4 for v in _jax_init().values())
    split = one - sum(_jax_init()[n].size * 4 for n in REPLICATED)
    want = one - split + split // mp
    for rk in ranks:
        assert rk[name]["param_bytes"] == want
        assert rk[name]["state_bytes"] == 2 * want      # AdamW's two slots


def _flat(tree, prefix=""):
    """``{"a/b": leaf}`` of a nested dict."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}{k}/"))
        return out
    return {prefix[:-1]: tree}


def _nest(flat, leaf):
    """The nested dict of ``flat``'s keys, each leaf ``leaf(key, value)``."""
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


@pytest.mark.parametrize("name", SAVED)
def test_port_tensor_sharded_save_loads_bit_exact_in_reference(
        started, ranks2, name):
    import jax.numpy as jnp
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    *_, jmesh = _jax_arm(name)
    d = os.path.join(str(started[2][2]), f"ck_{name}")
    leaves = _flat(ranks2[0][name]["state"])
    specs = _flat(ranks2[0][name]["layout"])
    got = _flat(jck.load(d, target=_nest(leaves,
                                         lambda k, v: jnp.zeros(1))))
    assert set(got) == set(leaves)
    for k in leaves:
        full = torch.from_numpy(np.array(got[k]))
        for r, rk in enumerate(ranks2):
            blk = local_shard(full, specs[k], _rank_mesh(jmesh, r)) \
                if full.dim() else full
            assert _bits(blk) == _bits(np.asarray(_flat(
                rk[name]["state"])[k])), (k, r)


def test_reference_tensor_sharded_save_loads_bit_exact_per_rank(
        ranks2, tmp_path):
    import jax
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    _, _, jstate, jmesh = _jax_arm("mp2")
    d = str(tmp_path / "jck_mp2")
    jck.save({"params": jstate["params"], "opt": jstate["opt"]}, d)
    full = {k: np.asarray(jax.device_get(v)) for k, v in _flat(
        {"params": jstate["params"], "opt": jstate["opt"]}).items()}
    specs = _flat(ranks2[0]["mp2"]["layout"])
    split = 0
    for r, rk in enumerate(ranks2):
        mine = {k: v for k, v in _flat(rk["mp2"]["state"]).items()
                if k in full}
        tmpl = _nest(mine, lambda k, v: torch.zeros(np.shape(v),
                                                    dtype=torch.as_tensor(
                                                        np.asarray(v)).dtype))
        got = _flat(tck.load(d, target=tmpl, shardings=tck.Layout(
            _nest(mine, lambda k, v: specs[k]), _rank_mesh(jmesh, r))))
        for k, v in mine.items():
            t = torch.from_numpy(full[k])
            want = local_shard(t, specs[k], _rank_mesh(jmesh, r)) \
                if t.dim() else t
            split += want.shape != t.shape
            assert _bits(got[k]) == _bits(want), (k, r)
    assert split > 0          # the model axis did split some leaves


@pytest.mark.parametrize("world", [2, 4])
def test_gather_full_over_tuple_entries(request, started, world):
    for rk in request.getfixturevalue(f"ranks{world}"):
        assert rk["gather_full"] == [True, True, True]


@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_monitor_counts_each_token_once(request, started, name):
    """A rank counts its rows x its chunk; a model group counts its
    tokens on its first rank, a sep group its examples on its first: the
    world's sums are the global batch's."""
    ranks = request.getfixturevalue("ranks2" if name in ARMS2
                                    else "ranks4")
    for rk in ranks:          # the first call is the monitor's compile
        assert len(rk[name]["counted"]) == STEPS - 1
    for step in range(STEPS - 1):
        got = [rk[name]["counted"][step] for rk in ranks]
        assert sum(e for e, _ in got) == B and sum(t for _, t in got) == B * L
        for rk, (e, t) in zip(ranks, got):
            assert (t > 0) == (rk[name]["mp_rank"] == 0)
            assert (e > 0) == (rk[name]["mp_rank"] == 0
                               and rk[name]["sep_rank"] == 0)


def test_sep_mp_layout_is_the_reference_mesh(ranks4):
    """sep 2 x mp 2: rank r sits at flat position r of the reference's
    mesh, its model and sep groups vary only that coordinate, its batch
    group is itself and its gradient group its sep group."""
    from paddle_tpu.distributed import HybridCommunicateGroup as JH
    jh = JH(sep_degree=2, mp_degree=2)
    jmesh = jh.mesh
    for r, rk in enumerate(ranks4):
        t = rk["topology"]
        assert t["shape"] == dict(jmesh.shape)
        coord = dict(zip(jmesh.axis_names, (int(i) for i in np.unravel_index(
            r, jmesh.devices.shape))))
        assert t["coord"] == coord
        mp_ranks = [2 * (r // 2), 2 * (r // 2) + 1]
        sep_ranks = [r % 2, r % 2 + 2]
        assert t["mp"] == (coord["model"], 2, mp_ranks, mp_ranks[0])
        assert t["sep"] == (coord["sep"], 2, sep_ranks)
        assert t["batch"] == ([r], 0)
        assert t["grad"] == (sep_ranks, coord["sep"])
        assert t["sums"] == {"model": float(sum(mp_ranks)),
                             "sep": float(sum(sep_ranks)),
                             "grad": float(sum(sep_ranks))}
        assert t["mode"] == "TensorParallel"


class _Degrees:
    """A hybrid group's degree getters and nothing else."""

    def __init__(self, **deg):
        self.deg = deg

    def __getattr__(self, name):
        key = {"get_model_parallel_world_size": "mp",
               "get_sep_parallel_world_size": "sep",
               "get_pipe_parallel_world_size": "pp"}.get(name)
        if key is None:
            raise AttributeError(name)
        return lambda: self.deg.get(key, 1)


@pytest.mark.parametrize("deg", [dict(mp=2), dict(sep=2)])
def test_refusals_that_stay_name_their_item(deg):
    from paddle_tpu_torch.models import gpt as TG
    import paddle_tpu_torch.optimizer as TO
    m = TG.GPTModel(TG.GPTConfig(**TINY), device="cpu")
    hcg = _Degrees(**deg)
    for kw in (dict(zero_stage=1), dict(zero_stage=3),
               dict(update_sharding=True)):
        with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
            TG.make_gpt_train_step(m, TO.AdamW(LR), hcg, **kw)
    if "sep" in deg:
        with pytest.raises(NotImplementedError, match="ROADMAP §C"):
            TG.make_sharded_gpt_train_step(TG.GPTConfig(**TINY),
                                           TO.AdamW(LR), hcg, device="cpu")
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP A7b"):
            TG.make_sharded_gpt_train_step(TG.GPTConfig(**TINY),
                                           TO.AdamW(LR), hcg, zero_stage=1,
                                           device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP §C"):
        TG.make_sharded_gpt_train_step(
            TG.GPTConfig(**TINY, sequence_parallel="ring"), TO.AdamW(LR),
            None, device="cpu")
    # a pipe degree (ROADMAP A7c) takes the pipeline, which keeps the
    # reference's refusals
    with pytest.raises(NotImplementedError, match="pp_degree>1"):
        TG.make_gpt_train_step(m, TO.AdamW(LR), _Degrees(pp=2, **deg),
                               zero_stage=1)

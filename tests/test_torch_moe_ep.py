"""Port parity for expert parallelism's exchange and MoE FFN over gloo
ranks: ``paddle_tpu_torch/distributed/utils.py`` (``global_scatter``,
``global_gather``, ``ragged_global_scatter``, ``ragged_global_gather``)
against the reference's under ``shard_map`` on the CPU mesh, and
``ops/moe.py``'s ``moe_ffn``/``moe_ffn_indices`` over a data (expert)
axis against the reference's single-device functions on the concatenated
rows, as ``tests/test_moe.py::test_expert_parallel_matches_single_device``
holds the reference's own mesh arm.

One spawn of 2 and one of 4 gloo ranks (each rank runs every check and
pickles its results; the JAX side runs meanwhile).  Tolerances: the
exchanges move rows, so their outputs are equal and their gradients within
1e-6; the MoE outputs, aux losses and the gradients of x, ``gate_w`` and
each rank's expert block within 1e-5; the routing integers
(``expert_idx``, ``slot_idx``, C) equal; each dispatch runs at
``capacity_factor`` 0.5, where experts overflow, and at 1.25, with the
experts split over the ranks or replicated (``MOE_CASES``); the routing
with gate jitter (each rank's rows of the reference's one draw over the
global logits) likewise.  Each rank's
loss is ``sum(out · ct) +
aux`` over its rows: the sum of the ranks' losses is the reference's
``sum(out · ct) + R · aux`` (every rank's loss reads the global aux),
whose gradient the ranks' gradients sum to.  The MoE data's smallest
gap between the first, second and third gate probabilities is held
above 1e-5 (it is 8.3e-5 for the two-rank arm's three experts, above
1e-4 for the rest), a hundred times the ~1e-7 by which the packages' fp32
gate probabilities differ (the gates agree within 1e-6 relative).  The
spawned ranks import this module, so it imports no JAX at its top.
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

H, I, K, TOK = 8, 16, 2, 32        # hidden, expert hidden, top-k, tokens
#: (dispatch, capacity factor, experts split over the ranks): each form at
#: the overflowing factor 0.5 and at 1.25, the experts split (a rank's
#: block) and replicated (a count the degree does not divide)
MOE_CASES = (("moe_ffn_indices", 1.25, True), ("moe_ffn_indices", 0.5, False),
             ("moe_ffn", 0.5, True), ("moe_ffn", 1.25, False))
UNI_ROWS, UNI_H = 6, 5             # rows a (rank, rank) block
RAG_T, RAG_H, RAG_EL = 12, 5, 2    # ragged: rows a rank, width, experts a rank
TOL = dict(rtol=1e-5, atol=1e-5)
GAP_MIN = 1e-5
JITTER_SEED = 23                   # the gate jitter's key: make_key(23)


def _experts_of(world, split):
    """The expert count of an arm: 4 a rank's block splits, ``world + 1``
    the degree does not divide (the experts stay replicated)."""
    return 2 * world if split else world + 1


def _moe_data(E, seed):
    r = np.random.RandomState(seed)
    return dict(x=r.randn(TOK, H).astype(np.float32),
                gw=r.randn(H, E).astype(np.float32),
                w1=(0.3 * r.randn(E, H, I)).astype(np.float32),
                b1=(0.1 * r.randn(E, I)).astype(np.float32),
                w2=(0.3 * r.randn(E, I, H)).astype(np.float32),
                b2=(0.1 * r.randn(E, H)).astype(np.float32),
                ct=r.randn(TOK, H).astype(np.float32))


def _uniform_data(world):
    r = np.random.RandomState(3 + world)
    n = world * UNI_ROWS
    return (r.randn(world, n, UNI_H).astype(np.float32),
            r.randn(world, n, UNI_H).astype(np.float32))


def _ragged_data(world):
    r = np.random.RandomState(7 + world)
    xs = r.randn(world, RAG_T, RAG_H).astype(np.float32)
    counts = np.stack([r.multinomial(RAG_T, np.ones(world * RAG_EL)
                                     / (world * RAG_EL))
                       for _ in range(world)]).astype(np.int32)
    ct = r.randn(world, RAG_T, RAG_H).astype(np.float32)
    return xs, counts, ct


def _ragged_scale(world, rc, rows):
    """The expert transform of the round trip: a received row of global
    expert d scales by d + 1 (rows arrive expert-major)."""
    me = torch.distributed.get_rank() if world > 1 else 0
    per = rc.sum(0)
    el = np.minimum(np.searchsorted(np.cumsum(per), np.arange(rows),
                                    side="right"), RAG_EL - 1)
    return torch.from_numpy((me * RAG_EL + el + 1).astype(np.float32))


# ------------------------------------------------------- the port side --

def _exchanges(world, rank):
    from paddle_tpu_torch.distributed import utils as U
    x, ct = (torch.from_numpy(a[rank]) for a in _uniform_data(world))
    xg = x.clone().requires_grad_()
    out = U.global_scatter(xg)
    back = U.global_gather(out)
    (out * ct).sum().backward()
    res = {"uniform": out.detach().numpy(), "roundtrip": back.detach()
           .numpy(), "uniform_grad": xg.grad.numpy()}
    xs, counts, ct = _ragged_data(world)
    xr = torch.from_numpy(xs[rank]).requires_grad_()
    got, rc, plan = U.ragged_global_scatter(xr, counts[rank])
    y = got * _ragged_scale(world, rc.numpy(), got.shape[0])[:, None]
    back = U.ragged_global_gather(y, counts[rank], plan, rows=RAG_T)
    (back * torch.from_numpy(ct[rank])).sum().backward()
    res.update(ragged=got.detach().numpy(), recv_counts=rc.numpy(),
               ragged_back=back.detach().numpy(),
               ragged_grad=xr.grad.numpy())
    return res


def _moe(world, rank, mesh, fn_name, cf, split):
    from paddle_tpu_torch.ops import moe as TM
    E = _experts_of(world, split)
    d = _moe_data(E, seed=E)
    n = TOK // world
    rows = slice(rank * n, (rank + 1) * n)
    blk = slice(rank * E // world, (rank + 1) * E // world) if split \
        else slice(None)
    x = torch.from_numpy(d["x"][rows]).requires_grad_()
    gw = torch.from_numpy(d["gw"]).requires_grad_()
    ws = [torch.from_numpy(d[k][blk]).requires_grad_()
          for k in ("w1", "b1", "w2", "b2")]
    out, aux = getattr(TM, fn_name)(x, gw, *ws, k=K, capacity_factor=cf,
                                    mesh=mesh)
    ((out * torch.from_numpy(d["ct"][rows])).sum() + aux).backward()
    res = {"out": out.detach().numpy(), "aux": float(aux),
           "gx": x.grad.numpy(), "ggw": gw.grad.numpy(),
           "gws": [w.grad.numpy() for w in ws]}
    route, _ = TM._check_mesh(mesh, "data")
    logits = torch.from_numpy(d["x"][rows] @ d["gw"])
    ei, si, gates, aux_r, C = TM.topk_gating_indices(
        logits, k=K, capacity_factor=cf, group=route)
    res.update(expert_idx=ei.numpy(), slot_idx=si.numpy(),
               gates=gates.numpy(), aux_r=float(aux_r), C=C)
    from paddle_tpu_torch.core import rng
    ei, si, gates, _, _ = TM.topk_gating_indices(
        logits, k=K, capacity_factor=cf, group=route,
        jitter_key=rng.make_key(JITTER_SEED))
    res.update(jit_expert_idx=ei.numpy(), jit_slot_idx=si.numpy(),
               jit_gates=gates.numpy())
    return res


def _moe_layer(world, rank, mesh):
    """``MoELayer.set_mesh``: the layer keeps its block of the experts and
    its forward routes the global batch."""
    from paddle_tpu_torch import nn as tnn
    E = _experts_of(world, True)
    d = _moe_data(E, seed=E)
    torch.manual_seed(0)
    with tnn.building("cpu"):
        layer = tnn.MoELayer(H, I, E, top_k=K)
    with torch.no_grad():
        for n, k in (("gate_weight", "gw"), ("expert_w1", "w1"),
                     ("expert_b1", "b1"), ("expert_w2", "w2"),
                     ("expert_b2", "b2")):
            getattr(layer, n).copy_(torch.from_numpy(d[k]))
    layer.set_mesh(mesh)
    n = TOK // world
    x = torch.from_numpy(d["x"][rank * n:(rank + 1) * n]).reshape(2, -1, H)
    out = layer(x)
    return {"out": out.detach().reshape(-1, H).numpy(),
            "aux": float(layer.aux_loss),
            "held": tuple(layer.expert_w1.shape),
            "distributed": layer.expert_w1.is_distributed is True}


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": world}
    fleet.init(is_collective=True, strategy=st)
    mesh = fleet.get_hybrid_communicate_group().mesh
    out = {"exchange": _exchanges(world, rank), "layer":
           _moe_layer(world, rank, mesh)}
    for fn_name, cf, split in MOE_CASES:
        out[fn_name, cf, split] = _moe(world, rank, mesh, fn_name, cf, split)
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp):
    import torch.multiprocessing as mp
    return mp.start_processes(_rank_main, args=(world, str(tmp)),
                              nprocs=world, join=False,
                              start_method="spawn"), world, tmp


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

def _sm(fn, world, in_specs, out_specs):
    import inspect

    import jax
    from jax.sharding import Mesh
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    mesh = Mesh(np.array(jax.devices()[:world]), ("data",))
    key = ("check_vma" if "check_vma" in inspect.signature(shard_map)
           .parameters else "check_rep")
    return jax.jit(shard_map(fn, mesh=mesh, in_specs=in_specs,
                             out_specs=out_specs, **{key: False}))


@functools.lru_cache(maxsize=None)
def _jax_exchanges(world):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.distributed.utils import (global_gather, global_scatter,
                                              ragged_global_gather,
                                              ragged_global_scatter)
    x, ct = _uniform_data(world)
    X, CT = (jnp.asarray(a.reshape(-1, UNI_H)) for a in (x, ct))
    scat = _sm(lambda v: global_scatter(v, group="data"), world, P("data"),
               P("data"))
    trip = _sm(lambda v: global_gather(global_scatter(v, group="data"),
                                       group="data"), world, P("data"),
               P("data"))
    grad = jax.grad(lambda v: jnp.sum(scat(v) * CT))(X)
    res = {"uniform": np.asarray(scat(X)).reshape(world, -1, UNI_H),
           "roundtrip": np.asarray(trip(X)).reshape(world, -1, UNI_H),
           "uniform_grad": np.asarray(grad).reshape(world, -1, UNI_H)}
    xs, counts, ct = _ragged_data(world)
    XS = jnp.asarray(xs.reshape(-1, RAG_H))
    CN = jnp.asarray(counts.reshape(-1))
    CR = jnp.asarray(ct.reshape(-1, RAG_H))

    def scatter(xl, cl):
        out, rc, _ = ragged_global_scatter(xl, cl, group="data")
        return out, rc

    def trip_fn(xl, cl):
        out, rc, perm = ragged_global_scatter(xl, cl, group="data")
        me = jax.lax.axis_index("data")
        cum = jnp.cumsum(jnp.sum(rc, axis=0))
        row = jnp.arange(out.shape[0])
        el = jnp.minimum(jnp.sum(row[:, None] >= cum[None, :], axis=1),
                         RAG_EL - 1)
        y = out * (me * RAG_EL + el + 1).astype(out.dtype)[:, None]
        return ragged_global_gather(y, cl, perm, rows=xl.shape[0],
                                    group="data")

    sc = _sm(scatter, world, (P("data"), P("data")), (P("data"), P("data")))
    tr = _sm(trip_fn, world, (P("data"), P("data")), P("data"))
    out, rc = sc(XS, CN)
    back = tr(XS, CN)
    g = jax.grad(lambda v: jnp.sum(tr(v, CN) * CR))(XS)
    res.update(ragged=np.asarray(out).reshape(world, -1, RAG_H),
               recv_counts=np.asarray(rc).reshape(world, world, RAG_EL),
               ragged_back=np.asarray(back).reshape(world, RAG_T, RAG_H),
               ragged_grad=np.asarray(g).reshape(world, RAG_T, RAG_H))
    return res


@functools.lru_cache(maxsize=None)
def _jax_moe(world, fn_name, cf, split):
    import jax
    import jax.numpy as jnp
    from paddle_tpu.ops import moe as JM
    E = _experts_of(world, split)
    d = {k: jnp.asarray(v) for k, v in _moe_data(E, seed=E).items()}
    fn = getattr(JM, fn_name)

    def loss(x, gw, w1, b1, w2, b2):
        out, aux = fn(x, gw, w1, b1, w2, b2, k=K, capacity_factor=cf)
        return jnp.sum(out * d["ct"]) + world * aux, (out, aux)

    args = [d[k] for k in ("x", "gw", "w1", "b1", "w2", "b2")]
    grads, (out, aux) = jax.jit(jax.grad(loss, argnums=tuple(range(6)),
                                         has_aux=True))(*args)
    logits = d["x"] @ d["gw"]
    ei, si, gates, aux_r, C = JM.topk_gating_indices(logits, k=K,
                                                     capacity_factor=cf)
    probs = np.sort(np.asarray(jax.nn.softmax(logits, -1)), -1)[:, ::-1]
    return {"out": np.asarray(out), "aux": float(aux),
            "grads": [np.asarray(g) for g in grads],
            "expert_idx": np.asarray(ei), "slot_idx": np.asarray(si),
            "gates": np.asarray(gates), "aux_r": float(aux_r), "C": int(C),
            "gap": float(min((probs[:, i] - probs[:, i + 1]).min()
                             for i in range(K)))}


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return {w: _start(w, tmp_path_factory.mktemp(f"moe{w}")) for w in (2, 4)}


@pytest.fixture(scope="module")
def ranks(started):
    return {w: _finish(started[w]) for w in (2, 4)}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    _jax_exchanges.cache_clear()
    _jax_moe.cache_clear()
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("world", [2, 4])
def test_exchanges_equal_the_reference_under_shard_map(started, ranks,
                                                       world):
    want = _jax_exchanges(world)
    for r, rk in enumerate(ranks[world]):
        got = rk["exchange"]
        for k in ("uniform", "roundtrip", "ragged_back"):
            np.testing.assert_array_equal(got[k], want[k][r], err_msg=k)
        # the uniform tier: rank r's block w came from rank w's block r
        blocks = _uniform_data(world)[0].reshape(world, world, UNI_ROWS,
                                                 UNI_H)
        np.testing.assert_array_equal(
            got["uniform"].reshape(world, UNI_ROWS, UNI_H), blocks[:, r])
        np.testing.assert_array_equal(got["recv_counts"],
                                      want["recv_counts"][r])
        n = int(got["recv_counts"].sum())
        # the reference's padded receive layout, expert-major, zero after n
        assert got["ragged"].shape == want["ragged"][r].shape
        np.testing.assert_array_equal(got["ragged"], want["ragged"][r])
        assert not got["ragged"][n:].any() and got["ragged"][:n].any()
        for k in ("uniform_grad", "ragged_grad"):
            np.testing.assert_allclose(got[k], want[k][r], rtol=1e-6,
                                       atol=1e-6, err_msg=k)


def test_exchanges_raise_where_the_reference_raises():
    from paddle_tpu.distributed.utils import global_scatter as j_scatter
    from paddle_tpu_torch.distributed import utils as U
    from paddle_tpu_torch.distributed.collective import Group
    four = Group(ranks=[0, 1, 2, 3], axis_name="data")
    counts = np.array([1, 3, 2, 2])
    import jax.numpy as jnp
    with pytest.raises(ValueError, match="ragged_global_scatter"):
        j_scatter(jnp.ones((8, 4)), local_count=counts, group="data")
    for fn in (U.global_scatter, U.global_gather):
        with pytest.raises(ValueError, match="ragged_global_scatter"):
            fn(torch.ones(8, 4), local_count=counts, group=four)
        with pytest.raises(ValueError, match="ragged_global_scatter"):
            fn(torch.ones(8, 4), global_count=torch.tensor(counts),
               group=four)
    with pytest.raises(ValueError, match="multiple"):
        U.global_scatter(torch.ones(6, 4), group=four)
    every = np.zeros((4, 4), np.int32)
    every[:, 0] = 8                       # every row to rank 0
    with pytest.raises(ValueError, match="block"):
        U.ragged_global_scatter(torch.ones(8, 3), every[0], group=four,
                                block=4)
    with pytest.raises(TypeError, match="plan"):
        U.ragged_global_gather(torch.ones(8, 3), every[0], np.arange(8), 8,
                               group=four)


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("fn_name,cf,split", MOE_CASES, ids=[
    f"{f}-{cf}-{'split' if sp else 'replicated'}" for f, cf, sp in MOE_CASES])
def test_moe_over_the_expert_axis_equals_one_device(started, ranks, world,
                                                    fn_name, cf, split):
    want = _jax_moe(world, fn_name, cf, split)
    assert want["gap"] > GAP_MIN, (
        f"the data's smallest gate gap {want['gap']:.3e} is under "
        f"{GAP_MIN}: a near-tie could route the packages apart")
    E = _experts_of(world, split)
    n = TOK // world
    got = [rk[fn_name, cf, split] for rk in ranks[world]]
    ggw = sum(g["ggw"] for g in got)
    np.testing.assert_allclose(ggw, want["grads"][1], **TOL)
    for r, g in enumerate(got):
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_allclose(g["out"], want["out"][rows], **TOL)
        np.testing.assert_allclose(g["aux"], want["aux"], **TOL)
        np.testing.assert_allclose(g["gx"], want["grads"][0][rows], **TOL)
        # routing: the same global slots, integers equal
        assert g["C"] == want["C"]
        np.testing.assert_array_equal(g["expert_idx"],
                                      want["expert_idx"][rows])
        np.testing.assert_array_equal(g["slot_idx"], want["slot_idx"][rows])
        np.testing.assert_allclose(g["gates"], want["gates"][rows],
                                   rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(g["aux_r"], want["aux_r"], rtol=1e-6)
        if split:                 # rank r's expert block's gradient
            blk = slice(r * E // world, (r + 1) * E // world)
            for a, b in zip(g["gws"], want["grads"][2:]):
                np.testing.assert_allclose(a, b[blk], **TOL)
    if not split:                 # replicated experts: the ranks' sum
        for i, b in enumerate(want["grads"][2:]):
            np.testing.assert_allclose(sum(g["gws"][i] for g in got), b,
                                       **TOL)
    if cf < 1.0:                  # the overflowing case drops tokens
        assert (want["slot_idx"] == want["C"]).any()


@pytest.mark.parametrize("world", [2, 4])
@pytest.mark.parametrize("cf,split", [(1.25, True), (0.5, False)])
def test_jittered_routing_over_the_batch_ranks_is_the_global_draw(
        started, ranks, world, cf, split):
    """Gate jitter over the data ranks: each rank adds its rows of the
    reference's one uniform draw over the global (T, E) logits, so the
    routing (experts, global slots, gates) is the reference's."""
    import jax
    from paddle_tpu.ops import moe as JM
    d = _moe_data(_experts_of(world, split), seed=_experts_of(world, split))
    ei, si, gates, _, _ = JM.topk_gating_indices(
        d["x"] @ d["gw"], k=K, capacity_factor=cf,
        jitter_key=jax.random.key(JITTER_SEED))
    n = TOK // world
    for r, rk in enumerate(ranks[world]):
        got = rk["moe_ffn_indices", cf, split]
        rows = slice(r * n, (r + 1) * n)
        np.testing.assert_array_equal(got["jit_expert_idx"],
                                      np.asarray(ei)[rows])
        np.testing.assert_array_equal(got["jit_slot_idx"],
                                      np.asarray(si)[rows])
        np.testing.assert_allclose(got["jit_gates"], np.asarray(gates)[rows],
                                   rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("world", [2, 4])
def test_moe_layer_set_mesh_holds_its_expert_block(started, ranks, world):
    want = _jax_moe(world, "moe_ffn_indices", 1.25, True)
    E = _experts_of(world, True)
    n = TOK // world
    for r, rk in enumerate(ranks[world]):
        got = rk["layer"]
        assert got["held"] == (E // world, H, I) and got["distributed"]
        np.testing.assert_allclose(got["out"], want["out"][r * n:(r + 1) * n],
                                   **TOL)
        np.testing.assert_allclose(got["aux"], want["aux"], **TOL)

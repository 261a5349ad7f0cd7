"""Port parity for the pipeline schedules (``paddle_tpu_torch/distributed/
spmd.py`` ``spmd_pipeline``, ``spmd_pipeline_interleaved``,
``pipeline_order``/``pipeline_ticks``; ``pipeline_engine.py``
``interleave_layers``) against the JAX package's ``spmd_pipeline`` and
``spmd_pipeline_interleaved`` under ``shard_map`` on its CPU mesh.

Each global stage g applies ``tanh(x @ W[g] + b[g])`` (4 features, 3 rows
a micro-batch, fp32).  On 2 and 4 gloo ranks (the pipe group of a
``fleet.init`` with that pp degree) the port's forward-only outputs, and
with a loss ``sum(y * cot[m])`` its loss, the gradients of each rank's
stage parameters and the first stage's micro-batch gradients, are held
within 1e-5 of the reference's (its gradients by ``jax.grad`` through the
schedule).  Plain 1F1B at M in {1, S, S+1, 2S}, interleaved at V 2 with M
in {S, 2S}, and V 3 on 2 ranks.  The tick table runs every op once, in
dependency order, and keeps at most S - d micro-batches in flight on
stage d under plain 1F1B.  The pipe topology (pp 2 x dp 2) is the
reference mesh's.  The spawned ranks import this module, so it imports no
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

F, ROWS = 4, 3
TOL = dict(rtol=1e-5, atol=1e-5)
CASES = {2: [(1, 1), (1, 2), (1, 3), (1, 4), (2, 2), (2, 4), (3, 2)],
         4: [(1, 2), (1, 4), (1, 5), (1, 8), (2, 4), (2, 8)]}


def _data(S, V, M):
    r = np.random.RandomState(100 * S + 10 * V + M)
    G = S * V
    return {"W": (r.randn(G, F, F) * 0.6).astype(np.float32),
            "b": (r.randn(G, F) * 0.1).astype(np.float32),
            "x": r.randn(M, ROWS, F).astype(np.float32),
            "cot": r.randn(M, ROWS, F).astype(np.float32)}


# ------------------------------------------------------- the port side --

def _stage(p, x, m, v=0):
    return torch.tanh(x @ p["W"] + p["b"])


def _port_case(S, V, M, d, pipe):
    from paddle_tpu_torch.distributed.spmd import (spmd_pipeline,
                                                   spmd_pipeline_interleaved)
    data = {k: torch.from_numpy(a) for k, a in _data(S, V, M).items()}
    mine = {k: torch.stack([data[k][v * S + d] for v in range(V)])
            for k in ("W", "b")}
    x, cot = data["x"], data["cot"]

    def loss_fn(y, m):
        return (y * cot[m]).sum()

    if V == 1:
        mine = {k: t[0] for k, t in mine.items()}
        out = spmd_pipeline(_stage, mine, x, S, group=pipe)
        loss, grads, xg = spmd_pipeline(_stage, mine, x, S, group=pipe,
                                        loss_fn=loss_fn)
    else:
        out = spmd_pipeline_interleaved(_stage, mine, x, S, V, group=pipe)
        loss, grads, xg = spmd_pipeline_interleaved(
            _stage, mine, x, S, V, group=pipe, loss_fn=loss_fn)
    return {"out": out.numpy(), "loss": float(loss),
            "grads": {k: g.numpy() for k, g in grads.items()},
            "xgrad": None if xg is None else xg.numpy()}


def _topology():
    """A dp 2 x pp 2 group's pipe layout on this rank."""
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "pp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    pipe = hcg.get_pipe_parallel_group()
    t = torch.tensor([float(hcg.get_global_rank())])
    return {"coord": dict(hcg.mesh.coord), "stage": hcg.get_stage_id(),
            "pp": hcg.get_pipe_parallel_world_size(), "ranks": pipe.ranks,
            "first": hcg.is_first_stage, "last": hcg.is_last_stage,
            "next": hcg._get_p2p_next_rank(),
            "prev": hcg._get_p2p_prev_rank(),
            "sum": float(C.all_reduce(t, group=pipe)),
            "mode": hcg.get_parallel_mode()}


def _rank_main(rank, world, tmp):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": world}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    pipe = hcg.get_pipe_parallel_group()
    out = {(V, M): _port_case(world, V, M, hcg.get_stage_id(), pipe)
           for V, M in CASES[world]}
    if world == 4:
        out["topology"] = _topology()
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp)),
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

@functools.lru_cache(maxsize=None)
def _jax_case(S, V, M):
    """(outputs, loss, grads of W and b (G, ...), micro-batch grads) of the
    reference's schedule under shard_map over S devices."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.distributed.spmd import (shard_map, spmd_pipeline,
                                             spmd_pipeline_interleaved)
    data = _data(S, V, M)
    mesh = Mesh(np.array(jax.devices()[:S]), ("pipe",))
    # device d's rows: its chunks' stages v*S + d, leading dim V
    order = [v * S + d for d in range(S) for v in range(V)]
    W = jnp.asarray(data["W"][order].reshape(S, V, F, F))
    b = jnp.asarray(data["b"][order].reshape(S, V, F))
    cot = jnp.asarray(data["cot"])

    def stage(p, x):
        return jnp.tanh(x @ p[0] + p[1])

    def run(w, bb, x):
        w, bb = w[0], bb[0]
        if V == 1:
            return spmd_pipeline(lambda p, h, m: stage(p, h), (w[0], bb[0]),
                                 x, S, axis="pipe")
        return spmd_pipeline_interleaved(
            lambda p, h, m, v: stage(p, h), (w, bb), x, S, V, axis="pipe")

    fn = shard_map(run, mesh=mesh, in_specs=(P("pipe"), P("pipe"), P()),
                   out_specs=P(), axis_names={"pipe"})
    out = jax.jit(fn)(W, b, jnp.asarray(data["x"]))
    loss, (gw, gb, gx) = jax.jit(jax.value_and_grad(
        lambda w, bb, x: jnp.sum(fn(w, bb, x) * cot),
        argnums=(0, 1, 2)))(W, b, jnp.asarray(data["x"]))
    inv = np.argsort(order)
    return (np.asarray(out), float(loss),
            np.asarray(gw).reshape(S * V, F, F)[inv],
            np.asarray(gb).reshape(S * V, F)[inv], np.asarray(gx))


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def started(tmp_path_factory):
    return {w: _start(w, tmp_path_factory.mktemp(f"pipe{w}"))
            for w in (2, 4)}


@pytest.fixture(scope="module")
def ranks(started):
    return {w: _finish(s) for w, s in started.items()}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    _jax_case.cache_clear()
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("S,V,M", [(s, v, m) for s in (2, 4)
                                   for v, m in CASES[s]])
def test_schedule_matches_the_reference(started, ranks, S, V, M):
    out, loss, gw, gb, gx = _jax_case(S, V, M)
    for d, rk in enumerate(ranks[S]):
        got = rk[(V, M)]
        np.testing.assert_allclose(got["out"], out, **TOL)
        np.testing.assert_allclose(got["loss"], loss, **TOL)
        idx = [v * S + d for v in range(V)]
        want_w = gw[idx] if V > 1 else gw[d]
        want_b = gb[idx] if V > 1 else gb[d]
        np.testing.assert_allclose(got["grads"]["W"], want_w, **TOL)
        np.testing.assert_allclose(got["grads"]["b"], want_b, **TOL)
        if d == 0:
            np.testing.assert_allclose(got["xgrad"], gx, **TOL)
        else:
            assert got["xgrad"] is None


@pytest.mark.parametrize("S,V,M", [(2, 1, 1), (2, 1, 6), (4, 1, 4),
                                   (4, 1, 9), (2, 2, 4), (4, 2, 8),
                                   (3, 2, 6), (2, 3, 6)])
def test_tick_table_runs_each_op_once_in_order(S, V, M):
    from paddle_tpu_torch.distributed.spmd import pipeline_ticks
    ticks = pipeline_ticks(S, V, M)
    G = S * V
    at = {}
    for d, ops in enumerate(ticks):
        assert [t for t, _ in ops] == sorted({t for t, _ in ops})
        for t, (kind, m, v) in ops:
            key = (kind, v * S + d, m)
            assert key not in at
            at[key] = t
        if V == 1:
            # 1F1B: at most S - d micro-batches in flight on stage d
            live = peak = 0
            for _, (kind, _, _) in ops:
                live += 1 if kind == "F" else -1
                peak = max(peak, live)
            assert peak <= S - d
    assert len(at) == 2 * G * M
    for (kind, g, m), t in at.items():
        if kind == "F" and g > 0:
            assert at[("F", g - 1, m)] < t
        if kind == "B":
            assert at[("F", g, m)] < t
            if g < G - 1:
                assert at[("B", g + 1, m)] < t


@pytest.mark.parametrize("S,V,M", [(2, 2, 3), (2, 2, 5), (4, 2, 6),
                                   (3, 3, 4)])
def test_interleaved_rejects_bad_M_as_the_reference(S, V, M):
    import jax.numpy as jnp
    from paddle_tpu.distributed.spmd import spmd_pipeline_interleaved as J
    from paddle_tpu_torch.distributed.spmd import spmd_pipeline_interleaved
    with pytest.raises(ValueError, match="multiple of the pipeline"):
        J(lambda c, x, m, v: x, jnp.zeros((V, 2)), jnp.zeros((M, 2, 2)),
          S, V, axis="pipe")
    with pytest.raises(ValueError, match="multiple of the pipeline"):
        spmd_pipeline_interleaved(lambda c, x, m, v: x, torch.zeros(V, 2),
                                  torch.zeros(M, 2, 2), S, V)


@pytest.mark.parametrize("S,V,lpc", [(2, 3, 2), (4, 2, 1), (2, 2, 3)])
def test_interleave_layers_round_trip_matches_the_reference(S, V, lpc):
    from paddle_tpu.distributed.pipeline_engine import \
        interleave_layers as J
    from paddle_tpu_torch.distributed.pipeline_engine import (
        deinterleave_layers, interleave_layers)
    L = S * V * lpc
    x = np.arange(L * 4.0, dtype=np.float32).reshape(L, 4)
    t = torch.from_numpy(x)
    y = interleave_layers(t, S, V)
    np.testing.assert_array_equal(y.numpy(), np.asarray(J(x, S, V)))
    for d in range(S):
        for v in range(V):
            for i in range(lpc):
                assert torch.equal(y[d * V * lpc + v * lpc + i],
                                   t[(v * S + d) * lpc + i])
    assert torch.equal(deinterleave_layers(y, S, V), t)
    np.testing.assert_array_equal(interleave_layers(x, S, V), y.numpy())


def test_override_leading_axis_matches_the_reference():
    from paddle_tpu.distributed.sharding_rules import \
        override_leading_axis as J
    from jax.sharding import PartitionSpec as JP
    from paddle_tpu_torch.distributed.sharding_rules import (
        PartitionSpec as P, override_leading_axis)
    for spec, ndim in ((P(), 3), (P(None, None, "model"), 3),
                       (P("data"), 2), (P(None, "model"), 2)):
        got = override_leading_axis(spec, ndim, "pipe")
        want = J(JP(*spec), ndim, "pipe")
        assert tuple(got) == tuple(want)


def test_pipe_layout_is_the_reference_mesh(ranks):
    """dp 2 x pp 2: rank r sits at flat position r of the reference's
    mesh; its pipe group varies only the pipe coordinate, its neighbours
    are that group's other rank, and the mode is PipelineParallel."""
    from paddle_tpu.distributed import HybridCommunicateGroup as JH
    jh = JH(dp_degree=2, pp_degree=2)
    jmesh = jh.mesh
    assert jh.get_parallel_mode() == "PipelineParallel"
    for r, rk in enumerate(ranks[4]):
        t = rk["topology"]
        coord = dict(zip(jmesh.axis_names, (int(i) for i in np.unravel_index(
            r, jmesh.devices.shape))))
        assert t["coord"] == coord
        pipe = [2 * (r // 2), 2 * (r // 2) + 1]
        assert t["ranks"] == pipe and t["pp"] == 2
        assert t["stage"] == coord["pipe"]
        assert (t["first"], t["last"]) == (coord["pipe"] == 0,
                                           coord["pipe"] == 1)
        other = pipe[1 - coord["pipe"]]
        assert t["next"] == other and t["prev"] == other
        assert t["sum"] == float(sum(pipe))
        assert t["mode"] == "PipelineParallel"

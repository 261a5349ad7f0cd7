"""Batch statistics, buffers and dropout draws of the port's mesh train
step (``distributed/spmd.py`` ``make_spmd_train_step`` over 2 and 4 gloo
ranks) against the reference's ``make_spmd_train_step`` on its CPU mesh.

The reference jits one GSPMD program, so a batch norm's mean covers the
global batch and a dropout mask is drawn over the global batch from one
key.  Each port rank computes its rows of that: the per-channel sums are
all-reduced over the batch ranks, and a rank's mask is its counter range
of the global draw (``core.rng.row_block``).

Arms, each on both worlds unless named:
- C4's repro (``Linear, BatchNorm1D, ReLU, Linear``, SGD 0.1, 3 steps on
  a batch whose halves differ): losses within 1e-6 relative, parameters
  within 1e-5, running statistics within 1e-5 and bit-equal across ranks;
- the same under ``donate=False`` (the layer's own buffers untouched) and
  after ``SyncBatchNorm.convert_sync_batchnorm`` (bit-equal to the plain
  run);
- ``accumulate_steps=2`` (C5 and the micro-batch rows: micro-batch m of
  the global rows first, then this rank's share; the buffers come back
  as given);
- C4's repro through ZeRO's offload step (the layer's own running
  statistics, advanced from the global batch's);
- the masks of ``dropout``, ``dropout2d``, ``alpha_dropout`` and
  ``dropout(axis=1)`` inside a step, at 2 rows a rank and at one: a
  rank's bit-equal to its rows of the reference's global masks;
- a conv net with ``BatchNorm2D`` and ``Dropout`` in float64 over 3 steps,
  within 1e-8;
- ``mobilenet_v2`` (scale 0.25; it draws and normalises) in float64 for
  2 steps at dp 2 (B 8, 64x64), within 1e-8;
- eager ``DataParallel`` (dp 2): a rank's forward rows and running
  statistics against the reference's layer on the whole batch;
- ``SpectralNorm``'s u and v through the step at dp 2 (advanced from the
  replicated weight, equal on both ranks).

One spawn per world (module fixtures, started before the JAX side runs);
the spawned ranks import this module, so it imports no JAX at its top.
"""

import contextlib
import functools
import gc
import os
import pickle
import sys

import numpy as np
import pytest
import torch

B, STEPS, LR = 16, 3, 0.1
RTOL, P_TOL = 1e-6, 1e-5
F64 = 1e-8
BASE = np.array([0, 21], np.uint32)
#: the arms each world runs (the accumulating and zoo arms on two only)
ARMS = {2: ("c4", "kept", "sync", "accum", "offload", "masks", "conv", "zoo",
            "eager", "spectral"),
        4: ("c4", "kept", "sync", "accum", "offload", "masks", "conv")}


def _key(i):
    from paddle_tpu_torch.core import rng
    return rng.fold_in(BASE, i)


def _c4_batch():
    """C4's batch: 16 rows whose second half is scaled by 3 and shifted
    by 2, so a half's statistics differ from the whole's."""
    r = np.random.RandomState(1)
    x = r.standard_normal((B, 10)).astype(np.float32)
    x[8:] = x[8:] * 3 + 2
    return x, r.randint(0, 4, B).astype(np.int64)


def _conv_batches():
    r = np.random.RandomState(4)
    return [(r.randn(8, 3, 6, 6), r.randint(0, 5, 8).astype(np.int64))
            for _ in range(STEPS)]


def _zoo_batches():
    r = np.random.RandomState(6)
    return [(r.randn(8, 3, 64, 64), r.randint(0, 10, 8).astype(np.int64))
            for _ in range(2)]


MASK_X = np.ones((8, 4, 3, 3), np.float32)


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t


# ------------------------------------------------------- the port side --

def _mlp():
    from paddle_tpu_torch import nn
    with nn.building("cpu"):
        return nn.Sequential(nn.Linear(10, 16), nn.BatchNorm1D(16),
                             nn.ReLU(), nn.Linear(16, 4))


def _conv_net():
    from paddle_tpu_torch import nn
    with nn.building("cpu"):
        return nn.Sequential(nn.Conv2D(3, 4, 3, padding=1),
                             nn.BatchNorm2D(4), nn.ReLU(), nn.Dropout(0.3),
                             nn.Flatten(), nn.Linear(4 * 6 * 6, 5))


def _sn_net():
    """``Linear(10, 4)`` whose weight goes through ``SpectralNorm``."""
    from paddle_tpu_torch import nn

    class SN(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([10, 4])
            self.sn = nn.SpectralNorm([10, 4], 1, 2)

        def forward(self, x):
            return x @ self.sn(self.weight)
    with nn.building("cpu"):
        return SN()


class _Draws(torch.nn.Module):
    """Records the dropouts' outputs of its input (ones): over every dim,
    over channels (``dropout2d``), ``alpha_dropout``, and along axis 1
    alone (a mask broadcast over the batch)."""

    def __init__(self):
        super().__init__()
        self.w = torch.nn.Parameter(torch.ones(()))
        self.seen = []

    def forward(self, x):
        from paddle_tpu_torch.nn import functional as F
        y = x * self.w
        outs = [F.dropout(y, 0.5), F.dropout2d(y, 0.5),
                F.alpha_dropout(y, 0.5), F.dropout(y, 0.5, axis=1)]
        self.seen = [_np(o) for o in outs]
        return sum(o.sum() for o in outs)


def _ce(o, y):
    from paddle_tpu_torch.nn import functional as F
    return F.cross_entropy(o, y)


def _trajectory(step, state, batches):
    losses = []
    for i, (x, y) in enumerate(batches):
        state, loss = step(state, _key(i), LR, [torch.from_numpy(x)],
                           [torch.from_numpy(y)])
        losses.append(float(loss))
    return {"losses": losses, "params": _np(state["params"]),
            "buffers": _np(state["buffers"])}


def _port_arm(kind, hcg, init):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import make_spmd_train_step
    from paddle_tpu_torch.optimizer import SGD
    from paddle_tpu_torch.vision.models import (mobilenet_v2,
                                                params_from_numpy)
    if kind in ("c4", "kept", "sync", "accum"):
        net = params_from_numpy(_mlp(), *init["mlp"])
        if kind == "sync":
            nn.SyncBatchNorm.convert_sync_batchnorm(net)
        own = {n: b.clone() for n, b in net.named_buffers()}
        step, st, _ = make_spmd_train_step(
            net, _ce, SGD(LR), hcg, donate=kind != "kept",
            accumulate_steps=2 if kind == "accum" else 1)
        out = _trajectory(step, st, [_c4_batch()] * STEPS)
        out["own"] = _np(dict(net.named_buffers()))
        out["own_moved"] = any(not torch.equal(own[n], b)
                               for n, b in net.named_buffers())
        return out
    if kind == "offload":
        from paddle_tpu_torch.core import rng
        from paddle_tpu_torch.distributed.zero import make_zero_train_step
        from paddle_tpu_torch.jit.functional import _make_loss_of
        net = params_from_numpy(_mlp(), *init["mlp"])
        step, st = make_zero_train_step(
            _make_loss_of(net, _ce, None, []), dict(net.named_parameters()),
            SGD(LR), hcg.mesh, layer=net, offload=True)
        losses = []
        for i, (x, y) in enumerate([_c4_batch()] * STEPS):
            with rng.rng_scope(_key(i)):
                st, loss = step(st, LR, [torch.from_numpy(x)],
                                [torch.from_numpy(y)])
            losses.append(float(loss))
        return {"losses": losses, "params": _np(st["params"]),
                "buffers": _np(dict(net.named_buffers()))}
    if kind == "masks":
        net = _Draws()
        step, st, _ = make_spmd_train_step(net, lambda o: o, SGD(LR), hcg)
        out = {}
        for rows in (len(MASK_X), hcg.mesh.size):   # then one row a rank
            step(st, _key(0), 0.0, [torch.from_numpy(MASK_X[:rows])], [])
            out[rows] = net.seen
        return out
    if kind == "conv":
        net = params_from_numpy(_conv_net().double(), *init["conv"])
        step, st, _ = make_spmd_train_step(net, _ce, SGD(LR), hcg)
        return _trajectory(step, st, _conv_batches())
    if kind == "zoo":
        torch.set_num_threads(1)
        net = mobilenet_v2(scale=0.25, num_classes=10, device="cpu").double()
        params_from_numpy(net, *init["zoo"])
        step, st, _ = make_spmd_train_step(net, _ce, SGD(LR), hcg)
        return _trajectory(step, st, _zoo_batches())
    if kind == "spectral":
        net = params_from_numpy(_sn_net(), *init["sn"])
        step, st, _ = make_spmd_train_step(net, _ce, SGD(LR), hcg)
        return _trajectory(step, st, [_c4_batch()] * 2)
    # eager DataParallel: this rank's rows through the wrapped layer
    from paddle_tpu_torch.distributed.fleet import DataParallel
    net = params_from_numpy(_mlp(), *init["mlp"])
    dp = DataParallel(net)
    x, _ = _c4_batch()
    n = B // hcg.mesh.size
    out = dp(torch.from_numpy(x[hcg.mesh.rank * n:(hcg.mesh.rank + 1) * n]))
    return {"out": _np(out), "buffers": _np(dict(net.named_buffers()))}


def _rank_main(rank, world, tmp, init):
    import datetime
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": world}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    out = {kind: _port_arm(kind, hcg, init) for kind in ARMS[world]}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), init),
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

class _x64:
    def __enter__(self):
        import jax
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        import jax
        jax.config.update("jax_enable_x64", False)


def _state(layer):
    from paddle_tpu.jit import functional as jf
    _, p, b = jf.functionalize(layer)
    return ({n: np.asarray(v) for n, v in p.items()},
            {n: np.asarray(v) for n, v in b.items()})


def _jax_layer(kind, init=None):
    """The reference's layer of an arm; given ``init``, holding it."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    paddle.seed(5)
    if kind == "mlp":
        m = jnn.Sequential(jnn.Linear(10, 16), jnn.BatchNorm1D(16),
                           jnn.ReLU(), jnn.Linear(16, 4))
    elif kind == "sn":
        class SN(jnn.Layer):
            def __init__(self):
                super().__init__()
                self.weight = self.create_parameter([10, 4])
                self.sn = jnn.SpectralNorm([10, 4], 1, 2)

            def forward(self, x):
                return paddle.matmul(x, self.sn(self.weight))
        m = SN()
    elif kind == "conv":
        m = jnn.Sequential(jnn.Conv2D(3, 4, 3, padding=1),
                           jnn.BatchNorm2D(4), jnn.ReLU(), jnn.Dropout(0.3),
                           jnn.Flatten(), jnn.Linear(4 * 6 * 6, 5))
    else:
        from test_torch_vision_families import reference_shell
        from paddle_tpu.vision.models import mobilenet_v2 as jmobilenet_v2
        m = reference_shell(lambda: jmobilenet_v2(scale=0.25,
                                                  num_classes=10))
    if init is not None:
        params, buffers = init
        for n, p in m.named_parameters():
            p._data = jnp.array(params[n], copy=True)
        for n, b in m.named_buffers():
            b._data = jnp.array(buffers[n], copy=True)
    return m


def _init():
    """The arms' initial weights: the reference's draws for the MLP and
    the conv net (float64 for the latter), the port's for the zoo model
    (the reference's eager build would take seconds)."""
    from paddle_tpu_torch.vision.models import mobilenet_v2
    mlp = _state(_jax_layer("mlp"))
    conv = tuple({n: v.astype(np.float64) for n, v in d.items()}
                 for d in _state(_jax_layer("conv")))
    torch.manual_seed(0)
    zoo = mobilenet_v2(scale=0.25, num_classes=10, device="cpu").double()
    return {"mlp": mlp, "conv": conv, "sn": _state(_jax_layer("sn")),
            "zoo": ({n: _np(p) for n, p in zoo.named_parameters()},
                    {n: _np(b) for n, b in zoo.named_buffers()})}


def _jax_hcg(dp):
    from paddle_tpu.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": 1}
    fleet.fleet.init(is_collective=True, strategy=st)
    return fleet.fleet.get_hybrid_communicate_group()


@functools.lru_cache(maxsize=None)
def _jax_run(kind, dp, accumulate=1):
    """The reference's ``make_spmd_train_step`` trajectory of an arm on a
    mesh of ``dp`` devices: losses, parameters and buffers."""
    import jax
    import jax.numpy as jnp
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.distributed import make_spmd_train_step
    from paddle_tpu.optimizer import SGD
    init = INIT[0]
    layer = "mlp" if kind == "sync" else kind
    batches = {"mlp": [_c4_batch()] * STEPS, "conv": _conv_batches(),
               "zoo": _zoo_batches(), "sn": [_c4_batch()] * 2}[layer]
    with (_x64() if layer in ("conv", "zoo") else contextlib.nullcontext()):
        m = _jax_layer(layer, init[layer])
        if kind == "sync":
            import paddle_tpu.nn as jnn
            jnn.SyncBatchNorm.convert_sync_batchnorm(m)
        step, st, _ = make_spmd_train_step(
            m, lambda o, y: JF.cross_entropy(o, y), SGD(LR), _jax_hcg(dp),
            accumulate_steps=accumulate, donate=False)
        losses = []
        for i, (x, y) in enumerate(batches):
            st, loss = step(st, jnp.asarray(_key(i)), LR, [x],
                            [y])
            losses.append(float(loss))
        got = {"losses": losses,
               "params": {n: np.asarray(jax.device_get(v))
                          for n, v in st["params"].items()},
               "buffers": {n: np.asarray(jax.device_get(v))
                           for n, v in st["buffers"].items()}}
    return got


#: the initial weights, made once by the ``init`` fixture
INIT = []


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's cached reference runs when it ends (a later
    module in the same process ranks the live JAX arrays)."""
    yield
    _jax_run.cache_clear()
    INIT.clear()
    gc.collect()


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    INIT[:] = [_init()]
    return {w: _start(w, tmp_path_factory.mktemp(f"bs{w}"), INIT[0])
            for w in (2, 4)}


@pytest.fixture(scope="module")
def ranks2(started):
    return _finish(started[2])


@pytest.fixture(scope="module")
def ranks4(started):
    return _finish(started[4])


@pytest.fixture(scope="module")
def reference(started):
    """Every reference run the tests read, made while the ranks run."""
    for dp in (1, 2, 4):
        _jax_run("mlp", dp)
        _jax_run("mlp", dp, accumulate=2)
    for dp in (2, 4):
        _jax_run("sync", dp)
        _jax_run("conv", dp)
    _jax_run("zoo", 2)
    _jax_run("sn", 2)


def _ranks(request, dp):
    request.getfixturevalue("reference")
    return request.getfixturevalue(f"ranks{dp}")


def _close(got, want, rtol, atol, msg):
    assert set(got) == set(want), msg
    for n in want:
        np.testing.assert_allclose(got[n], want[n], rtol=rtol, atol=atol,
                                   err_msg=f"{msg} {n}")


def _held(arm, want, tol, msg):
    np.testing.assert_allclose(arm["losses"], want["losses"], rtol=tol[0],
                               err_msg=f"{msg} losses")
    _close(arm["params"], want["params"], tol[1], tol[1], f"{msg} params")
    _close(arm["buffers"], want["buffers"], tol[1], tol[1],
           f"{msg} buffers")


def _bit_equal_across(ranks, arm, part="buffers"):
    for rk in ranks[1:]:
        for n, v in ranks[0][arm][part].items():
            np.testing.assert_array_equal(rk[arm][part][n], v,
                                          err_msg=f"{arm} {part} {n}")


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("dp", [2, 4])
def test_c4_global_batch_statistics_match_the_reference(request, dp):
    """C4: each rank normalised by its own rows' statistics and advanced
    its own running statistics from them; now the losses, parameters and
    running statistics are the reference's GSPMD step's, whose dp 2 and
    dp 4 runs equal its one-device run."""
    ranks = _ranks(request, dp)
    want = _jax_run("mlp", dp)
    np.testing.assert_allclose(want["losses"], _jax_run("mlp", 1)["losses"],
                               rtol=RTOL)
    for r, rk in enumerate(ranks):
        _held(rk["c4"], want, (RTOL, P_TOL), f"dp {dp} rank {r}")
    _bit_equal_across(ranks, "c4")
    _bit_equal_across(ranks, "c4", "params")


@pytest.mark.parametrize("dp", [2, 4])
def test_zero_offload_takes_the_global_batch_statistics(request, dp):
    """ZeRO's offload step runs its forward in the mesh step's scope: the
    reference's C4 trajectory, the running statistics (the layer's own,
    the offload state holds none) bit-equal across ranks."""
    ranks = _ranks(request, dp)
    want = _jax_run("mlp", dp)
    for rk in ranks:
        _held(rk["offload"], want, (RTOL, P_TOL), f"offload dp {dp}")
    _bit_equal_across(ranks, "offload")


@pytest.mark.parametrize("dp", [2, 4])
def test_kept_state_advances_clones_and_leaves_the_layer(request, dp):
    """``donate=False``: the forward advances clones of the state's
    buffers and returns them; the layer's own stay as built."""
    ranks = _ranks(request, dp)
    for rk in ranks:
        assert not rk["kept"]["own_moved"]
        _held(rk["kept"], rk["c4"], (0, 0), "kept vs donated")
        assert rk["c4"]["own_moved"]      # donated: the layer's own moved


@pytest.mark.parametrize("dp", [2, 4])
def test_sync_batch_norm_equals_batch_norm_over_the_mesh(request, dp):
    ranks = _ranks(request, dp)
    for rk in ranks:
        _held(rk["sync"], rk["c4"], (0, 0), "SyncBatchNorm vs BatchNorm")
    _held(ranks[0]["sync"], _jax_run("sync", dp), (RTOL, P_TOL),
          "SyncBatchNorm vs the reference's")


@pytest.mark.parametrize("dp", [2, 4])
def test_accumulation_takes_micro_batches_of_the_global_rows(request, dp):
    """C5 and the micro-batch rows: micro-batch m is the global batch's
    rows [m B/2, (m+1) B/2), of which this rank takes its share; the
    buffers come back as given (the reference's zeros and ones)."""
    ranks = _ranks(request, dp)
    want = _jax_run("mlp", dp, accumulate=2)
    for r, rk in enumerate(ranks):
        _held(rk["accum"], want, (RTOL, P_TOL), f"dp {dp} rank {r}")
        assert not rk["accum"]["own_moved"]
        np.testing.assert_array_equal(rk["accum"]["buffers"]["1._mean"], 0)
        np.testing.assert_array_equal(
            rk["accum"]["buffers"]["1._variance"], 1)


def test_c5_one_rank_accumulation_returns_the_buffers_as_given():
    import types
    from paddle_tpu_torch.distributed import make_spmd_train_step
    from paddle_tpu_torch.distributed.topology import ProcessMesh
    from paddle_tpu_torch.optimizer import SGD
    if not INIT:
        INIT[:] = [_init()]
    from paddle_tpu_torch.vision.models import params_from_numpy
    net = params_from_numpy(_mlp(), *INIT[0]["mlp"])
    hcg = types.SimpleNamespace(mesh=ProcessMesh(["data"], [1]))
    step, st, _ = make_spmd_train_step(net, _ce, SGD(LR), hcg,
                                       accumulate_steps=2)
    got = _trajectory(step, st, [_c4_batch()] * STEPS)
    _held(got, _jax_run("mlp", 1, accumulate=2), (RTOL, P_TOL), "one rank")
    np.testing.assert_array_equal(got["buffers"]["1._mean"], 0)
    np.testing.assert_array_equal(net[1]._variance.numpy(), 1)


@pytest.mark.parametrize("one_row", [False, True])
@pytest.mark.parametrize("dp", [2, 4])
def test_a_ranks_masks_are_its_rows_of_the_global_masks(request, dp,
                                                        one_row):
    """A rank's masks are its rows of the reference's masks over the
    global batch (8 rows, or one row a rank); a mask along axis 1 alone
    is broadcast over the batch, so every rank's is the whole one."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.nn.functional as JF
    from paddle_tpu.core import rng as jrng
    ranks = _ranks(request, dp)
    rows = dp if one_row else len(MASK_X)
    x = paddle.to_tensor(jnp.asarray(MASK_X[:rows]))
    with jrng.rng_scope(jnp.asarray(_key(0))):
        want = [np.asarray(JF.dropout(x, 0.5)._data),
                np.asarray(JF.dropout2d(x, 0.5)._data),
                np.asarray(JF.alpha_dropout(x, 0.5)._data),
                np.asarray(JF.dropout(x, 0.5, axis=1)._data)]
    n = rows // dp
    for r, rk in enumerate(ranks):
        got = rk["masks"][rows]
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[r * n:(r + 1) * n])
    assert 0 < int((want[0] == 0).sum()) < want[0].size


@pytest.mark.parametrize("dp", [2, 4])
def test_conv_net_with_batch_norm_and_dropout_float64(request, dp):
    ranks = _ranks(request, dp)
    want = _jax_run("conv", dp)
    for r, rk in enumerate(ranks):
        _held(rk["conv"], want, (F64, F64), f"dp {dp} rank {r}")
    _bit_equal_across(ranks, "conv")


def test_mobilenet_v2_draws_and_normalises_at_dp2(request):
    ranks2 = _ranks(request, 2)
    want = _jax_run("zoo", 2)
    for r, rk in enumerate(ranks2):
        _held(rk["zoo"], want, (F64, F64), f"rank {r}")
    _bit_equal_across(ranks2, "zoo")


def test_eager_data_parallel_takes_the_whole_batch_statistics(request):
    """The reference's ``DataParallel`` runs its layer on the whole batch
    on one controller; a port rank's forward of its rows gives those rows
    of that output and the same running statistics."""
    import jax.numpy as jnp
    import paddle_tpu as paddle
    ranks2 = _ranks(request, 2)
    m = _jax_layer("mlp", INIT[0]["mlp"])
    m.train()
    x, _ = _c4_batch()
    out = np.asarray(m(paddle.to_tensor(jnp.asarray(x)))._data)
    _, buffers = _state(m)
    for r, rk in enumerate(ranks2):
        got = rk["eager"]
        np.testing.assert_allclose(got["out"], out[r * 8:(r + 1) * 8],
                                   rtol=P_TOL, atol=P_TOL)
        _close(got["buffers"], buffers, P_TOL, P_TOL, f"rank {r}")


def test_spectral_norm_buffers_through_the_mesh_step(request):
    """u and v advance from the replicated weight on every rank, as the
    reference's GSPMD step returns them."""
    ranks2 = _ranks(request, 2)
    want = _jax_run("sn", 2)
    assert not np.allclose(want["buffers"]["sn.weight_u"],
                           INIT[0]["sn"][1]["sn.weight_u"])
    for r, rk in enumerate(ranks2):
        _held(rk["spectral"], want, (RTOL, P_TOL), f"rank {r}")
    _bit_equal_across(ranks2, "spectral")

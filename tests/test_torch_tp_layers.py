"""Port parity for the tensor-parallel layers and collectives
(``paddle_tpu_torch/distributed/fleet/meta_parallel/parallel_layers``,
``distributed/collective.py``'s autograd collectives and ``split``,
``core/rng.py``'s tracker) against the JAX package.

Each layer runs on 2 and on 4 gloo ranks (one spawn a world size, a
hybrid group with ``mp_degree`` the world) and is held against the
reference's own layer under ``shard_map`` over a ("model",) mesh of as
many CPU devices, its parameters swapped for the device's shard of the
same full weight: forward and the gradients of every input within 1e-5.
Embedding ids fall on every shard edge; cross-entropy labels too, with
``ignore_index`` rows: the port gives them 0 and no gradient (Paddle's
c_softmax_with_cross_entropy and the reference's one-rank path), where
the reference's shard_map arm reads the label as an index
(``ROADMAP.md`` §C), so those rows are held against the reference's
one-rank layer; the shard_map arm has no gradient (``lax.pmax`` has no
differentiation rule), so the gradient is held against the one-rank
layer's.  ``split`` builds the same layers from global sizes; the
reference's is called in ``shard_map`` with the local sizes and the
device's shard.  The tracker's streams equal the reference's bit for bit
(one process).  The spawned ranks import this module, so it imports no
JAX at its top.
"""

import datetime
import gc
import inspect
import os
import pickle
import sys

import numpy as np
import pytest
import torch

V, H, IN, OUT, N = 16, 8, 8, 16, 6
TOL = dict(rtol=1e-5, atol=1e-5)
IGNORE = -100


def _data():
    r = np.random.RandomState(1)
    edges = [0, 3, 4, 7, 8, 11, 12, 15]          # every shard edge at mp 2, 4
    return dict(
        E=r.standard_normal((V, H)).astype(np.float32),
        ids=np.array([edges, r.randint(0, V, 8)]),
        cot_e=r.standard_normal((2, 8, H)).astype(np.float32),
        Wc=r.standard_normal((IN, OUT)).astype(np.float32),
        bc=r.standard_normal(OUT).astype(np.float32),
        x=r.standard_normal((3, IN)).astype(np.float32),
        cot_c=r.standard_normal((3, OUT)).astype(np.float32),
        Wr=r.standard_normal((OUT, IN)).astype(np.float32),
        br=r.standard_normal(IN).astype(np.float32),
        xr=r.standard_normal((3, OUT)).astype(np.float32),
        cot_r=r.standard_normal((3, IN)).astype(np.float32),
        logits=(r.standard_normal((N, V)) * 3).astype(np.float32),
        labels=np.array([0, 7, IGNORE, 8, 15, IGNORE]),
        cot_ce=r.standard_normal(N).astype(np.float32),
        q=r.standard_normal((2, 8, 4, 3)).astype(np.float32))


def _blk(a, axis, r, n):
    s = a.shape[axis] // n
    return np.take(a, range(r * s, (r + 1) * s), axis=axis)


# ------------------------------------------------------- the port side --

def _port_cases(d):
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu_torch.nn.initializer import Assign
    from paddle_tpu_torch.nn.layer.base import building

    hcg = fleet.get_hybrid_communicate_group()
    g = hcg.get_model_parallel_group()
    r, n = g.rank, g.nranks
    out = {"mp_rank": hcg.get_model_parallel_rank()}

    def leaf(a):
        return torch.tensor(a).requires_grad_(True)

    def np_(t):
        return t.detach().numpy().copy()

    with building("cpu"):
        emb = VocabParallelEmbedding(V, H, weight_attr=Assign(d["E"]))
        e = emb(torch.tensor(d["ids"]))
        (e * torch.tensor(d["cot_e"])).sum().backward()
        out["emb"] = (np_(e), np_(emb.weight.grad), np_(emb.weight),
                      emb.weight._dims_mapping)
        for gather in (True, False):
            col = ColumnParallelLinear(IN, OUT, weight_attr=Assign(d["Wc"]),
                                       gather_output=gather)
            with torch.no_grad():
                col.bias.copy_(torch.tensor(_blk(d["bc"], 0, r, n)))
            x = leaf(d["x"])
            y = col(x)
            cot = d["cot_c"] if gather else _blk(d["cot_c"], 1, r, n)
            (y * torch.tensor(cot)).sum().backward()
            out[f"col_{gather}"] = (np_(y), np_(x.grad), np_(col.weight.grad),
                                    np_(col.bias.grad))
        for parallel in (True, False):
            row = RowParallelLinear(OUT, IN, weight_attr=Assign(d["Wr"]),
                                    input_is_parallel=parallel)
            with torch.no_grad():
                row.bias.copy_(torch.tensor(d["br"]))
            x = leaf(_blk(d["xr"], 1, r, n) if parallel else d["xr"])
            y = row(x)
            (y * torch.tensor(d["cot_r"])).sum().backward()
            out[f"row_{parallel}"] = (np_(y), np_(x.grad),
                                      np_(row.weight.grad),
                                      np_(row.bias.grad))
        lg = leaf(_blk(d["logits"], 1, r, n))
        loss = ParallelCrossEntropy(ignore_index=IGNORE)(
            lg, torch.tensor(d["labels"]))
        (loss[:, 0] * torch.tensor(d["cot_ce"])).sum().backward()
        out["ce"] = (np_(loss), np_(lg.grad))
        out["split"] = {
            "embedding": np_(C.split(torch.tensor(d["ids"]), (V, H),
                                     "embedding",
                                     weight_attr=Assign(d["E"]))),
            "col": np_(C.split(torch.tensor(d["x"]), (IN, OUT), "linear",
                               axis=1, weight_attr=Assign(d["Wc"]))),
            "row": np_(C.split(torch.tensor(d["xr"]), (OUT, IN), "linear",
                               axis=0, weight_attr=Assign(d["Wr"])))}
    out["spmd"] = _spmd_losses(d, hcg)
    # TensorParallel (fleet.distributed_model's route under mp): the
    # parameters the model ranks replicate come from the group's first
    # rank, a rank's block stays its own
    with building("cpu"):
        net = torch.nn.Sequential(
            ColumnParallelLinear(IN, OUT, gather_output=False),
            RowParallelLinear(OUT, IN, input_is_parallel=True))
    with torch.no_grad():
        net[1].bias.fill_(float(r + 1))
        net[0].weight.fill_(float(r + 1))
    wrapped = fleet.distributed_model(net)
    out["tensor_parallel"] = (type(wrapped).__name__,
                              hcg.get_parallel_mode(),
                              float(net[1].bias[0]),
                              float(net[0].weight[0, 0]))
    # the autograd collectives: forward, and the gradient of sum(y * cot)
    q = _blk(d["q"], 1, r, n)
    cots = {}
    for name, fn in (("gather", lambda t: C.gather_along(t, 1, g)),
                     ("a2a", lambda t: C.all_to_all_along(t, 2, 1, g)),
                     ("a2a_inv", lambda t: C.all_to_all_along(t, 1, 2, g))):
        src = d["q"] if name == "a2a_inv" else q
        if name == "a2a_inv":
            src = _blk(d["q"], 2, r, n)
        t = leaf(src)
        y = fn(t)
        cot = np.cos(np.arange(y.numel(), dtype=np.float32)).reshape(
            y.shape) * (r + 1)
        cots[name] = cot
        (y * torch.tensor(cot)).sum().backward()
        out[f"coll_{name}"] = (np_(y), np_(t.grad))
    return out


def _mlp(d):
    """Column- then row-parallel MLP with ``d``'s weights (dense without
    a model group), built on the CPU."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, RowParallelLinear)
    from paddle_tpu_torch.nn.initializer import Assign
    from paddle_tpu_torch.nn.layer.base import building
    with building("cpu"):
        return torch.nn.Sequential(
            ColumnParallelLinear(IN, OUT, weight_attr=Assign(d["Wc"]),
                                 gather_output=False),
            torch.nn.Tanh(),
            RowParallelLinear(OUT, IN, weight_attr=Assign(d["Wr"]),
                              input_is_parallel=True))


def _spmd_losses(d, hcg):
    """``make_spmd_train_step`` over the tensor-parallel MLP (its blocks
    held as they are): 3 SGD steps' losses and the state's specs."""
    from paddle_tpu_torch.distributed import make_spmd_train_step
    import paddle_tpu_torch.optimizer as TO
    step, st, specs = make_spmd_train_step(_mlp(d), torch.nn.MSELoss(),
                                           TO.SGD(0.1), hcg)
    losses = []
    for _ in range(3):
        st, loss = step(st, 0, 0.1, [torch.tensor(d["x"])],
                        [torch.tensor(d["cot_r"])])
        losses.append(float(loss))
    return losses, {n: tuple(v) for n, v in specs["params"].items()}


def _rank_main(rank, world, tmp, d):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"mp_degree": world}
    fleet.init(is_collective=True, strategy=st)
    assert "jax" not in sys.modules
    torch.manual_seed(0)
    out = _port_cases(d)
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, d):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), d),
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

def _shard_map():
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    return shard_map


def _sm(fn, mesh, in_specs, out_specs):
    """``shard_map`` without the replication check (the reference's
    layers reach their collectives through its eager ``apply``, which the
    check cannot see through), jitted."""
    import jax
    sm = _shard_map()
    key = ("check_vma" if "check_vma" in inspect.signature(sm).parameters
           else "check_rep")
    return jax.jit(sm(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                      **{key: False}))


def _jax_mesh(mp):
    import jax
    from jax.sharding import Mesh
    from paddle_tpu.distributed.topology import (
        HybridCommunicateGroup, set_hybrid_communicate_group)
    set_hybrid_communicate_group(HybridCommunicateGroup(mp_degree=mp))
    return Mesh(np.array(jax.devices()[:mp]), ("model",))


def _swap_call(layer, names, fn):
    """A function of (inputs..., params...) that calls ``fn(*inputs)``
    with ``layer``'s parameters ``names`` swapped for the given arrays."""
    def body(*args):
        k = len(args) - len(names)
        saved = [getattr(layer, n)._data for n in names]
        for nm, a in zip(names, args[k:]):
            getattr(layer, nm)._data = a
        try:
            return fn(*args[:k])
        finally:
            for nm, a in zip(names, saved):
                getattr(layer, nm)._data = a
    return body


def _jax_ref(mp, d):
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P
    from paddle_tpu.core.tensor import Tensor
    from paddle_tpu.distributed import collective as JC
    from paddle_tpu.distributed.fleet.meta_parallel import (
        ColumnParallelLinear, ParallelCrossEntropy, RowParallelLinear,
        VocabParallelEmbedding)
    from paddle_tpu.framework.param_attr import ParamAttr
    from paddle_tpu.nn.initializer import Initializer

    mesh = _jax_mesh(mp)
    J = {k: jnp.asarray(v) for k, v in d.items()}
    ref = {}

    def grad_of(f, argnums, cot):
        return jax.jit(jax.grad(lambda *a: jnp.sum(f(*a) * cot),
                                argnums=argnums))

    emb = VocabParallelEmbedding(V, H)
    f = _sm(_swap_call(emb, ["weight"], lambda i: emb(Tensor(i))._data),
            mesh, (P(), P("model", None)), P())
    ref["emb"] = (f(J["ids"], J["E"]),
                  grad_of(f, 1, J["cot_e"])(J["ids"], J["E"]))
    for gather in (True, False):
        col = ColumnParallelLinear(IN, OUT, gather_output=gather)
        f = _sm(_swap_call(col, ["weight", "bias"],
                           lambda x: col(Tensor(x))._data), mesh,
                (P(), P(None, "model"), P("model")),
                P() if gather else P(None, "model"))
        args = (J["x"], J["Wc"], J["bc"])
        ref[f"col_{gather}"] = (f(*args), *grad_of(f, (0, 1, 2),
                                                   J["cot_c"])(*args))
    for parallel in (True, False):
        row = RowParallelLinear(OUT, IN, input_is_parallel=parallel)
        f = _sm(_swap_call(row, ["weight", "bias"],
                           lambda x: row(Tensor(x))._data), mesh,
                (P(None, "model") if parallel else P(), P("model", None),
                 P()), P())
        args = (J["xr"], J["Wr"], J["br"])
        ref[f"row_{parallel}"] = (f(*args), *grad_of(f, (0, 1, 2),
                                                     J["cot_r"])(*args))
    ce = ParallelCrossEntropy(ignore_index=IGNORE)
    f = _sm(lambda lg, y: ce(Tensor(lg), Tensor(y))._data[:, 0], mesh,
            (P(None, "model"), P()), P())
    ce_fwd = f(J["logits"], J["labels"])
    # the one-rank layer: the ignored rows, and the gradient (the
    # shard_map arm's pmax has no differentiation rule)
    _jax_mesh(1)

    def one(lg):
        return ParallelCrossEntropy(ignore_index=IGNORE)(
            Tensor(lg), Tensor(J["labels"]))._data.reshape(-1)

    ref["ce"] = (ce_fwd, grad_of(one, 0, J["cot_ce"])(J["logits"]))
    ref["ce_one"] = one(J["logits"])
    mesh = _jax_mesh(mp)

    class Traced(Initializer):
        """The device's shard as the layer's initial value."""

        def __init__(self, value):
            self.value = value

        def __call__(self, shape, dtype):
            return self.value.reshape(tuple(shape))

    def split(op, size, axis, spec):
        def body(x, w):
            return JC.split(Tensor(x), size, op, axis=axis,
                            weight_attr=ParamAttr(initializer=Traced(w))
                            )._data
        return _sm(body, mesh, (P(), spec), P())

    ref["split"] = {
        "embedding": split("embedding", (V // mp, H), 0,
                           P("model", None))(J["ids"], J["E"]),
        "col": split("linear", (IN, OUT // mp), 1,
                     P(None, "model"))(J["x"], J["Wc"]),
        "row": split("linear", (OUT // mp, IN), 0,
                     P("model", None))(J["xr"], J["Wr"])}

    # the collectives: lax's, with the same per-device cotangents
    def coll(name, fn, in_spec, out_spec, x):
        def cot_of(y):
            r = jax.lax.axis_index("model")
            n = y.size
            return (jnp.cos(jnp.arange(n, dtype=jnp.float32)).reshape(
                y.shape) * (r + 1).astype(jnp.float32))
        f = _sm(fn, mesh, (in_spec,), out_spec)
        g = _sm(lambda t: jax.grad(lambda u: jnp.sum(
            fn(u) * cot_of(fn(u))))(t), mesh, (in_spec,), in_spec)
        ref[f"coll_{name}"] = (f(x), g(x))

    coll("gather", lambda t: jax.lax.all_gather(t, "model", axis=1,
                                                tiled=True),
         P(None, "model"), P(), J["q"])
    coll("a2a", lambda t: jax.lax.all_to_all(t, "model", 2, 1, tiled=True),
         P(None, "model"), P(None, None, "model"), J["q"])
    coll("a2a_inv", lambda t: jax.lax.all_to_all(t, "model", 1, 2,
                                                 tiled=True),
         P(None, None, "model"), P(None, "model"), J["q"])
    return jax.tree_util.tree_map(np.asarray, ref)


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def started(data, tmp_path_factory):
    return {n: _start(n, tmp_path_factory.mktemp(f"mp{n}"), data)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def ranks(started):
    return {n: _finish(s) for n, s in started.items()}


@pytest.fixture(scope="module")
def refs(started, data):
    out = {n: _jax_ref(n, data) for n in (2, 4)}
    yield out
    out.clear()
    gc.collect()


def _close(got, want, msg=""):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), err_msg=msg,
                               **TOL)


MPS = (2, 4)


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("mp", MPS)
def test_vocab_parallel_embedding(ranks, refs, data, mp):
    out, grad = refs[mp]["emb"]
    for r, rk in enumerate(ranks[mp]):
        y, gw, w, mapping = rk["emb"]
        assert mapping == {0: "model"} and rk["mp_rank"] == r
        np.testing.assert_array_equal(w, _blk(data["E"], 0, r, mp))
        _close(y, out, f"rank {r}")
        _close(gw, _blk(grad, 0, r, mp), f"rank {r}")


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("gather", [True, False])
def test_column_parallel_linear(ranks, refs, mp, gather):
    y, gx, gw, gb = refs[mp][f"col_{gather}"]
    for r, rk in enumerate(ranks[mp]):
        py, pgx, pgw, pgb = rk[f"col_{gather}"]
        _close(py, y if gather else _blk(y, 1, r, mp), f"rank {r}")
        _close(pgx, gx, f"rank {r}")
        _close(pgw, _blk(gw, 1, r, mp), f"rank {r}")
        _close(pgb, _blk(gb, 0, r, mp), f"rank {r}")


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("parallel", [True, False])
def test_row_parallel_linear(ranks, refs, mp, parallel):
    y, gx, gw, gb = refs[mp][f"row_{parallel}"]
    for r, rk in enumerate(ranks[mp]):
        py, pgx, pgw, pgb = rk[f"row_{parallel}"]
        _close(py, y, f"rank {r}")
        _close(pgx, _blk(gx, 1, r, mp) if parallel else gx, f"rank {r}")
        _close(pgw, _blk(gw, 0, r, mp), f"rank {r}")
        _close(pgb, gb, f"rank {r}")


@pytest.mark.parametrize("mp", MPS)
def test_parallel_cross_entropy_with_ignore_index(ranks, refs, data, mp):
    loss, grad = refs[mp]["ce"]
    keep = data["labels"] != IGNORE
    for r, rk in enumerate(ranks[mp]):
        pl, pg = rk["ce"]
        assert pl.shape == (N, 1)
        _close(pl[keep, 0], loss[keep], f"rank {r}")
        _close(pl[~keep, 0], refs[mp]["ce_one"][~keep].reshape(-1))
        assert not pl[~keep].any() and not pg[~keep].any()
        _close(pg, _blk(grad, 1, r, mp), f"rank {r}")


@pytest.mark.parametrize("mp", MPS)
def test_split_builds_the_reference_layers(ranks, refs, mp):
    for r, rk in enumerate(ranks[mp]):
        for op, want in refs[mp]["split"].items():
            _close(rk["split"][op], want, f"{op} rank {r}")


@pytest.mark.parametrize("mp", MPS)
@pytest.mark.parametrize("name", ["gather", "a2a", "a2a_inv"])
def test_autograd_collectives_match_lax(ranks, refs, mp, name):
    y, gx = refs[mp][f"coll_{name}"]
    specs = {"gather": (None, 1), "a2a": (2, 1), "a2a_inv": (1, 2)}
    out_dim, in_dim = specs[name]
    for r, rk in enumerate(ranks[mp]):
        py, pg = rk[f"coll_{name}"]
        _close(py, y if out_dim is None else _blk(y, out_dim, r, mp),
               f"rank {r}")
        _close(pg, _blk(gx, in_dim, r, mp), f"rank {r}")


@pytest.mark.parametrize("mp", MPS)
def test_spmd_step_over_tensor_parallel_layers(ranks, data, mp):
    """The mesh step holds a layer's blocks as they are and its losses
    are the dense MLP's (one process, no model group)."""
    from paddle_tpu_torch.distributed import (HybridCommunicateGroup,
                                              make_spmd_train_step)
    import paddle_tpu_torch.optimizer as TO
    step, st, _ = make_spmd_train_step(_mlp(data), torch.nn.MSELoss(),
                                       TO.SGD(0.1), HybridCommunicateGroup())
    want = []
    for _ in range(3):
        st, loss = step(st, 0, 0.1, [torch.tensor(data["x"])],
                        [torch.tensor(data["cot_r"])])
        want.append(float(loss))
    for r, rk in enumerate(ranks[mp]):
        losses, specs = rk["spmd"]
        _close(losses, want, f"rank {r}")
        assert specs["0.weight"] == (None, "model")
        assert specs["2.weight"] == ("model", None)
        assert specs["2.bias"] == (None,)


@pytest.mark.parametrize("mp", MPS)
def test_tensor_parallel_broadcasts_replicated_parameters(ranks, mp):
    for r, rk in enumerate(ranks[mp]):
        assert rk["tensor_parallel"] == ("TensorParallel", "TensorParallel",
                                         1.0, float(r + 1))


def test_rng_tracker_streams_equal_the_reference():
    import jax
    from paddle_tpu.core import rng as J
    from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import \
        random as JP
    from paddle_tpu_torch.core import rng as T
    from paddle_tpu_torch.distributed.fleet.meta_parallel.parallel_layers \
        import random as TP

    def draws(rng, tracker, keyed):
        out = []
        rng.seed(5)
        tracker.seeds.pop("tp_local", None)
        tracker.add("tp_local", 123)
        for _ in range(2):
            with tracker.rng_state("tp_local"):
                out.append(rng.next_key())
            out.append(rng.next_key())
        with tracker.rng_state("tp_fresh_name"):
            out.append(rng.next_key())
        with rng.rng_scope(keyed):
            with tracker.rng_state("tp_local"):
                out += [rng.next_key(), rng.next_key()]
            out.append(rng.next_key())
        return out

    def bits(k):
        return np.asarray(jax.random.key_data(k) if hasattr(k, "dtype") and
                          jax.dtypes.issubdtype(k.dtype,
                                                jax.dtypes.prng_key)
                          else k, np.uint32).reshape(-1)

    want = draws(J, J.get_rng_state_tracker(), jax.random.key(9))
    got = draws(T, T.get_rng_state_tracker(), T.make_key(9))
    assert len(want) == len(got) == 8
    for w, g in zip(want, got):
        np.testing.assert_array_equal(bits(w), g)
    # model_parallel_random_seed: local seed + 1024 + rank, global seed
    seeded = []
    for rng, P in ((J, JP), (T, TP)):
        P.model_parallel_random_seed(17)
        tr = P.get_rng_state_tracker()
        assert tr.seeds[P.MODEL_PARALLEL_RNG] == 17 + 1024
        with tr.rng_state(P.MODEL_PARALLEL_RNG):
            a = rng.next_key()
        seeded.append((bits(a), bits(rng.next_key())))
    for w, g in zip(*seeded):
        np.testing.assert_array_equal(w, g)
    assert T.get_rng_state_tracker() is TP.get_rng_state_tracker()
    with pytest.raises(ValueError, match="already set"):
        TP.get_rng_state_tracker().add(TP.MODEL_PARALLEL_RNG, 3)

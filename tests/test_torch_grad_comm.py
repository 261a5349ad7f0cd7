"""Port parity for the gradient-communication policies
(``paddle_tpu_torch/distributed/grad_comm.py``) against the JAX package's
``distributed/grad_comm.py``.

- Pure functions, bit for bit: ``quantize_blocks`` payloads and scales,
  ``dequantize_blocks``, ``ef_accumulate``, ``ef_residual``, local mode
  (``apply_local``: the R=1 composition the DP and ZeRO steps use),
  ``wire_bytes``, ``comm_info``; the reference's own property cases
  (constant and zero blocks, the documented bound, error feedback).
- Wire mode at R = 2 and 4 gloo ranks (one spawn of 4; the R = 2 groups
  are {0, 1} and {2, 3}) against the reference's ``shard_map`` bodies on
  the same per-device trees: ``compressed_all_reduce``,
  ``compressed_reduce_scatter`` and ``tree_from_shards`` under fp32, bf16
  and int8_ef.  The int8 hops' payloads and scales are equal; results
  agree within fp32 accumulation order (rtol 1e-6 of the result's
  magnitude; bf16 within one bf16 ulp, 2^-8 of it: the four-rank bf16
  sum may round in another order).
- The trainers: ZeRO-2 over sharding 4 under fp32 and int8_ef (curves
  within rtol 0.05, the reference's test), and the sharded-init GPT step
  over sharding 2 under each policy (``test_torch_dp.py``'s arms; one
  spawn of 2 ranks).

The spawned ranks import this module, so it imports no JAX at its top.
"""

import os
import pickle
import sys

import numpy as np
import pytest
import torch

from paddle_tpu_torch.distributed import grad_comm as gc

POLICIES = ("fp32", "bf16", "int8_ef")


def _t(tree):
    return {k: torch.tensor(np.asarray(v)) for k, v in tree.items()}


def _n(tree):
    return {k: np.asarray(v.detach().numpy() if hasattr(v, "detach") else v)
            for k, v in tree.items()}


# ------------------------------------------------------------ pure, exact --

def _rand_tree(seed=0):
    r = np.random.RandomState(seed)
    t = {"w": r.standard_normal((37, 13)).astype(np.float32),
         "b": r.standard_normal((300,)).astype(np.float32) * 1e-3,
         "z": np.zeros((5, 7), np.float32)}
    t["w"][3, 4] *= 1000.0          # an outlier block
    return t


class TestPureFunctionsBitExact:
    @pytest.mark.parametrize("block", [256, 128])
    def test_quantize_dequantize(self, block):
        import jax.numpy as jnp
        from paddle_tpu.distributed import grad_comm as jgc
        r = np.random.RandomState(1)
        x = r.standard_normal((6, 2 * block)).astype(np.float32)
        x[0] = 0.0
        x[1, :block] = 0.25
        x[2, 5] = 1e6
        qj, sj = jgc.quantize_blocks(jnp.asarray(x), block)
        qt, st = gc.quantize_blocks(torch.tensor(x), block)
        np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))
        np.testing.assert_array_equal(st.numpy(), np.asarray(sj))
        assert qt.dtype == torch.int8 and st.dtype == torch.float32
        np.testing.assert_array_equal(
            gc.dequantize_blocks(qt, st, block).numpy(),
            np.asarray(jgc.dequantize_blocks(qj, sj, block)))

    def test_error_feedback_primitives(self):
        import jax.numpy as jnp
        from paddle_tpu.distributed import grad_comm as jgc
        a, b = np.float32([1.0, 2.0, 1e-8]), np.float32([0.5, -1.0, 3.0])
        np.testing.assert_array_equal(
            gc.ef_accumulate(torch.tensor(a), torch.tensor(b)).numpy(),
            np.asarray(jgc.ef_accumulate(jnp.asarray(a), jnp.asarray(b))))
        np.testing.assert_array_equal(
            gc.ef_residual(torch.tensor(a), torch.tensor(b)).numpy(),
            np.asarray(jgc.ef_residual(jnp.asarray(a), jnp.asarray(b))))
        v = torch.tensor(b)
        assert gc.ef_accumulate(None, v) is v

    @pytest.mark.parametrize("policy", POLICIES)
    def test_local_mode_and_residual(self, policy):
        """``apply_local`` over two steps (the residual threaded): the
        tree and the flat residual equal the reference's bit for bit."""
        import jax.numpy as jnp
        from paddle_tpu.distributed import grad_comm as jgc
        tree = _rand_tree()
        jp, tp = jgc.resolve_policy(policy), gc.resolve_policy(policy)
        je, te = jp.residual_for(tree), tp.residual_for(_t(tree))
        for seed in (0, 3):
            g = _rand_tree(seed)
            jo, je = jp.apply_local({k: jnp.asarray(v) for k, v in g.items()},
                                    je)
            to, te = tp.apply_local(_t(g), te)
            for k in g:
                np.testing.assert_array_equal(to[k].numpy(),
                                              np.asarray(jo[k]), err_msg=k)
            if policy == "int8_ef":
                np.testing.assert_array_equal(te.numpy(), np.asarray(je))
            else:
                assert te is None and je is None

    def test_flat_layout_is_the_references(self):
        """Sorted keys, fp32, zero-padded: the flat vector the int8
        residual and the update-sharded slots are laid out in."""
        import jax.numpy as jnp
        from paddle_tpu.distributed import grad_comm as jgc
        tree = _rand_tree()
        fj, mj = jgc._flatten_tree({k: jnp.asarray(v) for k, v in
                                    tree.items()}, 512)
        ft, mt = gc._flatten_tree(_t(tree), 512)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        assert (mt.n, mt.n_pad) == (mj.n, mj.n_pad)
        back = gc._unflatten_tree(ft, mt)
        for k in tree:
            np.testing.assert_array_equal(back[k].numpy(), tree[k])
        with pytest.raises(ValueError, match="incompatible"):
            gc._flatten_tree(_t(tree), 512, total=513)

    def test_wire_bytes_and_comm_info(self):
        import jax.numpy as jnp
        from paddle_tpu.distributed import grad_comm as jgc
        for tree in (_rand_tree(), {"w": np.zeros((1024, 64)),
                                    "b": np.zeros((64,))}):
            jt = {k: jnp.asarray(v) for k, v in tree.items()}
            for p in POLICIES:
                assert gc.wire_bytes(_t(tree), p) == jgc.wire_bytes(jt, p)
                assert gc.comm_info(_t(tree), p) == jgc.comm_info(jt, p)
            q = gc.wire_bytes(_t(tree), gc.Int8EfPolicy(block=128))
            assert q == jgc.wire_bytes(jt, jgc.Int8EfPolicy(block=128))
        assert gc.comm_info(_t(_rand_tree()), "fp32") is None


class TestReferenceProperties:
    """The reference's ``tests/test_grad_comm.py`` cases on the port."""

    def test_constant_blocks_near_exact(self):
        for c in (0.1, -3.7, 1e-6, 2.0 ** 20):
            x = torch.full((4, 256), c)
            q, s = gc.quantize_blocks(x, 256)
            np.testing.assert_array_equal(q.numpy(),
                                          np.full((4, 256), np.sign(c) * 127))
            np.testing.assert_allclose(gc.dequantize_blocks(q, s, 256).numpy(),
                                       x.numpy(), rtol=1e-6)

    def test_zero_blocks_exact(self):
        q, s = gc.quantize_blocks(torch.zeros(2, 512), 256)
        assert (q == 0).all() and (s == 1.0).all()
        assert (gc.dequantize_blocks(q, s, 256) == 0).all()

    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_documented_elementwise_bound(self, seed):
        r = np.random.RandomState(seed)
        x = r.standard_normal((8, 256)).astype(np.float32)
        x[:, 7] *= 1000.0
        q, s = gc.quantize_blocks(torch.tensor(x), 256)
        deq = gc.dequantize_blocks(q, s, 256).numpy()
        bound = np.abs(x).max(axis=1, keepdims=True) / 254.0
        assert (np.abs(deq - x) <= bound + 1e-7 * np.abs(x)).all()

    def test_rejects_ragged_blocks_and_resolves(self):
        with pytest.raises(ValueError, match="multiple"):
            gc.quantize_blocks(torch.zeros(5), 256)
        assert gc.resolve_policy(None).name == "fp32"
        assert gc.resolve_policy("bf16").name == "bf16"
        p = gc.Int8EfPolicy(block=128)
        assert gc.resolve_policy(p) is p
        with pytest.raises(ValueError, match="unknown grad_comm"):
            gc.resolve_policy("fp8")
        with pytest.raises(TypeError):
            gc.resolve_policy(3)

    def test_ef_prevents_bias_accumulation(self):
        r = np.random.RandomState(1)
        g = {"w": torch.tensor(r.standard_normal((40, 13)).astype(np.float32))}
        p = gc.Int8EfPolicy()
        e = None
        acc_ef = np.zeros((40, 13), np.float32)
        acc_no = np.zeros((40, 13), np.float32)
        for _ in range(20):
            out, e = p.apply_local(g, e)
            acc_ef += out["w"].numpy()
            acc_no += p.apply_local(g, None)[0]["w"].numpy()
        target = 20 * g["w"].numpy()
        step = np.abs(g["w"].numpy()).max() / 127.0
        err_ef, err_no = (np.abs(a - target).max() for a in (acc_ef, acc_no))
        assert err_ef <= 2 * step and err_ef < err_no


# --------------------------------------------------------- wire mode --

def _grads(R=4):
    """R grad trees of a small MLP loss on R batch shards (the
    reference's ``_grad_pytree``), as numpy."""
    import jax
    import jax.numpy as jnp
    r = np.random.RandomState(0)
    params = {"w1": jnp.asarray(r.standard_normal((6, 8)).astype(np.float32)),
              "b1": jnp.zeros((8,), jnp.float32),
              "w2": jnp.asarray(r.standard_normal((8, 3)).astype(np.float32))}

    def loss_of(p, x, y):
        h = jnp.tanh(x @ p["w1"] + p["b1"])
        return -jnp.mean(jnp.take_along_axis(
            jax.nn.log_softmax(h @ p["w2"]), y[:, None], 1))

    out = []
    for _ in range(R):
        x = jnp.asarray(r.standard_normal((8, 6)).astype(np.float32))
        y = jnp.asarray(r.randint(0, 3, 8))
        out.append({k: np.asarray(v)
                    for k, v in jax.grad(loss_of)(params, x, y).items()})
    return out


def _port_wire(group, tree):
    out = {}
    for pol in POLICIES:
        p = gc.resolve_policy(pol)
        e0 = p.residual_for(tree, group.nranks) if p.stateful else None
        ar, e = gc.compressed_all_reduce(tree, group, p, e0)
        shard, meta, _ = gc.compressed_reduce_scatter(tree, group, p, e0)
        full = gc.tree_from_shards(shard, meta, group)
        out[pol] = {"ar": _n(ar), "shard": shard.numpy(), "full": _n(full),
                    "e": None if e is None else e.numpy()}
        if p.stateful:
            flat, _ = gc._flatten_tree(tree, p.block * group.nranks)
            _, _, _, (q1, s1), (q2, s2) = p._exchange(flat, group)
            out[pol]["hops"] = [a.numpy() for a in (q1, s1, q2, s2)]
    return out


def _zero_stage2(hcg, pol):
    from paddle_tpu_torch.distributed.zero import make_zero_train_step
    import paddle_tpu_torch.optimizer as TO
    p = {"w": torch.tensor(np.random.RandomState(5).standard_normal(
        (8, 4)).astype(np.float32))}
    xz = torch.tensor(np.random.RandomState(6).standard_normal(
        (16, 8)).astype(np.float32))
    step, state = make_zero_train_step(
        lambda q, x: torch.mean((x @ q["w"]) ** 2), p, TO.SGD(0.05),
        hcg.mesh, zero_stage=2, grad_comm=pol)
    losses = []
    for _ in range(6):
        state, loss = step(state, 0.05, xz)
        losses.append(float(loss))
    return losses, "comm_e" in state


def _rank_main(rank, world, tmp, grads):
    import datetime
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env, fleet
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    pairs = [C.new_group([0, 1]), C.new_group([2, 3])]
    out = {4: _port_wire(C.get_group(), _t(grads[rank])),
           2: _port_wire(pairs[rank // 2], _t(grads[rank]))}
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"sharding_degree": 4}
    fleet.init(is_collective=True, strategy=st)
    out["zero2"] = {p: _zero_stage2(fleet.get_hybrid_communicate_group(), p)
                    for p in ("fp32", "int8_ef")}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    C.destroy_process_group()


def _jax_wire(grads, R):
    """The reference's shard_map bodies over R devices, per device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.distributed import grad_comm as jgc
    from paddle_tpu.distributed.spmd import shard_map
    mesh = Mesh(np.array(jax.devices()[:R]), ("data",))
    specs = {k: P("data") for k in grads[0]}
    stacked = {k: jnp.stack([g[k] for g in grads]) for k in grads[0]}
    out = {}
    for pol in POLICIES:
        p = jgc.resolve_policy(pol)
        e0 = p.residual_for(grads[0], R) if p.stateful else jnp.zeros((R,))
        e0s = jnp.broadcast_to(e0[None], (R,) + e0.shape)

        def body(t, e):
            t1 = {k: v[0] for k, v in t.items()}
            ar, e2 = jgc.compressed_all_reduce(t1, "data", p,
                                               e[0] if p.stateful else None)
            shard, meta, _ = jgc.compressed_reduce_scatter(
                t1, "data", p, e[0] if p.stateful else None)
            full = jgc.tree_from_shards(shard, meta, "data")
            e2 = e2 if e2 is not None else e[0]
            return ({k: v[None] for k, v in ar.items()}, e2[None],
                    shard[None], {k: v[None] for k, v in full.items()})

        f = jax.jit(shard_map(body, mesh=mesh, in_specs=(specs, P("data")),
                              out_specs=(specs, P("data"), P("data"),
                                         specs), check_vma=False))
        ar, e, shard, full = jax.tree_util.tree_map(np.asarray,
                                                    f(stacked, e0s))
        out[pol] = {"ar": ar, "e": e, "shard": shard, "full": full}
        if p.stateful:
            hops = []
            for r in range(R):
                flat, _ = jgc._flatten_tree(grads[r], p.block * R)
                q1, s1 = jgc.quantize_blocks(flat.reshape(R, -1), p.block)
                q2, s2 = jgc.quantize_blocks(jnp.asarray(shard[r]), p.block)
                hops.append([np.asarray(a) for a in (q1, s1, q2, s2)])
            out[pol]["hops"] = hops
    return out


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop the JAX arrays of this module and of ``test_torch_dp``'s
    cached reference runs when it ends (a later module in the same
    process ranks the live JAX arrays: the reference's memory
    forensics)."""
    yield
    import gc as collector
    from test_torch_dp import _jax_gpt, _jax_sharded_gpt
    _jax_gpt.cache_clear()
    _jax_sharded_gpt.cache_clear()
    collector.collect()


@pytest.fixture(scope="module")
def grads():
    return _grads(4)


@pytest.fixture(scope="module")
def jwire(grads, started):
    return {2: [_jax_wire(grads[:2], 2), _jax_wire(grads[2:], 2)],
            4: [_jax_wire(grads, 4)]}


@pytest.fixture(scope="module")
def started(grads, tmp_path_factory):
    import torch.multiprocessing as mp
    from test_torch_dp import SHARDED_ARMS, _jax_init, _start
    tmp = tmp_path_factory.mktemp("wire4")
    ctx = mp.start_processes(_rank_main, args=(4, str(tmp), grads), nprocs=4,
                             join=False, start_method="spawn")
    sharded = _start(2, tmp_path_factory.mktemp("sharded2"),
                     _jax_init(("gpt_sharded",)), SHARDED_ARMS)
    return (ctx, 4, tmp), sharded


@pytest.fixture(scope="module")
def ranks4(started):
    from test_torch_dp import _finish
    return _finish(started[0])


@pytest.fixture(scope="module")
def sharded2(started):
    from test_torch_dp import _finish
    return _finish(started[1])


class TestWireMode:
    @pytest.mark.parametrize("policy", POLICIES)
    @pytest.mark.parametrize("R", [2, 4])
    def test_collectives_match_the_shard_map_bodies(self, jwire, started,
                                                    ranks4, R, policy):
        for rank, rk in enumerate(ranks4):
            got = rk[R][policy]
            want = jwire[R][rank // R if R == 2 else 0][policy]
            i = rank % R
            scale = max(np.abs(want["full"][k][i]).max() for k in
                        want["full"])
            tol = 2.0 ** -8 if policy == "bf16" else 1e-6
            for k in got["ar"]:
                np.testing.assert_allclose(got["ar"][k], want["ar"][k][i],
                                           rtol=0, atol=tol * scale,
                                           err_msg=f"all_reduce {k}")
                np.testing.assert_allclose(got["full"][k], want["full"][k][i],
                                           rtol=0, atol=tol * scale,
                                           err_msg=f"tree_from_shards {k}")
            np.testing.assert_allclose(got["shard"], want["shard"][i], rtol=0,
                                       atol=tol * scale, err_msg="shard")
            if policy == "int8_ef":
                for a, b, name in zip(got["hops"], want["hops"][i],
                                      ("q1", "s1", "q2", "s2")):
                    np.testing.assert_array_equal(a, b, err_msg=name)
                np.testing.assert_allclose(got["e"], want["e"][i], rtol=0,
                                           atol=1e-6 * scale)
            else:
                assert got["e"] is None

    def test_zero_stage2_policies(self, started, ranks4):
        """The reference's ``test_zero_stage2_policies`` over sharding 4:
        the int8_ef curve within rtol 0.05 of fp32, and each curve equal
        to the reference's."""
        import jax.numpy as jnp
        from jax.sharding import Mesh
        import jax
        from paddle_tpu.distributed.zero import make_zero_train_step
        from paddle_tpu.optimizer import SGD
        mesh = Mesh(np.array(jax.devices()[:4]).reshape(4), ("sharding",))
        xz = jnp.asarray(np.random.RandomState(6).standard_normal(
            (16, 8)).astype(np.float32))
        ref = {}
        for pol in ("fp32", "int8_ef"):
            p2 = {"w": jnp.asarray(np.random.RandomState(5).standard_normal(
                (8, 4)).astype(np.float32))}
            step, state = make_zero_train_step(
                lambda p, x: jnp.mean((x @ p["w"]) ** 2), p2, SGD(0.05),
                mesh, zero_stage=2, grad_comm=pol)
            ref[pol] = []
            for _ in range(6):
                state, loss = step(state, np.float32(0.05), xz)
                ref[pol].append(float(loss))
        for rk in ranks4:
            for pol in ("fp32", "int8_ef"):
                losses, has_e = rk["zero2"][pol]
                assert has_e == (pol == "int8_ef")
                np.testing.assert_allclose(losses, ref[pol], rtol=1e-5,
                                           atol=1e-6)
            np.testing.assert_allclose(rk["zero2"]["int8_ef"][0],
                                       rk["zero2"]["fp32"][0], rtol=0.05)


class TestShardedInitPolicies:
    @pytest.mark.parametrize("policy", POLICIES)
    def test_each_grad_comm_matches_the_jax_step(self, started, sharded2,
                                                 policy):
        """``make_sharded_gpt_train_step`` over sharding 2 from the
        reference's initial weights: fp32 step for step (losses, params,
        slots); bf16 and int8_ef local mode within rtol 1e-4 of the
        reference's curve and 0.02 of fp32's."""
        from test_torch_dp import _close, _compare, _jax_sharded_gpt
        losses, jstate = _jax_sharded_gpt(policy)
        for rk in sharded2:
            p = rk[f"sharded_{policy}"]
            assert ("comm_e" in p["state"]) == (policy == "int8_ef")
            if policy == "fp32":
                _close(p["losses"], losses)
            else:
                _close(p["losses"], losses, rtol=1e-4, atol=0)
        if policy == "fp32":
            _compare([rk["sharded_fp32"]["state"] for rk in sharded2],
                     jstate, ("params", "opt"))
        else:
            fp32, _ = _jax_sharded_gpt("fp32")
            for rk in sharded2:
                _close(rk[f"sharded_{policy}"]["losses"], fp32, rtol=0.02,
                       atol=0)

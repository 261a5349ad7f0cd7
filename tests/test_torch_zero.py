"""Port parity for ZeRO (``paddle_tpu_torch/distributed/zero.py``) against
the JAX package's ``distributed/zero.py``, at 2 gloo ranks (sharding 2)
and 4 (dp 2 x sharding 2; the reference's own tests use dp 2 x sharding
4 on its 8-device CPU mesh).

One spawn of ranks per mesh (module fixtures) runs every port scenario and
returns numpy results; the JAX side runs in this process.  Rank r of the
port holds what the reference's device at flat mesh position r holds, so
each rank's shards are compared with ``addressable_shards`` of that device.
The spawned ranks import this module, so it imports no JAX at its top
(the JAX helpers import it inside), and each rank asserts that ``jax`` is
not loaded.

Tolerances: the reference's for fp32 losses (rtol 1e-5, atol 1e-6).
State shards: optimizer slots and counters rtol 1e-5, atol 1e-6;
parameters rtol 1e-4 (the reference's update-sharding pin) and atol 1e-5
(``test_torch_train.py``'s: the two sides sum the gradient mean in other
orders, and Adam's normalised step turns a last-bit difference of a
near-zero gradient into up to 2·lr; 4e-6 seen).  bf16 parameters equal
their fp32 master's cast exactly; byte counts equal as integers, and
the storages under each rank's state hold exactly those bytes.
"""

import gc
import os
import pickle
import sys

import numpy as np
import pytest
import torch

TINY = dict(vocab_size=128, hidden_size=64, num_layers=2,
            num_attention_heads=4, max_position_embeddings=64,
            compute_dtype="float32")
B, L, STEPS, LR = 8, 16, 3, 1e-3
RTOL, ATOL = 1e-5, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5     # parameters (module docstring)


# ---------------------------------------------------------------- data --

def _batch():
    r = np.random.RandomState(0)
    return r.randint(0, 128, (B, L)), r.randint(0, 128, (B, L))


def _mlp_np(seed=0):
    r = np.random.RandomState(seed)
    mk = lambda *s: (r.standard_normal(s).astype(np.float32) * 0.1)  # noqa
    return {"w1": mk(16, 32), "b1": mk(32), "w2": mk(32, 8), "b2": mk(8)}


def _mlp_batch(seed=1):
    r = np.random.RandomState(seed)
    return (r.standard_normal((16, 16)).astype(np.float32),
            r.randint(0, 8, 16))


def _t_mlp_loss(params, x, y):
    h = torch.tanh(x @ params["w1"].float() + params["b1"].float())
    logits = h @ params["w2"].float() + params["b2"].float()
    logp = torch.log_softmax(logits, -1)
    return -logp.gather(1, y.long()[:, None]).mean()


def _t_mlp_loss_poisoned(params, x, y, poison):
    """The MLP loss plus ``sum(poison) * w1[0, 0]``: an inf in ``poison``
    reaches w1's gradient at [0, 0] and nothing else."""
    return _t_mlp_loss(params, x, y) + poison.sum() * params["w1"][0, 0]


def _poisons():
    """The found_inf arm's per-step ``poison`` (16 rows, 8 a rank at R 2):
    an inf in row 0 (rank 0's rows), then none.  At stage 2 the inf lands
    in rank 0's reduce-scattered block of w1's gradient only, so rank 1
    skips the step only through found_inf's MAX over the ranks."""
    bad = np.zeros(16, np.float32)
    bad[0] = np.inf
    return [bad, np.zeros(16, np.float32)]


def _storage_bytes(tree):
    """Bytes of the distinct storages under ``tree``: what the state's
    tensors keep allocated."""
    seen = {}

    def walk(t):
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            seen[st.data_ptr()] = st.nbytes()
        elif isinstance(t, dict):
            for v in t.values():
                walk(v)
    walk(tree)
    return sum(seen.values())


def _held(state):
    """(per_device_state_bytes, storage bytes of slots and masters,
    logical and storage bytes of the parameters) of a port state."""
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    params = state["params"]
    return (per_device_state_bytes(state),
            _storage_bytes({"opt": state["opt"]["slots"],
                            "master": state.get("master", {})}),
            sum(p.numel() * p.element_size() for p in params.values()),
            _storage_bytes(params))


def _np(t):
    if isinstance(t, torch.Tensor):
        return (t.detach().float() if t.dtype == torch.bfloat16
                else t.detach()).cpu().numpy().copy()
    if isinstance(t, dict):
        return {k: _np(v) for k, v in t.items()}
    return t


# ------------------------------------------------------- the port side --

def _port_hcg(dp, sh):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": dp, "sharding_degree": sh}
    fleet.init(is_collective=True, strategy=st)
    return fleet.get_hybrid_communicate_group()


def _port_gpt(weights, hcg, stage):
    from paddle_tpu_torch.models.gpt import (GPTConfig, make_gpt_train_step,
                                             params_from_numpy)
    import paddle_tpu_torch.optimizer as TO
    model = params_from_numpy(weights, GPTConfig(**TINY), device="cpu")
    step, state = make_gpt_train_step(model, TO.AdamW(LR), hcg, remat=False,
                                      zero_stage=stage)
    held = [_held(state)]
    x, y = (torch.tensor(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, 0, LR, x, y)
        losses.append(float(loss))
    held.append(_held(state))
    return {"losses": losses, "state": _np(state), "held": held}


def _port_mlp(hcg, stage, **kw):
    from paddle_tpu_torch.distributed.zero import (make_zero_train_step,
                                                   per_device_state_bytes)
    import paddle_tpu_torch.optimizer as TO
    from paddle_tpu_torch.nn import clip as TC
    dtype = kw.pop("dtype", torch.float32)
    bad = kw.pop("bad", False)
    clip = kw.pop("clip", None)
    params = {k: torch.tensor(v).to(dtype) for k, v in _mlp_np().items()}
    opt = TO.Adam(1e-2, grad_clip=None if clip is None else
                  getattr(TC, clip[0])(clip[1]))
    step, state = make_zero_train_step(
        _t_mlp_loss_poisoned if bad else _t_mlp_loss, params, opt,
        hcg.mesh, zero_stage=stage, **kw)
    x, y = (torch.tensor(a) for a in _mlp_batch())
    out = {"bytes": per_device_state_bytes(state), "losses": [],
           "states": [], "held": [_held(state)]}
    batches = ([(x, y, torch.tensor(p)) for p in _poisons()] if bad
               else [(x, y)] * STEPS)
    for b in batches:
        state, loss = step(state, 1e-2, *b)
        out["losses"].append(float(loss))
        out["states"].append(_np(state))
    out["held"].append(_held(state))
    out["pinned"] = [v.is_pinned() for s in state["opt"]["slots"].values()
                     for v in s.values()]
    return out


def _rank_main(rank, world, tmp, weights, arms):
    """One rank: every arm of this mesh, results pickled for the parent."""
    import datetime
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {}
    for name, (dp, sh, kind, kw) in arms.items():
        hcg = _port_hcg(dp, sh)
        out[name] = (_port_gpt(weights, hcg, **kw) if kind == "gpt"
                     else _port_mlp(hcg, **kw))
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, weights, arms):
    """Start the ranks (they run while this process computes the JAX
    side); ``_finish`` joins them and reads their results."""
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), weights,
                                               arms),
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

def _jax_weights():
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTModel
    paddle.seed(11)
    m = GPTModel(GPTConfig(**TINY))
    return {n: np.asarray(p._data) for n, p in m.named_parameters()}


def _jax_hcg(dp, sh):
    from paddle_tpu.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": sh}
    fleet.fleet.init(is_collective=True, strategy=st)
    return fleet.fleet.get_hybrid_communicate_group()


def _jax_gpt(dp, sh, stage):
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTModel, make_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg(dp, sh)
    paddle.seed(11)
    model = GPTModel(GPTConfig(**TINY))
    step, state = make_gpt_train_step(model, AdamW(LR), hcg, remat=False,
                                      zero_stage=stage)
    x, y = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax.random.key(0), np.float32(LR), x, y)
        losses.append(float(loss))
    return losses, _jshards(state, hcg.mesh), hcg.mesh


def _jax_mlp(sh, stage, **kw):
    import jax.numpy as jnp
    from paddle_tpu.distributed.zero import (make_zero_train_step,
                                             per_device_state_bytes)
    from paddle_tpu.optimizer import Adam
    import jax
    from paddle_tpu.nn import clip as JC
    dtype = kw.pop("dtype", jnp.float32)
    bad = kw.pop("bad", False)
    clip = kw.pop("clip", None)
    mesh = _jax_hcg(1, sh).mesh

    def loss_of(params, x, y):
        h = jnp.tanh(x @ params["w1"].astype(jnp.float32)
                     + params["b1"].astype(jnp.float32))
        logits = h @ params["w2"].astype(jnp.float32) \
            + params["b2"].astype(jnp.float32)
        logp = jax.nn.log_softmax(logits)
        return -jnp.mean(jnp.take_along_axis(logp, y[:, None], axis=1))

    def poisoned(params, x, y, poison):
        return loss_of(params, x, y) + jnp.sum(poison) * params["w1"][0, 0]

    params = {k: jnp.asarray(v, dtype) for k, v in _mlp_np().items()}
    opt = Adam(1e-2, grad_clip=None if clip is None else
               getattr(JC, clip[0])(clip[1]))
    step, state = make_zero_train_step(poisoned if bad else loss_of, params,
                                       opt, mesh, zero_stage=stage, **kw)
    x, y = _mlp_batch()
    out = {"bytes": per_device_state_bytes(state), "losses": [],
           "states": []}
    batches = ([(x, y, p) for p in _poisons()] if bad
               else [(x, y)] * STEPS)
    for b in batches:
        state, loss = step(state, np.float32(1e-2),
                           *(jnp.asarray(a) for a in b))
        out["losses"].append(float(loss))
        out["states"].append(_jshards(state, mesh))
    return out, mesh


def _jshards(tree, mesh):
    """``tree`` with each array replaced by the list of blocks the
    reference's devices hold, in flat mesh order (read at once: a later
    donated step deletes the arrays)."""
    import jax

    def blocks(arr):
        by_dev = {s.device: s.data for s in arr.addressable_shards}
        # a host array off the mesh (the offload state): every rank holds
        # the whole of it
        dev = [by_dev.get(d, arr) for d in mesh.devices.flat]
        return [np.asarray(b, np.float32) if str(arr.dtype) == "bfloat16"
                else np.asarray(b) for b in dev]
    return jax.tree_util.tree_map(blocks, tree)


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _compare_state(port_ranks, jstate, keys, rtol=None, atol=None):
    """Every rank's shard of every leaf under ``keys`` against the block
    the reference's device at that rank's mesh position holds
    (``_jshards``; parameters at P_RTOL/P_ATOL, the rest at RTOL/ATOL
    unless given)."""
    def walk(port, ref, path):
        if isinstance(ref, dict):
            for k in ref:
                walk(port[k], ref[k], path + [k])
            return
        for r, got in enumerate(port):
            want = ref[r]
            assert np.shape(got) == np.shape(want), (path, r)
            tol = (P_RTOL, P_ATOL) if path[0] == "params" else (RTOL, ATOL)
            _close(got, want, rtol or tol[0], atol or tol[1],
                   msg=f"{path} rank {r}")

    for key in keys:
        walk_port = _per_rank([p[key] for p in port_ranks])
        walk(walk_port, jstate[key], [key])


def _per_rank(trees):
    """A list of per-rank trees as one tree of per-rank lists."""
    if isinstance(trees[0], dict):
        return {k: _per_rank([t[k] for t in trees]) for k in trees[0]}
    return list(trees)


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


# ------------------------------------------------------------ fixtures --

ARMS2 = {**{f"gpt_z{s}": (1, 2, "gpt", dict(stage=s)) for s in (1, 2, 3)},
         "mlp_offload": (1, 2, "mlp", dict(stage=1, offload=True)),
         "mlp_found_inf": (1, 2, "mlp", dict(stage=2, bad=True,
                                             dynamic_loss_scale=True,
                                             init_loss_scale=1024.0)),
         "mlp_bf16": (1, 2, "mlp", dict(stage=2, dtype=torch.bfloat16)),
         **{f"mlp_{c}": (1, 2, "mlp", dict(stage=st, clip=(c, 0.05)))
            for c, st in (("ClipGradByGlobalNorm", 2),
                          ("ClipGradByNorm", 3))}}
ARMS4 = {f"gpt_z{s}": (2, 2, "gpt", dict(stage=s)) for s in (1, 2, 3)}


@pytest.fixture(scope="module")
def weights():
    return _jax_weights()


@pytest.fixture(scope="module")
def started(weights, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("zero2"), weights, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("zero4"), weights, ARMS4)}


@pytest.fixture(scope="module")
def ranks2(started):
    return _finish(started[2])


@pytest.fixture(scope="module")
def ranks4(started):
    return _finish(started[4])


# --------------------------------------------------------------- tests --

class TestGPTZeroParity:
    @pytest.mark.parametrize("stage", [1, 2, 3])
    @pytest.mark.parametrize("mesh", ["sharding2", "dp2xsharding2"])
    def test_losses_and_shards_match_the_jax_mesh(self, request, weights,
                                                  mesh, stage):
        """Losses over 3 AdamW steps, and each rank's shard of params,
        optimizer slots and the step counter, equal the JAX mesh's."""
        dp, sh, fx = (1, 2, "ranks2") if mesh == "sharding2" else \
            (2, 2, "ranks4")
        request.getfixturevalue("started")
        losses, jstate, _ = _jax_gpt(dp, sh, stage)
        ranks = request.getfixturevalue(fx)
        ports = [r[f"gpt_z{stage}"] for r in ranks]
        for p in ports:
            _close(p["losses"], losses, msg="losses")
        _compare_state([p["state"] for p in ports], jstate,
                       ("params", "opt", "scaler"))
        # stage 3 keeps parameters sharded, 1/2 of the leading divisible
        # dim; stages 1-2 keep them whole
        w = ports[0]["state"]["params"]["blocks_fc1_w"]
        full = np.prod(weights["blocks_fc1_w"].shape)
        assert w.size == (full // 2 if stage == 3 else full)


class TestHeldBytes:
    @pytest.mark.parametrize("fx,arm", [
        *(("ranks2", f"gpt_z{s}") for s in (1, 2, 3)),
        *(("ranks4", f"gpt_z{s}") for s in (1, 2, 3)),
        ("ranks2", "mlp_offload"), ("ranks2", "mlp_found_inf"),
        ("ranks2", "mlp_bf16"), ("ranks2", "mlp_ClipGradByNorm")])
    def test_state_holds_only_its_shards(self, request, fx, arm):
        """Before the first step and after the last, the storages under
        each rank's slots and masters hold exactly
        ``per_device_state_bytes``, and the parameters' storages exactly
        their own bytes: no shard keeps the whole tensor it was cut from
        alive."""
        for r, rk in enumerate(request.getfixturevalue(fx)):
            for when, (state_b, held_b, param_b, param_held) in zip(
                    ("before", "after"), rk[arm]["held"]):
                assert held_b == state_b, (arm, r, when)
                assert param_held == param_b, (arm, r, when)


class TestMLPZero:
    def test_offload_matches_reference_and_stays_on_host(self, ranks2):
        ref, mesh = _jax_mlp(2, 1, offload=True)
        ports = [r["mlp_offload"] for r in ranks2]
        for p in ports:
            _close(p["losses"], ref["losses"], msg="losses")
            # the CPU has no pinned memory: host state is plain CPU tensors
            # here, pinned on a card (chip_smoke.py phase 21c checks it)
            assert p["pinned"] and not any(p["pinned"])
        for i, js in enumerate(ref["states"]):
            _compare_state([p["states"][i] for p in ports], js,
                           ("params", "master", "opt"))

    def test_found_inf_skips_on_every_rank_and_backs_off(self, ranks2):
        """An inf in rank 0's block of one reduce-scattered gradient only
        (``_poisons``): both ranks skip the update, the scale halves and
        the step counter stays; a finite step proceeds — state for state
        as the reference's."""
        ref, mesh = _jax_mlp(2, 2, bad=True, dynamic_loss_scale=True,
                             init_loss_scale=1024.0)
        before = _mlp_np()
        for r, rk in enumerate(ranks2):
            p = rk["mlp_found_inf"]
            s0 = p["states"][0]
            assert bool(s0["scaler"]["found_inf"])
            assert float(s0["scaler"]["scale"]) == 512.0
            assert int(s0["opt"]["step"]) == 0
            for k, v in s0["params"].items():
                np.testing.assert_array_equal(v, before[k])
            assert not bool(p["states"][1]["scaler"]["found_inf"])
            assert int(p["states"][1]["opt"]["step"]) == 1
            _close(p["losses"][1], ref["losses"][1])
        for i, js in enumerate(ref["states"]):
            _compare_state([rk["mlp_found_inf"]["states"][i]
                            for rk in ranks2], js,
                           ("params", "opt", "scaler"))

    def test_bf16_params_track_fp32_master(self, ranks2):
        ref, mesh = _jax_mlp(2, 2, dtype="bfloat16")
        for rk in ranks2:
            p = rk["mlp_bf16"]
            assert p["states"][-1]["master"], "half params need masters"
            _close(p["losses"], ref["losses"], rtol=1e-2, atol=1e-3)
        # a bf16 parameter one ulp apart moves a near-zero gradient, which
        # Adam's normalised step turns into up to 2·lr (1.6e-3 seen)
        _compare_state([rk["mlp_bf16"]["states"][-1] for rk in ranks2],
                       ref["states"][-1], ("master",), rtol=1e-2, atol=2e-2)
        # params are exactly the bf16 cast of the master (the whole param
        # is replicated; the master shard is this rank's block of it)
        for r, rk in enumerate(ranks2):
            st = rk["mlp_bf16"]["states"][-1]
            w = torch.tensor(st["params"]["w1"])
            m = torch.tensor(st["master"]["w1"])
            assert torch.equal(w.chunk(2, 0)[r],
                               m.to(torch.bfloat16).float())

    @pytest.mark.parametrize("clip,stage", [("ClipGradByGlobalNorm", 2),
                                            ("ClipGradByNorm", 3)])
    def test_clip_over_shards_has_whole_tensor_semantics(self, ranks2, clip,
                                                          stage):
        """The gradients reach the update as shards (stages 2-3): a
        global-norm and a per-tensor clip that bite still give the
        reference's state, its clip seeing whole tensors."""
        ref, _ = _jax_mlp(2, stage, clip=(clip, 0.05))
        for rk in ranks2:
            _close(rk[f"mlp_{clip}"]["losses"], ref["losses"])
        for i, js in enumerate(ref["states"]):
            _compare_state([rk[f"mlp_{clip}"]["states"][i] for rk in ranks2],
                           js, ("params", "opt"))

    def test_state_bytes_equal_the_reference_as_integers(self, ranks2):
        ref1, _ = _jax_mlp(1, 1)
        ref2, _ = _jax_mlp(2, 2, bad=True, dynamic_loss_scale=True,
                           init_loss_scale=1024.0)
        for rk in ranks2:
            assert rk["mlp_found_inf"]["bytes"] == ref2["bytes"]
        from paddle_tpu_torch.distributed.topology import ProcessMesh
        from paddle_tpu_torch.distributed.zero import (make_zero_train_step,
                                                       per_device_state_bytes)
        import paddle_tpu_torch.optimizer as TO
        one = ProcessMesh(("data", "pipe", "sharding", "sep", "model"),
                          (1,) * 5)
        params = {k: torch.tensor(v) for k, v in _mlp_np().items()}
        _, st = make_zero_train_step(_t_mlp_loss, params, TO.Adam(1e-2), one,
                                     zero_stage=1)
        assert per_device_state_bytes(st) == ref1["bytes"]
        # all MLP params have a 2-divisible dim: half the bytes, exactly
        assert ref2["bytes"] == ref1["bytes"] // 2

    def test_unshardable_param_warns_with_the_reference_message(self):
        """Layout only (no step): a rank of a sharding-4 mesh warns about
        the tensor with no divisible dim, with the reference's text."""
        import jax.numpy as jnp
        from paddle_tpu.distributed.zero import make_zero_train_step as jz
        from paddle_tpu.optimizer import Adam
        from paddle_tpu_torch.distributed.topology import ProcessMesh
        from paddle_tpu_torch.distributed.zero import make_zero_train_step
        import paddle_tpu_torch.optimizer as TO
        mesh4 = ProcessMesh(("data", "pipe", "sharding", "sep", "model"),
                            (1, 1, 4, 1, 1), rank=1)
        params = {k: torch.tensor(v) for k, v in _mlp_np().items()}
        params["odd"] = torch.ones(3, 3)
        with pytest.warns(UserWarning, match="no dim divisible") as got:
            make_zero_train_step(_t_mlp_loss, params, TO.Adam(1e-2), mesh4,
                                 zero_stage=3)
        jparams = {k: jnp.asarray(v.numpy()) for k, v in params.items()}
        with pytest.warns(UserWarning, match="no dim divisible") as want:
            jz(lambda p, x, y: 0.0, jparams, Adam(1e-2),
               _jax_hcg(1, 4).mesh, zero_stage=3)
        assert sorted(str(w.message) for w in got) == \
            sorted(str(w.message) for w in want)

    def test_scale_grows_after_interval(self):
        from paddle_tpu_torch.distributed.zero import make_zero_train_step
        import paddle_tpu_torch.optimizer as TO
        params = {k: torch.tensor(v) for k, v in _mlp_np().items()}
        step, state = make_zero_train_step(
            _t_mlp_loss, params, TO.Adam(1e-2), None, zero_stage=1,
            dynamic_loss_scale=True, init_loss_scale=256.0,
            growth_interval=2)
        x, y = (torch.tensor(a) for a in _mlp_batch())
        for _ in range(2):
            state, _ = step(state, 1e-2, x, y)
        assert float(state["scaler"]["scale"]) == 512.0
        assert int(state["scaler"]["good_steps"]) == 0

    def test_offload_rejects_grad_comm(self):
        from paddle_tpu_torch.distributed.zero import make_zero_train_step
        import paddle_tpu_torch.optimizer as TO
        with pytest.raises(NotImplementedError, match="offload"):
            make_zero_train_step(lambda p, x: (p["w"] * x).sum(),
                                 {"w": torch.ones(4)}, TO.SGD(0.1), None,
                                 offload=True, grad_comm="bf16")

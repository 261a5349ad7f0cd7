"""Port parity for BERT pretraining over model ranks
(``paddle_tpu_torch/models/bert.py`` ``make_bert_train_step`` and
``make_sharded_bert_train_step`` with ``distributed/spmd.py``'s mesh
step) against the JAX package's BERT on its CPU mesh.

The reference's ``make_bert_train_step`` takes no padding mask, so its
arms here are its own ``make_gspmd_step_from_loss`` over the same
``pretrain_loss_fn`` with the mask passed (the step the reference's
builder makes, one argument wider); the port's step takes the mask as an
optional fifth batch argument.

Arms (tiny BERT: vocab 126, H 64, 2 layers, 4 heads, fp32, remat on,
AdamW, B 4, L 16 with padded rows, MLM labels ignored unevenly across
the batch, 3 steps): mp 2 with ``FLAGS_use_fused_ln`` on (the JAX side
runs the fused LN's Pallas kernels in interpret mode, the port their
plain versions) and off, and its sharded-init twin (the same initial
weights copied in, the flag on), on 2 gloo ranks; mp 4 with the
flag on, where 126 does not divide by 4 and ``word_emb`` and
``mlm_bias`` stay whole, as the reference's rule leaves them, and dp 2 ×
mp 2 with it off, on 4.  Each rank's losses and its parameter and slot
shards are held as ERNIE-MoE's are (``tests/test_torch_ernie_moe_ep.py``
``_compare_shards``): within 1e-4 relative (1e-5 absolute) of the
reference's losses and ``addressable_shards[r]``, but for parameter
elements whose gradient came under 1e-5 at some step, held to AdamW's
2·lr a step.  The monitor counts each token once.  The spawned ranks import this module, so it imports no JAX at its
top.
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
from test_torch_ernie_moe_ep import (_compare_shards, _flat,
                                     _second_moments)

TINY = dict(vocab_size=126, hidden_size=64, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=32,
            compute_dtype="float32")
B, L, STEPS, LR = 4, 16, 3, 1e-3
TOL = (1e-4, 1e-5)
MESHES = {"mp2": {"mp_degree": 2}, "mp4": {"mp_degree": 4},
          "dp2_mp2": {"dp_degree": 2, "mp_degree": 2}}
ARMS2 = [("mp2", True, False), ("mp2", False, False), ("mp2", True, True)]
ARMS4 = [("mp4", True, False), ("dp2_mp2", False, False)]


def _arm_id(arm):
    mesh, fused, sharded = arm
    return f"{mesh}_{'fused' if fused else 'plain'}" \
        + ("_sharded" if sharded else "")


def _batch():
    r = np.random.RandomState(4)
    ids = r.randint(0, 126, (B, L))
    mlm = np.where(r.rand(B, L) < 0.4, r.randint(0, 126, (B, L)), -100)
    mlm[0] = -100                  # the batch's rows see unequal counts
    mlm[0, 2] = 9
    am = np.ones((B, L), np.int32)
    am[1, 11:] = 0
    am[3, 6:] = 0
    return ids, mlm, r.randint(0, 2, (B,)), am


# ------------------------------------------------------- the port side --

def _port_arm(arm, init, tmp):
    from paddle_tpu_torch.core import flags as TFL
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    from paddle_tpu_torch.distributed.zero import per_device_state_bytes
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.telemetry import TrainMonitor
    import paddle_tpu_torch.optimizer as TO
    mesh_name, fused, sharded = arm
    TFL.set_flags({"FLAGS_use_fused_ln": fused})
    st = fleet.DistributedStrategy()
    st.hybrid_configs = MESHES[mesh_name]
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    mon = TrainMonitor()
    if sharded:
        step, state = TB.make_sharded_bert_train_step(
            TB.BertConfig(**TINY), TO.AdamW(LR), hcg, device="cpu",
            monitor=mon)
        specs, mesh = step.layout.specs["params"], step.layout.mesh
        with torch.no_grad():
            for n, p in state["params"].items():
                p.copy_(local_shard(torch.from_numpy(init[n]), specs[n],
                                    mesh))
    else:
        m = TB.params_from_numpy(init, TB.BertConfig(**TINY), device="cpu")
        step, state = TB.make_bert_train_step(m, TO.AdamW(LR), hcg,
                                              monitor=mon)
    batch = [torch.tensor(a) for a in _batch()]
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, LR, *batch)
        losses.append(float(loss))
    TFL.set_flags({"FLAGS_use_fused_ln": False})
    return {"losses": losses, "state": _np(state),
            "mp_rank": hcg.get_model_parallel_rank(),
            "counted": [(e["examples"], e["tokens"])
                        for e in mon.events("train_step")],
            "state_bytes": per_device_state_bytes(state),
            "layout": step.layout.specs}


def _rank_main(rank, world, tmp, arms):
    torch.set_num_threads(1)
    with np.load(os.path.join(tmp, "init.npz")) as f:
        init = dict(f)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {_arm_id(a): _port_arm(a, init, tmp) for a in arms}
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

@functools.lru_cache(maxsize=None)
def _init():
    """The initial weights, the port's draw from seed 17 (the reference's
    own initializers would run eagerly, op by op)."""
    from paddle_tpu_torch.models import bert as TB
    m = TB.BertModel(TB.BertConfig(**TINY), device="cpu",
                     generator=torch.Generator().manual_seed(17))
    return {n: p.detach().numpy().copy() for n, p in m.named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_model():
    """The reference's model holding ``_init()``: built under
    ``jax.eval_shape`` (its initializers traced, not run; its RNG streams
    left as they were), once (its steps do not donate)."""
    import jax
    import jax.numpy as jnp
    from paddle_tpu.core import rng as jrng
    from paddle_tpu.models.bert import BertConfig, BertModel
    box, saved = [], jrng.get_rng_state()

    def build():
        box.append(BertModel(BertConfig(**TINY)))
        return 0

    try:
        jax.eval_shape(build)
    finally:
        jrng.set_rng_state(saved)
    for n, p in box[0].named_parameters():
        p._data = jnp.array(_init()[n], copy=True)
    return box[0]


@functools.lru_cache(maxsize=None)
def _jax_arm(mesh_name, fused):
    from paddle_tpu.core.flags import set_flags
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.spmd import make_gspmd_step_from_loss
    from paddle_tpu.optimizer import AdamW
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, "pp_degree": 1,
                         **MESHES[mesh_name]}
    fleet.fleet.init(is_collective=True, strategy=st)
    hcg = fleet.fleet.get_hybrid_communicate_group()
    model = _jax_model()

    def loss_of(params, ids, mlm, nsp, am):
        return model.pretrain_loss_fn(params, ids, mlm, nsp,
                                      attention_mask=am, remat=True)

    set_flags({"FLAGS_use_fused_ln": fused,
               "FLAGS_fused_ln_interpret": fused})
    try:
        step, state = make_gspmd_step_from_loss(
            loss_of, {n: p._data for n, p in model.named_parameters()},
            AdamW(LR), hcg.mesh, layer=model, donate=False)
        losses, moments = [], []
        for _ in range(STEPS):
            state, loss = step(state, np.float32(LR), *_batch())
            losses.append(float(loss))
            moments.append(_second_moments(state, hcg.mesh))
    finally:
        set_flags({"FLAGS_use_fused_ln": False,
                   "FLAGS_fused_ln_interpret": False})
    shards = _jshards(state, hcg.mesh)
    shards["moments"] = moments
    return losses, shards


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def init():
    return _init()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("btp2"), init, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("btp4"), init, ARMS4)}


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
    _jax_model.cache_clear()
    _init.cache_clear()
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("arm", ARMS2 + ARMS4, ids=_arm_id)
def test_losses_and_shards_match_the_jax_mesh(request, started, arm):
    losses, jshards = _jax_arm(arm[0], arm[1])
    ranks = request.getfixturevalue("ranks2" if arm in ARMS2 else "ranks4")
    name = _arm_id(arm)
    for r, rk in enumerate(ranks):
        _close(rk[name]["losses"], losses, *TOL, msg=f"losses rank {r}")
    _compare_shards([rk[name]["state"] for rk in ranks], jshards)


@pytest.mark.parametrize("arm", ARMS2 + ARMS4, ids=_arm_id)
def test_vocabulary_splits_where_the_degree_divides_it(request, started,
                                                       init, arm):
    """``word_emb`` and ``mlm_bias`` split over mp 2 and stay whole at mp
    4 (126 rows); a rank holds 1/mp of the split blocks' bytes."""
    ranks = request.getfixturevalue("ranks2" if arm in ARMS2 else "ranks4")
    mp = MESHES[arm[0]]["mp_degree"]
    split = {"blocks_qkv_w", "blocks_qkv_b", "blocks_proj_w",
             "blocks_fc1_w", "blocks_fc1_b", "blocks_fc2_w"}
    if mp == 2:
        split |= {"word_emb", "mlm_bias"}
    want = sum(v.size * 4 // (mp if n in split else 1)
               for n, v in init.items())
    for rk in ranks:
        got = rk[_arm_id(arm)]
        for n in ("word_emb", "mlm_bias"):
            assert ("model" in tuple(got["layout"]["params"][n])) == \
                (mp == 2), (n, got["layout"]["params"][n])
        assert got["state_bytes"] == 2 * want
        assert sum(v.size * 4 for v in got["state"]["params"].values()) \
            == want


@pytest.mark.parametrize("arm", ARMS2 + ARMS4, ids=_arm_id)
def test_monitor_counts_each_token_once(request, started, arm):
    ranks = request.getfixturevalue("ranks2" if arm in ARMS2 else "ranks4")
    name = _arm_id(arm)
    for step in range(STEPS - 1):   # the first call is the compile event
        got = [rk[name]["counted"][step] for rk in ranks]
        assert sum(e for e, _ in got) == B and sum(t for _, t in got) == B * L
        for rk, (e, t) in zip(ranks, got):
            assert (t > 0) == (rk[name]["mp_rank"] == 0)


def test_weighted_vocab_parallel_ce_equals_the_whole_vocabulary():
    """``vocab_parallel_cross_entropy_weighted_mean`` over one rank is the
    plain weighted mean (its split arm runs in every mp arm above)."""
    from paddle_tpu_torch.distributed.collective import Group
    from paddle_tpu_torch.ops import loss as TL
    r = np.random.RandomState(0)
    logits = torch.tensor(r.randn(3, 5, 11), requires_grad=True)
    labels = torch.tensor(r.randint(0, 11, (3, 5)))
    w = torch.tensor((r.rand(3, 5) < 0.5).astype(np.float64))
    a = TL.vocab_parallel_cross_entropy_weighted_mean(logits, labels, w,
                                                      Group(ranks=[0]))
    b = TL.softmax_cross_entropy_weighted_mean(logits, labels, w)
    assert float(a.detach()) == float(b.detach())

"""Port parity for GPT training over the pipe axis
(``paddle_tpu_torch/models/gpt.py`` ``make_gpt_train_step``'s pipe branch,
``distributed/pipeline_engine.py`` ``make_stacked_pipeline_step``) against
the JAX package's ``make_gpt_train_step`` on its CPU mesh.

Arms (tiny GPT: vocab 128, H 32, 4 layers, 4 heads, L 16, fp32, AdamW,
B 4, 3 steps): pp 2 (M 2, remat off; M 4 with remat on; a global-norm
clip over the pipe ranks), pp 2 x V 2 interleaved (remat on) on 2 gloo
ranks; pp 4 (M 4), dp 2 x pp 2, pp 2 x mp 2 and pp 2 x V 2 x mp 2 on 4.
Each rank's losses are held within 1e-4 of the reference's, and its
parameter and slot shards against ``addressable_shards[r]`` as ERNIE-MoE's
are (``tests/test_torch_ernie_moe_ep.py`` ``_compare_shards``: 1e-4
relative, 1e-5 absolute, AdamW's 2·lr a step where the reference's own
gradient came under 1e-5).  The pipe ranks end every step with bit-equal
copies of the parameters they replicate.  The interleaved state's
checkpoint (dim 0 chunk-interleaved and split over "pipe") saved by the
two ranks loads bit-exact in the reference, and the reference's loads
bit-exact into each rank's shards.  BERT and ERNIE-MoE at pp 2 hold the
pipe axis replicated, as the reference's steps do: their ranks' losses
match the reference's pp 2 losses and their states equal the port's
one-rank step's bit for bit.  The reference's refusals raise with its
exception types.  The spawned ranks import this module, so it imports no
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

from test_torch_dp import _close, _jshards, _np
from test_torch_ernie_moe_ep import (_bits, _compare_shards, _flat, _nest,
                                     _rank_mesh, _second_moments)

TINY = dict(vocab_size=128, hidden_size=32, num_layers=4,
            num_attention_heads=4, max_position_embeddings=16,
            compute_dtype="float32")
B, L, STEPS, LR = 4, 16, 3, 1e-3
TOL = (1e-4, 1e-5)
#: name: (hybrid configs, n_microbatches, remat)
ARMS2 = {"pp2": ({"pp_degree": 2}, 2, False),
         "pp2_remat": ({"pp_degree": 2}, 4, True),
         "pp2_clip": ({"pp_degree": 2}, 2, False),
         "pp2_v2": ({"pp_degree": 2,
                     "pp_configs": {"virtual_pipeline_degree": 2}}, 2, True)}
ARMS4 = {"pp4": ({"pp_degree": 4}, 1, False),
         "dp2_pp2": ({"dp_degree": 2, "pp_degree": 2}, 2, False),
         "pp2_mp2": ({"pp_degree": 2, "mp_degree": 2}, 2, False),
         "pp2_v2_mp2": ({"pp_degree": 2, "mp_degree": 2,
                         "pp_configs": {"virtual_pipeline_degree": 2}}, 2,
                        True)}
SAVED = "pp2_v2"
CLIP = 0.05
WHOLE = ("wte", "wpe", "lnf_w", "lnf_b")
BERT = dict(vocab_size=126, hidden_size=32, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=16,
            compute_dtype="float32")
ERNIE = dict(vocab_size=128, hidden_size=32, num_layers=2,
             num_attention_heads=4, num_experts=4, top_k=2,
             max_position_embeddings=16, compute_dtype="float32")


def _clip(name, nn):
    return nn.ClipGradByGlobalNorm(CLIP) if name.endswith("_clip") else None


def _batch():
    r = np.random.RandomState(0)
    return r.randint(0, 128, (B, L)), r.randint(0, 128, (B, L))


def _bert_batch():
    r = np.random.RandomState(4)
    ids = r.randint(0, 126, (B, L))
    mlm = np.where(r.rand(B, L) < 0.4, r.randint(0, 126, (B, L)), -100)
    return ids, mlm, r.randint(0, 2, (B,))


# ------------------------------------------------------- the port side --

def _port_arm(name, init, tmp):
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import gpt as TG
    from paddle_tpu_torch.telemetry import TrainMonitor
    import paddle_tpu_torch.nn as tnn
    import paddle_tpu_torch.optimizer as TO
    hc, M, remat = {**ARMS2, **ARMS4}[name]
    st = fleet.DistributedStrategy()
    st.hybrid_configs = hc
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    m = TG.params_from_numpy(init, TG.GPTConfig(**TINY), device="cpu")
    mon = TrainMonitor()
    step, state = TG.make_gpt_train_step(
        m, TO.AdamW(LR, grad_clip=_clip(name, tnn)), hcg, n_microbatches=M,
        remat=remat, monitor=mon)
    x, y = (torch.tensor(a) for a in _batch())
    losses, whole = [], []
    for _ in range(STEPS):
        state, loss = step(state, 0, LR, x, y)
        losses.append(float(loss))
        whole.append({n: _np(state["params"][n]) for n in WHOLE})
    out = {"losses": losses, "state": _np(state), "whole": whole,
           "coord": dict(hcg.mesh.coord),
           "counted": [(e["examples"], e["tokens"])
                       for e in mon.events("train_step")],
           "layout": step.layout.specs}
    if name == SAVED:
        tck.save(state, os.path.join(tmp, f"ck_{name}"),
                 shardings=step.layout)
    return out


def _replicated_arms(init_bert, init_ernie):
    """BERT and ERNIE-MoE at pp 2 (the pipe axis replicated): losses and
    states."""
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import ernie_moe as TE
    import paddle_tpu_torch.optimizer as TO
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"pp_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    return {"bert": _run_bert(init_bert, hcg, TB, TO),
            "ernie": _run_ernie(init_ernie, hcg, TE, TO)}


def _run_bert(init, hcg, TB, TO):
    m = TB.params_from_numpy(init, TB.BertConfig(**BERT), device="cpu")
    step, state = TB.make_bert_train_step(m, TO.AdamW(LR), hcg)
    batch = [torch.tensor(a) for a in _bert_batch()]
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, LR, *batch)
        losses.append(float(loss))
    return losses, _np(state)


def _run_ernie(init, hcg, TE, TO):
    m = TE.params_from_numpy(init, TE.ErnieMoeConfig(**ERNIE), device="cpu")
    step, state = TE.make_ernie_moe_train_step(m, TO.AdamW(LR), hcg)
    x, y = (torch.tensor(a) for a in _batch())
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, LR, x, y)
        losses.append(float(loss))
    return losses, _np(state)


def _rank_main(rank, world, tmp, arms):
    torch.set_num_threads(1)
    with open(os.path.join(tmp, "init.pkl"), "rb") as f:
        init = pickle.load(f)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {n: _port_arm(n, init["gpt"], tmp) for n in arms}
    if world == 2:
        out["replicated"] = _replicated_arms(init["bert"], init["ernie"])
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init, arms):
    import torch.multiprocessing as mp
    with open(os.path.join(tmp, "init.pkl"), "wb") as f:
        pickle.dump(init, f)
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), list(arms)),
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


def _jax_inits():
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.models.bert import BertConfig, BertModel
    from paddle_tpu.models.ernie_moe import ErnieMoeConfig, ErnieMoeModel
    from paddle_tpu.models.gpt import GPTConfig, GPTModel

    def params(model):
        return {n: np.asarray(jax.device_get(p._data))
                for n, p in model.named_parameters()}
    paddle.seed(11)
    gpt = params(GPTModel(GPTConfig(**TINY)))
    paddle.seed(12)
    bert = params(BertModel(BertConfig(**BERT)))
    paddle.seed(13)
    ernie = params(ErnieMoeModel(ErnieMoeConfig(**ERNIE)))
    return {"gpt": gpt, "bert": bert, "ernie": ernie}


@functools.lru_cache(maxsize=None)
def _jax_arm(name):
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.models.gpt import GPTConfig, GPTModel, make_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    hc, M, remat = {**ARMS2, **ARMS4}[name]
    hcg = _jax_hcg(hc)
    paddle.seed(11)
    step, state = make_gpt_train_step(
        GPTModel(GPTConfig(**TINY)), AdamW(LR, grad_clip=_clip(name, jnn)),
        hcg, n_microbatches=M, remat=remat, donate=False)
    x, y = _batch()
    losses, moments = [], []
    for _ in range(STEPS):
        state, loss = step(state, jax.random.key(0), np.float32(LR), x, y)
        losses.append(float(loss))
        moments.append(_second_moments(state, hcg.mesh))
    shards = _jshards(state, hcg.mesh)
    shards["moments"] = moments
    return losses, shards, state, hcg.mesh


@functools.lru_cache(maxsize=None)
def _jax_replicated():
    """The reference's BERT and ERNIE-MoE losses at pp 2."""
    import paddle_tpu as paddle
    from paddle_tpu.models import bert as B
    from paddle_tpu.models import ernie_moe as E
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg({"pp_degree": 2})
    out = {}
    paddle.seed(12)
    step, state = B.make_bert_train_step(B.BertModel(B.BertConfig(**BERT)),
                                         AdamW(LR), hcg, donate=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, np.float32(LR), *_bert_batch())
        losses.append(float(loss))
    out["bert"] = losses
    paddle.seed(13)
    step, state = E.make_ernie_moe_train_step(
        E.ErnieMoeModel(E.ErnieMoeConfig(**ERNIE)), AdamW(LR), hcg,
        donate=False)
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, np.float32(LR), *_batch())
        losses.append(float(loss))
    out["ernie"] = losses
    return out


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def init():
    return _jax_inits()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("pp2"), init, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("pp4"), init, ARMS4)}


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
    _jax_replicated.cache_clear()
    gc.collect()


def _ranks(request, name):
    return request.getfixturevalue("ranks2" if name in ARMS2 else "ranks4")


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_losses_and_shards_match_the_jax_mesh(request, started, name):
    losses, jshards, _, _ = _jax_arm(name)
    ranks = _ranks(request, name)
    for r, rk in enumerate(ranks):
        _close(rk[name]["losses"], losses, *TOL, msg=f"losses rank {r}")
    _compare_shards([rk[name]["state"] for rk in ranks], jshards)


@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_pipe_ranks_hold_equal_whole_parameters(request, started, name):
    """``wte``, ``wpe`` and the final LayerNorm (the tied head's weight
    gathers two stages' gradients) are bit-equal over each pipe group
    after every step, and a rank's blocks are dim 0 of the interleaved
    stack split over "pipe"."""
    ranks = _ranks(request, name)
    hc = {**ARMS2, **ARMS4}[name][0]
    for rk in ranks:
        assert len(rk[name]["whole"]) == STEPS
    by_group = {}
    for rk in ranks:
        c = rk[name]["coord"]
        by_group.setdefault((c["data"], c["model"]), []).append(rk)
    for group in by_group.values():
        assert len(group) == hc["pp_degree"]
        for step in range(STEPS):
            for n in WHOLE:
                for rk in group[1:]:
                    np.testing.assert_array_equal(
                        rk[name]["whole"][step][n],
                        group[0][name]["whole"][step][n], err_msg=n)
    S = hc["pp_degree"]
    for rk in ranks:
        spec = tuple(rk[name]["layout"]["params"]["blocks_qkv_w"])
        assert spec[0] == "pipe"
        assert rk[name]["state"]["params"]["blocks_qkv_w"].shape[0] == \
            TINY["num_layers"] // S


@pytest.mark.parametrize("name", list(ARMS2) + list(ARMS4))
def test_monitor_counts_each_token_once(request, started, name):
    ranks = _ranks(request, name)
    for step in range(STEPS - 1):
        got = [rk[name]["counted"][step] for rk in ranks]
        assert sum(e for e, _ in got) == B and sum(t for _, t in got) == B * L


def test_port_pipe_sharded_save_loads_bit_exact_in_reference(started,
                                                            ranks2):
    import jax.numpy as jnp
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    *_, jmesh = _jax_arm(SAVED)
    d = os.path.join(str(started[2][2]), f"ck_{SAVED}")
    leaves = _flat(ranks2[0][SAVED]["state"])
    specs = _flat(ranks2[0][SAVED]["layout"])
    got = _flat(jck.load(d, target=_nest(leaves,
                                         lambda k, v: jnp.zeros(1))))
    assert set(got) == set(leaves)
    split = 0
    for k in leaves:
        full = torch.from_numpy(np.array(got[k]))
        for r, rk in enumerate(ranks2):
            blk = local_shard(full, specs[k], _rank_mesh(jmesh, r)) \
                if full.dim() else full
            split += blk.shape != full.shape
            assert _bits(blk) == _bits(np.asarray(_flat(
                rk[SAVED]["state"])[k])), (k, r)
    assert split > 0


def test_reference_pipe_sharded_save_loads_bit_exact_per_rank(ranks2,
                                                             tmp_path):
    import jax
    from paddle_tpu.distributed import checkpoint as jck
    from paddle_tpu_torch.distributed import checkpoint as tck
    from paddle_tpu_torch.distributed.sharding_rules import local_shard
    _, _, jstate, jmesh = _jax_arm(SAVED)
    d = str(tmp_path / "jck_pp2_v2")
    jck.save({"params": jstate["params"], "opt": jstate["opt"]}, d)
    full = {k: np.asarray(jax.device_get(v)) for k, v in _flat(
        {"params": jstate["params"], "opt": jstate["opt"]}).items()}
    specs = _flat(ranks2[0][SAVED]["layout"])
    for r, rk in enumerate(ranks2):
        mine = {k: v for k, v in _flat(rk[SAVED]["state"]).items()
                if k in full}
        tmpl = _nest(mine, lambda k, v: torch.zeros(
            np.shape(v), dtype=torch.as_tensor(np.asarray(v)).dtype))
        got = _flat(tck.load(d, target=tmpl, shardings=tck.Layout(
            _nest(mine, lambda k, v: specs[k]), _rank_mesh(jmesh, r))))
        for k in mine:
            t = torch.from_numpy(np.array(full[k]))
            want = local_shard(t, specs[k], _rank_mesh(jmesh, r)) \
                if t.dim() else t
            assert _bits(got[k]) == _bits(want), (k, r)


@pytest.mark.parametrize("model", ["bert", "ernie"])
def test_replicated_pipe_computes_the_one_rank_step(started, ranks2, init,
                                                   model):
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import ernie_moe as TE
    import paddle_tpu_torch.optimizer as TO
    want = _jax_replicated()[model]
    run = _run_bert if model == "bert" else _run_ernie
    one_losses, one_state = run(init[model], None,
                                TB if model == "bert" else TE, TO)
    _close(one_losses, want, *TOL, msg=model)
    for rk in ranks2:
        losses, state = rk["replicated"][model]
        assert losses == one_losses
        for k, v in _flat(one_state).items():
            np.testing.assert_array_equal(_flat(state)[k], v, err_msg=k)


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


@pytest.mark.parametrize("kw,exc", [(dict(grad_comm="bf16"),
                                     NotImplementedError),
                                    (dict(zero_stage=1), NotImplementedError),
                                    (dict(dynamic_loss_scale=True),
                                     NotImplementedError),
                                    (dict(sep=2), ValueError)])
def test_refusals_raise_as_the_reference(kw, exc):
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTModel, make_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    from paddle_tpu_torch.models import gpt as TG
    import paddle_tpu_torch.optimizer as TO
    kw = dict(kw)
    sep = kw.pop("sep", 1)
    mode = "ring" if sep > 1 else None
    paddle.seed(0)
    with pytest.raises(exc):
        make_gpt_train_step(
            GPTModel(GPTConfig(**TINY, sequence_parallel=mode)), AdamW(LR),
            _jax_hcg({"pp_degree": 2, "sep_degree": sep}), **kw)
    m = TG.GPTModel(TG.GPTConfig(**TINY, sequence_parallel=mode),
                    device="cpu")
    with pytest.raises(exc):
        TG.make_gpt_train_step(m, TO.AdamW(LR), _Degrees(pp=2, sep=sep),
                               **kw)

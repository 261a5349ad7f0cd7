"""Port parity for the data-parallel train steps (``distributed/spmd.py``,
``distributed/update_sharding.py``, the GPT and BERT builders) against
the JAX package on its CPU mesh, at 2 and 4 gloo ranks.

Arms: GPT over dp 2 and dp 4 (the GSPMD-counterpart step), update
sharding at R = 2 under fp32 and int8_ef (wire mode), and
``make_spmd_train_step`` with an ``nn.Sequential`` over dp 4 against the
reference's serial and dp 4 runs.  This module also holds the port and
JAX arms that ``test_torch_grad_comm.py`` (the sharded-init GPT step
under each ``grad_comm``) and ``test_torch_dp_bert.py`` (BERT) spawn.  One spawn per world size (module
fixtures, started before the JAX side runs); the spawned ranks import
this module, so it imports no JAX at its top.  Rank r holds what the
reference's device at flat mesh position r holds.

Tolerances: fp32 losses rtol 1e-5, atol 1e-6 (the reference's);
parameters rtol 1e-4, atol 1e-5 and slots rtol 1e-5, atol 1e-6
(``test_torch_zero.py``); int8_ef curves within rtol 0.02 of the fp32
curve (``tests/test_grad_comm.py:438``), and of the JAX int8_ef curve
within rtol 1e-4, their residuals equal but for under 0.1% of the
elements (a last-bit difference of a gradient may move a value across an
int8 rounding boundary; the parameter it feeds moves by up to 2·lr,
Adam's normalised step).
"""

import functools
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
BTINY = dict(vocab_size=128, hidden_size=64, num_hidden_layers=2,
             num_attention_heads=4, max_position_embeddings=64,
             compute_dtype="float32")
B, L, STEPS, LR = 8, 16, 3, 1e-3
RTOL, ATOL = 1e-5, 1e-6
P_RTOL, P_ATOL = 1e-4, 1e-5


def _batch():
    r = np.random.RandomState(0)
    return r.randint(0, 128, (B, L)), r.randint(0, 128, (B, L))


def _bert_batch():
    r = np.random.RandomState(2)
    ids = r.randint(0, 128, (B, L))
    mlm = np.where(r.rand(B, L) < 0.3, r.randint(0, 128, (B, L)), -100)
    mlm[:2] = -100                # rank 0 of 2 sees fewer valid labels
    mlm[0, 3] = 7
    return ids, mlm, r.randint(0, 2, (B,))


def _seq_batch():
    r = np.random.RandomState(5)
    return (r.standard_normal((16, 10)).astype(np.float32),
            r.randint(0, 4, 16))


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy().copy()
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


def _run(step, state, batch, lr=LR, pre=()):
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, *pre, lr, *batch)
        losses.append(float(loss))
    return {"losses": losses, "state": _np(state)}


def _port_arm(kind, dp, sh, kw, init):
    from paddle_tpu_torch.models import bert as TB
    from paddle_tpu_torch.models import gpt as TG
    import paddle_tpu_torch.optimizer as TO
    hcg = _port_hcg(dp, sh)
    x, y = (torch.tensor(a) for a in _batch())
    if kind == "gpt":
        m = TG.params_from_numpy(init["gpt"], TG.GPTConfig(**TINY),
                                 device="cpu")
        step, st = TG.make_gpt_train_step(m, TO.AdamW(LR), hcg, remat=False,
                                          **kw)
        return _run(step, st, (x, y), pre=(0,))
    if kind == "gpt_sharded":
        step, st = TG.make_sharded_gpt_train_step(
            TG.GPTConfig(**TINY), TO.AdamW(LR), hcg, remat=False,
            device="cpu", **kw)
        with torch.no_grad():     # the reference's initial weights
            for n, p in st["params"].items():
                p.copy_(torch.tensor(init["gpt_sharded"][n]))
        out = []
        for _ in range(STEPS):
            st, loss = step(st, LR, 0, x, y)
            out.append(float(loss))
        return {"losses": out, "state": _np(st)}
    batch = tuple(torch.tensor(a) for a in _bert_batch())
    if kind == "bert":
        m = TB.params_from_numpy(init["bert"], TB.BertConfig(**BTINY),
                                 device="cpu")
        step, st = TB.make_bert_train_step(m, TO.AdamW(LR), hcg, remat=False)
        return _run(step, st, batch)
    if kind == "bert_sharded":
        step, st = TB.make_sharded_bert_train_step(
            TB.BertConfig(**BTINY), TO.AdamW(LR), hcg, remat=False,
            device="cpu", **kw)
        with torch.no_grad():
            for n, p in st["params"].items():
                p.copy_(torch.tensor(init["bert_sharded"][n]))
        return _run(step, st, batch)
    # make_spmd_train_step over an nn.Sequential
    from paddle_tpu_torch.distributed import make_spmd_train_step
    net = torch.nn.Sequential(torch.nn.Linear(10, 16), torch.nn.Tanh(),
                              torch.nn.Linear(16, 4))
    with torch.no_grad():
        for n, p in net.named_parameters():
            p.copy_(torch.tensor(init["seq"][n]).T)   # paddle's (in, out)
    step, st, specs = make_spmd_train_step(
        net, torch.nn.CrossEntropyLoss(), TO.SGD(0.1), hcg)
    sx, sy = (torch.tensor(a) for a in _seq_batch())
    out = []
    for _ in range(4):
        st, loss = step(st, 0, 0.1, [sx], [sy.long()])
        out.append(float(loss))
    return {"losses": out, "state": _np(st)}


def _rank_main(rank, world, tmp, init, arms):
    import datetime
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {name: _port_arm(*spec, init) for name, spec in arms.items()}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init, arms):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), init, arms),
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

def _jax_hcg(dp, sh):
    from paddle_tpu.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": dp, "mp_degree": 1, "pp_degree": 1,
                         "sharding_degree": sh}
    fleet.fleet.init(is_collective=True, strategy=st)
    return fleet.fleet.get_hybrid_communicate_group()


def _jshards(tree, mesh):
    import jax

    def blocks(arr):
        by_dev = {s.device: s.data for s in arr.addressable_shards}
        return [np.asarray(by_dev.get(d, arr)) for d in mesh.devices.flat]
    return jax.tree_util.tree_map(blocks, tree)


def _jax_init(parts):
    """The initial weights of the arms in ``parts``, from the reference's
    own inits (the sharded-init builders draw from jax.random.key(seed))."""
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.models.bert import BertConfig, BertModel
    from paddle_tpu.models.gpt import GPTConfig, GPTModel

    def gpt():
        paddle.seed(11)
        return GPTModel(GPTConfig(**TINY)).named_parameters()

    def bert():
        paddle.seed(13)
        return BertModel(BertConfig(**BTINY)).named_parameters()

    def seq():
        paddle.seed(7)
        return jnn.Sequential(jnn.Linear(10, 16), jnn.Tanh(),
                              jnn.Linear(16, 4)).named_parameters()

    def sharded(fn):
        return lambda: fn(build_only=True)[1]["params"].items()

    makers = {"gpt": gpt, "bert": bert, "seq": seq,
              "gpt_sharded": sharded(_jax_sharded_gpt),
              "bert_sharded": sharded(_jax_sharded_bert)}
    return {k: {n: np.asarray(jax.device_get(getattr(p, "_data", p)))
                for n, p in makers[k]()} for k in parts}


@functools.lru_cache(maxsize=None)
def _jax_gpt(dp, **kw):
    import jax
    import paddle_tpu as paddle
    from paddle_tpu.models.gpt import GPTConfig, GPTModel, make_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg(dp, 1)
    paddle.seed(11)
    step, state = make_gpt_train_step(GPTModel(GPTConfig(**TINY)),
                                      AdamW(LR), hcg, remat=False, **kw)
    x, y = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, jax.random.key(0), np.float32(LR), x, y)
        losses.append(float(loss))
    return losses, _jshards(state, hcg.mesh)


@functools.lru_cache(maxsize=None)
def _jax_sharded_gpt(grad_comm=None, build_only=False):
    import jax
    from paddle_tpu.models.gpt import GPTConfig, make_sharded_gpt_train_step
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg(1, 2)
    step, state = make_sharded_gpt_train_step(
        GPTConfig(**TINY), AdamW(LR), hcg, remat=False, grad_comm=grad_comm)
    if build_only:
        return step, state
    x, y = _batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, np.float32(LR), jax.random.key(0), x, y)
        losses.append(float(loss))
    return losses, _jshards(state, hcg.mesh)


def _jax_bert(dp):
    import paddle_tpu as paddle
    from paddle_tpu.models.bert import (BertConfig, BertModel,
                                        make_bert_train_step)
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg(dp, 1)
    paddle.seed(13)
    step, state = make_bert_train_step(BertModel(BertConfig(**BTINY)),
                                       AdamW(LR), hcg, remat=False)
    return _jax_bert_run(step, state, hcg)


def _jax_sharded_bert(build_only=False):
    from paddle_tpu.models.bert import (BertConfig,
                                        make_sharded_bert_train_step)
    from paddle_tpu.optimizer import AdamW
    hcg = _jax_hcg(1, 2)
    step, state = make_sharded_bert_train_step(
        BertConfig(**BTINY), AdamW(LR), hcg, zero_stage=1, remat=False)
    if build_only:
        return step, state
    return _jax_bert_run(step, state, hcg)


def _jax_bert_run(step, state, hcg):
    ids, mlm, nsp = _bert_batch()
    losses = []
    for _ in range(STEPS):
        state, loss = step(state, np.float32(LR), ids, mlm, nsp)
        losses.append(float(loss))
    return losses, _jshards(state, hcg.mesh)


def _jax_seq(dp):
    import jax
    import jax.numpy as jnp
    import paddle_tpu as paddle
    import paddle_tpu.distributed as jdist
    import paddle_tpu.nn as jnn
    from paddle_tpu.optimizer import SGD
    hcg = _jax_hcg(dp, 1)
    paddle.seed(7)
    net = jnn.Sequential(jnn.Linear(10, 16), jnn.Tanh(), jnn.Linear(16, 4))
    step, state, _ = jdist.make_spmd_train_step(
        net, jnn.CrossEntropyLoss(), SGD(0.1, parameters=net.parameters()),
        hcg)
    x, y = _seq_batch()
    losses = []
    for _ in range(4):
        state, loss = step(state, jax.random.key(0), np.float32(0.1),
                           [jnp.asarray(x)], [jnp.asarray(y)])
        losses.append(float(loss))
    return losses


def _close(got, want, rtol=RTOL, atol=ATOL, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=rtol,
                               atol=atol, err_msg=msg)


def _compare(port_ranks, jstate, keys, tol=None):
    """Each rank's leaf under ``keys`` against the reference's block at
    that rank's mesh position."""
    def walk(ports, ref, path):
        if isinstance(ref, dict):
            for k in ref:
                walk([p[k] for p in ports], ref[k], path + [k])
            return
        for r, got in enumerate(ports):
            assert np.shape(got) == np.shape(ref[r]), (path, r)
            t = tol or ((P_RTOL, P_ATOL) if path[0] == "params"
                        else (RTOL, ATOL))
            _close(got, ref[r], *t, msg=f"{path} rank {r}")

    for key in keys:
        walk([p[key] for p in port_ranks], jstate[key], [key])


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays (the cached reference runs) when it
    ends: a later module in the same process ranks the live JAX arrays
    (the reference's memory forensics), and these would crowd out its
    own."""
    yield
    _jax_gpt.cache_clear()
    _jax_sharded_gpt.cache_clear()
    gc.collect()


# ------------------------------------------------------------ fixtures --

ARMS2 = {"gpt_dp2": ("gpt", 2, 1, {}),
         "us_fp32": ("gpt", 2, 1, dict(update_sharding=True)),
         "us_int8": ("gpt", 2, 1, dict(update_sharding=True,
                                       grad_comm="int8_ef"))}
#: the sharded-init arms (``test_torch_grad_comm.py``) and the BERT arms
#: (``test_torch_dp_bert.py``) spawn from their own files
SHARDED_ARMS = {f"sharded_{p}": ("gpt_sharded", 1, 2, dict(grad_comm=p))
                for p in ("fp32", "bf16", "int8_ef")}
BERT_ARMS = {"bert_dp2": ("bert", 2, 1, {}),
             "bert_z1": ("bert_sharded", 1, 2, dict(zero_stage=1))}
ARMS4 = {"gpt_dp4": ("gpt", 4, 1, {}), "seq_dp4": ("seq", 4, 1, {})}


@pytest.fixture(scope="module")
def init():
    return _jax_init(("gpt", "seq"))


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    return {2: _start(2, tmp_path_factory.mktemp("dp2"), init, ARMS2),
            4: _start(4, tmp_path_factory.mktemp("dp4"), init, ARMS4)}


@pytest.fixture(scope="module")
def ranks2(started):
    return _finish(started[2])


@pytest.fixture(scope="module")
def ranks4(started):
    return _finish(started[4])


# --------------------------------------------------------------- tests --

class TestGPTDataParallel:
    @pytest.mark.parametrize("dp", [2, 4])
    def test_dp_matches_the_jax_mesh_and_serial(self, request, dp):
        request.getfixturevalue("started")
        losses, jstate = _jax_gpt(dp)
        serial, _ = _jax_gpt(1)
        ranks = request.getfixturevalue(f"ranks{dp}")
        for rk in ranks:
            p = rk[f"gpt_dp{dp}"]
            _close(p["losses"], losses, msg="losses vs the JAX mesh")
            _close(p["losses"], serial, msg="losses vs serial")
        _compare([rk[f"gpt_dp{dp}"]["state"] for rk in ranks], jstate,
                 ("params", "opt"))


class TestUpdateSharding:
    def test_fp32_step_for_step_with_the_jax_mesh(self, started, ranks2):
        losses, jstate = _jax_gpt(2, update_sharding=True)
        for rk in ranks2:
            _close(rk["us_fp32"]["losses"], losses)
        _compare([rk["us_fp32"]["state"] for rk in ranks2], jstate,
                 ("params", "opt"))
        # the flat slot shards are 1/2 of the padded flat vector
        n = sum(v.size for v in ranks2[0]["us_fp32"]["state"]
                ["params"].values())
        m1 = ranks2[0]["us_fp32"]["state"]["opt"]["slots"]["flat"]["moment1"]
        assert m1.size == -(-n // 2)

    def test_int8_ef_wire_mode(self, started, ranks2):
        losses, jstate = _jax_gpt(2, update_sharding=True,
                                  grad_comm="int8_ef")
        fp32, _ = _jax_gpt(2, update_sharding=True)
        for rk in ranks2:
            p = rk["us_int8"]
            _close(p["losses"], losses, rtol=1e-4, atol=0)
            _close(p["losses"], fp32, rtol=0.02, atol=0)
            assert p["state"]["comm_e"].shape[0] == 1    # its own row
            assert np.abs(p["state"]["comm_e"]).max() > 0
        # each replica's residual row equals the reference's but where a
        # last-bit difference of the local gradient moved an element
        # across an int8 rounding boundary (one quantization step of its
        # block; ~30 of 100k elements seen)
        for r, rk in enumerate(ranks2):
            d = np.abs(rk["us_int8"]["state"]["comm_e"] - jstate["comm_e"][r])
            assert (d > 1e-6).mean() < 1e-3, (r, (d > 1e-6).sum())
        # such an element moves its parameter by up to 2·lr through Adam's
        # normalised step
        _compare([rk["us_int8"]["state"] for rk in ranks2], jstate,
                 ("params",), tol=(0, 2 * LR))


class TestSpmdTrainStep:
    def test_sequential_dp4_loss_matches_serial(self, started, ranks4):
        """The reference's ``test_dp_loss_matches_serial`` on the port:
        an ``nn.Sequential`` and ``CrossEntropyLoss`` over dp 4."""
        serial, dp4 = _jax_seq(1), _jax_seq(4)
        np.testing.assert_allclose(serial, dp4, rtol=1e-5, atol=1e-6)
        for rk in ranks4:
            _close(rk["seq_dp4"]["losses"], dp4)

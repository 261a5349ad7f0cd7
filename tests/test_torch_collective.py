"""Port parity for the collective API, the topology and the environment
(``paddle_tpu_torch/distributed/{collective,topology,env}.py`` and
``fleet``) against the JAX package.

Each collective runs on 4 gloo ranks (one spawn for the file; the R = 2
cases on the groups {0, 1} and {2, 3}) over the same numpy data the
reference's ``shard_map`` body sees per device, and rank r's result is
held against device r's: integers exactly, fp32 within 1e-6 relative
(``PROD`` within the reference's own 1e-5: it multiplies through
exp(sum(log|x|)), the port exactly).  The port's collectives act in place
on the caller's tensor and return it (``ROADMAP.md`` §C).  The hybrid
group's layout (rank r = flat mesh position r, dp 2 x sharding 2) is held
against the reference's mesh.  Guards: the import grep, a JAX-free
import, ``init_parallel_env()`` without a card, the refusals GPT's
pipeline keeps (ROADMAP A7c: ZeRO and update sharding over a pipe
degree), and the model/sep degrees that BERT's step and ZeRO wait for
(ROADMAP A7b).

The spawned ranks import this module, so it imports no JAX at its top.
"""

import gc
import os
import pickle
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import paddle_tpu_torch.distributed as dist

R = 4
REPO = Path(__file__).resolve().parents[1]


def _data():
    r = np.random.RandomState(0)
    signs = np.array([[2.0, 1.0], [-3.0, 2.0], [0.5, -4.0], [-1.0, 0.5]],
                     np.float32)
    zeros = np.array([[2.0, 1.0], [-3.0, 0.0], [0.0, -4.0], [-1.0, 3.0]],
                     np.float32)
    return {"f": r.standard_normal((R, 4)).astype(np.float32),
            "i": r.randint(-50, 50, (R, 4)).astype(np.int32),
            "signs": signs, "zeros": zeros,
            "iprod": np.array([[2], [3], [7], [1]], np.int32)}


# ------------------------------------------------------- the port side --

def _port(rank, data):
    """Every collective on this rank's rows; in-place ones also report
    that they returned the caller's tensor."""
    C = dist.collective
    out = {}
    mine = {k: torch.tensor(v[rank]) for k, v in data.items()}
    for op in ("SUM", "MAX", "MIN", "AVG"):
        for k in ("f", "i") if op != "AVG" else ("f",):
            t = mine[k].clone()
            got = dist.all_reduce(t, op=getattr(dist.ReduceOp, op))
            out[f"ar_{op}_{k}"] = (got.numpy().copy(), got is t)
    for k in ("signs", "zeros", "iprod"):
        t = mine[k].clone()
        out[f"prod_{k}"] = dist.all_reduce(t, op=dist.ReduceOp.PROD).numpy()
    lst = []
    dist.all_gather(lst, mine["f"])
    out["all_gather"] = np.stack([t.numpy() for t in lst])
    out["all_gather_stacked"] = dist.all_gather(None, mine["f"]).numpy()
    out["reduce_scatter"] = dist.reduce_scatter(
        None, input_tensor=mine["f"]).numpy()
    t = torch.empty(1)
    got = dist.reduce_scatter(t, tensor_list=list(mine["f"].split(1)))
    out["reduce_scatter_list"] = (got.numpy().copy(), got is t)
    out["alltoall"] = dist.alltoall(list(mine["f"].split(1))).numpy()
    out["alltoall_single"] = dist.alltoall_single(mine["i"]).numpy()
    t = mine["f"].clone()
    got = dist.broadcast(t, src=2)
    out["broadcast"] = (got.numpy().copy(), got is t)
    t = torch.empty(4)
    dist.scatter(t, [torch.tensor(data["f"][i]) for i in range(R)], src=1)
    out["scatter"] = t.numpy()
    t = mine["i"].clone()
    out["reduce"] = dist.reduce(t, dst=0).numpy()
    buf = torch.empty(4)
    send_to, recv_from = (rank + 1) % R, (rank - 1) % R
    if rank % 2 == 0:
        dist.send(mine["f"], send_to)
        dist.recv(buf, recv_from)
    else:
        dist.recv(buf, recv_from)
        dist.send(mine["f"], send_to)
    out["ring"] = buf.numpy()
    objs = []
    dist.all_gather_object(objs, {"rank": rank, "s": "x" * rank})
    out["all_gather_object"] = objs
    lst = [f"from {rank}", rank * 10] if rank == 3 else [None, None]
    dist.broadcast_object_list(lst, src=3)
    out["broadcast_object_list"] = lst
    dist.barrier()
    # the R = 2 groups: every rank creates both, in the same order
    pairs = [dist.new_group([0, 1]), dist.new_group([2, 3])]
    g = pairs[rank // 2]
    t = mine["f"].clone()
    out["pair_sum"] = dist.all_reduce(t, group=g).numpy()
    out["pair_gather"] = dist.all_gather(None, mine["i"], group=g).numpy()
    out["pair_rank"] = (g.rank, g.nranks, g.ranks)
    out["staged"] = dict(dist.collective.HOST_STAGING)
    return out


def _port_topology(rank):
    from paddle_tpu_torch.distributed import fleet
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 2, "sharding_degree": 2}
    fleet.init(is_collective=True, strategy=st)
    hcg = fleet.get_hybrid_communicate_group()
    mesh = hcg.mesh
    # a collective over each axis group: the sum of the members' ranks
    sums = {}
    for axis in ("data", "sharding"):
        t = torch.tensor([float(rank)])
        sums[axis] = float(dist.all_reduce(t, group=mesh.axis_group(axis)))
    return {"shape": dict(mesh.shape), "coord": dict(mesh.coord),
            "devices": mesh.devices.tolist(),
            "dp_rank": hcg.get_data_parallel_rank(),
            "sh_rank": hcg.get_sharding_parallel_rank(),
            "dp_ranks": hcg.get_data_parallel_group().ranks,
            "sh_ranks": hcg.get_sharding_parallel_group().ranks,
            "mode": hcg.get_parallel_mode(), "nranks": hcg.nranks,
            "sums": sums, "worker": (fleet.worker_index(),
                                     fleet.worker_num())}


def _rank_main(rank, world, tmp, data):
    import datetime
    torch.set_num_threads(1)
    dist.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                           rank=rank, world_size=world,
                           timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {"coll": _port(rank, data), "topo": _port_topology(rank),
           "rank": (dist.get_rank(), dist.get_world_size())}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def ranks(data, tmp_path_factory):
    import torch.multiprocessing as mp
    tmp = tmp_path_factory.mktemp("coll4")
    mp.start_processes(_rank_main, args=(R, str(tmp), data), nprocs=R,
                       join=True, start_method="spawn")
    out = []
    for r in range(R):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


# -------------------------------------------------------- the JAX side --

def _jax_each(body, *arrays, n=R):
    """``body`` as the reference's ``shard_map`` over ``n`` devices, each
    seeing its row of every array; the per-device results stacked."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    from paddle_tpu.core.device import local_devices
    from paddle_tpu.distributed.spmd import shard_map
    mesh = Mesh(np.array(local_devices()[:n]), ("x",))

    def wrapped(*xs):
        return body(*(jnp.squeeze(x, 0) for x in xs))[None]

    f = jax.jit(shard_map(wrapped, mesh=mesh,
                          in_specs=tuple(P("x") for _ in arrays),
                          out_specs=P("x"), check_vma=False))
    return np.asarray(f(*(jnp.asarray(a) for a in arrays)))


def _jgroup(n=R):
    import paddle_tpu.distributed as jd
    return jd.Group(ranks=list(range(n)), axis_name="x")


# --------------------------------------------------------------- tests --

class TestCollectives:
    @pytest.mark.parametrize("op", ["SUM", "MAX", "MIN", "AVG"])
    def test_all_reduce_in_place(self, data, ranks, op):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        for k in ("f", "i") if op != "AVG" else ("f",):
            want = _jax_each(lambda x: jd.all_reduce(
                x, op=getattr(jd.ReduceOp, op), group=g), data[k])
            for r, rk in enumerate(ranks):
                got, same = rk["coll"][f"ar_{op}_{k}"]
                assert same, "all_reduce returns the caller's tensor"
                if k == "i":
                    np.testing.assert_array_equal(got, want[r])
                else:
                    np.testing.assert_allclose(got, want[r], rtol=1e-6)

    @pytest.mark.parametrize("case", ["signs", "zeros", "iprod"])
    def test_all_reduce_prod_signs_zeros_and_integers(self, data, ranks,
                                                      case):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        want = _jax_each(lambda x: jd.all_reduce(x, op=jd.ReduceOp.PROD,
                                                 group=g), data[case])
        exact = data[case].prod(axis=0)
        for r, rk in enumerate(ranks):
            got = rk["coll"][f"prod_{case}"]
            np.testing.assert_array_equal(got, exact)   # the exact product
            if case == "iprod":
                np.testing.assert_array_equal(got, want[r])
            else:
                np.testing.assert_allclose(got, want[r], rtol=1e-5, atol=0)
                np.testing.assert_array_equal(np.sign(got), np.sign(want[r]))

    def test_all_gather_both_forms(self, data, ranks):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        want = _jax_each(lambda x: jd.all_gather(None, x, group=g),
                         data["f"])
        for r, rk in enumerate(ranks):
            np.testing.assert_array_equal(rk["coll"]["all_gather"], want[r])
            np.testing.assert_array_equal(rk["coll"]["all_gather_stacked"],
                                          want[r])

    def test_reduce_scatter(self, data, ranks):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        want = _jax_each(lambda x: jd.reduce_scatter(None, input_tensor=x,
                                                     group=g), data["f"])
        for r, rk in enumerate(ranks):
            np.testing.assert_allclose(rk["coll"]["reduce_scatter"], want[r],
                                       rtol=1e-6)
            got, same = rk["coll"]["reduce_scatter_list"]
            assert same
            np.testing.assert_allclose(got, want[r], rtol=1e-6)

    def test_alltoall_is_the_transpose(self, data, ranks):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        want = _jax_each(lambda x: jd.alltoall(x[:, None], group=g),
                         data["f"])
        for r, rk in enumerate(ranks):
            np.testing.assert_array_equal(rk["coll"]["alltoall"], want[r])
            np.testing.assert_array_equal(
                rk["coll"]["alltoall"].reshape(-1), data["f"][:, r])
        want = _jax_each(lambda x: jd.alltoall_single(x, group=g), data["i"])
        for r, rk in enumerate(ranks):
            np.testing.assert_array_equal(rk["coll"]["alltoall_single"],
                                          want[r])

    def test_broadcast_scatter_reduce(self, data, ranks):
        import paddle_tpu.distributed as jd
        g = _jgroup()
        bc = _jax_each(lambda x: jd.broadcast(x, src=2, group=g), data["f"])
        rows = [data["f"][i] for i in range(R)]
        # the reference stacks the (traced) list every device passes and
        # keeps its own row
        sc = _jax_each(lambda x: jd.scatter(
            x, tensor_list=[x * 0 + row for row in rows], src=1, group=g),
            data["f"])
        red = _jax_each(lambda x: jd.reduce(x, dst=0, group=g), data["i"])
        for r, rk in enumerate(ranks):
            got, same = rk["coll"]["broadcast"]
            assert same
            np.testing.assert_array_equal(got, bc[r])
            np.testing.assert_array_equal(rk["coll"]["scatter"], sc[r])
            np.testing.assert_array_equal(rk["coll"]["reduce"], red[r])

    def test_send_recv_ring_is_the_ppermute(self, data, ranks):
        import jax
        want = _jax_each(lambda x: jax.lax.ppermute(
            x, "x", [(i, (i + 1) % R) for i in range(R)]), data["f"])
        for r, rk in enumerate(ranks):
            np.testing.assert_array_equal(rk["coll"]["ring"], want[r])

    def test_object_collectives_and_pairs(self, data, ranks):
        want = [{"rank": i, "s": "x" * i} for i in range(R)]
        for r, rk in enumerate(ranks):
            c = rk["coll"]
            assert c["all_gather_object"] == want
            assert c["broadcast_object_list"] == ["from 3", 30]
            lo = 2 * (r // 2)
            np.testing.assert_allclose(c["pair_sum"], data["f"][lo]
                                       + data["f"][lo + 1], rtol=1e-6)
            np.testing.assert_array_equal(c["pair_gather"],
                                          data["i"][lo:lo + 2])
            assert c["pair_rank"] == (r % 2, 2, [lo, lo + 1])
            assert c["staged"] == {"copies": 0, "bytes": 0}   # CPU tensors
            assert rk["rank"] == (r, R)

    def test_pairs_match_two_device_shard_map(self, data, ranks):
        import paddle_tpu.distributed as jd
        g = _jgroup(2)
        for half in (0, 1):
            rows = data["f"][2 * half:2 * half + 2]
            want = _jax_each(lambda x: jd.all_reduce(x, group=g), rows, n=2)
            for i in range(2):
                np.testing.assert_allclose(
                    ranks[2 * half + i]["coll"]["pair_sum"], want[i],
                    rtol=1e-6)

    def test_solo_group_is_the_identity(self):
        g = dist.Group(ranks=[0], axis_name="solo")
        t = torch.tensor([1.0, 2.0])
        assert dist.all_reduce(t, group=g) is t
        out = []
        dist.all_gather(out, t, group=g)
        assert len(out) == 1 and out[0] is t
        assert dist.broadcast(t, group=g) is t
        # a split over no model ranks is the dense layer (a column split
        # over ranks: tests/test_torch_tp_layers.py)
        from paddle_tpu_torch.nn import initializer as I
        from paddle_tpu_torch.nn.layer.base import building
        w = np.arange(8.0, dtype=np.float32).reshape(2, 4)
        with building("cpu"):
            out = dist.split(t[None], (2, 4), "linear", axis=1,
                             weight_attr=I.Assign(w))
        np.testing.assert_allclose(out.detach().numpy(),
                                   t.numpy()[None] @ w, rtol=1e-6)


class TestTopology:
    def test_communicate_topology_matches_the_reference(self):
        from paddle_tpu.distributed import CommunicateTopology as JT
        from paddle_tpu_torch.distributed import CommunicateTopology as TT
        args = (["data", "pipe", "model"], [2, 2, 2])
        j, t = JT(*args), TT(*args)
        assert t.world_size() == j.world_size() == 8
        assert t.get_rank(data=1, pipe=0, model=1) == 5
        for r in range(8):
            assert t.get_coord(r) == j.get_coord(r)
        for axis in args[0]:
            assert t.get_comm_list(axis) == j.get_comm_list(axis)
            assert t.get_axis_list(axis, 1) == j.get_axis_list(axis, 1)

    def test_rank_r_is_mesh_position_r(self, ranks):
        """dp 2 x sharding 2: each rank's coordinates, axis groups and
        getters are those of the reference's device at its flat mesh
        position."""
        from paddle_tpu.distributed import HybridCommunicateGroup as JH
        jmesh = JH(dp_degree=2, sharding_degree=2).mesh
        for r, rk in enumerate(ranks):
            t = rk["topo"]
            assert t["shape"] == dict(jmesh.shape)
            assert t["devices"] == np.vectorize(lambda d: d.id)(
                jmesh.devices).tolist()
            assert tuple(t["coord"].values()) == tuple(
                int(i) for i in np.unravel_index(r, jmesh.devices.shape))
            assert t["dp_rank"] == t["coord"]["data"]
            assert t["sh_rank"] == t["coord"]["sharding"]
            assert t["dp_ranks"] == [r % 2, r % 2 + 2]
            assert t["sh_ranks"] == [2 * (r // 2), 2 * (r // 2) + 1]
            assert t["sums"] == {"data": float(sum(t["dp_ranks"])),
                                 "sharding": float(sum(t["sh_ranks"]))}
            assert t["mode"] == "ShardingParallel" and t["nranks"] == 4
            assert t["worker"] == (r, 4)

    @pytest.mark.parametrize("degree,item", [("mp_degree", "A7b"),
                                             ("sep_degree", "A7b"),
                                             ("pp_degree", "A7c")])
    def test_model_pipe_sep_degrees_raise(self, degree, item):
        """Model and sep degrees run GPT (tests/test_torch_gpt_tp.py), and
        model degrees BERT (tests/test_torch_bert_tp.py); a pipe degree
        runs GPT's pipeline (A7c, tests/test_torch_gpt_pp.py).  The hybrid
        group takes each of them (here it only asks for a world of two),
        and what still waits raises: GPT's and BERT's ZeRO and GPT's
        update sharding over model or sep ranks (A7b), GPT's ZeRO and
        update sharding over pipe ranks (the pipeline step keeps its own
        state layout, as the reference's)."""
        from paddle_tpu_torch.distributed import HybridCommunicateGroup
        from paddle_tpu_torch.models import bert as TB
        from paddle_tpu_torch.models.gpt import (GPTConfig, GPTModel,
                                                 make_gpt_train_step)
        import paddle_tpu_torch.optimizer as TO
        with pytest.raises(ValueError, match="torch.distributed world"):
            HybridCommunicateGroup(**{degree: 2})
        match = "pp_degree>1" if item == "A7c" else item
        getter = {"mp_degree": "get_model_parallel_world_size",
                  "sep_degree": "get_sep_parallel_world_size",
                  "pp_degree": "get_pipe_parallel_world_size"}[degree]
        hcg = type("Hcg", (), {getter: lambda self: 2})()
        m = GPTModel(GPTConfig(vocab_size=64, hidden_size=32, num_layers=1,
                               num_attention_heads=2,
                               max_position_embeddings=16,
                               compute_dtype="float32"), device="cpu")
        for kw in (dict(zero_stage=1), dict(update_sharding=True)):
            with pytest.raises(NotImplementedError, match=match):
                make_gpt_train_step(m, TO.SGD(0.1), hcg, **kw)
        if item == "A7c":
            return      # BERT holds a pipe axis replicated, as the reference
        bert = TB.BertModel(TB.BertConfig(
            vocab_size=64, hidden_size=32, num_hidden_layers=1,
            num_attention_heads=2, max_position_embeddings=16,
            compute_dtype="float32"), device="cpu")
        with pytest.raises(NotImplementedError, match=item):
            TB.make_bert_train_step(bert, TO.SGD(0.1), hcg, zero_stage=1)

    def test_hybrid_group_needs_the_world_of_its_degrees(self):
        from paddle_tpu_torch.distributed import HybridCommunicateGroup
        with pytest.raises(ValueError, match="torch.distributed world"):
            HybridCommunicateGroup(dp_degree=2)


class TestGuards:
    def test_port_imports_nothing_of_jax(self):
        pat = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu\b)")
        hits = [f"{p}:{i}" for p in list((REPO / "paddle_tpu_torch").rglob(
            "*.py")) + [REPO / "chip_smoke.py"]
            for i, line in enumerate(p.read_text().splitlines(), 1)
            if pat.match(line)]
        assert hits == []

    def test_distributed_imports_without_jax(self):
        code = ("import sys, paddle_tpu_torch.distributed as d; "
                "from paddle_tpu_torch.distributed import fleet, zero, "
                "update_sharding, grad_comm, sharding_rules; "
                "assert 'jax' not in sys.modules, 'jax imported'; "
                "print(d.get_world_size(), d.get_rank())")
        out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                             capture_output=True, text=True, timeout=120,
                             env={k: v for k, v in os.environ.items()
                                  if k != "PYTHONPATH"})
        assert out.returncode == 0, out.stderr
        assert out.stdout.split() == ["1", "0"]

    def test_init_parallel_env_without_a_card_raises(self):
        """The default backend is NCCL on the card; with none it raises
        and starts no process group (no fallback to gloo or the CPU)."""
        import torch.distributed as tdist
        assert not torch.cuda.is_available()
        with pytest.raises(RuntimeError, match="CUDA device"):
            dist.init_parallel_env()
        with pytest.raises(RuntimeError, match="CUDA device"):
            dist.init_parallel_env(backend="nccl")
        assert not tdist.is_initialized()
        assert dist.get_world_size() == 1 and dist.get_rank() == 0
        with pytest.raises(ValueError, match="backend"):
            dist.init_parallel_env(backend="mpi")

    def test_parallel_env_reads_the_launchers(self, monkeypatch):
        monkeypatch.setenv("LOCAL_RANK", "3")
        assert dist.ParallelEnv().device_id == 3
        monkeypatch.delenv("LOCAL_RANK")
        monkeypatch.setenv("FLAGS_selected_gpus", "5,6")
        assert dist.ParallelEnv().device_id == 5

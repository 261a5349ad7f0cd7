"""Port parity for sequence-parallel attention
(``paddle_tpu_torch/ops/ring_attention.py``) against the JAX package's
``paddle_tpu/ops/ring_attention.py``.

Ring and Ulysses attention, causal and not, run on 2 and on 4 gloo ranks
(one spawn a world size, the sequence split over a group of all of them)
and are held against the reference's ``ring_attention`` and
``ulysses_attention`` under ``shard_map`` over a ("sep",) mesh of as
many CPU devices: each rank's output block and its blocks of dQ, dK and
dV (the gradient of sum(out * cot), the cotangent random and split as
the output) within 1e-5.  The gathered arm (the port's attention over
sep ranks without a ``sequence_parallel`` mode) is held against the
reference's dense attention over the whole sequence.  fp32, B 2, L 32,
H 4, D 8.  The spawned ranks import this module, so it imports no JAX at
its top.
"""

import datetime
import os
import pickle
import sys

import numpy as np
import pytest
import torch

B, L, H, D = 2, 32, 4, 8
TOL = dict(rtol=1e-5, atol=1e-5)
MODES = ("ring", "ulysses", "gathered")


def _data():
    r = np.random.RandomState(3)
    return [r.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]                      # q, k, v, cot


def _blk(a, r, n, dim=1):
    s = a.shape[dim] // n
    return np.take(a, range(r * s, (r + 1) * s), axis=dim)


def _rank_main(rank, world, tmp, data):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.distributed import env
    from paddle_tpu_torch.ops import ring_attention as RA
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    group = C.Group(ranks=list(range(world)), axis_name="sep")
    out = {}
    for mode in MODES:
        for causal in (False, True):
            q, k, v, cot = (torch.tensor(_blk(a, rank, world)) for a in data)
            q, k, v = (t.requires_grad_(True) for t in (q, k, v))
            if mode == "gathered":
                y = RA.gathered_attention(q, k, v, causal=causal,
                                          group=group)
            else:
                y = RA.sequence_parallel_attention(
                    q, k, v, causal=causal, mode=mode, group=group)
            (y * cot).sum().backward()
            out[mode, causal] = [t.detach().numpy().copy() for t in
                                 (y, q.grad, k.grad, v.grad)]
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    C.destroy_process_group()


def _start(world, tmp, data):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), data),
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


def _jax_ref(sep, data):
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map
    from paddle_tpu.ops.attention import dense_attention
    from paddle_tpu.ops.ring_attention import (ring_attention,
                                               ulysses_attention)

    mesh = Mesh(np.array(jax.devices()[:sep]), ("sep",))
    q, k, v, cot = (jnp.asarray(a) for a in data)
    out = {}
    for mode in MODES:
        for causal in (False, True):
            if mode == "gathered":
                def f(a, b, c, causal=causal):
                    return dense_attention(a, b, c, causal=causal)
            else:
                fn = ring_attention if mode == "ring" else ulysses_attention
                f = shard_map(
                    lambda a, b, c, fn=fn, causal=causal: fn(
                        a, b, c, "sep", causal=causal),
                    mesh=mesh, in_specs=(P(None, "sep"),) * 3,
                    out_specs=P(None, "sep"))
            y = jax.jit(f)(q, k, v)
            grads = jax.jit(jax.grad(
                lambda a, b, c, f=f: jnp.sum(f(a, b, c) * cot),
                argnums=(0, 1, 2)))(q, k, v)
            out[mode, causal] = [np.asarray(t) for t in (y, *grads)]
    return out


@pytest.fixture(scope="module")
def data():
    return _data()


@pytest.fixture(scope="module")
def started(data, tmp_path_factory):
    return {n: _start(n, tmp_path_factory.mktemp(f"sep{n}"), data)
            for n in (2, 4)}


@pytest.fixture(scope="module")
def refs(started, data):
    return {n: _jax_ref(n, data) for n in (2, 4)}


@pytest.fixture(scope="module")
def ranks(started):
    return {n: _finish(s) for n, s in started.items()}


@pytest.mark.parametrize("sep", [2, 4])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("mode", MODES)
def test_forward_and_grads_match_the_reference(ranks, refs, sep, causal,
                                               mode):
    want = refs[sep][mode, causal]
    for r, rk in enumerate(ranks[sep]):
        for name, got, w in zip(("out", "dq", "dk", "dv"), rk[mode, causal],
                                want):
            np.testing.assert_allclose(got, _blk(w, r, sep), **TOL,
                                       err_msg=f"{name} rank {r}")


def test_one_rank_is_plain_attention_and_checks_heads():
    from paddle_tpu_torch.distributed import collective as C
    from paddle_tpu_torch.ops import attention as A
    from paddle_tpu_torch.ops import ring_attention as RA
    q, k, v, _ = (torch.tensor(a) for a in _data())
    solo = C.Group(ranks=[0], axis_name="sep")
    want = A.dense_attention(q, k, v, causal=True)
    for mode in ("ring", "ulysses"):
        got = RA.sequence_parallel_attention(q, k, v, causal=True, mode=mode,
                                             group=solo)
        torch.testing.assert_close(got, want, **TOL)
    # a learned scale rides in q
    s = torch.tensor(0.5, requires_grad=True)
    got = RA.ring_attention(q, k, v, causal=True, scale=s, group=solo)
    torch.testing.assert_close(got, A.dense_attention(q, k, v, causal=True,
                                                      scale=0.5), **TOL)
    got.sum().backward()
    assert s.grad is not None and torch.isfinite(s.grad)
    with pytest.raises(ValueError, match="unknown sequence-parallel mode"):
        RA.sequence_parallel_attention(q, k, v, mode="bogus", group=solo)
    three = C.Group(ranks=[0, 1, 2], axis_name="sep")
    with pytest.raises(ValueError, match="divisible"):
        RA.ulysses_attention(q, k, v, group=three)

"""Port parity for the MoE ops (paddle_tpu_torch/ops/moe.py) against
``paddle_tpu/ops/moe.py`` on the same numpy inputs: the cases of
``tests/test_moe.py``'s routing and dispatch tests, as parity checks.

Tolerances: gating's integers (experts, slots, dispatch masks) equal;
its floats and the fp32 FFN outputs within 1e-5 (1e-6 for the gates),
gradients within 1e-5 of their largest magnitude; bf16 within 3e-2 (the
reference's own bf16 tier for these paths, ``tests/test_moe.py``).  The
port's ``moe_ffn_gather`` runs every expert over every row and keeps the
top k, where the reference gathers k weight slices a token: equal up to
the matmuls' summation order, held to the same bounds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.ops import moe as _J
from paddle_tpu_torch.ops import moe as T


class J:
    """The reference's functions, each jitted once (eager JAX dispatches
    op by op and costs seconds a call on the CPU)."""


for _name, _static in (("topk_gating", ("k", "capacity")),
                       ("topk_gating_indices", ("k", "capacity",
                                                "capacity_factor")),
                       ("moe_ffn", ("k", "capacity_factor")),
                       ("moe_ffn_indices", ("k", "capacity_factor")),
                       ("moe_ffn_gather", ("k",))):
    setattr(J, _name, staticmethod(jax.jit(getattr(_J, _name),
                                           static_argnames=_static)))


def _close(got, want, rtol=1e-5, atol=1e-6, msg=""):
    np.testing.assert_allclose(np.asarray(got.detach().float()),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=msg)


def _ffn_inputs(T_=64, H=16, E=4, I=32, seed=0, bias=0.0):
    r = np.random.RandomState(seed)
    x = r.standard_normal((T_, H)).astype(np.float32)
    gw = (r.standard_normal((H, E)) * 0.5).astype(np.float32)
    w1 = (r.standard_normal((E, H, I)) * 0.1).astype(np.float32)
    b1 = (r.standard_normal((E, I)) * bias).astype(np.float32)
    w2 = (r.standard_normal((E, I, H)) * 0.1).astype(np.float32)
    b2 = (r.standard_normal((E, H)) * bias).astype(np.float32)
    return x, gw, w1, b1, w2, b2


def _both(arrs, dtype=None):
    j = [jnp.asarray(a) for a in arrs]
    t = [torch.tensor(a) for a in arrs]
    if dtype is not None:       # x in the compute dtype, weights fp32
        j[0], t[0] = j[0].astype(jnp.bfloat16), t[0].to(torch.bfloat16)
    return j, t


# --------------------------------------------------------------- gating --

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("capacity", [None, 4, 64])
def test_topk_gating_matches_reference(k, capacity):
    """capacity 4 drops most tokens, 64 none, None the default factor."""
    logits = np.random.RandomState(k).standard_normal((64, 8)).astype(
        np.float32)
    jc, jd, ja = J.topk_gating(jnp.asarray(logits), k=k, capacity=capacity)
    tc, td, ta = T.topk_gating(torch.tensor(logits), k=k, capacity=capacity)
    assert td.dtype == torch.bool and tuple(td.shape) == jd.shape
    np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
    _close(tc, jc, rtol=1e-6, atol=1e-7)
    _close(ta, ja, rtol=1e-6, atol=1e-7)
    d = td.numpy()
    assert d.sum(axis=(1, 2)).max() <= k and d.sum(axis=0).max() <= 1
    if capacity == 4:
        assert d.sum() < 64 * k           # overflow drops happened


@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("cf", [1.25, 0.3])
def test_topk_gating_indices_matches_reference(k, cf):
    logits = np.random.RandomState(5 + k).standard_normal((48, 4)).astype(
        np.float32)
    jo = J.topk_gating_indices(jnp.asarray(logits), k=k, capacity_factor=cf)
    to = T.topk_gating_indices(torch.tensor(logits), k=k, capacity_factor=cf)
    assert to[4] == jo[4]
    for i in (0, 1):
        assert to[i].dtype == torch.int32
        np.testing.assert_array_equal(to[i].numpy(), np.asarray(jo[i]))
    _close(to[2], jo[2], rtol=1e-6, atol=1e-7)
    _close(to[3], jo[3], rtol=1e-6, atol=1e-7)
    if cf == 0.3:
        assert (to[1].numpy() == to[4]).any()          # some dropped


def test_argmax_ties_take_the_first_expert():
    """Equal logits route to the lowest expert index, as JAX's argmax."""
    logits = np.zeros((12, 4), np.float32)
    logits[:, 2] = logits[:, 3] = 1.0
    logits[6:, 1] = 1.0
    jo = J.topk_gating_indices(jnp.asarray(logits), k=2, capacity=12)
    to = T.topk_gating_indices(torch.tensor(logits), k=2, capacity=12)
    np.testing.assert_array_equal(to[0].numpy(), np.asarray(jo[0]))
    assert to[0][0].tolist() == [2, 3] and to[0][6].tolist() == [1, 2]


def test_jitter_key_is_a_generator():
    """The jitter key is key data, as the reference's: the same key draws
    the same noise, another key other noise, and the routing equals the
    reference's on that key."""
    from paddle_tpu_torch.core import rng
    logits = torch.tensor(np.random.RandomState(1).standard_normal((16, 4))
                          .astype(np.float32))
    outs = [T.topk_gating_indices(logits, k=2, jitter_key=rng.make_key(s))[2]
            for s in (3, 3, 4)]
    assert torch.equal(outs[0], outs[1]) and not torch.equal(outs[0],
                                                             outs[2])
    jo = J.topk_gating_indices(jnp.asarray(logits.numpy()), k=2,
                               jitter_key=jax.random.key(3))
    np.testing.assert_allclose(outs[0].numpy(), np.asarray(jo[2]),
                               rtol=1e-6, atol=1e-7)


# ------------------------------------------------------------------ FFNs --

@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("path", ["moe_ffn", "moe_ffn_indices"])
def test_ffn_forward_matches_reference(path, k):
    j, t = _both(_ffn_inputs(bias=0.1))
    jo, ja = getattr(J, path)(*j, k=k, capacity_factor=1.25)
    to, ta = getattr(T, path)(*t, k=k, capacity_factor=1.25)
    _close(to, jo)
    _close(ta, ja, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("path", ["moe_ffn", "moe_ffn_indices"])
def test_ffn_overflow_drops_match(path):
    j, t = _both(_ffn_inputs(seed=2))
    jo, _ = getattr(J, path)(*j, k=2, capacity_factor=0.3)
    to, _ = getattr(T, path)(*t, k=2, capacity_factor=0.3)
    _close(to, jo)


@pytest.mark.parametrize("path", ["moe_ffn", "moe_ffn_indices"])
def test_ffn_gradients_match_reference(path):
    """d(sum(out^2) + aux) with respect to x, the gate and every expert
    weight: the gate's gradient comes through the gates and the aux
    loss's mean probabilities, not through the routed fractions."""
    arrs = _ffn_inputs(T_=32, H=8, E=4, I=16, seed=1, bias=0.1)

    def jloss(*a):
        out, aux = getattr(J, path)(*a, k=2, capacity_factor=1.0)
        return jnp.sum(out ** 2) + aux

    jg = jax.jit(jax.grad(jloss, argnums=tuple(range(6))))(
        *[jnp.asarray(a) for a in arrs])
    tt = [torch.tensor(a, requires_grad=True) for a in arrs]
    out, aux = getattr(T, path)(*tt, k=2, capacity_factor=1.0)
    tg = torch.autograd.grad((out ** 2).sum() + aux, tt)
    for i, (a, b) in enumerate(zip(tg, jg)):
        scale = float(np.abs(np.asarray(b)).max())
        _close(a, b, rtol=0, atol=1e-5 * scale, msg=f"grad {i}")


def test_ffn_bf16_matches_reference():
    j, t = _both(_ffn_inputs(seed=3, bias=0.1), dtype="bf16")
    for path in ("moe_ffn", "moe_ffn_indices"):
        jo, _ = getattr(J, path)(*j, k=2)
        to, _ = getattr(T, path)(*t, k=2)
        assert to.dtype == torch.bfloat16
        _close(to, jo, rtol=3e-2, atol=3e-2, msg=path)


@pytest.mark.parametrize("k", [1, 2])
def test_gather_matches_reference_and_indices_at_nodrop(k):
    arrs = _ffn_inputs(T_=10, seed=0, bias=0.1)
    j, t = _both(arrs)
    E = arrs[1].shape[1]
    got = T.moe_ffn_gather(*t, k=k)
    _close(got, J.moe_ffn_gather(*j, k=k), rtol=2e-5, atol=2e-6)
    want, _ = T.moe_ffn_indices(*t, k=k, capacity_factor=float(E) / k)
    _close(got, want.numpy(), rtol=2e-5, atol=2e-6)


def test_gather_bf16_matches_reference_and_indices():
    arrs = _ffn_inputs(T_=8, seed=1, bias=0.1)
    j, t = _both(arrs, dtype="bf16")
    got = T.moe_ffn_gather(*t, k=2)
    assert got.dtype == torch.bfloat16
    _close(got, J.moe_ffn_gather(*j, k=2), rtol=3e-2, atol=3e-2)
    want, _ = T.moe_ffn_indices(*t, k=2, capacity_factor=2.0)
    _close(got, want.float().numpy(), rtol=3e-2, atol=3e-2)


def test_gather_on_tied_probabilities():
    """Rows whose gate scores tie across experts: the top k are taken by
    lower expert index, as ``jax.lax.top_k`` and the no-drop index path
    take them."""
    x, gw, w1, b1, w2, b2 = _ffn_inputs(T_=12, E=4, seed=4, bias=0.1)
    gw[:, 3] = gw[:, 1]                      # experts 1 and 3 tie
    gw[:, 2] = gw[:, 0]                      # experts 0 and 2 tie
    j, t = _both((x, gw, w1, b1, w2, b2))
    got = T.moe_ffn_gather(*t, k=2)
    _close(got, J.moe_ffn_gather(*j, k=2), rtol=2e-5, atol=2e-6)
    want, _ = T.moe_ffn_indices(*t, k=2, capacity_factor=2.0)
    _close(got, want.numpy(), rtol=2e-5, atol=2e-6)


def test_expert_mesh_axis_raises():
    """Expert parallelism over the data axis runs
    (tests/test_torch_moe_ep.py); what waits for ROADMAP A7b raises: an
    expert axis the tokens are not split over, a sharding degree beside
    a split expert axis, a sep degree."""
    def mesh(**shape):
        return type("Mesh", (), {"shape": shape, "size": 4})()

    _, t = _both(_ffn_inputs(T_=8))
    for fn in (T.moe_ffn, T.moe_ffn_indices):
        for m, axis in ((mesh(model=2), "model"),
                        (mesh(data=2, sharding=2), "data"),
                        (mesh(data=2, sep=2), "data")):
            with pytest.raises(NotImplementedError, match="A7b"):
                fn(*t, mesh=m, expert_axis=axis)
    out, _ = T.moe_ffn_indices(*t, mesh=type("One", (), {"shape":
                                                         {"data": 1}})())
    assert out.shape == (8, 16)

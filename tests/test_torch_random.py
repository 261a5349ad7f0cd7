"""``core.rng``'s laws against ``jax.random`` on the same key, and
``paddle_tpu_torch.tensor.random`` (with ``rrelu``, ``gumbel_softmax``,
``class_center_sample`` and the MoE gate's jitter) against
``paddle_tpu``'s after the same ``seed()``.

Stated tolerances:
- bit-equal: bits (8, 16, 32, 64), uniform (f32, f64, bf16, fp16),
  bernoulli, randint, permutation/randperm, rrelu's slopes, the jitter,
  class_center_sample;
- within 4 ulp (fp32): normal, truncated_normal, exponential; gumbel
  within 4 ulp of max(1, |x|) (``-log(-log(u))`` loses every relative
  digit where the inner log is near 1, in the reference too);
- categorical, multinomial, poisson, binomial and hard gumbel_softmax
  indices: equal element for element on these seeds (the stated bound is
  one flip, traced to a last-ulp difference, in 10**4 draws).
float64 laws run against jax with x64 on; normal's float64 polynomial is
held within 1e-13 relative (``torch.log1p`` in float64 is not XLA's).
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.ops import moe as JM
from paddle_tpu_torch import nn
from paddle_tpu_torch import tensor as P
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import moe as TM

N = 1 << 14
KEY = jax.random.key(17)
KD = np.asarray(jax.random.key_data(KEY))


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _ulps(got, want):
    """|got - want| in units of the last place of fp32 (same signs)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    return np.abs(got.view(np.int32).astype(np.int64)
                  - want.view(np.int32).astype(np.int64))


def _eq(got, want):
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.fixture
def x64():
    jax.config.update("jax_enable_x64", True)
    yield
    jax.config.update("jax_enable_x64", False)


# ------------------------------------------------------------- the laws

@pytest.mark.parametrize("bits", [8, 16, 32, 64])
def test_bits(bits, x64):
    want = np.asarray(jax.random.bits(KEY, (N,), jnp.dtype(f"uint{bits}")))
    got = rng.random_bits(KD, bits, (N,), "cpu").numpy()
    _eq(got.astype(np.uint64) if bits == 64 else got, want)


UNIFORM = [(jnp.float32, torch.float32), (jnp.bfloat16, torch.bfloat16),
           (jnp.float16, torch.float16)]


@pytest.mark.parametrize("bounds", [(0.0, 1.0), (-1e-2, 1e-2), (-0.3, 2.7)])
@pytest.mark.parametrize("dt", UNIFORM, ids=lambda d: str(d[1]))
def test_uniform_and_bernoulli(dt, bounds):
    want = jax.random.uniform(KEY, (N,), dt[0], *bounds)
    got = rng.uniform(KD, (N,), dt[1], *bounds, device="cpu")
    _eq(got.float().numpy(), np.asarray(want.astype(jnp.float32)))
    if bounds == (0.0, 1.0):
        _eq(rng.bernoulli(KD, 0.3, (N,), dt[1], "cpu").numpy(),
            jax.random.bernoulli(KEY, jnp.asarray(0.3, dt[0]), (N,)))


def test_float64_uniform_and_normal(x64):
    _eq(rng.uniform(KD, (N,), torch.float64, -0.3, 2.7, "cpu").numpy(),
        jax.random.uniform(KEY, (N,), jnp.float64, -0.3, 2.7))
    want = np.asarray(jax.random.normal(KEY, (N,), jnp.float64))
    got = rng.normal(KD, (N,), torch.float64, "cpu").numpy()
    np.testing.assert_allclose(got, want, rtol=1e-13, atol=1e-15)


def test_normal_truncated_exponential_gumbel_ulps():
    cases = {
        "normal": (jax.random.normal(KEY, (N,)),
                   rng.normal(KD, (N,), device="cpu")),
        "truncated": (jax.random.truncated_normal(KEY, -2.0, 2.0, (N,)),
                      rng.truncated_normal(KD, -2.0, 2.0, (N,),
                                           device="cpu")),
        "truncated_asym": (jax.random.truncated_normal(KEY, -0.5, 3.0, (N,)),
                           rng.truncated_normal(KD, -0.5, 3.0, (N,),
                                                device="cpu")),
        "exponential": (jax.random.exponential(KEY, (N,)),
                        rng.exponential(KD, (N,), device="cpu")),
    }
    for name, (want, got) in cases.items():
        assert _ulps(got.numpy(), want).max() <= 4, name
    t = rng.truncated_normal(KD, -0.5, 3.0, (N,), device="cpu")
    assert t.min() > -0.5 and t.max() < 3.0
    want = np.asarray(jax.random.gumbel(KEY, (N,)))
    got = rng.gumbel(KD, (N,), device="cpu").numpy()
    ulp = np.spacing(np.maximum(1.0, np.abs(want)).astype(np.float32))
    assert (np.abs(got - want) / ulp).max() <= 4


def test_erf_inv_edges():
    x = torch.tensor([-1.0, 1.0, 0.0, 0.5, -0.999999])
    want = np.asarray(jax.scipy.special.erfinv(jnp.asarray(x.numpy())))
    got = rng.erf_inv(x).numpy()
    assert np.isinf(got[:2]).all() and (np.sign(got[:2]) == [-1, 1]).all()
    assert _ulps(got[2:], want[2:]).max() <= 2


@pytest.mark.parametrize("bounds", [(0, 10), (-5, 1000003), (3, 3),
                                    (-2 ** 31, 2 ** 31 - 1), (7, 2)])
def test_randint(bounds):
    _eq(rng.randint(KD, (N,), *bounds, device="cpu").numpy(),
        jax.random.randint(KEY, (N,), *bounds, jnp.int32))


def test_randint_narrow_dtypes():
    _eq(rng.randint(KD, (N,), -3, 300, torch.int8, "cpu").numpy(),
        jax.random.randint(KEY, (N,), -3, 300, jnp.int8))
    _eq(rng.randint(KD, (N,), 0, 256, torch.uint8, "cpu").numpy(),
        jax.random.randint(KEY, (N,), 0, 256, jnp.uint8))
    with pytest.raises(ValueError, match="32 bits"):
        rng.randint(KD, (4,), 0, 9, torch.int64, "cpu")


@pytest.mark.parametrize("n", [1, 7, 1000, 5000])
def test_permutation(n):
    _eq(rng.permutation(KD, n, device="cpu").numpy(),
        jax.random.permutation(KEY, n))


def test_permutation_of_arrays():
    x = np.arange(24.0).reshape(4, 6)
    for axis, ind in ((0, False), (1, False), (1, True)):
        _eq(rng.permutation(KD, torch.from_numpy(x), axis, ind).numpy(),
            jax.random.permutation(KEY, jnp.asarray(x), axis, ind))


def test_categorical():
    logits = np.random.RandomState(0).randn(64, 100).astype(np.float32)
    t = torch.from_numpy(logits)
    _eq(rng.categorical(KD, t).numpy(),
        jax.random.categorical(KEY, logits))
    _eq(rng.categorical(KD, t, axis=0).numpy(),
        jax.random.categorical(KEY, logits, axis=0))
    for replace in (True, False):
        _eq(rng.categorical(KD, t, shape=(5, 64), replace=replace).numpy(),
            jax.random.categorical(KEY, logits, shape=(5, 64),
                                   replace=replace))
    with pytest.raises(ValueError, match="Incompatible shapes"):
        rng.categorical(KD, t, shape=(64, 3))


def test_poisson_and_binomial_draws():
    r = np.random.RandomState(1)
    lam = r.uniform(0, 30, (N,)).astype(np.float32)
    lam[:16] = 0.0
    _eq(rng.poisson(KD, torch.from_numpy(lam)).numpy(),
        jax.random.poisson(KEY, lam))
    count = r.randint(0, 200, (N,)).astype(np.float32)
    prob = r.uniform(0, 1, (N,)).astype(np.float32)
    count[:4] = [-1, np.inf, 5, 5]
    prob[2:4] = [np.nan, -0.5]
    got = rng.binomial(KD, torch.from_numpy(count),
                       torch.from_numpy(prob)).numpy()
    want = np.asarray(jax.random.binomial(KEY, count, prob))
    _eq(np.isnan(got), np.isnan(want))
    _eq(np.nan_to_num(got), np.nan_to_num(want))


def test_offset_draws_a_block_of_the_global_draw():
    full = rng.uniform(KD, (8, 5), device="cpu")
    part = rng.uniform(KD, (3, 5), device="cpu", offset=4 * 5)
    _eq(part.numpy(), full[4:7].numpy())


# ------------------------------------------------- tensor/random.py names

NAMES = ["uniform", "uniform_", "rand", "randn", "standard_normal", "normal",
         "normal_", "gaussian", "randint", "randint_like", "randperm",
         "multinomial", "bernoulli", "bernoulli_", "poisson", "binomial",
         "exponential_", "check_shape"]


def test_every_name_at_both_levels():
    import paddle_tpu_torch as pt
    for n in NAMES:
        assert getattr(P, n) is getattr(pt, n) is getattr(P.random, n), n
        assert hasattr(paddle, n), n


def _both(call_j, call_t, seed=9):
    """The reference's call and the port's, each after ``seed(seed)``."""
    import paddle_tpu_torch as pt
    paddle.seed(seed)
    want = call_j()
    pt.seed(seed)
    with nn.building("cpu"):
        got = call_t()
    return (np.asarray(got.detach().float().numpy()),
            np.asarray(want.astype("float32").numpy()))


EXACT = {
    "uniform": lambda m: m.uniform([40, 30], min=-2.0, max=3.0),
    "uniform_seed": lambda m: m.uniform([40, 30], seed=123),
    "uniform_bf16": lambda m: m.uniform([40, 30], "bfloat16"),
    "rand": lambda m: m.rand([40, 30]),
    "randint": lambda m: m.randint(-4, 9, [500]),
    "randint_high": lambda m: m.randint(11, shape=[500]),
    "randint_like": lambda m: m.randint_like(m.zeros([3, 4], "int32"), 2,
                                             8),
    "randperm": lambda m: m.randperm(3000),
    "bernoulli": lambda m: m.bernoulli(m.full([50, 40], 0.3)),
    "multinomial": lambda m: m.multinomial(m.to_tensor(
        [[0.1, 0.2, 0.7], [0.5, 0.0, 0.5]]), 2),
    "multinomial_replace": lambda m: m.multinomial(m.to_tensor(
        [0.1, 0.2, 0.3, 0.4]), 500, replacement=True),
    "multinomial_replace_2d_square": lambda m: m.multinomial(m.to_tensor(
        [[0.1, 0.9], [0.8, 0.2]]), 2, replacement=True),
    "poisson": lambda m: m.poisson(m.full([600], 4.5)),
    "poisson_large": lambda m: m.poisson(m.full([600], 40.0)),
    "binomial": lambda m: m.binomial(m.full([600], 30, "int32"),
                                     m.full([600], 0.4)),
}

ULPS = {
    "randn": lambda m: m.randn([40, 30]),
    "standard_normal": lambda m: m.standard_normal([40, 30]),
    "normal": lambda m: m.normal(1.5, 2.0, [40, 30]),
    "normal_no_shape": lambda m: m.normal(m.full([6], 1.0), 3.0),
    "gaussian": lambda m: m.gaussian([40, 30], mean=-1.0, std=0.5, seed=7),
}


def _ulps_at_scale(got, want):
    """|got - want| in fp32 ulps of max(1, |want|): ``mean + std * z``
    cancels near 0, where its own ulp is no measure of the draw."""
    ulp = np.spacing(np.maximum(1.0, np.abs(want)).astype(np.float32))
    return np.abs(np.asarray(got, np.float64) - want) / ulp


@pytest.mark.parametrize("name", sorted(EXACT))
def test_exact_draws(name):
    import paddle_tpu_torch as pt
    got, want = _both(lambda: EXACT[name](paddle), lambda: EXACT[name](pt))
    _eq(got, want)


@pytest.mark.parametrize("name", sorted(ULPS))
def test_normal_draws(name):
    import paddle_tpu_torch as pt
    got, want = _both(lambda: ULPS[name](paddle), lambda: ULPS[name](pt))
    assert got.shape == want.shape
    assert _ulps_at_scale(got, want).max() <= 4


def test_in_place_draws_write_their_tensor():
    r = {}
    for name, call in {
            "uniform_": lambda m, x: m.uniform_(x, -1.0, 2.0),
            "normal_": lambda m, x: m.normal_(x, 1.0, 2.0),
            "bernoulli_": lambda m, x: m.bernoulli_(x, 0.25),
            "exponential_": lambda m, x: m.exponential_(x, 3.0)}.items():
        def tcall():
            x = torch.zeros(30, 20)
            assert call(P, x) is x
            return x
        got, want = _both(lambda: call(paddle, paddle.zeros([30, 20])),
                          tcall)
        r[name] = _ulps_at_scale(got, want).max()
    assert r["uniform_"] == r["bernoulli_"] == 0, r
    assert max(r.values()) <= 4, r


def test_multinomial_refuses_as_the_reference():
    """With replacement, the reference asks ``categorical`` for shape
    (*batch, num_samples): a 2-D input with num_samples != B raises."""
    probs = [[0.2, 0.3, 0.5], [0.6, 0.2, 0.2]]
    with pytest.raises(ValueError, match="Incompatible shapes"):
        paddle.multinomial(paddle.to_tensor(probs), 4, replacement=True)
    with pytest.raises(ValueError, match="Incompatible shapes"):
        P.multinomial(torch.tensor(probs), 4, replacement=True)


def test_draws_land_on_the_build_scope_and_check_shape():
    with nn.building("cpu"):
        assert P.rand([2]).device.type == "cpu"
        assert P.randint(5, shape=[3]).dtype == torch.int64
    assert P.rand([2], device="cpu").shape == (2,)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.randn([2])
    assert P.check_shape([2, 3]) == [2, 3]
    with pytest.raises(TypeError):
        P.check_shape([2, "x"])


# ------------------------------------------- functionals that draw a key

X = np.random.RandomState(3).randn(6, 9).astype(np.float32)


def test_rrelu_training_slopes_bit_equal():
    got, want = _both(
        lambda: JF.rrelu(paddle.to_tensor(X), 0.1, 0.4, training=True),
        lambda: F.rrelu(torch.from_numpy(X), 0.1, 0.4, training=True))
    _eq(got, want)
    got, want = _both(
        lambda: JF.rrelu(paddle.to_tensor(X)),
        lambda: F.rrelu(torch.from_numpy(X)))
    _eq(got, want)


@pytest.mark.parametrize("hard", [False, True])
def test_gumbel_softmax(hard):
    jx = paddle.to_tensor(X, stop_gradient=False)
    tx = torch.from_numpy(X.copy()).requires_grad_()
    got, want = _both(lambda: JF.gumbel_softmax(jx, 0.7, hard, axis=1),
                      lambda: F.gumbel_softmax(tx, 0.7, hard, axis=1))
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    _eq(got.argmax(1), want.argmax(1))
    g = np.random.RandomState(4).randn(6, 9).astype(np.float32)
    paddle.seed(9)
    (JF.gumbel_softmax(jx, 0.7, hard, axis=1) * paddle.to_tensor(g)
     ).sum().backward()
    rng.seed(9)
    (F.gumbel_softmax(tx, 0.7, hard, axis=1) * torch.from_numpy(g)
     ).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), jx.grad.numpy(), rtol=0,
                               atol=1e-5)


def test_class_center_sample():
    label = np.array([3, 17, 3, 40, 8, 17], np.int64)
    paddle.seed(9)
    jremap, jcenters = JF.class_center_sample(
        paddle.to_tensor(label.astype(np.int32)), 50, 12)
    rng.seed(9)
    remap, centers = F.class_center_sample(torch.from_numpy(label), 50, 12)
    _eq(centers.numpy(), jcenters.numpy())
    _eq(remap.numpy(), jremap.numpy())
    assert (centers[remap] == torch.from_numpy(label)).all()
    with pytest.raises(ValueError, match="cannot exceed"):
        F.class_center_sample(torch.from_numpy(label), 5, 12)


# ------------------------------------------------------------ gate jitter

def test_gate_jitter_on_one_device():
    logits = np.random.RandomState(5).randn(32, 4).astype(np.float32)
    for jdt, tdt in ((jnp.float32, torch.float32),
                     (jnp.bfloat16, torch.bfloat16)):
        want = JM.topk_gating_indices(jnp.asarray(logits, jdt), k=2,
                                      jitter_key=KEY)
        got = TM.topk_gating_indices(torch.from_numpy(logits).to(tdt), k=2,
                                     jitter_key=KD)
        for a, b in zip(got, want):
            if isinstance(a, torch.Tensor):
                np.testing.assert_allclose(a.float().numpy(), np.asarray(
                    b, np.float32), rtol=1e-6, atol=1e-7)
        noise = TM.jitter_noise(KD, torch.from_numpy(logits).to(tdt))
        _eq(noise.float().numpy(), np.asarray(jax.random.uniform(
            KEY, (32, 4), jdt, -1e-2, 1e-2).astype(jnp.float32)))


def test_gate_jitter_at_dp2_is_the_global_draw():
    """A rank's jitter is its rows of the reference's draw over the global
    (T * R, E) logits; ``_check_mesh`` no longer refuses jitter."""
    import types
    want = np.asarray(jax.random.uniform(KEY, (2 * 16, 4), jnp.bfloat16,
                                         -1e-2, 1e-2).astype(jnp.float32))
    for r in range(2):
        logits = torch.zeros(16, 4, dtype=torch.bfloat16)
        got = TM.jitter_noise(KD, logits, types.SimpleNamespace(rank=r,
                                                                nranks=2))
        _eq(got.float().numpy(), want[16 * r:16 * (r + 1)])


def test_moe_layer_jitter_draws_the_reference_key():
    import paddle_tpu.nn as jnn
    import paddle_tpu_torch as pt
    paddle.seed(4)
    jl = jnn.MoELayer(8, 16, 4, gate_jitter=True)
    pt.seed(4)
    with nn.building("cpu"):
        tl = nn.MoELayer(8, 16, 4, gate_jitter=True)
    for (n, p), (_, q) in zip(jl.named_parameters(), tl.named_parameters()):
        assert _ulps(q.detach().numpy(), p.numpy()).max() <= 4, n
    nn.params_from_numpy(tl, {n: p.numpy() for n, p in
                              jl.named_parameters()})
    x = np.random.RandomState(6).randn(2, 8, 8).astype(np.float32)
    jl.train()
    tl.train()
    paddle.seed(7)
    want = jl(paddle.to_tensor(x)).numpy()
    rng.seed(7)
    got = tl(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    before = rng.get_rng_state()["global"]
    tl.eval()
    tl(torch.from_numpy(x))
    _eq(rng.get_rng_state()["global"], before)

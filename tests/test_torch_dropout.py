"""``paddle_tpu_torch.core.rng`` and the port's dropouts against
``jax.random`` and ``paddle_tpu``'s, from the same key data:

- ``split``, ``fold_in``, ``random_bits`` (32 and 64 bits), ``uniform``
  (float32 and float64, also over [-2, 3.5)) and ``bernoulli`` bit for
  bit, for three keys and odd shapes;
- ``F.dropout`` (``axis`` None, an int, a list; both modes, train and
  eval), ``dropout2d``, ``dropout3d`` and ``alpha_dropout`` bit for bit,
  fp32 against the reference with x64 off and float64 with x64 on; the two
  widths draw different masks;
- the eager streams after ``seed``, the scoped draws, eval mode and
  ``p == 0`` drawing nothing;
- with no device named, a draw raising without a card;
- the train steps' draws: the step key's masks in ``make_train_step`` and
  the one-rank ``make_spmd_train_step`` (a micro-batch under
  ``fold_in(key, m)``), the latter also against the reference's on a
  one-device mesh (fp32), a step over two model ranks refusing to draw,
  and a data rank's draw as its rows of the global mask.
"""

import gc
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.core import rng as jrng
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.distributed.topology import ProcessMesh
from paddle_tpu_torch.jit.functional import fold_in_step_key, make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD

KEYS = [np.array([0, 0], np.uint32), np.array([0, 42], np.uint32),
        np.array([0xDEADBEEF, 0x12345678], np.uint32)]
SHAPES = [(3, 5, 7), (4097,), ()]


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


class _x64:
    """``jax_enable_x64`` on for the body, off again after it."""

    def __enter__(self):
        jax.config.update("jax_enable_x64", True)

    def __exit__(self, *exc):
        jax.config.update("jax_enable_x64", False)


def _eq(got, want):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    np.testing.assert_array_equal(got, np.asarray(want))


# ------------------------------------------------------------ primitives --

@pytest.mark.parametrize("k", range(len(KEYS)))
def test_split_and_fold_in(k):
    key, jkey = KEYS[k], jnp.asarray(KEYS[k])
    _eq(rng.split(key), jax.random.split(jkey))
    _eq(rng.split(key, 5), jax.random.split(jkey, 5))
    for data in (0, 1, 7, 2**32 - 1):
        _eq(rng.fold_in(key, data), jax.random.fold_in(jkey, data))
        _eq(fold_in_step_key(key, data), jax.random.fold_in(jkey, data))
    _eq(rng.make_key(123), jax.random.key_data(jax.random.key(123)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("k", range(len(KEYS)))
def test_random_bits_uniform_bernoulli(k, shape):
    key, jkey, cpu = KEYS[k], jnp.asarray(KEYS[k]), "cpu"
    _eq(rng.random_bits(key, 32, shape, cpu),
        np.asarray(jax.random.bits(jkey, shape, jnp.uint32)).astype(np.int64))
    _eq(rng.uniform(key, shape, device=cpu), jax.random.uniform(jkey, shape))
    _eq(rng.uniform(key, shape, torch.float32, -2.0, 3.5, cpu),
        jax.random.uniform(jkey, shape, jnp.float32, -2.0, 3.5))
    _eq(rng.bernoulli(key, 0.7, shape, device=cpu),
        jax.random.bernoulli(jkey, 0.7, shape))
    with _x64():
        _eq(rng.random_bits(key, 64, shape, cpu),
            np.asarray(jax.random.bits(jkey, shape, jnp.uint64)).view(
                np.int64))
        _eq(rng.uniform(key, shape, torch.float64, device=cpu),
            jax.random.uniform(jkey, shape, jnp.float64))
        _eq(rng.uniform(key, shape, torch.float64, -2.0, 3.5, cpu),
            jax.random.uniform(jkey, shape, jnp.float64, -2.0, 3.5))
        _eq(rng.bernoulli(key, 0.7, shape, torch.float64, cpu),
            jax.random.bernoulli(jkey, 0.7, shape))


@pytest.mark.parametrize("draw", ["random_bits", "uniform", "bernoulli"])
def test_draws_need_a_card_by_default(draw):
    """With no device named a draw lands on ``cuda``, as every entry point
    of the port, and raises without a card rather than draw on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        getattr(rng, draw)(KEYS[0], shape=(3,))


# -------------------------------------------------------------- dropouts --

CASES = {
    "axis_none": (lambda f, x: f.dropout(x, 0.3), (4, 6, 5)),
    "axis_int": (lambda f, x: f.dropout(x, 0.5, axis=1), (4, 6, 5)),
    "axis_list": (lambda f, x: f.dropout(x, 0.4, axis=[0, 2]), (4, 6, 5)),
    "downscale": (lambda f, x: f.dropout(x, 0.3, mode="downscale_in_infer"),
                  (4, 6, 5)),
    "downscale_eval": (lambda f, x: f.dropout(
        x, 0.3, training=False, mode="downscale_in_infer"), (4, 6, 5)),
    "upscale_eval": (lambda f, x: f.dropout(x, 0.3, training=False),
                     (4, 6, 5)),
    "dropout2d": (lambda f, x: f.dropout2d(x, 0.5), (3, 8, 4, 4)),
    "dropout2d_nhwc": (lambda f, x: f.dropout2d(x, 0.5, data_format="NHWC"),
                       (3, 4, 4, 8)),
    "dropout3d": (lambda f, x: f.dropout3d(x, 0.5), (2, 5, 3, 3, 3)),
    "alpha": (lambda f, x: f.alpha_dropout(x, 0.2), (4, 6, 5)),
}


def _reference(case, x, key, x64):
    fn, _ = CASES[case]
    if x64:
        jax.config.update("jax_enable_x64", True)
    try:
        with jrng.rng_scope(jnp.asarray(key)):
            out = fn(JF, paddle.to_tensor(jnp.asarray(x)))._data
        assert out.dtype == x.dtype
        return np.asarray(out)
    finally:
        jax.config.update("jax_enable_x64", False)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_dropout_bit_equal(case, dtype):
    fn, shape = CASES[case]
    x = np.random.RandomState(3).randn(*shape).astype(dtype)
    for key in KEYS[1:]:
        want = _reference(case, x, key, x64=dtype == "float64")
        with rng.rng_scope(key):
            got = fn(F, torch.from_numpy(x))
        assert got.dtype == torch.from_numpy(x).dtype
        _eq(got, want)


def test_mask_width_follows_the_input():
    """A float64 input draws 64-bit uniforms (the reference under x64
    on), any other 32-bit ones (x64 off): the masks differ, so a port that
    drew one width for both would fail one of the cases above."""
    x = np.ones((4096,))
    key = KEYS[0]
    with rng.rng_scope(key):
        m64 = F.dropout(torch.from_numpy(x), 0.3) != 0
    with rng.rng_scope(key):
        m32 = F.dropout(torch.from_numpy(x.astype(np.float32)), 0.3) != 0
    assert int((m64 != m32).sum()) > 1000
    _eq(m64, _reference("axis_none", x, key, x64=True) != 0)
    _eq(m32, _reference("axis_none", x.astype(np.float32), key, x64=False)
        != 0)


def test_dropout_layers():
    x = torch.from_numpy(np.random.RandomState(5).randn(2, 4, 3, 3))
    with nn.building("cpu"):
        layers = [nn.Dropout(0.3), nn.Dropout(0.3, axis=1),
                  nn.Dropout2D(0.4), nn.Dropout3D(0.4), nn.AlphaDropout(0.2)]
    fns = [lambda a: F.dropout(a, 0.3), lambda a: F.dropout(a, 0.3, axis=1),
           lambda a: F.dropout2d(a, 0.4), lambda a: F.dropout3d(
               a.unsqueeze(2), 0.4).squeeze(2),
           lambda a: F.alpha_dropout(a, 0.2)]
    for layer, fn in zip(layers, fns):
        arg = x.unsqueeze(2) if isinstance(layer, nn.Dropout3D) else x
        with rng.rng_scope(KEYS[2]):
            got = layer(arg)
        with rng.rng_scope(KEYS[2]):
            want = fn(x)
        _eq(got.reshape(want.shape), want)
        layer.eval()
        assert layer(arg) is arg


# ---------------------------------------------------------------- streams --

@pytest.fixture
def reference_streams():
    """Put the reference's seed flag and streams back after the test: a
    later test in this worker may draw from them."""
    seed, streams = paddle.get_flags(["FLAGS_seed"]), dict(jrng._streams)
    yield
    paddle.set_flags(seed)
    jrng._streams.clear()
    jrng._streams.update(streams)


def test_eager_stream_draws_follow_the_reference(reference_streams):
    x = np.random.RandomState(7).randn(5, 9).astype(np.float32)
    paddle.seed(11)
    rng.seed(11)
    for _ in range(4):
        want = np.asarray(JF.dropout(paddle.to_tensor(x), 0.5)._data)
        _eq(F.dropout(torch.from_numpy(x), 0.5), want)
    _eq(rng.next_key(), jax.random.key_data(jrng.next_key()))
    state = rng.get_rng_state()
    _eq(state["global"], jax.random.key_data(jrng.get_stream().key))
    first = rng.next_key()
    rng.set_rng_state(state)
    _eq(rng.next_key(), first)


def test_scoped_draws_are_fold_ins_and_eval_draws_nothing():
    key = KEYS[1]
    x = torch.ones(8)
    with rng.rng_scope(key):
        for n in (1, 2, 3):
            assert rng.in_rng_scope()
            _eq(rng.next_key(), jax.random.fold_in(jnp.asarray(key), n))
            F.dropout(x, 0.5, training=False)
            F.dropout(x, 0.0)
            F.alpha_dropout(x, 0.5, training=False)
            F.dropout(x, 0.5, training=False, mode="downscale_in_infer")
        with rng.fold_scope(4):
            _eq(rng.next_key(), jax.random.fold_in(jax.random.fold_in(
                jnp.asarray(key), 4), 1))
        _eq(rng.next_key(), jax.random.fold_in(jnp.asarray(key), 4))
    assert not rng.in_rng_scope()
    rng.seed(3)
    before = rng.get_rng_state()["global"].copy()
    F.dropout(x, 0.5, training=False)
    F.dropout(x, 0.0)
    _eq(rng.get_rng_state()["global"], before)


# ------------------------------------------------------------ train steps --

def _net():
    torch.manual_seed(0)
    with nn.building("cpu"):
        return nn.Sequential(nn.Linear(6, 16), nn.Dropout(0.5),
                             nn.Linear(16, 3)).double()


def _mse(o, y):
    return ((o - y) ** 2).mean()


def _grads_of(net, key, x, y):
    """The first layer's weight gradient of one forward under
    ``rng_scope(key)``."""
    net.zero_grad()
    with rng.rng_scope(key):
        _mse(net(x), y).backward()
    return net[0].weight.grad.clone()


def test_train_steps_draw_from_the_step_key():
    r = np.random.RandomState(8)
    x, y = torch.from_numpy(r.randn(4, 6)), torch.from_numpy(r.randn(4, 3))
    key = fold_in_step_key(KEYS[2], 5)
    net = _net()
    w0 = net[0].weight.detach().clone()
    want = _grads_of(net, key, x, y)
    step, state = make_train_step(net, _mse, SGD(1.0), donate=False)
    new, _ = step(state, key, 1.0, [x], [y])
    torch.testing.assert_close(new["params"]["0.weight"], w0 - want,
                               rtol=0, atol=0)
    other, _ = step(state, fold_in_step_key(KEYS[2], 6), 1.0, [x], [y])
    assert not torch.equal(other["params"]["0.weight"],
                           new["params"]["0.weight"])

    hcg = types.SimpleNamespace(mesh=ProcessMesh(["data"], [1]))
    sstep, sstate, _ = spmd.make_spmd_train_step(net, _mse, SGD(1.0), hcg,
                                                 donate=False)
    snew, _ = sstep(sstate, key, 1.0, [x], [y])
    torch.testing.assert_close(snew["params"]["0.weight"], w0 - want,
                               rtol=0, atol=0)
    # two micro-batches: the m-th under fold_in(key, m)
    astep, astate, _ = spmd.make_spmd_train_step(
        net, _mse, SGD(1.0), hcg, accumulate_steps=2, donate=False)
    anew, _ = astep(astate, key, 1.0, [x], [y])
    g = sum(_grads_of(net, rng.fold_in(key, m), x[2 * m:2 * m + 2],
                      y[2 * m:2 * m + 2]) for m in range(2)) / 2
    torch.testing.assert_close(anew["params"]["0.weight"], w0 - g,
                               rtol=1e-15, atol=1e-15)


@pytest.mark.parametrize("accumulate_steps", [1, 2])
def test_one_rank_spmd_step_matches_the_reference(accumulate_steps):
    """The one-rank ``make_spmd_train_step`` against the reference's on a
    one-device mesh, from the same weights and key: with two micro-batches
    the m-th draws under ``fold_in(key, m)`` on both sides.  In fp32 with
    x64 off: the reference's accumulating arm carries its loss as a
    float32 loop carry, which a float64 loss does not fit."""
    from paddle_tpu import nn as jnn
    from paddle_tpu.distributed import make_spmd_train_step as jmake
    from paddle_tpu.distributed.topology import HybridCommunicateGroup
    from paddle_tpu.optimizer import SGD as JSGD

    r = np.random.RandomState(8)
    x, y = r.randn(4, 6).astype(np.float32), r.randn(4, 3).astype(np.float32)
    key = fold_in_step_key(KEYS[2], 5)
    net = _net().float()
    hcg = types.SimpleNamespace(mesh=ProcessMesh(["data"], [1]))
    step, state, _ = spmd.make_spmd_train_step(
        net, _mse, SGD(1.0), hcg, accumulate_steps=accumulate_steps,
        donate=False)
    new, loss = step(state, key, 1.0, [torch.from_numpy(x)],
                     [torch.from_numpy(y)])

    saved = jrng.get_rng_state()
    try:
        jnet = jnn.Sequential(jnn.Linear(6, 16), jnn.Dropout(0.5),
                              jnn.Linear(16, 3))
    finally:
        jrng.set_rng_state(saved)
    params = dict(net.named_parameters())
    for n, p in jnet.named_parameters():
        p._data = jnp.array(params[n].detach().numpy(), copy=True)
    jstep, jstate, _ = jmake(jnet, _mse, JSGD(1.0),
                             HybridCommunicateGroup(dp_degree=1),
                             accumulate_steps=accumulate_steps, donate=False)
    jnew, jloss = jstep(jstate, jnp.asarray(key), np.float32(1.0),
                        [jnp.asarray(x)], [jnp.asarray(y)])
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-6)
    assert set(new["params"]) == set(jnew["params"])
    for n, v in new["params"].items():
        np.testing.assert_allclose(v.detach().numpy(),
                                   np.asarray(jnew["params"][n]),
                                   rtol=1e-5, atol=1e-6, err_msg=n)


def test_a_step_over_two_ranks_refuses_to_draw():
    """Over two model ranks a rank's block of a column-split mask is not
    one counter range of the global draw: the step raises at the draw,
    before any collective, naming ROADMAP A7b item 8."""
    net = _net()
    hcg = types.SimpleNamespace(mesh=ProcessMesh(["model"], [2]))
    step, state, _ = spmd.make_spmd_train_step(net, _mse, SGD(1.0), hcg)
    x, y = torch.zeros(4, 6, dtype=torch.float64), torch.zeros(
        4, 3, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="ROADMAP A7b item 8"):
        step(state, KEYS[0], 1.0, [x], [y])
    assert not rng.in_rng_scope()
    assert F.dropout(torch.ones(3), 0.5).shape == (3,)   # refusal undone


@pytest.mark.parametrize("ranks", [2, 4, 8])
@pytest.mark.parametrize("case", ["axis_none", "axis_int", "axis_list",
                                  "dropout2d", "alpha"])
def test_a_data_rank_draws_its_rows_of_the_global_mask(case, ranks):
    """Over the data ranks a step draws each rank's rows of the
    reference's mask of the global batch: the counters are row-major, so
    rank r's block is the range ``[r n, (r + 1) n)`` (``rng.row_block``,
    which the mesh step enters around each rank's forward); 8 ranks hold
    one row each.  ``axis_int``'s mask is broadcast over the batch: every
    rank draws the whole of it."""
    fn, shape = CASES[case]
    shape = (8,) + shape[1:]
    x = np.random.RandomState(5).randn(*shape).astype(np.float32)
    want = _reference(case, x, KEYS[1], x64=False)
    n = shape[0] // ranks
    for r in range(ranks):
        with rng.rng_scope(KEYS[1]), rng.row_block(r, n):
            got = fn(F, torch.from_numpy(x[r * n:(r + 1) * n]))
        _eq(got, want[r * n:(r + 1) * n])

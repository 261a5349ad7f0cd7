"""Max pooling's ``return_mask``, ``max_unpool2d``/``MaxUnPool2D``,
adaptive max pooling, the transposed convs, ``fold``/``unfold`` and the
``Orthogonal``, ``Dirac`` and ``Bilinear`` initializers with
``calculate_gain`` in ``paddle_tpu_torch.nn`` against ``paddle_tpu.nn`` on
the same numpy inputs: fp32 values within 1e-5, indices equal, the
transposed convs' gradients within 1e-5, the layers' parameter names and
shapes equal.  ``Orthogonal``'s law is checked here (orthonormal rows or
columns times the gain); its draw against the reference's after the same
``seed()`` is ``test_torch_init_draws.py``'s.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.functional as JF
import paddle_tpu.nn.initializer as JI
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import functional as jf
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I

TOL = 1e-5


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(getattr(x, "_data", x))


def _ref(fn, *arrays):
    """The reference's ``fn`` of Tensors over ``arrays``, jitted (its eager
    dispatch costs seconds): numpy outputs."""
    def raw(*a):
        out = fn(*(Tensor(v) for v in a))
        return jax.tree_util.tree_map(lambda t: t._data, out,
                                      is_leaf=lambda t: isinstance(t, Tensor))
    return jax.tree_util.tree_map(np.asarray, jax.jit(raw)(*arrays))


# ------------------------------------------------------------- pooling --

# name: (call, input shape)
MASKED = {
    "1d_sym": (lambda f, x: f.max_pool1d(x, 3, 2, 1, return_mask=True),
               (2, 3, 11)),
    "2d_sym": (lambda f, x: f.max_pool2d(x, 3, 2, 1, return_mask=True),
               (2, 3, 9, 8)),
    "2d_asym_ceil": (lambda f, x: f.max_pool2d(
        x, 3, 2, [0, 1, 1, 0], return_mask=True, ceil_mode=True),
        (2, 3, 9, 8)),
    "2d_nhwc_same": (lambda f, x: f.max_pool2d(
        x, 2, 2, "SAME", return_mask=True, data_format="NHWC"),
        (2, 7, 5, 3)),
    "3d_sym": (lambda f, x: f.max_pool3d(x, 2, 2, 0, return_mask=True),
               (1, 2, 4, 6, 4)),
    "adaptive_1d": (lambda f, x: f.adaptive_max_pool1d(x, 4, True),
                    (2, 3, 10)),
    "adaptive_2d": (lambda f, x: f.adaptive_max_pool2d(x, (3, 4), True),
                    (2, 3, 7, 9)),
    "adaptive_3d": (lambda f, x: f.adaptive_max_pool3d(x, 2, True),
                    (1, 2, 5, 4, 3)),
}


@pytest.mark.parametrize("name", sorted(MASKED))
def test_max_pooling_values_and_masks(name):
    fn, shape = MASKED[name]
    x = _rand(shape, 1)
    want, wmask = _ref(lambda t: fn(JF, t), x)
    tx = torch.from_numpy(x).requires_grad_()
    got, mask = fn(F, tx)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(_np(mask), _np(wmask).astype(np.int64))
    got.sum().backward()           # one gradient at each window's maximum
    assert tx.grad.sum().item() == got.numel()


def test_max_unpool2d_inverts_the_pool():
    x = _rand((2, 3, 8, 6), 2)
    want = _ref(lambda t: jnn.MaxUnPool2D(2, 2)(
        *JF.max_pool2d(t, 2, 2, return_mask=True)), x)
    out, mask = F.max_pool2d(torch.from_numpy(x), 2, 2, return_mask=True)
    got = nn.MaxUnPool2D(2, 2)(out, mask)
    np.testing.assert_array_equal(_np(got), _np(want))
    sized = F.max_unpool2d(out, mask, 2, output_size=(9, 7))
    assert tuple(sized.shape) == (2, 3, 9, 7)
    with pytest.raises(ValueError, match="NCHW"):
        F.max_unpool2d(out, mask, 2, data_format="NHWC")


@pytest.mark.parametrize("n", [1, 2, 3])
def test_adaptive_max_pool_layers(n):
    shape = (2, 3) + (7, 5, 6)[:n]
    x = _rand(shape, 3)
    cls = f"AdaptiveMaxPool{n}D"
    want = _ref(getattr(jnn, cls)(3), x)
    got = getattr(nn, cls)(3)(torch.from_numpy(x))
    np.testing.assert_array_equal(_np(got), _np(want))


# ------------------------------------------------------ transposed conv --

# name: (n, x shape (NC...), weight shape (in, out/groups, *k), keywords)
TRANSPOSED = {
    "1d": (1, (2, 4, 7), (4, 3, 3), dict(stride=2, padding=1,
                                         output_padding=1)),
    "2d_groups_dilation": (2, (2, 4, 5, 6), (4, 3, 3, 2),
                           dict(stride=(2, 1), padding=[1, 0],
                                dilation=(1, 2), groups=2)),
    "2d_asym": (2, (2, 3, 5, 5), (3, 2, 3, 3),
                dict(stride=2, padding=[0, 2, 1, 0], output_padding=1)),
    "2d_same_nhwc": (2, (2, 3, 5, 4), (3, 2, 3, 3),
                     dict(stride=2, padding="SAME", data_format="NHWC")),
    "2d_valid": (2, (1, 2, 4, 4), (2, 3, 2, 3),
                 dict(stride=3, padding="VALID")),
    "3d": (3, (1, 2, 3, 4, 3), (2, 2, 2, 3, 2), dict(stride=2, padding=1)),
}


def _nhwc(a, n):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


@pytest.mark.parametrize("name", sorted(TRANSPOSED))
def test_conv_transpose_forward_and_gradients(name):
    n, xs, ws, kw = TRANSPOSED[name]
    x = _rand(xs, 4)
    if kw.get("data_format") == "NHWC":
        x = _nhwc(x, n)
    w, b = _rand(ws, 5, 0.5), _rand((ws[1] * kw.get("groups", 1),), 6)
    call = f"conv{n}d_transpose"

    def ref(x, w, b):
        out = getattr(JF, call)(Tensor(x), Tensor(w), Tensor(b), **kw)._data
        return jnp.sum(out * jnp.cos(out)), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2), has_aux=True))(x, w, b)
    tx, tw, tb = (torch.from_numpy(a).requires_grad_() for a in (x, w, b))
    out = getattr(F, call)(tx, tw, tb, **kw)
    (out * torch.cos(out)).sum().backward()
    assert tuple(out.shape) == want.shape
    np.testing.assert_allclose(_np(out), np.asarray(want), rtol=TOL,
                               atol=TOL)
    for t, g in zip((tx, tw, tb), grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), rtol=TOL,
                                   atol=TOL)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_conv_transpose_layers_names_and_forward(n):
    cls = f"Conv{n}DTranspose"
    paddle.seed(1)
    jl = getattr(jnn, cls)(4, 6, 3, stride=2, padding=1, groups=2)
    apply_fn, jp, _ = jf.functionalize(jl)
    with nn.building("cpu"):
        tl = getattr(nn, cls)(4, 6, 3, stride=2, padding=1, groups=2)
    assert {k: tuple(p.shape) for k, p in tl.named_parameters()} == \
        {k: tuple(v.shape) for k, v in jp.items()}
    bound = 1 / np.sqrt(2 * 3 ** n)         # fan_in = in/groups * prod(k)
    assert tl.weight.abs().max().item() <= bound
    with torch.no_grad():
        for k, p in tl.named_parameters():
            p.copy_(torch.from_numpy(np.asarray(jp[k])))
    x = _rand((2, 4) + (5, 4, 3)[:n], 7)
    want, _ = jax.jit(lambda p, a: apply_fn(p, {}, a))(jp, x)
    np.testing.assert_allclose(_np(tl(torch.from_numpy(x))),
                               np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("kw", [dict(), dict(strides=2, paddings=1),
                                dict(strides=(1, 2), paddings=[1, 0, 2, 1],
                                     dilations=2)], ids=str)
def test_unfold_and_fold(kw):
    x = _rand((2, 3, 7, 6), 8)
    want = _ref(lambda t: JF.unfold(t, 3, **kw), x)
    got = F.unfold(torch.from_numpy(x), 3, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)
    cols = _rand(tuple(got.shape), 9)
    want = _ref(lambda t: JF.fold(t, (7, 6), 3, **kw), cols)
    got = F.fold(torch.from_numpy(cols), (7, 6), 3, **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL, atol=TOL)


# -------------------------------------------------------- initializers --

@pytest.mark.parametrize("shape,groups", [((4, 4, 3, 3), 1),
                                          ((6, 3, 5), 2),
                                          ((4, 2, 3, 3, 3), 1)])
def test_dirac_as_the_reference(shape, groups):
    with nn.building("cpu"):              # an initializer's device
        got = I.Dirac(groups)(shape, "float32")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JI.Dirac(groups)(shape, "float32")))


@pytest.mark.parametrize("shape", [(2, 3, 4, 4), (1, 2, 3, 5)])
def test_bilinear_as_the_reference(shape):
    with nn.building("cpu"):              # an initializer's device
        got = I.Bilinear()(shape, "float32")
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JI.Bilinear()(shape, "float32")))
    with pytest.raises(ValueError, match="4-D"):
        I.Bilinear()((3, 3), "float32")


@pytest.mark.parametrize("shape", [(3, 5), (6, 2, 2), (4, 4)])
def test_orthogonal_law(shape):
    from paddle_tpu_torch.core import rng
    rng.seed(0)
    with nn.building("cpu"):
        w = I.Orthogonal(gain=2.0)(shape, torch.float64).reshape(
            shape[0], -1)
    small = min(w.shape)
    gram = w @ w.T if w.shape[0] == small else w.T @ w
    torch.testing.assert_close(gram, 4.0 * torch.eye(small,
                                                     dtype=torch.float64),
                               rtol=0, atol=1e-5)   # an fp32 QR
    with nn.building("cpu"):
        assert I.Orthogonal()(shape, "float32").dtype == torch.float32


def test_calculate_gain_table():
    for name, param in [("sigmoid", None), ("linear", None),
                        ("conv2d", None), ("tanh", None), ("relu", None),
                        ("leaky_relu", None), ("leaky_relu", 0.2),
                        ("selu", None)]:
        assert I.calculate_gain(name, param) == JI.calculate_gain(name,
                                                                  param)
    with pytest.raises(ValueError):
        I.calculate_gain("gelu")

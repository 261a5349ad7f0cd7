"""``paddle_tpu_torch.nn``'s activations, losses and common functionals
and layers against ``paddle_tpu.nn``'s on the same numpy inputs.

Each case is one call written once for both packages (the functional
module or layer namespace passed in).  fp32 outputs and the gradients of
``sum(out * g)`` with respect to the float inputs within 1e-5 of the
tensor's scale (``max(1, max|want|)``); bf16 within 2e-2; integer and
bool outputs exactly.  The reference's calls are jitted (its op-by-op
dispatch costs seconds), its gradients from ``jax.grad``.  The names
that draw from ``jax.random`` laws the port lacks (``rrelu`` in training,
``gumbel_softmax``) and ``HSigmoidLoss`` raise ``NotImplementedError``
naming ROADMAP A8b-1.
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
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.jit import functional as jf
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F

TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _r(shape, seed, scale=1.0, shift=0.0):
    return np.asarray(np.random.RandomState(seed).randn(*shape) * scale
                      + shift, np.float32)


def _u(shape, seed, lo=0.05, hi=0.95):
    return np.random.RandomState(seed).uniform(lo, hi, shape).astype(
        np.float32)


def _ints(shape, seed, hi):
    return np.random.RandomState(seed).randint(0, hi, shape).astype(np.int64)


def _close(got, want, tol=TOL, err_msg=""):
    want = np.asarray(want)
    if want.dtype.kind in "biu":
        assert np.array_equal(np.asarray(got), want), err_msg
        return
    want = want.astype(np.float32)
    scale = max(1.0, float(np.abs(want).max())) if want.size else 1.0
    np.testing.assert_allclose(np.asarray(got, np.float32) / scale,
                               want / scale, rtol=tol, atol=tol,
                               err_msg=err_msg)


def _first(out):
    return out[0] if isinstance(out, (tuple, list)) else out


def _check(call, arrays, diff=(0,)):
    """``call(module, *tensors)`` through both packages: the output and
    the gradients of ``sum(out * g)`` in the ``diff`` inputs."""
    jarrays = [jnp.asarray(a) for a in arrays]

    def ref(*xs):
        out = _first(call(JF, *[Tensor(x) for x in xs]))._data
        return out

    want = jax.jit(ref)(*jarrays)
    tx = [torch.from_numpy(np.array(a)).requires_grad_(i in diff)
          for i, a in enumerate(arrays)]
    got = _first(call(F, *tx))
    assert tuple(got.shape) == tuple(want.shape)
    _close(got.detach().numpy(), want)
    if not diff or not np.issubdtype(np.asarray(want).dtype, np.floating):
        return
    g = _r(tuple(want.shape), 99)

    def loss(*xs):
        return jnp.sum(ref(*xs) * g)

    grads = jax.jit(jax.grad(loss, argnums=tuple(diff)))(*jarrays)
    (got * torch.from_numpy(g)).sum().backward()
    for i, w in zip(diff, grads):
        _close(tx[i].grad.numpy(), w, err_msg=f"grad of input {i}")


X = _r((4, 6, 5), 1, 2.0)

ACTS = {
    "relu": lambda m, x: m.relu(x),
    "relu6": lambda m, x: m.relu6(x * 4),
    "elu": lambda m, x: m.elu(x, 0.7),
    "selu": lambda m, x: m.selu(x),
    "celu": lambda m, x: m.celu(x, 0.8),
    "gelu": lambda m, x: m.gelu(x),
    "gelu_tanh": lambda m, x: m.gelu(x, approximate=True),
    "sigmoid": lambda m, x: m.sigmoid(x),
    "hardsigmoid": lambda m, x: m.hardsigmoid(x),
    "hardswish": lambda m, x: m.hardswish(x),
    "hardtanh": lambda m, x: m.hardtanh(x, -0.5, 0.7),
    "hardshrink": lambda m, x: m.hardshrink(x, 0.3),
    "softshrink": lambda m, x: m.softshrink(x, 0.3),
    "tanhshrink": lambda m, x: m.tanhshrink(x),
    "leaky_relu": lambda m, x: m.leaky_relu(x, 0.1),
    "rrelu_eval": lambda m, x: m.rrelu(x, 0.1, 0.3),
    "log_sigmoid": lambda m, x: m.log_sigmoid(x),
    "maxout": lambda m, x: m.maxout(x, 2, 1),
    "maxout_last": lambda m, x: m.maxout(x, 5, -1),
    "silu": lambda m, x: m.silu(x),
    "swish": lambda m, x: m.swish(x),
    "mish": lambda m, x: m.mish(x),
    "softplus": lambda m, x: m.softplus(x, 2.0, 3.0),
    "softsign": lambda m, x: m.softsign(x),
    "tanh": lambda m, x: m.tanh(x),
    "thresholded_relu": lambda m, x: m.thresholded_relu(x, 0.5),
    "softmax": lambda m, x: m.softmax(x, 1),
    "log_softmax": lambda m, x: m.log_softmax(x),
    "glu": lambda m, x: m.glu(x[..., :4], -1),
}


@pytest.mark.parametrize("name", sorted(ACTS))
def test_activation(name):
    _check(ACTS[name], [X])


@pytest.mark.parametrize("shape", [(1,), (6,)])
def test_prelu(shape):
    _check(lambda m, x, w: m.prelu(x, w), [X, _u(shape, 2)], (0, 1))


@pytest.mark.parametrize("name", ["relu_", "softmax_", "elu_", "tanh_"])
def test_inplace_forms_write_their_input(name):
    x = torch.from_numpy(X.copy())
    out = getattr(F, name)(x)
    assert out is x
    want = jax.jit(lambda a: getattr(JF, name)(Tensor(a))._data)(
        jnp.asarray(X))
    _close(x.numpy(), want)


@pytest.mark.parametrize("name", ["gelu", "sigmoid", "softmax", "mish"])
def test_activation_bf16(name):
    want = jax.jit(lambda a: ACTS[name](JF, Tensor(a))._data)(
        jnp.asarray(X, jnp.bfloat16))
    got = ACTS[name](F, torch.from_numpy(X).bfloat16())
    assert got.dtype == torch.bfloat16 and str(want.dtype) == "bfloat16"
    _close(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
           BF16_TOL)


def test_random_activations_wait_for_the_random_slice():
    """The random slice has landed: ``rrelu`` in training and
    ``gumbel_softmax`` draw one key each from ``core.rng`` (their laws
    against the reference's are ``test_torch_random.py``'s); HSigmoidLoss
    still waits for A8b-1's next slice."""
    from paddle_tpu_torch.core import rng
    x = torch.from_numpy(X)
    rng.seed(3)
    a = F.rrelu(x, training=True)
    g = F.gumbel_softmax(x)
    rng.seed(3)
    assert torch.equal(F.rrelu(x, training=True), a)
    assert torch.equal(F.gumbel_softmax(x), g)
    assert torch.equal(a[x >= 0], x[x >= 0]) and not torch.equal(
        a, F.rrelu(x))
    torch.testing.assert_close(g.sum(-1), torch.ones(g.shape[:-1]))
    with pytest.raises(NotImplementedError, match="A8b-1"):
        nn.HSigmoidLoss(4, 5)


# ------------------------------------------------------------------ losses

P2 = _r((8, 5), 3)
Y2 = _r((8, 5), 4)
LBL = _ints((8,), 5, 5)
LBL_IGN = np.where(np.arange(8) == 3, -100, LBL)
W5 = _u((5,), 6, 0.5, 1.5)
PM = np.where(_r((8,), 7) > 0, 1.0, -1.0).astype(np.float32)
LOGP = np.log(_u((8, 5), 8))

LOSSES = {
    "mse": (lambda m, a, b: m.mse_loss(a, b), [P2, Y2], (0, 1)),
    "mse_none": (lambda m, a, b: m.mse_loss(a, b, "none"), [P2, Y2], (0,)),
    "l1_sum": (lambda m, a, b: m.l1_loss(a, b, "sum"), [P2, Y2], (0, 1)),
    "smooth_l1": (lambda m, a, b: m.smooth_l1_loss(a, b, delta=0.5),
                  [P2, Y2], (0,)),
    "nll": (lambda m, a, y: m.nll_loss(a, y), [LOGP, LBL_IGN], (0,)),
    "nll_weight": (lambda m, a, y, w: m.nll_loss(a, y, w), [LOGP, LBL_IGN,
                                                           W5], (0,)),
    "nll_none": (lambda m, a, y: m.nll_loss(a, y, reduction="none"),
                 [LOGP, LBL], (0,)),
    "bce": (lambda m, p, y: m.binary_cross_entropy(p, y),
            [_u((8, 5), 9), _u((8, 5), 10, 0, 1)], (0,)),
    "bce_weight": (lambda m, p, y, w: m.binary_cross_entropy(p, y, w, "sum"),
                   [_u((8, 5), 9), _u((8, 5), 10, 0, 1), W5], (0,)),
    "bce_logits": (lambda m, z, y: m.binary_cross_entropy_with_logits(z, y),
                   [P2, _u((8, 5), 10, 0, 1)], (0,)),
    "bce_logits_pos": (lambda m, z, y, w, pw:
                       m.binary_cross_entropy_with_logits(z, y, w, "none",
                                                          pw),
                       [P2, _u((8, 5), 10, 0, 1), W5, W5 * 2], (0,)),
    "kl_mean": (lambda m, a, y: m.kl_div(a, y), [LOGP, _u((8, 5), 11)],
                (0, 1)),
    "kl_batchmean": (lambda m, a, y: m.kl_div(a, y, "batchmean"),
                     [LOGP, _u((8, 5), 11)], (0,)),
    "margin_ranking": (lambda m, a, b, y: m.margin_ranking_loss(a, b, y,
                                                                0.2),
                       [_r((8,), 12), _r((8,), 13), PM], (0, 1)),
    "hinge_embedding": (lambda m, a, y: m.hinge_embedding_loss(a, y, 0.5),
                        [_r((8,), 12), PM], (0,)),
    "cosine_embedding": (lambda m, a, b, y: m.cosine_embedding_loss(
        a, b, y, 0.1), [P2, Y2, PM], (0, 1)),
    "triplet": (lambda m, a, p, n: m.triplet_margin_loss(a, p, n),
                [P2, Y2, _r((8, 5), 14)], (0, 1, 2)),
    "triplet_swap_p1": (lambda m, a, p, n: m.triplet_margin_loss(
        a, p, n, 0.5, 1.0, swap=True, reduction="sum"),
        [P2, Y2, _r((8, 5), 14)], (0, 1, 2)),
    "log_loss": (lambda m, p, y: m.log_loss(p, y),
                 [_u((8, 1), 15), _u((8, 1), 16, 0, 1)], (0,)),
    "square_error_cost": (lambda m, a, b: m.square_error_cost(a, b),
                          [P2, Y2], (0,)),
    "focal": (lambda m, z, y: m.sigmoid_focal_loss(z, y),
              [P2, _u((8, 5), 10, 0, 1).round()], (0,)),
    "focal_norm": (lambda m, z, y, n: m.sigmoid_focal_loss(
        z, y, n, 0.4, 1.5, "mean"), [P2, _u((8, 5), 10, 0, 1).round(),
                                     np.float32(3.0)], (0,)),
    "npair": (lambda m, a, p, y: m.npair_loss(a, p, y),
              [P2, Y2, _ints((8,), 17, 3)], (0, 1)),
    "dice": (lambda m, p, y: m.dice_loss(p, y),
             [_u((4, 6, 5), 18), _ints((4, 6, 1), 19, 5)], (0,)),
    "swce_hard": (lambda m, z, y: m.softmax_with_cross_entropy(z, y),
                  [P2, LBL[:, None]], (0,)),
    "swce_soft": (lambda m, z, y: m.softmax_with_cross_entropy(
        z, y, soft_label=True), [P2, _u((8, 5), 20)], (0,)),
    "swce_softmax": (lambda m, z, y: m.softmax_with_cross_entropy(
        z, y, return_softmax=True)[1], [P2, LBL[:, None]], (0,)),
}

# CTC: (T, B, C) logits, padded labels (B, L), lengths
CTC_IN = [_r((12, 3, 6), 21), np.array([[1, 2, 2, 0], [3, 3, 3, 4],
                                        [5, 1, 0, 0]], np.int64),
          np.array([12, 10, 9], np.int64), np.array([3, 4, 2], np.int64)]
for _red in ("mean", "sum", "none"):
    LOSSES[f"ctc_{_red}"] = (
        lambda m, a, b, c, d, r=_red: m.ctc_loss(a, b, c, d, 0, r), CTC_IN,
        (0,))
LOSSES["ctc_blank_last"] = (
    lambda m, a, b, c, d: m.ctc_loss(a, b, c, d, 5, "mean", True),
    [CTC_IN[0], np.minimum(CTC_IN[1], 4), CTC_IN[2], CTC_IN[3]], (0,))


@pytest.mark.parametrize("name", sorted(LOSSES))
def test_loss(name):
    call, arrays, diff = LOSSES[name]
    _check(call, arrays, diff)


# name: (constructor arguments, inputs)
LOSS_LAYERS = {
    "CrossEntropyLoss": ((), [P2, LBL]),
    "MSELoss": ((), [P2, Y2]),
    "L1Loss": (("sum",), [P2, Y2]),
    "NLLLoss": ((), [LOGP, LBL_IGN]),
    "BCELoss": ((), [_u((8, 5), 9), _u((8, 5), 10, 0, 1)]),
    "BCEWithLogitsLoss": ((), [P2, _u((8, 5), 10, 0, 1)]),
    "SmoothL1Loss": (("mean", 0.5), [P2, Y2]),
    "KLDivLoss": (("batchmean",), [LOGP, _u((8, 5), 11)]),
    "MarginRankingLoss": ((0.2,), [_r((8,), 12), _r((8,), 13), PM]),
    "HingeEmbeddingLoss": ((0.5,), [_r((8,), 12), PM]),
    "CosineEmbeddingLoss": ((0.1,), [P2, Y2, PM]),
    "TripletMarginLoss": ((), [P2, Y2, _r((8, 5), 14)]),
    "CTCLoss": ((), CTC_IN),
}


@pytest.mark.parametrize("name", sorted(LOSS_LAYERS))
def test_loss_layer(name):
    args, arrays = LOSS_LAYERS[name]
    want = jax.jit(lambda *xs: getattr(jnn, name)(*args)(
        *[Tensor(x) for x in xs])._data)(*[jnp.asarray(a) for a in arrays])
    got = getattr(nn, name)(*args)(*[torch.from_numpy(a) for a in arrays])
    _close(got.numpy(), want)


# ------------------------------------------------------- common functionals

IMG = _r((2, 4, 6, 8), 30)
IMG_NHWC = _r((2, 6, 8, 4), 31)
THETA = (np.array([[[0.9, 0.2, 0.1], [-0.1, 1.1, -0.2]],
                   [[1.2, 0.0, 0.3], [0.1, 0.8, 0.0]]], np.float32))
GRID = _u((2, 5, 7, 2), 32, -1.2, 1.2)

COMMON = {
    "embedding": (lambda m, i, w: m.embedding(i, w, padding_idx=2),
                  [_ints((3, 5), 33, 7), _r((7, 4), 34)], (1,)),
    "embedding_neg_pad": (lambda m, i, w: m.embedding(i, w, padding_idx=-1),
                          [_ints((3, 5), 33, 7), _r((7, 4), 34)], (1,)),
    "one_hot": (lambda m, i: m.one_hot(i, 6), [_ints((3, 4), 35, 6)], ()),
    "label_smooth": (lambda m, y: m.label_smooth(y, epsilon=0.2),
                     [_u((4, 5), 36)], (0,)),
    "label_smooth_prior": (lambda m, y, p: m.label_smooth(y, p, 0.1),
                           [_u((4, 5), 36), _u((1, 5), 37)], (0, 1)),
    "nearest_up": (lambda m, x: m.interpolate(x, scale_factor=2), [IMG],
                   (0,)),
    "nearest_size": (lambda m, x: m.interpolate(x, size=[5, 11]), [IMG],
                     (0,)),
    "bilinear_up": (lambda m, x: m.interpolate(x, [9, 13], mode="bilinear"),
                    [IMG], (0,)),
    "bilinear_down": (lambda m, x: m.interpolate(x, [3, 5],
                                                 mode="bilinear"),
                      [IMG], (0,)),
    "bilinear_corners": (lambda m, x: m.interpolate(
        x, [9, 13], mode="bilinear", align_corners=True), [IMG], (0,)),
    "bicubic_up": (lambda m, x: m.interpolate(x, [9, 13], mode="bicubic"),
                   [IMG], (0,)),
    "bicubic_down": (lambda m, x: m.interpolate(x, [4, 5], mode="bicubic"),
                     [IMG], (0,)),
    "area_down": (lambda m, x: m.interpolate(x, [3, 4], mode="area"), [IMG],
                  (0,)),
    "bilinear_nhwc": (lambda m, x: m.interpolate(
        x, scale_factor=1.5, mode="bilinear", data_format="NHWC"),
        [IMG_NHWC], (0,)),
    "linear_1d": (lambda m, x: m.interpolate(x, [11], mode="linear",
                                             data_format="NCW"),
                  [IMG[:, :, 0]], (0,)),
    "trilinear": (lambda m, x: m.upsample(x, [3, 5, 7], mode="trilinear",
                                          data_format="NCDHW"),
                  [IMG[:, :, :2]], (0,)),
    "pixel_shuffle": (lambda m, x: m.pixel_shuffle(x, 2), [IMG], (0,)),
    "pixel_shuffle_nhwc": (lambda m, x: m.pixel_shuffle(x, 2, "NHWC"),
                           [IMG_NHWC], (0,)),
    "pixel_unshuffle": (lambda m, x: m.pixel_unshuffle(x, 2), [IMG], (0,)),
    "pixel_unshuffle_nhwc": (lambda m, x: m.pixel_unshuffle(x, 2, "NHWC"),
                             [IMG_NHWC], (0,)),
    "channel_shuffle": (lambda m, x: m.channel_shuffle(x, 2), [IMG], (0,)),
    "channel_shuffle_nhwc": (lambda m, x: m.channel_shuffle(x, 2, "NHWC"),
                             [IMG_NHWC], (0,)),
    "pad_constant": (lambda m, x: m.pad(x, [1, 2, 0, 3], value=0.5), [IMG],
                     (0,)),
    "pad_reflect": (lambda m, x: m.pad(x, [2, 3, 1, 4], "reflect"), [IMG],
                    (0,)),
    "pad_replicate_nhwc": (lambda m, x: m.pad(x, [2, 1, 3, 0], "replicate",
                                              data_format="NHWC"),
                           [IMG_NHWC], (0,)),
    "pad_circular": (lambda m, x: m.pad(x, [2, 3, 1, 1], "circular"), [IMG],
                     (0,)),
    "pad_every_axis": (lambda m, x: m.pad(x, [0, 1, 1, 0, 2, 2, 1, 3]),
                       [IMG], (0,)),
    "cosine_similarity": (lambda m, a, b: m.cosine_similarity(a, b),
                          [P2, Y2], (0, 1)),
    "bilinear": (lambda m, a, b, w, bias: m.bilinear(a, b, w, bias),
                 [_r((4, 3), 38), _r((4, 5), 39), _r((2, 3, 5), 40),
                  _r((1, 2), 41)], (0, 1, 2, 3)),
    "affine_grid": (lambda m, t: m.affine_grid(t, [2, 3, 5, 7]), [THETA],
                    (0,)),
    "affine_grid_centers": (lambda m, t: m.affine_grid(
        t, [2, 3, 5, 7], align_corners=False), [THETA], (0,)),
    "grid_sample": (lambda m, x, g: m.grid_sample(x, g), [IMG, GRID],
                    (0, 1)),
    "grid_sample_border": (lambda m, x, g: m.grid_sample(
        x, g, padding_mode="border", align_corners=False), [IMG, GRID],
        (0, 1)),
    "grid_sample_nearest": (lambda m, x, g: m.grid_sample(
        x, g, mode="nearest"), [IMG, GRID], (0,)),
    "unfold": (lambda m, x: m.unfold(x, [2, 3], 1, 1), [IMG], (0,)),
    "fold": (lambda m, x: m.fold(x, [4, 5], [2, 2]), [_r((2, 8, 12), 42)],
             (0,)),
    "sequence_mask": (lambda m, n: m.sequence_mask(n, 6),
                      [np.array([0, 3, 6], np.int64)], ()),
    "sequence_mask_float": (lambda m, n: m.sequence_mask(
        n, 5, dtype="float32"), [np.array([[1, 4], [2, 5]], np.int64)], ()),
    "diag_embed": (lambda m, x: m.diag_embed(x, 1), [_r((3, 4), 43)], (0,)),
    "diag_embed_dims": (lambda m, x: m.diag_embed(x, -1, 0, 2),
                        [_r((3, 4), 43)], (0,)),
    "temporal_shift": (lambda m, x: m.temporal_shift(x, 2, 0.25),
                       [_r((4, 8, 3, 3), 44)], (0,)),
    "npu_identity": (lambda m, x: m.npu_identity(x), [P2], (0,)),
    "zeropad2d": (lambda m, x: m.zeropad2d(x, [1, 2, 3, 0]), [IMG], (0,)),
}


def _csr(L, seed):
    """A (1, 2, L + 1) offsets / (1, 2, nnz) columns pattern, each row
    keeping itself and two random earlier or later keys."""
    r = np.random.RandomState(seed)
    offs, cols = [], []
    for _ in range(2):
        o, c = [0], []
        for i in range(L):
            row = sorted({i, *r.randint(0, L, 2).tolist()})
            c += row
            o.append(len(c))
        offs.append(o)
        cols.append(c)
    n = max(len(c) for c in cols)
    cols = [c + [0] * (n - len(c)) for c in cols]
    return (np.array([offs], np.int64), np.array([cols], np.int64))


_OFF, _COL = _csr(8, 45)
COMMON["sparse_attention"] = (
    lambda m, q, k, v, o, c: m.sparse_attention(q, k, v, o, c),
    [_r((1, 2, 8, 4), 46), _r((1, 2, 8, 4), 47), _r((1, 2, 8, 4), 48), _OFF,
     _COL], (0, 1, 2))


@pytest.mark.parametrize("name", sorted(COMMON))
def test_common_functional(name):
    call, arrays, diff = COMMON[name]
    _check(call, arrays, diff)


# ------------------------------------------------------------ layers

# name: (constructor (over the layer namespace), inputs)
LAYERS = {
    "CELU": (lambda m: m.CELU(0.5), [X]),
    "ELU": (lambda m: m.ELU(), [X]),
    "GELU": (lambda m: m.GELU(True), [X]),
    "GLU": (lambda m: m.GLU(1), [X]),
    "Hardshrink": (lambda m: m.Hardshrink(), [X]),
    "Hardsigmoid": (lambda m: m.Hardsigmoid(), [X]),
    "Hardswish": (lambda m: m.Hardswish(), [X]),
    "Hardtanh": (lambda m: m.Hardtanh(), [X]),
    "LeakyReLU": (lambda m: m.LeakyReLU(0.2), [X]),
    "LogSigmoid": (lambda m: m.LogSigmoid(), [X]),
    "LogSoftmax": (lambda m: m.LogSoftmax(1), [X]),
    "Maxout": (lambda m: m.Maxout(3), [X]),
    "Mish": (lambda m: m.Mish(), [X]),
    "PReLU": (lambda m: m.PReLU(6, 0.1), [X]),
    "RReLU": (lambda m: m.RReLU(), [X]),
    "SELU": (lambda m: m.SELU(), [X]),
    "Sigmoid": (lambda m: m.Sigmoid(), [X]),
    "Silu": (lambda m: m.Silu(), [X]),
    "Softmax": (lambda m: m.Softmax(), [X]),
    "Softplus": (lambda m: m.Softplus(2.0), [X]),
    "Softshrink": (lambda m: m.Softshrink(), [X]),
    "Softsign": (lambda m: m.Softsign(), [X]),
    "Tanh": (lambda m: m.Tanh(), [X]),
    "Tanhshrink": (lambda m: m.Tanhshrink(), [X]),
    "ThresholdedReLU": (lambda m: m.ThresholdedReLU(0.4), [X]),
    "Embedding": (lambda m: m.Embedding(7, 4, padding_idx=1),
                  [_ints((3, 5), 33, 7)]),
    "Upsample": (lambda m: m.Upsample(scale_factor=2, mode="bilinear"),
                 [IMG]),
    "UpsamplingNearest2D": (lambda m: m.UpsamplingNearest2D([7, 9]), [IMG]),
    "UpsamplingBilinear2D": (lambda m: m.UpsamplingBilinear2D([7, 9]),
                             [IMG]),
    "Bilinear": (lambda m: m.Bilinear(3, 5, 2), [_r((4, 3), 38),
                                                 _r((4, 5), 39)]),
    "Pad1D": (lambda m: m.Pad1D([1, 2], "reflect"), [IMG[:, :, 0]]),
    "Pad2D": (lambda m: m.Pad2D([1, 2, 2, 1], "replicate"), [IMG]),
    "Pad3D": (lambda m: m.Pad3D(1, "constant", 0.3), [IMG[:, :, :2]]),
    "ZeroPad2D": (lambda m: m.ZeroPad2D([1, 0, 2, 1]), [IMG]),
    "CosineSimilarity": (lambda m: m.CosineSimilarity(-1), [P2, Y2]),
    "PairwiseDistance": (lambda m: m.PairwiseDistance(3.0, keepdim=True),
                         [P2, Y2]),
    "PixelShuffle": (lambda m: m.PixelShuffle(2), [IMG]),
    "PixelUnshuffle": (lambda m: m.PixelUnshuffle(2), [IMG]),
    "ChannelShuffle": (lambda m: m.ChannelShuffle(4), [IMG]),
    "Unfold": (lambda m: m.Unfold([3, 3], 2, 1), [IMG]),
    "Fold": (lambda m: m.Fold([4, 5], [2, 2]), [_r((2, 8, 12), 42)]),
    "Unflatten": (lambda m: m.Unflatten(1, [2, 3]), [X]),
}


@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer(name):
    """The port's layer with the reference's parameters (by name): output
    and the gradients of its float inputs and parameters."""
    ctor, arrays = LAYERS[name]
    paddle.seed(0)
    apply_fn, jp, _ = jf.functionalize(ctor(jnn))
    params = {n: np.asarray(v) + _r(v.shape, 50, 0.1) for n, v in jp.items()}
    with nn.building("cpu"):
        layer = ctor(nn)
    nn.params_from_numpy(layer, params)
    floats = [i for i, a in enumerate(arrays) if a.dtype == np.float32]

    def ref(p, *xs):
        return apply_fn(p, {}, *xs)[0]

    jarrays = [jnp.asarray(a) for a in arrays]
    jparams = {n: jnp.asarray(v) for n, v in params.items()}
    want = jax.jit(ref)(jparams, *jarrays)
    tx = [torch.from_numpy(a.copy()).requires_grad_(i in floats)
          for i, a in enumerate(arrays)]
    got = layer(*tx)
    _close(got.detach().numpy(), want)
    g = _r(tuple(want.shape), 99)
    grads = jax.jit(jax.grad(lambda p, *xs: jnp.sum(ref(p, *xs) * g),
                             argnums=(0, *[1 + i for i in floats])))(
        jparams, *jarrays)
    (got * torch.from_numpy(g)).sum().backward()
    for n, p in layer.named_parameters():
        _close(p.grad.numpy(), grads[0][n], err_msg=n)
    for i, w in zip(floats, grads[1:]):
        _close(tx[i].grad.numpy(), w)


def test_embedding_zeroes_its_padding_row_at_build():
    with nn.building("cpu"):
        emb = nn.Embedding(6, 3, padding_idx=-2)
    assert torch.count_nonzero(emb.weight[4]) == 0
    assert torch.count_nonzero(emb.weight[3]) == 3

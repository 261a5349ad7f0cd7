"""Initial weights from ``core.rng``'s streams: every initializer of
``paddle_tpu_torch.nn.initializer`` against ``paddle_tpu``'s after the
same ``seed()``, and whole models built after ``seed(s)`` in both
packages, parameter for parameter, with the eager draw that follows.

Stated tolerances: the uniform laws (``Uniform``, ``XavierUniform``,
``KaimingUniform``, every conv, RNN, ``Linear`` and ``Embedding`` weight)
bit-equal; the normal laws (``Normal``, ``TruncatedNormal``,
``XavierNormal``, ``KaimingNormal``, ``SpectralNorm``'s u and v) within 4
ulp
of max(1, |x|) (``core.rng.erf_inv`` is XLA's polynomial in torch ops;
``mean + std * z`` cancels near 0); ``Orthogonal`` within 1e-5 (a QR).
"""

import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu.nn.initializer as JI
import paddle_tpu.vision.models  # noqa: F401
import paddle_tpu_torch as pt
import paddle_tpu_torch.vision.models  # noqa: F401
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import initializer as I


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _ulps(got, want):
    """|got - want| in fp32 ulps of max(1, |want|)."""
    want = np.asarray(want, np.float32)
    ulp = np.spacing(np.maximum(1.0, np.abs(want)))
    return np.abs(np.asarray(got, np.float64) - want) / ulp


def _init_pair(name, args, shape, dtype="float32", seed=5):
    paddle.seed(seed)
    want = np.asarray(getattr(JI, name)(*args)(shape, dtype).astype(
        "float32"))
    pt.seed(seed)
    with nn.building("cpu"):
        got = getattr(I, name)(*args)(shape, dtype)
    assert tuple(got.shape) == tuple(shape)
    assert got.dtype == I.to_dtype(dtype)
    return got.float().numpy(), want


EXACT = {
    "Uniform": ((-0.3, 0.7), (40, 50)),
    "XavierUniform": ((), (40, 50)),
    "XavierUniform_fans": ((7, 9, 2.0), (6, 8)),
    "KaimingUniform": ((), (16, 8, 3, 3)),
    "KaimingUniform_leaky": ((None, 0.2, "leaky_relu"), (16, 8, 3)),
    "Constant": ((0.25,), (3, 4)),
    "Dirac": ((2,), (4, 2, 3, 3)),
    "Bilinear": ((), (2, 3, 4, 4)),
}

NORMAL = {
    "Normal": ((1.0, 2.0), (40, 50)),
    "TruncatedNormal": ((0.5, 2.0), (40, 50)),
    "XavierNormal": ((), (40, 50)),
    "KaimingNormal": ((), (16, 8, 3, 3)),
}


@pytest.mark.parametrize("name,dtype", [(n, "float32") for n in sorted(EXACT)]
                         + [("Uniform", "bfloat16"),
                            ("KaimingUniform", "bfloat16")])
def test_uniform_and_fixed_initializers_bit_equal(name, dtype):
    args, shape = EXACT[name]
    got, want = _init_pair(name.split("_")[0], args, shape, dtype)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("dtype", ["float32", "float16"])
@pytest.mark.parametrize("name", sorted(NORMAL))
def test_normal_initializers_within_4_ulp(name, dtype):
    args, shape = NORMAL[name]
    got, want = _init_pair(name, args, shape, dtype)
    if dtype == "float32":
        assert _ulps(got, want).max() <= 4
    else:                   # drawn in fp32, then one rounding to fp16
        np.testing.assert_allclose(got, want, rtol=2 ** -10, atol=1e-3)


@pytest.mark.parametrize("shape", [(3, 5), (6, 2, 2), (4, 4)])
def test_orthogonal_within_qr_roundoff(shape):
    got, want = _init_pair("Orthogonal", (2.0,), shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_assign_and_the_draws_each_initializer_takes():
    """A drawing initializer takes one key; ``Constant``, ``Assign``,
    ``Dirac`` and ``Bilinear`` take none; on ``meta`` nothing is drawn."""
    def keys_taken(call, device="cpu"):
        rng.seed(1)
        before = rng.get_rng_state()["global"]
        with nn.building(device):
            call()
        n, key = 0, before
        while not np.array_equal(key, rng.get_rng_state()["global"]):
            key = rng.split(key)[0]
            n += 1
            assert n < 5
        return n
    assert keys_taken(lambda: I.Normal()((3,), "float32")) == 1
    assert keys_taken(lambda: I.Orthogonal()((3, 3), "float32")) == 1
    for init in (I.Constant(1.0), I.Assign(np.ones(3)), I.Dirac(),
                 I.Bilinear()):
        shape = (2, 2, 3, 3) if isinstance(init, (I.Dirac, I.Bilinear)) \
            else (3,)
        assert keys_taken(lambda: init(shape, "float32")) == 0
    assert keys_taken(lambda: I.Uniform()((3,), "float32"), "meta") == 0
    with nn.building("cpu"):
        a = I.Assign(np.arange(6.0))((2, 3), "float64")
    assert a.dtype == torch.float64 and a[1, 2] == 5.0


# ------------------------------------------------------------ the models

def _model_pair(make, seed, exact):
    paddle.seed(seed)
    jm = make(paddle)
    jr = paddle.randn([6, 5]).numpy()
    pt.seed(seed)
    with nn.building("cpu"):
        tm = make(pt)
        tr = pt.randn([6, 5]).numpy()
    jp = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tp = {n: p.detach().numpy() for n, p in tm.named_parameters()}
    assert list(tp) == list(jp)
    for n in jp:
        if exact(n):
            np.testing.assert_array_equal(tp[n], jp[n], err_msg=n)
        else:
            assert _ulps(tp[n], jp[n]).max() <= 4, n
    assert _ulps(tr, jr).max() <= 4
    return jm, tm


MODELS = {
    "lenet": lambda m: m.vision.models.LeNet(),
    "squeezenet1_1": lambda m: m.vision.models.squeezenet1_1(num_classes=10),
    "lstm": lambda m: m.nn.LSTM(12, 16, num_layers=2, direction="bidirect",
                                dropout=0.5),
    "gru": lambda m: m.nn.GRU(12, 16, num_layers=2),
    "embedding_linear": lambda m: m.nn.Sequential(m.nn.Embedding(30, 8),
                                                  m.nn.Linear(8, 4)),
    "transformer": lambda m: m.nn.Transformer(16, 2, 1, 1, 32),
    "multi_head_attention": lambda m: m.nn.MultiHeadAttention(16, 2, kdim=8,
                                                             vdim=12),
    "conv_transpose_bilinear": lambda m: m.nn.Sequential(
        m.nn.Conv1D(4, 2, 3, bias_attr=False), m.nn.Conv2DTranspose(2, 3, 3),
        m.nn.Bilinear(3, 4, 5)),
}


@pytest.mark.parametrize("name", sorted(MODELS))
def test_models_built_after_seed_equal_the_reference(name):
    """Every layer draws its parameters in the reference's order: one
    out-of-order draw would shift every later tensor (the MoE layer's
    normal draws: ``test_torch_random.py``)."""
    _model_pair(MODELS[name], 11, lambda n: True)


def test_spectral_norm_vectors_follow_the_stream():
    paddle.seed(3)
    jl = jnn.SpectralNorm([6, 4])
    pt.seed(3)
    with nn.building("cpu"):
        tl = nn.SpectralNorm([6, 4])
    for n in ("weight_u", "weight_v"):
        assert _ulps(getattr(tl, n).numpy(),
                     np.asarray(getattr(jl, n).numpy())).max() <= 4

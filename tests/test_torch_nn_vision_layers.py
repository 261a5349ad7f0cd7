"""The vision layers and functionals of ``paddle_tpu_torch.nn`` against
``paddle_tpu.nn`` on the same numpy inputs: conv, pooling, batch norm,
cross entropy, linear, flatten and the activations, in fp32 within 1e-5
unless a case says otherwise (the bf16 cases within 2e-2, the bf16 tier);
the initializers' laws; the parameter and buffer names and shapes of
``resnet50`` (NHWC) and ``LeNet``; and the port's import boundary.
"""

import gc
import math
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.tensor.manipulation import flatten as jflatten
from paddle_tpu_torch import nn
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn import initializer as I
from paddle_tpu_torch.tensor import flatten

REPO = Path(__file__).resolve().parents[1]
TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


def _rand(shape, seed=0, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _j(a, dtype=None):
    return paddle.to_tensor(a if dtype is None else jnp.asarray(a, dtype))


def _t(a, dtype=None):
    t = torch.from_numpy(np.ascontiguousarray(a))
    return t if dtype is None else t.to(dtype)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x._data).astype(np.float32)


def _close(got, want, tol=TOL):
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


def _nhwc(a):
    return np.ascontiguousarray(np.moveaxis(a, 1, -1))


# ------------------------------------------------------------------ conv --

PADDINGS = [0, 1, [1, 2], [1, 0, 2, 1], [[1, 0], [2, 1]], "SAME", "VALID",
            "pairs_with_nc"]


def _pairs_with_nc(df):
    return ([[0, 0], [0, 0], [1, 0], [2, 1]] if df == "NCHW"
            else [[0, 0], [1, 0], [2, 1], [0, 0]])


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("padding", PADDINGS, ids=str)
@pytest.mark.parametrize("stride", [1, 2])
def test_conv2d_padding_forms(padding, stride, df):
    x = _rand((2, 4, 9, 8))
    w = _rand((6, 4, 3, 3), 1, 0.3)
    b = _rand((6,), 2)
    if padding == "pairs_with_nc":
        padding = _pairs_with_nc(df)
    xin = x if df == "NCHW" else _nhwc(x)
    want = JF.conv2d(_j(xin), _j(w), _j(b), stride=stride, padding=padding,
                     data_format=df)
    got = F.conv2d(_t(xin), _t(w), _t(b), stride=stride, padding=padding,
                   data_format=df)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("groups,dilation", [(2, 1), (1, 2), (4, 2)])
def test_conv2d_groups_dilation(groups, dilation, df):
    x = _rand((2, 8, 10, 9))
    w = _rand((8, 8 // groups, 3, 3), 1, 0.3)
    xin = x if df == "NCHW" else _nhwc(x)
    kw = dict(stride=1, padding="SAME", dilation=dilation, groups=groups,
              data_format=df)
    want = JF.conv2d(_j(xin), _j(w), **kw)
    got = F.conv2d(_t(xin), _t(w), **kw)
    _close(got, want)


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_conv2d_bf16_input_fp32_weight(df):
    """A bf16 input against an fp32 weight runs the conv in bf16, as the
    reference does (its output dtype too)."""
    x = _rand((2, 3, 16, 16))
    w = _rand((8, 3, 7, 7), 1, 0.1)
    b = _rand((8,), 2)
    xin = x if df == "NCHW" else _nhwc(x)
    want = JF.conv2d(_j(xin, jnp.bfloat16), _j(w), _j(b), stride=2,
                     padding=3, data_format=df)
    got = F.conv2d(_t(xin, torch.bfloat16), _t(w), _t(b), stride=2,
                   padding=3, data_format=df)
    assert str(want._data.dtype) == "bfloat16"
    assert got.dtype == torch.bfloat16
    _close(got, want, BF16_TOL)


@pytest.mark.parametrize("a,b,want", [
    (torch.float16, torch.bfloat16, torch.float32),
    (torch.float32, torch.float64, torch.float64),
    (torch.float32, torch.float16, torch.float16)])
def test_conv_dtype_rule(a, b, want):
    x = torch.ones(1, 2, 4, 4, dtype=a)
    w = torch.ones(3, 2, 1, 1, dtype=b)
    assert F.conv2d(x, w).dtype == want


def test_conv1d_and_conv3d():
    x1, w1 = _rand((2, 4, 11)), _rand((6, 2, 3), 1, 0.3)
    _close(F.conv1d(_t(x1), _t(w1), padding=[1, 0], groups=2),
           JF.conv1d(_j(x1), _j(w1), padding=[1, 0], groups=2))
    x1l = np.ascontiguousarray(np.moveaxis(x1, 1, -1))
    _close(F.conv1d(_t(x1l), _t(w1), stride=2, padding="SAME", groups=2,
                    data_format="NLC"),
           JF.conv1d(_j(x1l), _j(w1), stride=2, padding="SAME", groups=2,
                     data_format="NLC"))
    x3, w3, b3 = _rand((1, 3, 5, 6, 7)), _rand((4, 3, 3, 2, 3), 1, 0.3), \
        _rand((4,), 2)
    for df in ("NCDHW", "NDHWC"):
        xin = x3 if df == "NCDHW" else np.ascontiguousarray(
            np.moveaxis(x3, 1, -1))
        _close(F.conv3d(_t(xin), _t(w3), _t(b3), stride=[1, 2, 1],
                        padding=1, data_format=df),
               JF.conv3d(_j(xin), _j(w3), _j(b3), stride=[1, 2, 1],
                         padding=1, data_format=df))


def test_nhwc_conv_keeps_channels_last_without_a_copy():
    x = torch.randn(2, 9, 9, 4)
    w = torch.randn(6, 4, 3, 3)
    out = F.conv2d(x, w, padding=1, data_format="NHWC")
    assert out.shape == (2, 9, 9, 6) and out.is_contiguous()


# --------------------------------------------------------------- pooling --

POOLS = [
    dict(kernel_size=3, stride=2, padding=1),
    dict(kernel_size=2, stride=2, padding=0),
    dict(kernel_size=3, stride=2, padding=0, ceil_mode=True),
    dict(kernel_size=[3, 2], stride=[2, 1], padding=[1, 0]),
    dict(kernel_size=3, stride=2, padding=[0, 1, 1, 2], ceil_mode=True),
    dict(kernel_size=2, stride=2, padding=[[0, 1], [1, 1]]),
    dict(kernel_size=3, stride=2, padding="SAME"),
    dict(kernel_size=3, stride=3, padding="VALID", ceil_mode=True),
    dict(kernel_size=3, stride=1, padding=2),
]


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", POOLS, ids=str)
def test_max_pool2d(kw, df):
    x = _rand((2, 3, 9, 8))
    xin = x if df == "NCHW" else _nhwc(x)
    want = JF.max_pool2d(_j(xin), data_format=df, **kw)
    got = F.max_pool2d(_t(xin), data_format=df, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


@pytest.mark.parametrize("exclusive", [True, False])
@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("kw", POOLS, ids=str)
def test_avg_pool2d(kw, df, exclusive):
    x = _rand((2, 3, 9, 8))
    xin = x if df == "NCHW" else _nhwc(x)
    want = JF.avg_pool2d(_j(xin), data_format=df, exclusive=exclusive, **kw)
    got = F.avg_pool2d(_t(xin), data_format=df, exclusive=exclusive, **kw)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_pool1d_and_pool3d():
    x1 = _rand((2, 3, 11))
    for kw in (dict(kernel_size=3, stride=2, padding=1),
               dict(kernel_size=2, stride=2, ceil_mode=True)):
        _close(F.max_pool1d(_t(x1), **kw), JF.max_pool1d(_j(x1), **kw))
        _close(F.avg_pool1d(_t(x1), **kw), JF.avg_pool1d(_j(x1), **kw))
    x3 = _rand((1, 2, 5, 6, 7))
    for df in ("NCDHW", "NDHWC"):
        xin = x3 if df == "NCDHW" else np.ascontiguousarray(
            np.moveaxis(x3, 1, -1))
        kw = dict(kernel_size=2, stride=2, padding=[0, 1, 0],
                  ceil_mode=True, data_format=df)
        _close(F.max_pool3d(_t(xin), **kw), JF.max_pool3d(_j(xin), **kw))
        _close(F.avg_pool3d(_t(xin), exclusive=False, **kw),
               JF.avg_pool3d(_j(xin), exclusive=False, **kw))


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("size", [(1, 1), (3, 4), (5, 3), 2], ids=str)
def test_adaptive_avg_pool2d(size, df):
    """Divisible (9 -> 3, 8 -> 4) and non-divisible (9 -> 5, 8 -> 3)
    bins."""
    x = _rand((2, 3, 9, 8))
    xin = x if df == "NCHW" else _nhwc(x)
    want = JF.adaptive_avg_pool2d(_j(xin), size, data_format=df)
    got = F.adaptive_avg_pool2d(_t(xin), size, data_format=df)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_adaptive_avg_pool1d_and_3d():
    x1 = _rand((2, 3, 10))
    for o in (5, 3):
        _close(F.adaptive_avg_pool1d(_t(x1), o),
               JF.adaptive_avg_pool1d(_j(x1), o))
    x3 = _rand((1, 2, 5, 6, 7))
    for df in ("NCDHW", "NDHWC"):
        xin = x3 if df == "NCDHW" else np.ascontiguousarray(
            np.moveaxis(x3, 1, -1))
        _close(F.adaptive_avg_pool3d(_t(xin), (2, 3, 4), data_format=df),
               JF.adaptive_avg_pool3d(_j(xin), (2, 3, 4), data_format=df))


def test_return_mask_waits():
    """Max pooling's ``return_mask`` no longer waits: the values and each
    maximum's index within the flattened unpadded input, as the
    reference's (``test_torch_pool_conv_extras.py`` has the other
    forms)."""
    x = _rand((1, 2, 5, 4), 7)
    want, wmask = JF.max_pool2d(_j(x), 2, 2, 1, return_mask=True)
    got, mask = F.max_pool2d(_t(x), 2, 2, 1, return_mask=True)
    _close(got, want)
    np.testing.assert_array_equal(mask.numpy(),
                                  np.asarray(wmask._data).astype(np.int64))


# ------------------------------------------------------------ batch norm --

def _bn_case(df, training, use_global_stats, dtype=None):
    x = _rand((4, 5, 3, 6), 0, 2.0) + 0.5
    xin = x if df == "NCHW" else _nhwc(x)
    mean0, var0 = _rand((5,), 1, 0.1), np.abs(_rand((5,), 2)) + 0.5
    w, b = _rand((5,), 3), _rand((5,), 4)
    jm, jv = _j(mean0), _j(var0)
    tm, tv = _t(mean0.copy()), _t(var0.copy())
    kw = dict(training=training, momentum=0.9, epsilon=1e-5,
              data_format=df, use_global_stats=use_global_stats)
    jdt = None if dtype is None else jnp.bfloat16
    want = JF.batch_norm(_j(xin, jdt), jm, jv, _j(w), _j(b), **kw)
    got = F.batch_norm(_t(xin, dtype), tm, tv, _t(w), _t(b), **kw)
    return got, want, (tm, tv), (jm, jv), (mean0, var0)


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
@pytest.mark.parametrize("training,use_global_stats",
                         [(True, None), (False, None), (True, True),
                          (False, False)])
def test_batch_norm(training, use_global_stats, df):
    got, want, (tm, tv), (jm, jv), init = _bn_case(df, training,
                                                   use_global_stats)
    _close(got, want)
    _close(tm, jm)
    _close(tv, jv)
    moved = training and use_global_stats is not True
    assert moved == (not np.array_equal(tm.numpy(), init[0]))


def test_batch_norm_running_stats_use_the_biased_variance():
    got, want, (tm, tv), _, (mean0, var0) = _bn_case("NCHW", True, None)
    x = _rand((4, 5, 3, 6), 0, 2.0) + 0.5
    bv = x.var(axis=(0, 2, 3))                       # biased
    np.testing.assert_allclose(tv.numpy(), 0.9 * var0 + 0.1 * bv,
                               rtol=1e-5)


@pytest.mark.parametrize("df", ["NCHW", "NHWC"])
def test_batch_norm_bf16_input(df):
    """bf16 statistics and normalization, promoted to fp32 by the fp32
    weight; the running statistics stay fp32."""
    got, want, (tm, tv), (jm, jv), _ = _bn_case(df, True, None,
                                                torch.bfloat16)
    assert str(want._data.dtype) == "float32" and got.dtype == torch.float32
    assert tm.dtype == torch.float32 and str(jm._data.dtype) == "float32"
    _close(got, want, BF16_TOL)
    _close(tm, jm, BF16_TOL)
    _close(tv, jv, BF16_TOL)


def test_batch_norm_layer_buffers_and_eval():
    with nn.building("cpu"):
        bn = nn.BatchNorm2D(5, data_format="NHWC")
    assert [n for n, _ in bn.named_buffers()] == ["_mean", "_variance"]
    assert [n for n, _ in bn.named_parameters()] == ["weight", "bias"]
    x = torch.randn(4, 3, 3, 5)
    bn(x)
    assert not torch.equal(bn._mean, torch.zeros(5))
    bn.eval()
    m = bn._mean.clone()
    bn(x)
    assert torch.equal(bn._mean, m)


# --------------------------------------------------------- cross entropy --

CE_CASES = [
    dict(),
    dict(reduction="sum"),
    dict(reduction="none"),
    dict(ignore_index=1),
    dict(weight=True),
    dict(weight=True, reduction="sum"),
    dict(weight=True, ignore_index=2),
    dict(label_smoothing=0.1),
    dict(label_smoothing=0.2, weight=True),
    dict(use_softmax=False),
    dict(trailing_one=True),
    dict(axis=1),
    dict(soft_label=True),
    dict(soft_label=True, label_smoothing=0.1),
    dict(soft_implicit=True),
    dict(soft_label=True, axis=1, reduction="none"),
]


@pytest.mark.parametrize("case", CE_CASES, ids=str)
def test_cross_entropy(case):
    case = dict(case)
    r = np.random.RandomState(5)
    logits = r.randn(6, 5).astype(np.float32)
    axis = case.get("axis", -1)
    soft = case.pop("soft_label", False)
    implicit = case.pop("soft_implicit", False)
    if soft or implicit:
        shape = (6, 5) if axis == -1 else (3, 5, 4)
        logits = r.randn(*shape).astype(np.float32)
        lab = r.rand(*shape).astype(np.float32)
        lab /= lab.sum(axis=axis, keepdims=True)
    else:
        lab = r.randint(0, 5, (6,)).astype(np.int64)
        lab[0] = 1
        if case.pop("trailing_one", False):
            lab = lab[:, None]
    if case.get("use_softmax") is False:
        logits = np.exp(logits) / np.exp(logits).sum(-1, keepdims=True)
    jw = tw = None
    if case.pop("weight", False):
        wv = r.rand(5).astype(np.float32) + 0.5
        jw, tw = _j(wv), _t(wv)
    want = JF.cross_entropy(_j(logits), _j(lab), weight=jw, soft_label=soft,
                            **case)
    got = F.cross_entropy(_t(logits), _t(lab), weight=tw, soft_label=soft,
                          **case)
    assert tuple(got.shape) == tuple(want.shape)
    _close(got, want)


def test_cross_entropy_gradient():
    r = np.random.RandomState(9)
    logits = r.randn(6, 5).astype(np.float32)
    lab = r.randint(0, 5, (6,)).astype(np.int64)
    t = _t(logits).requires_grad_(True)
    F.cross_entropy(t, _t(lab), label_smoothing=0.1).backward()
    jt = paddle.to_tensor(logits, stop_gradient=False)
    JF.cross_entropy(jt, _j(lab), label_smoothing=0.1).backward()
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(jt.grad._data),
                               rtol=TOL, atol=TOL)


# ----------------------------------------------- linear, flatten, relu --

def test_linear_flatten_activations():
    x, w, b = _rand((3, 4, 6)), _rand((6, 5), 1), _rand((5,), 2)
    _close(F.linear(_t(x), _t(w), _t(b)), JF.linear(_j(x), _j(w), _j(b)))
    _close(F.linear(_t(x), _t(w)), JF.linear(_j(x), _j(w)))
    for s0, s1 in ((0, -1), (1, -1), (1, 2), (0, 1)):
        got, want = flatten(_t(x), s0, s1), jflatten(_j(x), s0, s1)
        assert tuple(got.shape) == tuple(want.shape)
        _close(got, want)
    _close(F.relu(_t(x)), JF.relu(_j(x)))
    _close(F.relu6(_t(x * 5)), JF.relu6(_j(x * 5)))
    _close(F.softmax(_t(x), axis=1), JF.softmax(_j(x), axis=1))
    with nn.building("cpu"):
        lin = nn.Linear(6, 5)
    assert tuple(lin.weight.shape) == (6, 5)
    assert torch.equal(lin.bias, torch.zeros(5))
    assert nn.Flatten()(torch.zeros(2, 3, 4)).shape == (2, 12)
    assert torch.equal(nn.ReLU()(_t(x)), F.relu(_t(x)))


# ----------------------------------------------------------- initializers --

N_DRAW = 200_000


def _draw(init, shape=(400, 500), dtype=torch.float32, seed=0):
    from paddle_tpu_torch.core import rng
    rng.seed(seed)
    with nn.building("cpu"):
        return init(shape, dtype)


def test_initializer_laws():
    u = _draw(I.Uniform(-0.5, 1.5))
    assert u.min() >= -0.5 and u.max() <= 1.5
    assert abs(u.mean() - 0.5) < 0.01 and abs(u.var() - 4 / 12) < 0.01
    n = _draw(I.Normal(1.0, 2.0))
    assert abs(n.mean() - 1.0) < 0.02 and abs(n.std() - 2.0) < 0.02
    t = _draw(I.TruncatedNormal(0.5, 2.0))
    assert t.min() >= 0.5 - 4.0 and t.max() <= 0.5 + 4.0
    # the standard normal truncated to [-2, 2] has std 0.8796
    assert abs(t.mean() - 0.5) < 0.02 and abs(t.std() - 2 * 0.8796) < 0.02
    fi, fo = 500, 400                         # _fan of (400, 500)
    xu = _draw(I.XavierUniform())
    limit = math.sqrt(6.0 / (fi + fo))
    assert xu.abs().max() <= limit and xu.abs().max() > 0.99 * limit
    xn = _draw(I.XavierNormal())
    assert abs(xn.std() - math.sqrt(2.0 / (fi + fo))) < 0.002
    ku = _draw(I.KaimingUniform(), (64, 32, 3, 3))
    klimit = math.sqrt(2.0) * math.sqrt(3.0 / (32 * 9))
    assert ku.abs().max() <= klimit and ku.abs().max() > 0.99 * klimit
    kn = _draw(I.KaimingNormal(), (64, 32, 3, 3))
    assert abs(kn.std() - math.sqrt(2.0 / (32 * 9))) < 0.003
    assert torch.equal(_draw(I.Constant(0.25), (3,)), torch.full((3,), 0.25))
    with nn.building("cpu"):
        a = I.Assign(np.arange(6.0))((2, 3), "float64")
    assert a.dtype == torch.float64 and a[1, 2] == 5.0
    bf = _draw(I.Normal(), (8,), torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    # the same stream seed draws the same values
    assert torch.equal(_draw(I.Normal(), seed=3), _draw(I.Normal(), seed=3))


def test_create_parameter_order_of_initializers():
    class L(nn.Layer):
        def __init__(self, **kw):
            super().__init__()
            self.w = self.create_parameter([4], **kw)
            self.b = self.create_parameter([4], is_bias=True)

    with nn.building("cpu"):
        assert torch.equal(L().b, torch.zeros(4))
        assert torch.equal(L(default_initializer=I.Constant(2.0)).w,
                           torch.full((4,), 2.0))
        try:
            I.set_global_initializer(I.Constant(3.0), I.Constant(4.0))
            lay = L(default_initializer=I.Constant(2.0))
            assert torch.equal(lay.w, torch.full((4,), 3.0))
            assert torch.equal(lay.b, torch.full((4,), 4.0))
            assert torch.equal(L(attr=I.Constant(5.0)).w,
                               torch.full((4,), 5.0))
        finally:
            I.set_global_initializer(None)
        assert I.get_global_initializer() == (None, None)


def test_conv_and_linear_initial_bounds():
    with nn.building("cpu"):
        conv = nn.Conv2D(16, 32, 3, groups=2)
        assert conv.weight.shape == (32, 8, 3, 3)
        assert conv.weight.abs().max() <= 1 / math.sqrt(8 * 9)
        assert torch.equal(conv.bias, torch.zeros(32))
        assert nn.Conv2D(16, 32, 3, bias_attr=False).bias is None


def test_building_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    from paddle_tpu_torch.vision.models import LeNet, resnet18

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        nn.building().__enter__()
    # a layer built outside a scope goes to the card too: its parameters
    # (Linear, Conv2D) and its buffers (BatchNorm) never land on the CPU
    for make in (lambda: nn.Linear(4, 4), lambda: nn.Conv2D(3, 4, 3),
                 lambda: nn.BatchNorm2D(4, weight_attr=False,
                                        bias_attr=False),
                 lambda: LeNet(), lambda: resnet18(num_classes=10)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()


@pytest.mark.parametrize("make", ["linear", "batch_norm", "lenet"])
def test_models_follow_the_scope_and_torch_manual_seed(make):
    """Parameters and buffers land on the innermost scope's device (a
    model's ``device=None`` inherits it), drawn from ``core.rng``'s
    stream: ``paddle_tpu_torch.seed`` repeats the draws, as
    ``paddle.seed`` does for the reference (``torch.manual_seed`` no
    longer plays a part)."""
    import paddle_tpu_torch as pt
    from paddle_tpu_torch.vision.models import LeNet

    build = {"linear": lambda: nn.Linear(6, 5),
             "batch_norm": lambda: nn.BatchNorm1D(5),
             "lenet": lambda: LeNet()}[make]

    def state(seed):
        pt.seed(seed)
        torch.manual_seed(0)
        with nn.building("cpu"):
            m = build()
        return {n: t.clone() for n, t in m.state_dict().items()}

    a, b, c = state(5), state(5), state(6)
    assert all(t.device.type == "cpu" for t in a.values())
    assert all(torch.equal(a[n], b[n]) for n in a)
    drawn = [n for n in a if not torch.equal(a[n], c[n])]
    assert bool(drawn) == (make != "batch_norm"), drawn


# --------------------------------------------------------- names, shapes --

def _shapes(named):
    return {n: tuple(int(d) for d in t.shape) for n, t in named}


@pytest.mark.parametrize("model", ["resnet50", "LeNet"])
def test_parameter_and_buffer_names_equal_the_reference(model):
    from paddle_tpu.vision import models as jm
    from paddle_tpu_torch.vision import models as tm
    kw = {"data_format": "NHWC"} if model == "resnet50" else {}
    paddle.seed(0)
    ref = getattr(jm, model)(**kw)
    port = getattr(tm, model)(device="cpu", **kw)
    rp, tp = _shapes(ref.named_parameters()), _shapes(port.named_parameters())
    rb, tb = _shapes(ref.named_buffers()), _shapes(port.named_buffers())
    assert list(rp) == list(tp) and rp == tp
    assert list(rb) == list(tb) and rb == tb
    want = {"resnet50": (161, 25_557_032, 106),
            "LeNet": (10, 61_610, 0)}[model]
    assert (len(tp), sum(math.prod(s) for s in tp.values()), len(tb)) == want


def test_params_from_numpy_raises_on_any_mismatch():
    from paddle_tpu_torch.vision.models import LeNet, params_from_numpy
    m = LeNet(device="cpu")
    good = {n: p.detach().numpy() * 0 + 1 for n, p in m.named_parameters()}
    params_from_numpy(m, good, {})
    assert all(torch.all(p == 1) for p in m.parameters())
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(m, {k: v for k, v in good.items()
                              if k != "fc.0.bias"})
    with pytest.raises(ValueError, match="unexpected"):
        params_from_numpy(m, dict(good, extra=np.zeros(1)))
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(m, dict(good, **{"fc.0.weight": np.zeros((120,
                                                                     400))}))


# -------------------------------------------------------- import boundary --

def test_port_imports_no_jax_and_nothing_of_the_reference():
    pat = re.compile(r"^\s*(import|from)\s+(jax|paddle_tpu\b)")
    files = sorted((REPO / "paddle_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "flash_ab.py"]
    bad = [f"{f.relative_to(REPO)}:{i}: {line.strip()}"
           for f in files if f.exists()
           for i, line in enumerate(f.read_text().splitlines(), 1)
           if pat.match(line)]
    assert not bad, bad

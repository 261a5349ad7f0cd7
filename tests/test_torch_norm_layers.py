"""The normalization functionals and layers of ``paddle_tpu_torch.nn``
(``layer_norm``, ``instance_norm``, ``group_norm``,
``local_response_norm``, ``normalize``; ``LayerNorm``, ``GroupNorm``,
``InstanceNorm1D/2D/3D``, ``LocalResponseNorm``, ``SpectralNorm`` and
``SyncBatchNorm``) against ``paddle_tpu.nn`` on the same numpy inputs.

fp32 outputs and the gradients of ``sum(out * g)`` (input, weight, bias)
within 1e-5; bf16 inputs within 2e-2 (the bf16 tier) in the reference's
dtypes (an fp32 weight promotes, except in ``layer_norm``).  The reference's gradients come from ``jax.grad`` of its
functionals and of its layers through ``functionalize``.  Also:
``SpectralNorm``'s power-iteration buffers through the one-device and
one-rank steps (advanced clones under ``donate=False``, given back under
accumulation, as the reference's ``functionalize`` returns them), the
conversion to ``SyncBatchNorm`` (names, buffers and layer types as the
reference's), and the mesh step's refusals that name ROADMAP A7b item 8.
"""

import gc
import types

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
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.distributed import spmd
from paddle_tpu_torch.distributed.topology import ProcessMesh
from paddle_tpu_torch.jit.functional import make_train_step
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.optimizer import SGD
from paddle_tpu_torch.vision.models import params_from_numpy

TOL = 1e-5
BF16_TOL = 2e-2


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _rand(shape, seed=0, scale=1.0, shift=0.0):
    return (np.random.RandomState(seed).randn(*shape) * scale
            + shift).astype(np.float32)


def _t(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


# name: (port functional call, reference functional call, x shape,
#        weight/bias shape or None)
FUNCS = {
    "layer_norm_2d": (lambda f, x, w, b: f.layer_norm(x, [5, 6], w, b),
                      (3, 5, 6), (5, 6)),
    "layer_norm_int": (lambda f, x, w, b: f.layer_norm(x, 6, w, b, 1e-3),
                       (4, 6), (6,)),
    "instance_norm_nchw": (lambda f, x, w, b: f.instance_norm(
        x, weight=w, bias=b), (2, 3, 5, 4), (3,)),
    "instance_norm_nhwc": (lambda f, x, w, b: f.instance_norm(
        x, weight=w, bias=b, data_format="NHWC"), (2, 5, 4, 3), (3,)),
    "instance_norm_ncl": (lambda f, x, w, b: f.instance_norm(
        x, weight=w, bias=b, data_format="NCL"), (2, 3, 7), (3,)),
    "group_norm_nchw": (lambda f, x, w, b: f.group_norm(x, 3, 1e-5, w, b),
                        (2, 6, 4, 4), (6,)),
    "group_norm_nhwc": (lambda f, x, w, b: f.group_norm(
        x, 2, 1e-5, w, b, data_format="NHWC"), (2, 4, 3, 6), (6,)),
    "lrn_odd": (lambda f, x, w, b: f.local_response_norm(x, 3, 1e-2, 0.75,
                                                         1.0), (2, 7, 4, 4),
                None),
    "lrn_even_nhwc": (lambda f, x, w, b: f.local_response_norm(
        x, 4, 1e-2, 0.6, 2.0, data_format="NHWC"), (2, 4, 4, 7), None),
    "normalize_l2": (lambda f, x, w, b: f.normalize(x), (3, 5, 2), None),
    "normalize_l1_last": (lambda f, x, w, b: f.normalize(x, 1, -1),
                          (3, 5, 2), None),
}


def _inputs(name):
    _, shape, wshape = FUNCS[name]
    x = _rand(shape, 1, 2.0, 0.5)
    g = _rand(shape, 2)
    wb = (None, None) if wshape is None else (_rand(wshape, 3, 0.5, 1.0),
                                              _rand(wshape, 4, 0.5))
    return x, g, wb


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functional_fp32_forward_and_gradients(name):
    fn = FUNCS[name][0]
    x, g, (w, b) = _inputs(name)
    has_w = w is not None

    def ref(x, w, b):
        out = fn(JF, Tensor(x), Tensor(w) if has_w else None,
                 Tensor(b) if has_w else None)._data
        return jnp.sum(out * g), out

    (_, want), grads = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1, 2) if has_w else (0,), has_aux=True))(
            jnp.asarray(x), jnp.asarray(w) if has_w else None,
            jnp.asarray(b) if has_w else None)
    tx = _t(x, True)
    tw, tb = (_t(w, True), _t(b, True)) if has_w else (None, None)
    out = fn(F, tx, tw, tb)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    for got, w_ in zip([tx, tw, tb], grads):
        np.testing.assert_allclose(got.grad.numpy(), np.asarray(w_),
                                   rtol=TOL, atol=TOL)


@pytest.mark.parametrize("name", sorted(FUNCS))
def test_functional_bf16_follows_the_reference_dtypes(name):
    fn = FUNCS[name][0]
    x, _, (w, b) = _inputs(name)
    has_w = w is not None
    want = jax.jit(lambda x, w, b: fn(
        JF, Tensor(x), *((Tensor(w), Tensor(b)) if has_w
                         else (None, None)))._data)(
        jnp.asarray(x, jnp.bfloat16), w, b)
    got = fn(F, _t(x).bfloat16(), *((_t(w), _t(b)) if has_w
                                    else (None, None)))
    # a float32 weight promotes, as in the reference (not layer_norm's)
    assert str(got.dtype) == f"torch.{want.dtype}"
    assert (got.dtype == torch.bfloat16) == (not has_w or "layer" in name)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


# ---------------------------------------------------------------- layers --

# name: (constructor arguments, input shape)
LAYERS = {
    "LayerNorm": (([4, 5],), (3, 4, 5)),
    "GroupNorm": ((2, 6), (2, 6, 3, 3)),
    "InstanceNorm1D": ((3,), (2, 3, 8)),
    "InstanceNorm2D": ((3,), (2, 3, 4, 5)),
    "InstanceNorm3D": ((3,), (2, 3, 2, 3, 4)),
    "LocalResponseNorm": ((5,), (2, 6, 3, 3)),
}


@pytest.mark.parametrize("name", sorted(LAYERS) + ["SpectralNorm"])
def test_layer_names_forward_and_gradients(name):
    """The port's layer with the reference's names takes the reference's
    weights (perturbed from their constant inits) and gives its output,
    its gradients and, for ``SpectralNorm``, its advanced u and v."""
    if name == "SpectralNorm":
        args, shape = ([4, 6], 1, 2), (4, 6)
    else:
        args, shape = LAYERS[name]
    paddle.seed(3)
    jlayer = getattr(jnn, name)(*args)
    apply_fn, jp, jb = jf.functionalize(jlayer)
    params = {n: np.asarray(v) + _rand(v.shape, 7, 0.1) for n, v in
              jp.items()}
    buffers = {n: np.asarray(v) for n, v in jb.items()}
    with nn.building("cpu"):
        layer = getattr(nn, name)(*args)
    assert [n for n, _ in layer.named_parameters()] == list(jp)
    assert [n for n, _ in layer.named_buffers()] == list(jb)
    params_from_numpy(layer, params, buffers)
    x = _rand(shape, 5, 1.5, 0.3)
    g = _rand(shape, 6)

    def ref(p, x):
        out, nb = apply_fn(p, buffers, x, training=True)
        return jnp.sum(out * g), (out, nb)

    (_, (want, new_b)), (gp, gx) = jax.jit(jax.value_and_grad(
        ref, argnums=(0, 1), has_aux=True))(
            {n: jnp.asarray(v) for n, v in params.items()}, jnp.asarray(x))
    tx = _t(x, True)
    out = layer(tx)
    (out * _t(g)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), rtol=TOL,
                               atol=TOL)
    for n, p in layer.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), np.asarray(gp[n]),
                                   rtol=TOL, atol=TOL, err_msg=n)
    for n, b in layer.named_buffers():
        np.testing.assert_allclose(b.numpy(), np.asarray(new_b[n]), rtol=TOL,
                                   atol=TOL, err_msg=n)


@pytest.mark.parametrize("name", sorted(LAYERS) + ["SpectralNorm"])
def test_layer_bf16_input_follows_the_reference_dtypes(name):
    """A bf16 input through each layer with its fp32 weights (and, for
    ``SpectralNorm``, its fp32 u and v): the reference's output dtype
    and values within the bf16 tier."""
    if name == "SpectralNorm":
        args, shape = ([4, 6], 1, 2), (4, 6)
    else:
        args, shape = LAYERS[name]
    x = _rand(shape, 5)
    paddle.seed(3)
    apply_fn, jp, jb = jf.functionalize(getattr(jnn, name)(*args))
    want, _ = jax.jit(lambda p, b, a: apply_fn(p, b, a, training=True))(
        jp, jb, jnp.asarray(x, jnp.bfloat16))
    with nn.building("cpu"):
        layer = getattr(nn, name)(*args)
    params_from_numpy(layer, {n: np.asarray(v) for n, v in jp.items()},
                      {n: np.asarray(v) for n, v in jb.items()})
    got = layer(_t(x).bfloat16())
    assert str(got.dtype) == f"torch.{want.dtype}"
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want.astype(jnp.float32)),
                               rtol=BF16_TOL, atol=BF16_TOL)


# ------------------------------------------- SpectralNorm through a step --

def _sn_nets():
    """A linear map whose weight goes through ``SpectralNorm`` (power
    iterations 2), in both packages, with the reference's weights."""
    class JNet(jnn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([5, 3])
            self.sn = jnn.SpectralNorm([5, 3], 0, 2)

        def forward(self, x):
            return paddle.matmul(x, self.sn(self.weight))

    class TNet(nn.Layer):
        def __init__(self):
            super().__init__()
            self.weight = self.create_parameter([5, 3])
            self.sn = nn.SpectralNorm([5, 3], 0, 2)

        def forward(self, x):
            return x @ self.sn(self.weight)

    paddle.seed(9)
    jnet = JNet()
    _, jp, jb = jf.functionalize(jnet)
    with nn.building("cpu"):
        tnet = params_from_numpy(TNet(), {n: np.asarray(v) for n, v in
                                          jp.items()},
                                 {n: np.asarray(v) for n, v in jb.items()})
    return jnet, tnet, {n: np.asarray(v) for n, v in jb.items()}


def _mse(o, y):
    return ((o - y) ** 2).mean()


def _sn_batch():
    r = np.random.RandomState(2)
    return (r.randn(8, 5).astype(np.float32),
            r.randn(8, 3).astype(np.float32))


@pytest.mark.parametrize("accumulate", [1, 2])
def test_spectral_norm_buffers_through_the_steps(accumulate):
    """One device (``make_train_step``, kept) and a one-rank mesh
    (``make_spmd_train_step``): the forward advances clones of the
    state's u and v and returns them, as the reference's functionalize
    returns its new buffers; under accumulation the given ones come back
    (the reference's ``new_b = state["buffers"]``).  The layer's own u and
    v are never written."""
    from paddle_tpu.distributed import make_spmd_train_step as jmake
    from paddle_tpu.distributed.topology import HybridCommunicateGroup
    from paddle_tpu.optimizer import SGD as JSGD
    jnet, tnet, b0 = _sn_nets()
    x, y = _sn_batch()
    key = np.array([0, 3], np.uint32)
    jstep, jst, _ = jmake(jnet, lambda o, t: jnp.mean((o._data - t._data)
                                                       ** 2),
                          JSGD(0.1), HybridCommunicateGroup(dp_degree=1),
                          accumulate_steps=accumulate, donate=False)
    hcg = types.SimpleNamespace(mesh=ProcessMesh(["data"], [1]))
    step, st, _ = spmd.make_spmd_train_step(tnet, _mse, SGD(0.1), hcg,
                                            accumulate_steps=accumulate,
                                            donate=False)
    steps = [(step, st)]
    if accumulate == 1:
        steps.append(make_train_step(tnet, _mse, SGD(0.1), donate=False))
    for i in range(2):
        jst, jloss = jstep(jst, jnp.asarray(key), np.float32(0.1),
                           [jnp.asarray(x)], [jnp.asarray(y)])
        for k, (s, state) in enumerate(steps):
            state, loss = s(state, key, 0.1, [_t(x)], [_t(y)])
            steps[k] = (s, state)
            loss = loss[0] if isinstance(loss, tuple) else loss
            np.testing.assert_allclose(float(loss), float(jloss), rtol=TOL)
            for n, v in state["buffers"].items():
                np.testing.assert_allclose(v.numpy(),
                                           np.asarray(jst["buffers"][n]),
                                           rtol=TOL, atol=TOL, err_msg=n)
            for n, v in state["params"].items():
                np.testing.assert_allclose(v.detach().numpy(),
                                           np.asarray(jst["params"][n]),
                                           rtol=TOL, atol=TOL, err_msg=n)
    moved = not np.allclose(np.asarray(jst["buffers"]["sn.weight_u"]),
                            b0["sn.weight_u"])
    assert moved == (accumulate == 1)
    for n, b in tnet.named_buffers():
        np.testing.assert_array_equal(b.numpy(), b0[n])


# ------------------------------------------------------- SyncBatchNorm --

def test_convert_sync_batchnorm_names_and_buffers_as_the_reference():
    from test_torch_vision_families import reference_shell
    jm = reference_shell(lambda: jnn.Sequential(
        jnn.Conv2D(3, 4, 3), jnn.BatchNorm2D(4),
        jnn.Sequential(jnn.Linear(4, 4), jnn.BatchNorm1D(4))))
    _, jp, jb = jf.functionalize(jm)
    with nn.building("cpu"):
        tm = nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                           nn.Sequential(nn.Linear(4, 4), nn.BatchNorm1D(4)))
    params_from_numpy(tm, {n: _rand(v.shape, 1) for n, v in jp.items()},
                      {n: _rand(v.shape, 2) for n, v in jb.items()})
    own = dict(tm.named_buffers())
    weight = tm[1].weight
    assert nn.SyncBatchNorm.convert_sync_batchnorm(tm) is tm
    jnn.SyncBatchNorm.convert_sync_batchnorm(jm)
    _, jp2, jb2 = jf.functionalize(jm)
    assert [n for n, _ in tm.named_parameters()] == list(jp2)
    assert [n for n, _ in tm.named_buffers()] == list(jb2)
    assert [type(m).__name__ for m in tm.modules()][1:] == \
        [type(m).__name__ for m in jm.sublayers()]
    assert tm[1].weight is weight and tm[1]._data_format == "NCHW"
    assert all(b is own[n] for n, b in tm.named_buffers())
    x = _rand((2, 4, 5, 5), 3)
    with torch.no_grad():
        want = F.batch_norm(_t(x), own["1._mean"].clone(),
                            own["1._variance"].clone(), weight, tm[1].bias,
                            training=True)
    torch.testing.assert_close(tm[1](_t(x)), want, rtol=0, atol=0)


# ------------------------------------------------------------ refusals --

def test_batch_norm_over_sep_split_rows_refuses():
    """Rows split over the sep ranks too: a batch norm's statistics over
    the batch ranks would miss the sequence's other chunks."""
    with nn.building("cpu"):
        bn = nn.BatchNorm1D(4, data_format="NLC")
    params = dict(bn.named_parameters())
    mesh = ProcessMesh(["sep"], [2])
    step, state = spmd.make_gspmd_step_from_loss(
        lambda p, x: bn(x).sum(), params, SGD(0.1), mesh, layer=bn,
        seq_dim=1)
    with pytest.raises(NotImplementedError, match="A7b item 8"):
        step(state, 0.1, torch.ones(2, 4, 4))


def test_a_pipeline_step_batch_norm_refuses():
    """A pipeline stage sees one rank's micro-batch: over more than one
    rank a batch norm in training mode raises, before any collective,
    naming ROADMAP A7b item 8 (its draws raise there too)."""
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        parallel_layers as pp
    from paddle_tpu_torch.distributed.pipeline_engine import \
        make_pipeline_train_step

    def mse(o, y):
        return ((o - y) ** 2).mean()
    with nn.building("cpu"):
        layer = pp.PipelineLayer([pp.LayerDesc(nn.Linear, 4, 8),
                                  pp.LayerDesc(nn.BatchNorm1D, 8),
                                  pp.LayerDesc(nn.Linear, 8, 2)],
                                 loss_fn=mse)
    hcg = types.SimpleNamespace(mesh=ProcessMesh(["data"], [2]))
    step, state = make_pipeline_train_step(layer, mse, SGD(0.1), hcg)
    with pytest.raises(NotImplementedError, match="A7b item 8"):
        step(state, np.array([0, 1], np.uint32), 0.1, [torch.ones(4, 4)],
             [torch.zeros(4, 2)])


def test_a_draw_not_over_the_rows_refuses():
    """Inside a step over the batch ranks a draw whose dim 0 is not this
    rank's rows (a multiple of them too: a sequence-first layout) is not
    known to be one counter range; a mask broadcast over the batch is
    the whole global mask."""
    key = np.array([0, 1], np.uint32)
    with rng.row_block(1, 3):
        with rng.rng_scope(key):
            for rows in (4, 6, 1):
                with pytest.raises(NotImplementedError, match="A7b item 8"):
                    F.dropout(torch.ones(rows, 2), 0.5)
            assert F.dropout(torch.ones(3, 2), 0.5).shape == (3, 2)
        with rng.rng_scope(key):
            got = F.dropout(torch.ones(3, 2), 0.5, axis=1)
    with rng.rng_scope(key):
        want = F.dropout(torch.ones(3, 2), 0.5, axis=1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)

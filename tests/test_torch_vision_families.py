"""Every block class of eight vision families (AlexNet, VGG, SqueezeNet,
MobileNet V1/V2, GoogLeNet, InceptionV3, DenseNet, ShuffleNetV2) against
the reference's, from the same weights and running statistics on the
same numpy input, in float64 and training mode: the output, the gradient
of ``mean(out**2)`` by every parameter and the running statistics after
the forward, within ``rtol=1e-8, atol=1e-8``, at B 2 and 8x8-12x12
pixels.

The reference runs jitted (``functionalize`` + ``jax.value_and_grad``),
never eagerly; its block is built under ``jax.eval_shape``, which traces
its initializers instead of running them (an eager build of an
inception block costs seconds of op-by-op dispatch), and then takes the
port's weights.  A ``_DenseLayer`` with dropout draws its mask from the
same key in both (``rng_key`` there, ``rng_scope`` here).
"""

import gc
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.core import rng as jrng
from paddle_tpu.jit import functional as jf
from paddle_tpu.vision.models import _utils as j_utils
from paddle_tpu.vision.models import densenet as j_densenet
from paddle_tpu.vision.models import inceptionv3 as j_inceptionv3
from paddle_tpu.vision.models import mobilenet as j_mobilenet
from paddle_tpu.vision.models import shufflenetv2 as j_shufflenetv2
from paddle_tpu.vision.models import squeezenet as j_squeezenet
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.vision.models import _utils as t_utils
from paddle_tpu_torch.vision.models import densenet as t_densenet
from paddle_tpu_torch.vision.models import inceptionv3 as t_inceptionv3
from paddle_tpu_torch.vision.models import mobilenet as t_mobilenet
from paddle_tpu_torch.vision.models import params_from_numpy
from paddle_tpu_torch.vision.models import shufflenetv2 as t_shufflenetv2
from paddle_tpu_torch.vision.models import squeezenet as t_squeezenet

# the package exports a function named after this module
j_googlenet = importlib.import_module("paddle_tpu.vision.models.googlenet")
t_googlenet = importlib.import_module(
    "paddle_tpu_torch.vision.models.googlenet")

RTOL = ATOL = 1e-8
KEY = np.array([0, 17], np.uint32)

# name: (module pair, class name, constructor arguments, input shape)
BLOCKS = {
    "ConvBNReLU": ((j_utils, t_utils), "ConvBNReLU", (6, 8, 3, 2, 1),
                   (2, 6, 12, 12)),
    "Fire": ((j_squeezenet, t_squeezenet), "_Fire", (16, 4, 8, 8),
             (2, 16, 10, 10)),
    "DepthwiseSeparable": ((j_mobilenet, t_mobilenet), "DepthwiseSeparable",
                           (8, 8, 16, 2), (2, 8, 12, 12)),
    "InvertedResidual_res": ((j_mobilenet, t_mobilenet), "InvertedResidual",
                             (8, 8, 1, 6), (2, 8, 10, 10)),
    "InvertedResidual_s2": ((j_mobilenet, t_mobilenet), "InvertedResidual",
                            (8, 16, 2, 1), (2, 8, 10, 10)),
    "Inception": ((j_googlenet, t_googlenet), "_Inception",
                  (16, 4, 4, 8, 2, 4, 4), (2, 16, 8, 8)),
    "InceptionA": ((j_inceptionv3, t_inceptionv3), "_InceptionA", (16, 8),
                   (2, 16, 8, 8)),
    "InceptionB": ((j_inceptionv3, t_inceptionv3), "_InceptionB", (16,),
                   (2, 16, 9, 9)),
    "InceptionC": ((j_inceptionv3, t_inceptionv3), "_InceptionC", (16, 8),
                   (2, 16, 8, 8)),
    "InceptionD": ((j_inceptionv3, t_inceptionv3), "_InceptionD", (16,),
                   (2, 16, 9, 9)),
    "InceptionE": ((j_inceptionv3, t_inceptionv3), "_InceptionE", (16,),
                   (2, 16, 8, 8)),
    "DenseLayer_dropout": ((j_densenet, t_densenet), "_DenseLayer",
                           (16, 8, 4, 0.3), (2, 16, 8, 8)),
    "Transition": ((j_densenet, t_densenet), "_Transition", (16, 8),
                   (2, 16, 8, 8)),
    "ShuffleUnit_s1_relu": ((j_shufflenetv2, t_shufflenetv2),
                            "_InvertedResidual", (16, 16, 1, "relu"),
                            (2, 16, 8, 8)),
    "ShuffleUnit_s2_relu": ((j_shufflenetv2, t_shufflenetv2),
                            "_InvertedResidual", (16, 32, 2, "relu"),
                            (2, 16, 8, 8)),
    "ShuffleUnit_s1_swish": ((j_shufflenetv2, t_shufflenetv2),
                             "_InvertedResidual", (16, 16, 1, "swish"),
                             (2, 16, 8, 8)),
    "ShuffleUnit_s2_swish": ((j_shufflenetv2, t_shufflenetv2),
                             "_InvertedResidual", (16, 32, 2, "swish"),
                             (2, 16, 8, 8)),
}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    """Drop this module's JAX arrays when it ends: a later module in the
    same process ranks the live JAX arrays (the reference's memory
    forensics), and these would crowd out its own."""
    yield
    gc.collect()


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU ops on one thread, then restore the count: with
    several test workers each spreading tiny float64 ops (depthwise
    convolutions, a group at a time) over every core, OpenMP's barriers
    made one 1-second MobileNet step run for minutes."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def reference_shell(ctor):
    """The reference layer ``ctor()`` built under ``jax.eval_shape``: its
    parameters and buffers are placeholders until the caller sets them.
    The reference's RNG streams are left as they were."""
    box, saved = [], jrng.get_rng_state()

    def build():
        box.append(ctor())
        return 0

    try:
        jax.eval_shape(build)
    finally:
        jrng.set_rng_state(saved)
    return box[0]


def numpy_state(layer):
    return ({n: p.detach().numpy().copy() for n, p in
             layer.named_parameters()},
            {n: b.detach().numpy().copy() for n, b in layer.named_buffers()})


def set_reference_state(layer, params, buffers):
    """Give a reference layer the port's weights, as jax arrays of their
    own dtype (float64 under ``jax_enable_x64``)."""
    for n, p in layer.named_parameters():
        p._data = jnp.asarray(params[n])
    for n, b in layer.named_buffers():
        b._data = jnp.asarray(buffers[n])


@pytest.mark.parametrize("name", sorted(BLOCKS))
def test_block_float64_forward_gradients_and_statistics(name):
    (jmod, tmod), cls, args, shape = BLOCKS[name]
    torch.manual_seed(3)
    with nn.building("cpu"):
        tblk = getattr(tmod, cls)(*args).double()
    params, buffers = numpy_state(tblk)
    jblk = reference_shell(lambda: getattr(jmod, cls)(*args))
    x = np.random.RandomState(4).randn(*shape)
    draws = name.endswith("dropout")
    jax.config.update("jax_enable_x64", True)
    try:
        set_reference_state(jblk, params, buffers)
        apply_fn, p64, b64 = jf.functionalize(jblk)

        def loss(p):
            out, nb = apply_fn(p, b64, jnp.asarray(x), training=True,
                               rng_key=jnp.asarray(KEY) if draws else None)
            return jnp.mean(out ** 2), (out, nb)

        (jloss, (jout, jbuf)), jgrad = jax.jit(
            jax.value_and_grad(loss, has_aux=True))(p64)
        want = (float(jloss), np.asarray(jout),
                {k: np.asarray(v) for k, v in jgrad.items()},
                {k: np.asarray(v) for k, v in jbuf.items()})
    finally:
        jax.config.update("jax_enable_x64", False)
    tblk.train()
    with rng.rng_scope(KEY):
        out = tblk(torch.from_numpy(x))
    tloss = (out ** 2).mean()
    tloss.backward()
    if draws:           # the mask zeroed part of the dropout's output
        new = out[:, args[0]:]
        assert 0 < int((new == 0).sum()) < new.numel()
    np.testing.assert_allclose(float(tloss.detach()), want[0], rtol=RTOL)
    np.testing.assert_allclose(out.detach().numpy(), want[1], rtol=RTOL,
                               atol=ATOL)
    assert set(want[2]) == {n for n, _ in tblk.named_parameters()}
    for n, p in tblk.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), want[2][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)
    for n, b in tblk.named_buffers():
        np.testing.assert_allclose(b.numpy(), want[3][n], rtol=RTOL,
                                   atol=ATOL, err_msg=n)


def test_params_from_numpy_loads_a_block_by_the_reference_names():
    """A port block loads the reference's names as they are; the block
    built here and the shell built there share every name and shape."""
    (jmod, tmod), cls, args, _ = BLOCKS["InceptionE"]
    jblk = reference_shell(lambda: getattr(jmod, cls)(*args))
    _, jp, jb = jf.functionalize(jblk)
    with nn.building("cpu"):
        tblk = getattr(tmod, cls)(*args)
    params = {n: np.full(v.shape, 0.5, np.float32) for n, v in jp.items()}
    buffers = {n: np.full(v.shape, 2.0, np.float32) for n, v in jb.items()}
    params_from_numpy(tblk, params, buffers)
    assert all(torch.all(p == 0.5) for p in tblk.parameters())
    assert all(torch.all(b == 2.0) for b in tblk.buffers())

"""Port parity for the pipeline layers
(``paddle_tpu_torch/distributed/fleet/meta_parallel/parallel_layers/
pp_layers.py`` ``LayerDesc``, ``SharedLayerDesc``, ``SegmentLayers``,
``PipelineLayer``; ``fleet.meta_parallel.PipelineParallel``) against the
JAX package's.

``SegmentLayers`` gives the reference's boundaries, uniformly and by a
class-name pattern.  A five-layer model (a shared 8 x 8 ``Linear`` at both
ends, ``Linear`` 8 -> 16, ``ReLU``, ``Linear`` 16 -> 8; mean squared
error) is trained for 3 steps by ``PipelineParallel.train_batch`` with 2
micro-batches (``strategy.pipeline_configs``), AdamW, on pp 2 (with and
without a global-norm clip) and dp 2 x pp 2 gloo ranks: each rank holds
only its stage's layers (the shared one on both stages, under its first
position's name), and its losses and parameters are held within 1e-5 of
the reference's ``train_batch`` (which runs the stages serially under
GSPMD); ``eval_batch`` then gives the trained model's loss on every rank.
The spawned ranks import this module, so it imports no JAX at its top.
"""

import datetime
import functools
import gc
import os
import pickle
import sys

import numpy as np
import pytest
import torch

B, STEPS, LR, CLIP = 4, 3, 1e-2, 0.5
TOL = dict(rtol=1e-5, atol=1e-5)
ARMS = {"pp2": ({"pp_degree": 2}, False), "pp2_clip": ({"pp_degree": 2}, True),
        "dp2_pp2": ({"dp_degree": 2, "pp_degree": 2}, False)}
WORLD = {"pp2": 2, "pp2_clip": 2, "dp2_pp2": 4}


def _descs(nn, pp):
    return [pp.SharedLayerDesc("w", nn.Linear, None, "weight", 8, 8),
            pp.LayerDesc(nn.Linear, 8, 16), pp.LayerDesc(nn.ReLU),
            pp.LayerDesc(nn.Linear, 16, 8),
            pp.SharedLayerDesc("w", nn.Linear, None, "weight", 8, 8)]


def _mse(out, y):
    d = out - y
    return (d * d).mean()


def _batch():
    r = np.random.RandomState(0)
    return r.randn(B, 8).astype(np.float32), r.randn(B, 8).astype(np.float32)


def _strategy(fleet, hc):
    st = fleet.DistributedStrategy()
    st.hybrid_configs = {"dp_degree": 1, "mp_degree": 1, **hc}
    st.pipeline_configs = {"accumulate_steps": 2, "micro_batch_size": 1}
    return st


# ------------------------------------------------------- the port side --

def _port_arm(name, init):
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed import fleet
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        parallel_layers as pp
    import paddle_tpu_torch.optimizer as TO
    hc, clip = ARMS[name]
    fleet.init(is_collective=True, strategy=_strategy(fleet, hc))
    with nn.building("cpu"):
        layer = pp.PipelineLayer(_descs(nn, pp), loss_fn=_mse)
    with torch.no_grad():
        for n, p in layer.named_parameters():
            p.copy_(torch.from_numpy(init[n]))
    model = fleet.distributed_model(layer)
    opt = TO.AdamW(LR, grad_clip=nn.ClipGradByGlobalNorm(CLIP) if clip
                   else None)
    x, y = (torch.from_numpy(a) for a in _batch())
    losses = [float(model.train_batch(([x], [y]), opt))
              for _ in range(STEPS)]
    return {"losses": losses, "type": type(model).__name__,
            "params": {n: p.detach().numpy().copy()
                       for n, p in layer.named_parameters()},
            "segments": layer.segment_parts,
            "eval": float(model.eval_batch((x, y)))}


def _rank_main(rank, world, tmp, init, arms):
    torch.set_num_threads(1)
    from paddle_tpu_torch.distributed import env
    env.init_parallel_env(backend="gloo", init_method=f"file://{tmp}/rdv",
                          rank=rank, world_size=world,
                          timeout=datetime.timedelta(seconds=120))
    assert "jax" not in sys.modules
    out = {n: _port_arm(n, init) for n in arms}
    assert "jax" not in sys.modules
    with open(os.path.join(tmp, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)
    from paddle_tpu_torch.distributed.collective import destroy_process_group
    destroy_process_group()


def _start(world, tmp, init, arms):
    import torch.multiprocessing as mp
    ctx = mp.start_processes(_rank_main, args=(world, str(tmp), init, arms),
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


# -------------------------------------------------------- the JAX side --

def _jax_layer(hc):
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed import fleet
    from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import \
        pp_layers
    fleet.fleet.init(is_collective=True, strategy=_strategy(fleet, hc))
    paddle.seed(7)
    return pp_layers.PipelineLayer(_descs(jnn, pp_layers), loss_fn=_mse)


def _jax_init():
    import jax
    return {n: np.asarray(jax.device_get(p._data))
            for n, p in _jax_layer({"pp_degree": 2}).named_parameters()}


@functools.lru_cache(maxsize=None)
def _jax_arm(name):
    import jax
    import paddle_tpu as paddle
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed import fleet
    hc, clip = ARMS[name]
    layer = _jax_layer(hc)
    model = fleet.fleet.distributed_model(layer)
    opt = paddle.optimizer.AdamW(
        learning_rate=LR, parameters=layer.parameters(),
        grad_clip=jnn.ClipGradByGlobalNorm(CLIP) if clip else None)
    x, y = _batch()
    losses = [float(model.train_batch(([x], [y]), opt))
              for _ in range(STEPS)]
    params = {n: np.asarray(jax.device_get(v))
              for n, v in model._state["params"].items()}
    return losses, params, layer.segment_parts


def _numpy_loss(p):
    x, y = _batch()

    def lin(h, i):
        return h @ p[f"stages.{i}.weight"] + p[f"stages.{i}.bias"]
    h = lin(np.maximum(lin(lin(x, 0), 1), 0), 3)
    return float(np.mean((lin(h, 0) - y) ** 2))


# ------------------------------------------------------------ fixtures --

@pytest.fixture(scope="module")
def init():
    return _jax_init()


@pytest.fixture(scope="module")
def started(init, tmp_path_factory):
    out = {}
    for world in (2, 4):
        arms = [n for n in ARMS if WORLD[n] == world]
        out[world] = _start(world, tmp_path_factory.mktemp(f"ppl{world}"),
                            init, arms)
    return out


@pytest.fixture(scope="module")
def ranks(started):
    return {w: _finish(s) for w, s in started.items()}


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    _jax_arm.cache_clear()
    gc.collect()


# --------------------------------------------------------------- tests --

@pytest.mark.parametrize("n,parts,method", [
    (5, 2, "uniform"), (7, 3, "uniform"), (8, 4, "uniform"),
    (5, 2, "layer:Linear"), (9, 3, "layer:Linear"), (6, 2, "layer:ReLU")])
def test_segment_layers_match_the_reference(n, parts, method):
    import paddle_tpu.nn as jnn
    from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import \
        pp_layers as J
    from paddle_tpu_torch import nn
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        parallel_layers as pp

    def descs(mod, lib):
        return [mod.LayerDesc(lib.Linear if i % 3 else lib.ReLU,
                              *((4, 4) if i % 3 else ()))
                for i in range(n)]
    want = J.SegmentLayers(descs(J, jnn), parts, method).do_segment()
    assert pp.SegmentLayers(descs(pp, nn), parts,
                            method).do_segment() == want


def test_descriptions_refuse_as_the_reference():
    from paddle_tpu.distributed.fleet.meta_parallel.parallel_layers import \
        pp_layers as J
    from paddle_tpu_torch.distributed.fleet.meta_parallel import \
        parallel_layers as pp
    for mod in (J, pp):
        with pytest.raises(TypeError):
            mod.LayerDesc(int)
        with pytest.raises(ValueError, match="too few layers"):
            mod.SegmentLayers([None], 2)
        with pytest.raises(ValueError, match="unknown segment method"):
            mod.SegmentLayers([None, None], 2, "bogus").do_segment()


@pytest.mark.parametrize("name", list(ARMS))
def test_train_batch_matches_the_reference(started, ranks, name):
    losses, params, parts = _jax_arm(name)
    for r, rk in enumerate(ranks[WORLD[name]]):
        got = rk[name]
        assert got["type"] == "PipelineParallel"
        assert got["segments"] == parts
        np.testing.assert_allclose(got["losses"], losses, **TOL)
        stage = (r % 2)
        mine = {0: {"stages.0.weight", "stages.0.bias", "stages.1.weight",
                    "stages.1.bias"},
                1: {"stages.0.weight", "stages.0.bias", "stages.3.weight",
                    "stages.3.bias"}}[stage]
        assert set(got["params"]) == mine
        for n, v in got["params"].items():
            np.testing.assert_allclose(v, params[n], **TOL, err_msg=n)
        np.testing.assert_allclose(got["eval"], _numpy_loss(params), **TOL)

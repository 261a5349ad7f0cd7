"""``paddle_tpu_torch``'s ``save``/``load`` (``framework/io.py``), ``grad``
and the rest of the top level, and ``core.dtype``/``core.device``,
against ``paddle_tpu``'s.

A ``.pdparams`` and a ``.pdopt`` written by either package load in the
other bit for bit: fp32, bf16 (the reference's ``ml_dtypes`` arrays; the
port moves them as 16-bit words and writes the dtype by name), int64 and
nested lists and dicts, with ``return_numpy`` and both pickle protocols
the reference takes.  ``grad`` keeps the reference's ``allow_unused``
rule, its error and every ``.grad`` untouched.
"""

import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as P
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import device as tdevice
from paddle_tpu_torch.core import dtype as tdtype
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.optimizer import AdamW


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _r(shape, seed):
    return np.random.RandomState(seed).randn(*shape).astype(np.float32)


def _bf16_words(t):
    """A bf16 value's 16-bit words: a port tensor's or a reference
    tensor's (an ``ml_dtypes`` array)."""
    if isinstance(t, torch.Tensor):
        return t.view(torch.uint16).numpy()
    return np.asarray(t.numpy() if hasattr(t, "numpy") else t).view(
        np.uint16)


def _port_tree():
    bf = torch.from_numpy(_r((3, 5), 1)).bfloat16()
    return {"w": torch.nn.Parameter(torch.from_numpy(_r((4, 3), 2))),
            "bf": bf, "ids": torch.arange(6, dtype=torch.int64) * 7,
            "nest": [torch.from_numpy(_r((2,), 3)),
                     {"deep": (bf[:1].clone(), 3, "text")}],
            "step": 5}


def _ref_tree():
    paddle.seed(0)
    return {"w": jnn.Linear(4, 3).weight,
            "v": paddle.to_tensor(_r((4, 3), 2), stop_gradient=False),
            "bf": paddle.to_tensor(_r((3, 5), 1)).astype("bfloat16"),
            "ids": paddle.to_tensor(np.arange(6, dtype=np.int32) * 7),
            "nest": [paddle.to_tensor(_r((2,), 3)),
                     {"deep": (paddle.to_tensor(_r((3, 5), 1)).astype(
                         "bfloat16")[:1], 3, "text")}],
            "step": 5}


@pytest.mark.parametrize("protocol", [4, 5])
def test_port_file_loads_in_the_reference(tmp_path, protocol):
    tree = _port_tree()
    path = str(tmp_path / "m.pdparams")
    P.save(tree, path, protocol=protocol)
    got = paddle.load(path)
    np.testing.assert_array_equal(got["w"].numpy(), tree["w"].detach()
                                  .numpy())
    assert str(got["bf"].dtype) == "bfloat16"
    np.testing.assert_array_equal(_bf16_words(got["bf"]),
                                  _bf16_words(tree["bf"]))
    np.testing.assert_array_equal(np.asarray(got["ids"].numpy()),
                                  tree["ids"].numpy())
    np.testing.assert_array_equal(got["nest"][0].numpy(),
                                  tree["nest"][0].numpy())
    deep = got["nest"][1]["deep"]
    assert isinstance(deep, tuple) and deep[1:] == (3, "text")
    np.testing.assert_array_equal(_bf16_words(deep[0]),
                                  _bf16_words(tree["nest"][1]["deep"][0]))
    assert got["step"] == 5
    raw = paddle.load(path, return_numpy=True)
    assert isinstance(raw["w"], np.ndarray)
    np.testing.assert_array_equal(raw["bf"].view(np.uint16),
                                  _bf16_words(tree["bf"]))


@pytest.mark.parametrize("protocol", [4, 5])
def test_reference_file_loads_in_the_port(tmp_path, protocol):
    tree = _ref_tree()
    path = str(tmp_path / "m.pdparams")
    paddle.save(tree, path, protocol=protocol)
    got = P.load(path, device="cpu")
    assert isinstance(got["w"], torch.nn.Parameter)
    np.testing.assert_array_equal(got["w"].detach().numpy(),
                                  tree["w"].numpy())
    assert got["v"].requires_grad and not isinstance(got["v"],
                                                     torch.nn.Parameter)
    assert got["bf"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_words(got["bf"]),
                                  _bf16_words(tree["bf"]))
    np.testing.assert_array_equal(got["ids"].numpy(), tree["ids"].numpy())
    deep = got["nest"][1]["deep"]
    assert deep[1:] == (3, "text") and deep[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(_bf16_words(deep[0]),
                                  _bf16_words(tree["nest"][1]["deep"][0]))
    raw = P.load(path, return_numpy=True)
    assert isinstance(raw["ids"], np.ndarray)
    # bf16 comes back as its exact float32 values
    assert raw["bf"].dtype == np.float32
    np.testing.assert_array_equal(
        raw["bf"], np.asarray(tree["bf"].astype("float32").numpy()))


def test_port_round_trip_and_default_device(tmp_path):
    tree = _port_tree()
    path = str(tmp_path / "p.pdparams")
    P.save(tree, path)
    with nn.building("cpu"):
        got = P.load(path)
    assert torch.equal(got["bf"], tree["bf"])
    assert torch.equal(got["ids"], tree["ids"])
    assert isinstance(got["w"], torch.nn.Parameter)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.load(path)
    with pytest.raises(ValueError, match="does not exist"):
        P.load(str(tmp_path / "missing"))


def _models():
    paddle.seed(0)
    jm = jnn.Sequential(jnn.Linear(3, 4), jnn.ReLU(), jnn.Linear(4, 2))
    with nn.building("cpu"):
        tm = nn.Sequential(nn.Linear(3, 4), nn.ReLU(), nn.Linear(4, 2))
    nn.params_from_numpy(tm, {n: np.asarray(v.numpy())
                              for n, v in jm.state_dict().items()})
    return jm, tm


def test_pdparams_and_pdopt_cross_both_ways(tmp_path):
    """A model's ``state_dict`` and its AdamW's after two steps, saved by
    each package, set into the other's model and optimizer: every value
    bit-equal."""
    jm, tm = _models()
    jopt = paddle.optimizer.AdamW(1e-2, parameters=jm.parameters())
    topt = AdamW(1e-2, parameters=list(tm.parameters()))
    x = _r((5, 3), 4)
    for _ in range(2):
        jm(paddle.to_tensor(x)).sum().backward()
        jopt.step()
        jopt.clear_grad()
        tm(torch.from_numpy(x)).sum().backward()
        topt.step()
        topt.clear_grad()
    paddle.save(jm.state_dict(), str(tmp_path / "j.pdparams"))
    paddle.save(jopt.state_dict(), str(tmp_path / "j.pdopt"))
    P.save(tm.state_dict(), str(tmp_path / "t.pdparams"))
    P.save(topt.state_dict(), str(tmp_path / "t.pdopt"))

    # the reference's files into a fresh port model and optimizer
    _, tm2 = _models()
    topt2 = AdamW(1e-2, parameters=list(tm2.parameters()))
    tm2.load_state_dict(P.load(str(tmp_path / "j.pdparams"), device="cpu"))
    topt2.set_state_dict(P.load(str(tmp_path / "j.pdopt"), device="cpu"))
    jsd = jm.state_dict()
    for n, v in tm2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), jsd[n].numpy())
    jopt_sd = jopt.state_dict()
    topt2_sd = topt2.state_dict()
    assert topt2_sd["__step__"] == jopt_sd["__step__"] == 2
    for k, v in jopt_sd.items():
        if k != "__step__":
            np.testing.assert_array_equal(topt2_sd[k].numpy(), v.numpy())

    # the port's files into a fresh reference model and optimizer
    jm2, _ = _models()
    jopt2 = paddle.optimizer.AdamW(1e-2, parameters=jm2.parameters())
    jm2.set_state_dict(paddle.load(str(tmp_path / "t.pdparams")))
    jopt2.set_state_dict(paddle.load(str(tmp_path / "t.pdopt")))
    tsd = tm.state_dict()
    for n, v in jm2.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), tsd[n].numpy())
    topt_sd = topt.state_dict()
    for k, v in jopt2.state_dict().items():
        if k != "__step__":
            np.testing.assert_array_equal(v.numpy(), topt_sd[k].numpy())


# -------------------------------------------------------------------- grad

def test_grad_matches_the_reference_and_leaves_grad_untouched():
    x = _r((3, 4), 5)
    w = _r((4, 2), 6)
    g = _r((3, 2), 7)
    jx = paddle.to_tensor(x, stop_gradient=False)
    jw = paddle.to_tensor(w, stop_gradient=False)
    jout = paddle.tanh(paddle.matmul(jx, jw))
    want = paddle.grad(jout, [jx, jw], [paddle.to_tensor(g)])
    tx = torch.from_numpy(x).requires_grad_()
    tw = torch.from_numpy(w).requires_grad_()
    tout = torch.tanh(tx @ tw)
    got = P.grad(tout, [tx, tw], torch.from_numpy(g))
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-5,
                                   atol=1e-5)
    assert tx.grad is None and tw.grad is None
    # the graph is kept: a later backward still runs and fills .grad
    (tout * torch.from_numpy(g)).sum().backward(retain_graph=True)
    np.testing.assert_allclose(tx.grad.numpy(), got[0].numpy(), rtol=1e-6)
    before = tx.grad.clone()
    P.grad(tout.sum(), tx)
    assert torch.equal(tx.grad, before)


def test_grad_unused_input():
    x = torch.ones(3, requires_grad=True)
    unused = torch.ones(2, requires_grad=True)
    y = (x * 2).sum()
    with pytest.raises(RuntimeError, match="allow_unused=True"):
        P.grad(y, [x, unused])
    got = P.grad(y, [x, unused], allow_unused=True)
    assert got[1] is None and torch.equal(got[0], torch.full((3,), 2.0))
    jx = paddle.to_tensor(np.ones(3, np.float32), stop_gradient=False)
    ju = paddle.to_tensor(np.ones(2, np.float32), stop_gradient=False)
    with pytest.raises(RuntimeError, match="allow_unused=True"):
        paddle.grad((jx * 2).sum(), [jx, ju])


# --------------------------------------------------------------- top level

def test_top_level_helpers():
    with nn.building("cpu"):
        x = P.to_tensor([[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]])
        p = P.create_parameter([3, 2], "float32")
        b = P.create_parameter([2], "float32", is_bias=True)
    assert x.dtype == torch.float32 and not x.requires_grad
    assert isinstance(p, torch.nn.Parameter) and p.shape == (3, 2)
    assert torch.count_nonzero(b) == 0
    assert P.tolist(x) == [[1.0, 2.0, 3.0], [4.0, 5.0, 6.0]]
    assert P.crop_tensor(x, [1, 2], [1, 1]).tolist() == [[5.0, 6.0]]
    assert P.reverse(x, 0).tolist()[0] == [4.0, 5.0, 6.0]
    assert P.bool is torch.bool and P.float32 is torch.float32
    assert P.in_dynamic_mode() and P.in_dygraph_mode()
    P.disable_static()
    assert P.CPUPlace().is_cpu_place() and P.CUDAPlace(1).index == 1
    assert P.CUDAPlace(0) == tdevice.Place("gpu:0")
    for bad in (P.TPUPlace, P.NPUPlace, P.XPUPlace):
        with pytest.raises(RuntimeError):
            bad()
    assert P.is_compiled_with_xpu() is False and P.is_compiled_with_npu() \
        is False
    with P.no_grad():
        assert not P.is_grad_enabled()
    w = P.to_tensor([1.0], place="cpu", stop_gradient=False)
    assert w.requires_grad
    with P.set_grad_enabled(False):
        assert not (w * 1).requires_grad
    assert P.to_tensor(np.arange(3), place=P.CPUPlace()).dtype == torch.int64
    assert P.VarBase is torch.Tensor


def test_seed_repeats_both_kinds_of_draw():
    """``seed`` repeats a key and a tensor draw, and both are the
    reference's: every draw of the port (``tensor.random``, the
    initializers) takes its key from ``core.rng``'s stream, which
    ``torch.manual_seed`` no longer stands in for."""
    P.seed(11)
    k1, t1 = rng.next_key(), P.rand([3], device="cpu")
    P.seed(11)
    k2, t2 = rng.next_key(), P.rand([3], device="cpu")
    assert np.array_equal(k1, k2) and torch.equal(t1, t2)
    paddle.seed(11)
    from paddle_tpu.core import rng as jrng
    import jax
    assert np.array_equal(np.asarray(jax.random.key_data(jrng.next_key())),
                          k1)
    np.testing.assert_array_equal(t1.numpy(), paddle.rand([3]).numpy())


def test_dtype_table_and_default():
    """The reference's names and aliases map onto torch dtypes; 64-bit
    names are not narrowed (ROADMAP §C)."""
    want = {"float16": torch.float16, "fp16": torch.float16,
            "half": torch.float16, "bf16": torch.bfloat16,
            "float": torch.float32, "paddle.float32": torch.float32,
            "double": torch.float64, "int64": torch.int64,
            "uint8": torch.uint8, "bool": torch.bool,
            "complex64": torch.complex64}
    for name, dt in want.items():
        assert tdtype.convert_dtype(name) is dt, name
        ref = str(paddle.core.dtype.convert_dtype(name))
        assert ref == str(dt).split(".")[1] or ref in ("int32", "float32"), \
            name
    assert tdtype.convert_dtype(np.float32) is torch.float32
    assert nn.initializer.to_dtype("bfloat16") is torch.bfloat16
    assert P.get_default_dtype() is torch.float32
    P.set_default_dtype("float64")
    try:
        assert torch.get_default_dtype() is torch.float64
    finally:
        P.set_default_dtype("float32")
    with pytest.raises(TypeError):
        P.set_default_dtype("int32")
    with pytest.raises(ValueError):
        tdtype.convert_dtype("nope")


def test_places_and_device_queries():
    assert tdevice.Place("gpu:2").torch_device() == torch.device("cuda", 2)
    assert tdevice.Place("cpu").torch_device() == torch.device("cpu")
    assert P.device_count() == torch.cuda.device_count()
    assert P.is_compiled_with_cuda() == torch.backends.cuda.is_built()
    assert tdevice.local_devices("cpu") == [torch.device("cpu")]
    prev = P.get_device()
    P.set_device("cpu")
    assert P.get_device() == "cpu"
    if not torch.cuda.is_available():
        assert prev == "cpu"
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            P.set_device("gpu:0")
        assert P.get_cuda_rng_state() == []
    P.synchronize()

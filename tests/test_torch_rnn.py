"""``paddle_tpu_torch.nn``'s recurrent layers, ``BeamSearchDecoder`` and
``dynamic_decode`` against ``paddle_tpu.nn``'s on the same numpy inputs.

Each pair is built after ``seed(s)`` in both packages, so the port's
initial weights are the reference's (every RNN weight is a Uniform draw:
bit for bit).  Both streams are seeded again before the forward, so the
dropout between layers draws the same masks.  fp32 outputs, final states
and the gradients of ``sum(out * g) + sum(h_T * g_h)`` (every parameter
and the inputs) hold within 1e-5 of the tensor's scale, with
``sequence_length`` and training dropout; bf16 within 2e-2.  The
decoder's ids equal the reference's and its log-probabilities hold within
1e-5.
"""

import gc

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
import paddle_tpu_torch as pt
from paddle_tpu_torch import nn

TOL = 1e-5
BF16_TOL = 2e-2
B, T, I, HID = 3, 5, 5, 6


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _close(got, want, tol=TOL, err_msg=""):
    """Within ``tol`` of ``max(1, max|want|)``."""
    want = np.asarray(want, np.float64)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float64) / scale,
                               want / scale, rtol=tol, atol=tol,
                               err_msg=err_msg)


def _np(t):
    return t.detach().float().numpy()


def _pair(make, seed=3):
    """The reference's layer and the port's, each built after
    ``seed(seed)``; their parameters are equal bit for bit."""
    paddle.seed(seed)
    jl = make(jnn)
    pt.seed(seed)
    with nn.building("cpu"):
        tl = make(nn)
    jp = {n: np.asarray(p.numpy()) for n, p in jl.named_parameters()}
    tp = {n: _np(p) for n, p in tl.named_parameters()}
    assert list(tp) == list(jp)
    for n in jp:
        np.testing.assert_array_equal(tp[n], jp[n], err_msg=n)
    return jl, tl


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        return [x for t in tree for x in _leaves(t)]
    return [tree]


def _run(jl, tl, x, lens=None, train=True, seed=5, tol=TOL, cast=None):
    """Both layers on ``x`` (and ``sequence_length=lens``) after seeding
    both streams: outputs and final states, then the gradients of the
    outputs and states weighted by fixed draws, for every parameter and
    the input."""
    jl.train() if train else jl.eval()
    tl.train(train)
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x.copy())
    if cast is not None:
        jx = paddle.to_tensor(x).astype(cast[0])
        jx.stop_gradient = False
        tx = tx.to(cast[1])
    tx.requires_grad_()
    kw_j = {} if lens is None else {"sequence_length": paddle.to_tensor(lens)}
    kw_t = {} if lens is None else {"sequence_length": torch.from_numpy(lens)}
    paddle.seed(seed)
    pt.seed(seed)
    jout, jst = jl(jx, **kw_j)
    tout, tst = tl(tx, **kw_t)
    jall, tall = [jout] + _leaves(jst), [tout] + _leaves(tst)
    jloss, tloss = 0.0, 0.0
    for i, (a, b) in enumerate(zip(jall, tall)):
        _close(_np(b), np.asarray(a.astype("float32").numpy()), tol,
               f"output {i}")
        g = _rand(tuple(b.shape), 20 + i)
        jloss = jloss + (a.astype("float32") * paddle.to_tensor(g)).sum()
        tloss = tloss + (b.float() * torch.from_numpy(g)).sum()
    jloss.backward()
    tloss.backward()
    jgrads = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(_np(p.grad), jgrads[n].grad.astype("float32").numpy(), tol, n)
    _close(_np(tx.grad), jx.grad.astype("float32").numpy(), tol, "input")
    return jout, tout


# -------------------------------------------------------------- the cells

CELLS = {
    "simple_tanh": lambda m: m.SimpleRNNCell(I, HID),
    "simple_relu": lambda m: m.SimpleRNNCell(I, HID, activation="relu"),
    "lstm": lambda m: m.LSTMCell(I, HID),
    "gru": lambda m: m.GRUCell(I, HID),
}


@pytest.mark.parametrize("name", sorted(CELLS))
def test_cell_step_states_and_grads(name):
    jl, tl = _pair(CELLS[name])
    x = _rand((B, I), 1)
    lstm = name == "lstm"
    hs = [_rand((B, HID), 2 + k) for k in range(2 if lstm else 1)]
    jx = paddle.to_tensor(x, stop_gradient=False)
    tx = torch.from_numpy(x).requires_grad_()
    jh = [paddle.to_tensor(h, stop_gradient=False) for h in hs]
    th = [torch.from_numpy(h).requires_grad_() for h in hs]
    jout, jst = jl(jx, tuple(jh) if lstm else jh[0])
    tout, tst = tl(tx, tuple(th) if lstm else th[0])
    jall, tall = [jout] + _leaves(jst), [tout] + _leaves(tst)
    for a, b in zip(jall, tall):
        _close(_np(b), a.numpy())
    g = [_rand(tuple(b.shape), 30 + i) for i, b in enumerate(tall)]
    sum((a * paddle.to_tensor(gi)).sum() for a, gi in zip(jall, g)).backward()
    sum((b * torch.from_numpy(gi)).sum() for b, gi in zip(tall, g)).backward()
    jgrads = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(_np(p.grad), jgrads[n].grad.numpy(), err_msg=n)
    for a, b in zip([tx] + th, [jx] + jh):
        _close(_np(a.grad), b.grad.numpy())


def test_cell_default_states_and_shapes():
    with nn.building("cpu"):
        cell = nn.LSTMCell(I, HID)
    out, (h, c) = cell(torch.zeros(B, I))
    assert out.shape == h.shape == c.shape == (B, HID)
    assert cell.state_shape == ((HID,), (HID,))
    assert torch.equal(cell.get_initial_states(torch.zeros(4, I), init_value=
                                               2.0), torch.full((4, HID), 2.0))


# ------------------------------------------------------------- the layers

LAYERS = {
    "lstm_2_bidirect_dropout": lambda m: m.LSTM(
        I, HID, num_layers=2, direction="bidirect", dropout=0.5),
    "gru_2_dropout": lambda m: m.GRU(I, HID, num_layers=2, dropout=0.3),
    "gru_bidirect": lambda m: m.GRU(I, HID, direction="bidirectional"),
    "simple_relu_2": lambda m: m.SimpleRNN(I, HID, num_layers=2,
                                           activation="relu"),
    "lstm_time_major": lambda m: m.LSTM(I, HID, time_major=True),
}


@pytest.mark.parametrize("lens", [False, True])
@pytest.mark.parametrize("name", sorted(LAYERS))
def test_layer_outputs_states_grads(name, lens):
    jl, tl = _pair(LAYERS[name])
    x = _rand((T, B, I) if "time_major" in name else (B, T, I), 1)
    seq = np.array([5, 2, 4], np.int64) if lens else None
    _run(jl, tl, x, seq)


def test_layer_eval_has_no_dropout_and_bf16():
    jl, tl = _pair(LAYERS["lstm_2_bidirect_dropout"])
    x = _rand((B, T, I), 1)
    _run(jl, tl, x, train=False)
    jl, tl = _pair(LAYERS["gru_2_dropout"])
    jl.to(dtype="bfloat16")
    tl.to(torch.bfloat16)
    tl._dtype = torch.bfloat16
    jl._dtype = paddle.bfloat16
    _run(jl, tl, x, train=True, tol=BF16_TOL,
         cast=("bfloat16", torch.bfloat16))


def test_dropout_masks_are_the_reference_stream():
    """Two seeds give two outputs; the port's training forward equals the
    reference's only because the masks are equal."""
    jl, tl = _pair(LAYERS["gru_2_dropout"])
    x = _rand((B, T, I), 1)
    a, _ = _run(jl, tl, x, seed=5)
    b, _ = _run(jl, tl, x, seed=6)
    assert not np.allclose(a.numpy(), b.numpy())


def test_parameter_names_and_params_from_numpy():
    jl, tl = _pair(LAYERS["lstm_2_bidirect_dropout"])
    names = [n for n, _ in tl.named_parameters()]
    assert names[:4] == ["weight_ih_l0", "weight_hh_l0", "bias_ih_l0",
                         "bias_hh_l0"]
    assert "weight_ih_l1_reverse" in names
    assert tuple(tl.weight_ih_l1.shape) == (4 * HID, 2 * HID)
    paddle.seed(11)
    other = jnn.LSTM(I, HID, num_layers=2, direction="bidirect")
    nn.params_from_numpy(tl, {n: p.numpy() for n, p in
                              other.named_parameters()})
    np.testing.assert_array_equal(_np(tl.weight_hh_l1_reverse),
                                  other.weight_hh_l1_reverse.numpy())


@pytest.mark.parametrize("bi", [False, True])
def test_rnn_and_birnn_wrappers(bi):
    def make(m):
        if bi:
            return m.BiRNN(m.GRUCell(I, HID), m.GRUCell(I, HID))
        return m.RNN(m.LSTMCell(I, HID), is_reverse=True)
    jl, tl = _pair(make)
    _run(jl, tl, _rand((B, T, I), 1), train=False)


def test_seeded_build_then_eager_draw():
    """``nn.LSTM`` and ``nn.GRU`` built after ``seed(s)`` equal the
    reference's, and so does the next eager ``randn``."""
    for make in (lambda m: m.LSTM(I, HID, num_layers=2,
                                  direction="bidirect", dropout=0.5),
                 lambda m: m.GRU(I, HID)):
        _pair(make, seed=42)
        want = paddle.randn([4, 3]).numpy()
        with nn.building("cpu"):
            got = pt.randn([4, 3]).numpy()
        u = np.abs(got.view(np.int32).astype(np.int64)
                   - want.view(np.int32))
        assert u.max() <= 4


# ----------------------------------------------------------- beam search

V, E, K, H2 = 11, 4, 3, 8


def _decoder_pair(seed=2):
    def make(m):
        return (m.Embedding(V, E), m.LSTMCell(E, H2), m.Linear(H2, V))
    paddle.seed(seed)
    jemb, jcell, jout = make(jnn)
    pt.seed(seed)
    with nn.building("cpu"):
        temb, tcell, tout = make(nn)
    for a, b in ((jemb, temb), (jcell, tcell), (jout, tout)):
        for (n, p), (_, q) in zip(a.named_parameters(),
                                  b.named_parameters()):
            np.testing.assert_array_equal(_np(q), p.numpy(), err_msg=n)
    jd = jnn.BeamSearchDecoder(jcell, 0, 1, K, embedding_fn=jemb,
                               output_fn=jout)
    td = nn.BeamSearchDecoder(tcell, 0, 1, K, embedding_fn=temb,
                              output_fn=tout)
    return jd, td


@pytest.mark.parametrize("time_major", [False, True])
def test_dynamic_decode_ids_and_log_probs(time_major):
    jd, td = _decoder_pair()
    h0 = _rand((2, H2), 4)
    c0 = _rand((2, H2), 5)
    jinit = (paddle.to_tensor(h0), paddle.to_tensor(c0))
    with torch.no_grad():
        tids, tlp, tlen = nn.dynamic_decode(
            td, (torch.from_numpy(h0), torch.from_numpy(c0)),
            max_step_num=9, output_time_major=time_major,
            return_length=True)
    jids, jlp, jlen = jnn.dynamic_decode(
        jd, jinit, max_step_num=9, output_time_major=time_major,
        return_length=True)
    np.testing.assert_array_equal(tids.numpy(), jids.numpy())
    np.testing.assert_array_equal(tlen.numpy(), jlen.numpy())
    _close(tlp.numpy(), jlp.numpy())
    assert tids.shape[1 if time_major else 0] == 2


def test_beam_step_finished_beams_and_ties():
    """A finished beam extends only with the end token at no cost (-inf
    elsewhere, as the reference's eager step computes it); equal totals
    keep the lower flat index."""
    jd, td = _decoder_pair()
    h = _rand((2 * K, H2), 6)
    c = _rand((2 * K, H2), 7)
    fin = np.array([[True, False, False], [False, True, True]])
    lp = np.array([[-1.0, -1.0, -2.0], [0.0, -1.0, -1.0]], np.float32)
    ids = np.array([[3, 3, 4], [1, 2, 2]], np.int64)
    jst = {"cell": (paddle.to_tensor(h)._data, paddle.to_tensor(c)._data),
           "log_probs": paddle.to_tensor(lp)._data,
           "finished": paddle.to_tensor(fin)._data}
    tst = {"cell": (torch.from_numpy(h), torch.from_numpy(c)),
           "log_probs": torch.from_numpy(lp),
           "finished": torch.from_numpy(fin)}
    jtok, jnew, jpar = jd.step(0, paddle.to_tensor(ids.astype(np.int32))
                               ._data, jst)
    with torch.no_grad():
        ttok, tnew, tpar = td.step(0, torch.from_numpy(ids), tst)
    np.testing.assert_array_equal(ttok.numpy(), np.asarray(jtok))
    np.testing.assert_array_equal(tpar.numpy(), np.asarray(jpar))
    np.testing.assert_array_equal(tnew["finished"].numpy(),
                                  np.asarray(jnew["finished"]))
    _close(tnew["log_probs"].numpy(), np.asarray(jnew["log_probs"]))
    # beam 0 of row 0 is finished: its only child is the end token at -1
    assert ttok[0, 0] == 1 and tnew["log_probs"][0, 0] == -1.0


def test_gather_tree_and_tile():
    from paddle_tpu.nn import functional as JF
    from paddle_tpu_torch.nn import functional as F
    r = np.random.RandomState(3)
    ids = r.randint(0, 9, (6, 2, 4))
    par = r.randint(0, 4, (6, 2, 4))
    want = np.asarray(JF.gather_tree(paddle.to_tensor(ids.astype(np.int32)),
                                     paddle.to_tensor(par.astype(np.int32))
                                     ).numpy())
    got = F.gather_tree(torch.from_numpy(ids), torch.from_numpy(par))
    np.testing.assert_array_equal(got.numpy(), want)
    x = torch.arange(6).reshape(2, 3)
    assert nn.BeamSearchDecoder.tile_beam_merge_with_batch(x, 2).tolist() \
        == [[0, 1, 2], [0, 1, 2], [3, 4, 5], [3, 4, 5]]

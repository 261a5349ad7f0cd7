"""``paddle_tpu_torch.nn``'s ``MultiHeadAttention`` and ``Transformer*``
layers against ``paddle_tpu.nn``'s on the same numpy inputs and the
reference's weights (its ``state_dict`` by name, no mapping), d 64, 4
heads, at L 128 (the flash path: its plain versions here) and L 96 (the
dense path).

fp32 outputs and the gradients of ``sum(out * g)`` (every parameter and
the inputs) within 1e-5 of the tensor's scale (``_close``: a bias
gradient sums 256 rows into values near 40, whose fp32 roundoff passes
1e-5 absolute); bf16 within 2e-2.  The reference runs eagerly,
so its dropout draws come from its global stream: both streams are
seeded after the build (``paddle.seed`` / ``core.rng.seed``) and the
draws happen in the same order, so the masks are bit-equal.  Also: every
mask shape of ``_is_key_padding_mask``, a (L, L) mask and bool masks;
``need_weights``; both caches; encoder-decoder ``Transformer``; the
attention keep-mask against the reference's ``position_hash_keep`` at the
seed the reference draws; the clone rule.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.nn as jnn
from paddle_tpu.core import rng as jrng
from paddle_tpu.ops import attention as A
from paddle_tpu_torch import nn
from paddle_tpu_torch.core import rng
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops import attention as T

TOL = 1e-5
BF16_TOL = 2e-2
B, D, H, FF = 2, 64, 4, 128


@pytest.fixture(scope="module", autouse=True)
def _release_jax_arrays():
    yield
    gc.collect()


def _rand(shape, seed, scale=1.0):
    return (np.random.RandomState(seed).randn(*shape) * scale).astype(
        np.float32)


def _mask(kind, L, Lq=None):
    """An attention mask of ``kind`` over ``L`` keys (the last 16 keys of
    batch row 1 masked where it has a batch axis)."""
    Lq = L if Lq is None else Lq
    pad = np.zeros((B, L), np.float32)
    pad[1, -16:] = -1e9
    causal = np.triu(np.full((Lq, L), -1e9, np.float32), 1)
    return {
        None: None,
        "b11l": pad[:, None, None, :],
        "111l": pad[1:2, None, None, :],
        "b1l": pad[:, None, :],
        "ll": causal,
        "bool_b11l": (pad == 0)[:, None, None, :],
        "bool_ll": causal == 0,
    }[kind]


def _close(got, want, err_msg=""):
    """Within TOL of ``max(1, max|want|)``."""
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got) / scale, want / scale,
                               rtol=TOL, atol=TOL, err_msg=err_msg)


def _pair(jctor, tctor):
    """The reference's layer built from seed 0 and the port's with its
    weights."""
    paddle.seed(0)
    jl = jctor(jnn)
    with nn.building("cpu"):
        tl = tctor(nn)
    sd = {n: np.asarray(v.numpy()) for n, v in jl.state_dict().items()}
    assert [n for n, _ in tl.named_parameters()] == list(sd)
    nn.params_from_numpy(tl, sd)
    return jl, tl


def _run(jl, tl, xs, extra=(), g_seed=9, train=True, seed=5):
    """Both layers on inputs ``xs`` (differentiated) and ``extra`` (masks,
    passed as given) after seeding both streams: outputs, then gradients
    of ``sum(out * g)`` for every parameter and input."""
    jl.train() if train else jl.eval()
    tl.train(train)
    jx = [paddle.to_tensor(x, stop_gradient=False) for x in xs]
    tx = [torch.from_numpy(x.copy()).requires_grad_() for x in xs]
    jextra = [None if m is None else paddle.to_tensor(m) for m in extra]
    textra = [None if m is None else torch.from_numpy(np.array(m))
              for m in extra]
    paddle.seed(seed)
    rng.seed(seed)
    jout = jl(*jx, *jextra)
    tout = tl(*tx, *textra)
    jo = jout[0] if isinstance(jout, tuple) else jout
    to = tout[0] if isinstance(tout, tuple) else tout
    g = _rand(tuple(to.shape), g_seed)
    (jo * paddle.to_tensor(g)).sum().backward()
    (to * torch.from_numpy(g)).sum().backward()
    _close(to.detach().numpy(), jo.numpy())
    jgrads = dict(jl.named_parameters())
    for n, p in tl.named_parameters():
        _close(p.grad.numpy(), jgrads[n].grad.numpy(), n)
    for a, b in zip(tx, jx):
        _close(a.grad.numpy(), b.grad.numpy())
    return jout, tout


class _Route:
    """Counts the plain flash forward's calls (the flash path on the
    CPU)."""

    def __init__(self, monkeypatch):
        self.n = 0
        real = T.flash_fwd_ref

        def spy(*a, **k):
            self.n += 1
            return real(*a, **k)
        monkeypatch.setattr(T, "flash_fwd_ref", spy)


# ------------------------------------------------------ MultiHeadAttention

MASKS = [None, "b11l", "111l", "b1l", "ll", "bool_b11l", "bool_ll"]


@pytest.mark.parametrize("L", [128, 96])
@pytest.mark.parametrize("mask", MASKS)
def test_mha_forward_grads_and_route(L, mask, monkeypatch):
    route = _Route(monkeypatch)
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, H),
                   lambda m: m.MultiHeadAttention(D, H))
    x = _rand((B, L, D), 1)
    _run(jl, tl, [x, x, x], [_mask(mask, L)])
    flash = L % 128 == 0 and (mask is None or "ll" not in mask)
    assert route.n == (1 if flash else 0)


def test_mha_cross_attention_kdim_vdim():
    """Queries of 128 over 96 keys of other widths (the dense path)."""
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, H, kdim=32, vdim=48),
                   lambda m: m.MultiHeadAttention(D, H, kdim=32, vdim=48))
    _run(jl, tl, [_rand((B, 128, D), 1), _rand((B, 96, 32), 2),
                  _rand((B, 96, 48), 3)], [_mask("b11l", 96)])


@pytest.mark.parametrize("train", [False, True])
def test_mha_need_weights(train):
    """The dense einsum path: output and weights; in training the
    attention dropout falls on the output (the reference's rule)."""
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, H, dropout=0.25,
                                                  need_weights=True),
                   lambda m: m.MultiHeadAttention(D, H, dropout=0.25,
                                                  need_weights=True))
    x = _rand((B, 96, D), 1)
    jout, tout = _run(jl, tl, [x, x, x], [_mask("b11l", 96)], train=train)
    np.testing.assert_allclose(tout[1].detach().numpy(), jout[1].numpy(),
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("L,mask", [(96, None), (96, "b11l"), (96, "ll"),
                                    (128, "ll")])
def test_mha_attention_dropout_dense_route(L, mask):
    """Attention dropout on the dense routes (L 96, or a (L, L) mask):
    the port draws the reference's threefry masks, so outputs and
    gradients agree.  (The flash route's position-hash mask is held by
    the next test.)"""
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, H, dropout=0.3),
                   lambda m: m.MultiHeadAttention(D, H, dropout=0.3))
    x = _rand((B, L, D), 1)
    _run(jl, tl, [x, x, x], [_mask(mask, L)])


def test_flash_keep_mask_is_the_reference_position_hash(monkeypatch):
    """The flash route's seed is the low 32 bits of ``jax.random.bits``
    of the stream's next key, and its keep-mask is the reference's
    ``position_hash_keep`` of that seed, head by head: the port's
    attention output with dropout equals the reference's math on the
    reference's mask."""
    L, p = 128, 0.2
    seen = []
    real = T.flash_attention

    def spy(*a, **k):
        seen.append(k["dropout_seed"])
        return real(*a, **k)
    monkeypatch.setattr(T, "flash_attention", spy)
    q, k, v = (_rand((B, L, H, 16 * 4), s) for s in (1, 2, 3))
    km = _mask("b11l", L)
    paddle.seed(21)
    want_seed = int(jax.random.bits(jrng.next_key(), (), jnp.uint32))
    rng.seed(21)
    got = F.scaled_dot_product_attention(
        *(torch.from_numpy(a) for a in (q, k, v)),
        attn_mask=torch.from_numpy(km), dropout_p=p)
    assert seen == [want_seed]
    keep = np.stack([np.asarray(A._dropout_keep(jnp.uint32(want_seed), bh, 0,
                                                0, (L, L), p))
                     for bh in range(B * H)]).reshape(B, H, L, L)
    assert np.array_equal(
        T._keep_all_heads(want_seed, B * H, L, p, "cpu").numpy()
        .reshape(B, H, L, L), keep)
    s = np.einsum("blhd,bmhd->bhlm", q, k) / np.sqrt(q.shape[-1]) + km
    w = np.exp(s - s.max(-1, keepdims=True))
    w = w / w.sum(-1, keepdims=True)
    want = np.einsum("bhlm,bmhd->blhd", np.where(keep, w / (1 - p), 0), v)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_incremental_and_static_caches():
    """Three decode steps through a ``Cache``, and cross attention over a
    ``StaticCache``, both against the reference's."""
    jl, tl = _pair(lambda m: m.MultiHeadAttention(D, H),
                   lambda m: m.MultiHeadAttention(D, H))
    jl.eval()
    tl.eval()
    xs = _rand((B, 3, D), 4)
    jc = jl.gen_cache(paddle.to_tensor(xs))
    tc = tl.gen_cache(torch.from_numpy(xs))
    assert tuple(tc.k.shape) == (B, 0, H, D // H)
    for t in range(3):
        xt = xs[:, t:t + 1]
        jo, jc = jl(paddle.to_tensor(xt), None, None, None, jc)
        to, tc = tl(torch.from_numpy(xt), None, None, None, tc)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   rtol=TOL, atol=TOL)
        np.testing.assert_allclose(tc.k.detach().numpy(), jc.k.numpy(),
                                   rtol=TOL, atol=TOL)
    mem = _rand((B, 96, D), 5)
    js = jl.gen_cache(paddle.to_tensor(mem), paddle.to_tensor(mem),
                      jnn.MultiHeadAttention.StaticCache)
    ts = tl.gen_cache(torch.from_numpy(mem), torch.from_numpy(mem),
                      nn.MultiHeadAttention.StaticCache)
    q = _rand((B, 7, D), 6)
    jo = jl(paddle.to_tensor(q), None, None, None, js)
    to = tl(torch.from_numpy(q), None, None, None, ts)
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), rtol=TOL,
                               atol=TOL)


# --------------------------------------------------------- Transformer*

def _enc(m, before=False):
    layer = m.TransformerEncoderLayer(D, H, FF, dropout=0.1,
                                      activation="gelu", attn_dropout=0.0,
                                      normalize_before=before)
    return m.TransformerEncoder(layer, 2,
                                m.LayerNorm(D) if before else None)


def _dec(m):
    layer = m.TransformerDecoderLayer(D, H, FF, dropout=0.1,
                                      attn_dropout=0.0)
    return m.TransformerDecoder(layer, 2)


@pytest.mark.parametrize("L", [128, 96])
@pytest.mark.parametrize("mask", [None, "b11l", "bool_b11l"])
def test_encoder_with_residual_dropout(L, mask):
    jl, tl = _pair(_enc, _enc)
    _run(jl, tl, [_rand((B, L, D), 1)], [_mask(mask, L)])


def test_pre_norm_encoder_with_final_norm():
    jl, tl = _pair(lambda m: _enc(m, True), lambda m: _enc(m, True))
    _run(jl, tl, [_rand((B, 128, D), 1)], [_mask("111l", 128)])


def test_encoder_layer_cache():
    jl, tl = _pair(_enc, _enc)
    jl.eval()
    tl.eval()
    x = _rand((B, 4, D), 2)
    jc = jl.gen_cache(paddle.to_tensor(x))
    tc = tl.gen_cache(torch.from_numpy(x))
    jo, _ = jl(paddle.to_tensor(x), None, jc)
    to, tcache = tl(torch.from_numpy(x), None, tc)
    assert len(tcache) == 2 and tuple(tcache[0].k.shape) == (B, 4, H, 16)
    np.testing.assert_allclose(to.detach().numpy(), jo.numpy(), rtol=TOL,
                               atol=TOL)


@pytest.mark.parametrize("L", [128, 96])
def test_decoder_with_masks(L):
    jl, tl = _pair(_dec, _dec)
    causal = np.asarray(jnn.Transformer.generate_square_subsequent_mask(L)
                        .numpy())
    with nn.building("cpu"):
        tm = nn.Transformer.generate_square_subsequent_mask(L)
    assert np.array_equal(tm.numpy(), causal)
    _run(jl, tl, [_rand((B, L, D), 1), _rand((B, 128, D), 2)],
         [causal, _mask("b11l", 128)])


def test_decoder_incremental_cache():
    jl, tl = _pair(_dec, _dec)
    jl.eval()
    tl.eval()
    mem = _rand((B, 96, D), 3)
    jc = jl.gen_cache(paddle.to_tensor(mem))
    tc = tl.gen_cache(torch.from_numpy(mem))
    tgt = _rand((B, 3, D), 4)
    for t in range(3):
        xt = tgt[:, t:t + 1]
        jo, jc = jl(paddle.to_tensor(xt), paddle.to_tensor(mem), None, None,
                    jc)
        to, tc = tl(torch.from_numpy(xt), torch.from_numpy(mem), None, None,
                    tc)
        np.testing.assert_allclose(to.detach().numpy(), jo.numpy(),
                                   rtol=TOL, atol=TOL)
    zipped = tl.gen_cache(torch.from_numpy(mem), do_zip=True)
    assert len(zipped) == 2 and len(zipped[0]) == 2


@pytest.mark.parametrize("L", [128, 96])
def test_encoder_decoder_transformer(L):
    ctor = (lambda m: m.Transformer(D, H, 2, 2, FF, dropout=0.1,
                                    attn_dropout=0.0))
    jl, tl = _pair(ctor, ctor)
    _run(jl, tl, [_rand((B, L, D), 1), _rand((B, L, D), 2)],
         [_mask("b11l", L), np.asarray(
             jnn.Transformer.generate_square_subsequent_mask(L).numpy()),
          _mask("b11l", L)])


def test_clone_rule_every_layer_starts_equal():
    """``TransformerEncoder``/``Decoder`` copy the first layer's weights
    into every other layer (no new draws), in both packages."""
    with nn.building("cpu"):
        enc = nn.TransformerEncoder(nn.TransformerEncoderLayer(D, H, FF), 3)
        dec = nn.TransformerDecoder(nn.TransformerDecoderLayer(D, H, FF), 3)
    paddle.seed(0)
    jenc = jnn.TransformerEncoder(jnn.TransformerEncoderLayer(D, H, FF), 3)
    for model, ref in ((enc, jenc), (dec, None)):
        sd = model.state_dict()
        firsts = [n for n in sd if n.startswith("layers.0.")]
        for n in firsts:
            for i in (1, 2):
                other = n.replace("layers.0.", f"layers.{i}.")
                assert torch.equal(sd[n], sd[other]), other
                assert sd[n].data_ptr() != sd[other].data_ptr()
    jsd = jenc.state_dict()
    for n in jsd:
        if n.startswith("layers.0."):
            assert np.array_equal(jsd[n].numpy(), jsd[n.replace(
                "layers.0.", "layers.2.")].numpy())


def test_bf16_encoder_forward():
    """The port's encoder cast to bf16 against the reference's cast
    (eval, no dropout), within the bf16 tier."""
    jl, tl = _pair(_enc, _enc)
    jl = jl.bfloat16()
    tl = tl.bfloat16()
    jl.eval()
    tl.eval()
    x = _rand((B, 128, D), 1)
    mask = _mask("b11l", 128)
    jo = jl(paddle.to_tensor(x).astype("bfloat16"), paddle.to_tensor(mask))
    to = tl(torch.from_numpy(x).bfloat16(), torch.from_numpy(mask))
    assert to.dtype == torch.bfloat16
    np.testing.assert_allclose(to.float().detach().numpy(),
                               np.asarray(jo.astype("float32").numpy()),
                               rtol=BF16_TOL, atol=BF16_TOL)

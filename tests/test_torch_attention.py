"""Port parity for training attention (paddle_tpu_torch/ops/attention.py):
the same numpy inputs go through the JAX package and the port.

- The dropout keep-mask is bit-exact against the reference's
  ``position_hash_keep`` (uint32 wraparound included).
- The flash path (``_FlashAttention``: ``flash_fwd_ref`` forward,
  ``flash_bwd_ref`` backward on CPU tensors) is held to the reference's
  ``_flash_attention`` in Pallas interpret mode: forward at fp32 atol/rtol
  2e-5, gradients at 1e-4 (fp32 in both, other summation order).
- ``dense_attention`` at p = 0 against the reference's dense path.
- The dispatch rule and the kernel wrappers' argument checks.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.attention as A
from paddle_tpu_torch.ops import attention as T

B, H, D = 2, 2, 64
SEED = 7


def _qkv(L=256, seed=0):
    r = np.random.RandomState(seed)
    return [r.standard_normal((B, L, H, D)).astype(np.float32)
            for _ in range(4)]                                # q k v do


def _key_mask(L, seed=1):
    """~30% of keys masked (key 0 always kept) plus one masked run longer
    than a tile of either side (keys 64..191)."""
    r = np.random.RandomState(seed)
    valid = r.rand(B, L) > 0.3
    valid[:, 0] = True
    valid[:, 64:192] = False
    return np.where(valid, 0.0, -1e30).astype(np.float32)


class TestPositionHash:
    @pytest.mark.parametrize("row0,col0", [(0, 0), (1000, 37),
                                           (2**31 - 5, 2**31 - 3),
                                           (2**32 - 9, 5), (3, 2**32 - 2)])
    @pytest.mark.parametrize("seed", [0, 12345, 2**31 + 11, 2**32 - 1])
    def test_bit_exact(self, row0, col0, seed):
        want = np.asarray(A.position_hash_keep(jnp.uint32(seed), row0, col0,
                                               (24, 40), 0.37))
        got = T.position_hash_keep(seed, row0, col0, (24, 40), 0.37).numpy()
        np.testing.assert_array_equal(got, want)

    @pytest.mark.parametrize("bh", [0, 3, 191])
    def test_dropout_keep_mixes_head(self, bh):
        want = np.asarray(A._dropout_keep(jnp.uint32(SEED), bh, 128, 256,
                                          (64, 64), 0.1))
        got = T._dropout_keep(SEED, bh, 128, 256, (64, 64), 0.1).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.85 < got.mean() < 0.95

    def test_all_heads_mask_is_the_per_block_mask(self):
        full = T._keep_all_heads(SEED, 4, 256, 0.1, "cpu")
        blk = T._dropout_keep(SEED, 3, 128, 64, (128, 64), 0.1)
        assert torch.equal(full[3, 128:, 64:128], blk)


def _jax_flash(q, k, v, km, causal, p):
    def f(q, k, v):
        return A._flash_attention(q, k, v, jnp.asarray(km),
                                  jnp.full((1,), SEED, jnp.uint32), causal,
                                  1.0 / np.sqrt(D), p, 128)
    return f


class TestFlashParity:
    @pytest.mark.parametrize("causal", [False, True])
    @pytest.mark.parametrize("masked", [False, True])
    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_forward_and_grads(self, causal, masked, p):
        L = 256
        q, k, v, do = _qkv(L)
        km = _key_mask(L) if masked else np.zeros((B, L), np.float32)
        jo, vjp = jax.vjp(_jax_flash(q, k, v, km, causal, p),
                          *(jnp.asarray(x) for x in (q, k, v)))
        jg = vjp(jnp.asarray(do))
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        tkm = torch.tensor(km, requires_grad=True)
        out = T._FlashAttention.apply(tq, tk, tv, tkm, SEED, causal,
                                      1.0 / np.sqrt(D), p)
        np.testing.assert_allclose(out.detach().numpy(), np.asarray(jo),
                                   rtol=2e-5, atol=2e-5)
        grads = torch.autograd.grad(out, (tq, tk, tv, tkm), torch.tensor(do))
        for got, want, name in zip(grads, jg, "qkv"):
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-4,
                                       err_msg=f"d{name}")
        assert torch.equal(grads[3], torch.zeros(B, L))

    def test_lse_matches_reference(self):
        L = 128
        q, k, v, _ = _qkv(L, seed=3)
        km = _key_mask(L)
        bh = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3).reshape(B * H, L, D)
        _, jlse = A._flash_fwd_pallas(bh(q), bh(k), bh(v), jnp.asarray(km),
                                      jnp.full((1,), SEED, jnp.uint32), True,
                                      1.0 / np.sqrt(D), 0.1, 128, 128, H,
                                      True)
        _, lse = T.flash_fwd_ref(*(torch.tensor(x) for x in (q, k, v, km)),
                                 SEED, True, 1.0 / np.sqrt(D), 0.1)
        np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=2e-5,
                                   atol=2e-5)

    def test_backward_ref_matches_autograd_of_forward_ref(self):
        L = 128
        q, k, v, do = _qkv(L, seed=4)
        km = torch.tensor(_key_mask(L))
        tq, tk, tv = (torch.tensor(x, requires_grad=True) for x in (q, k, v))
        out, lse = T.flash_fwd_ref(tq, tk, tv, km, SEED, True, 0.125, 0.1)
        want = torch.autograd.grad(out, (tq, tk, tv), torch.tensor(do))
        tdo = torch.tensor(do)
        delta = (tdo * out.detach()).sum(-1).permute(0, 2, 1).reshape(B * H, L)
        got = T.flash_bwd_ref(tq.detach(), tk.detach(), tv.detach(), km, SEED,
                              tdo, lse.detach(), delta, True, 0.125, 0.1)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=1e-4, atol=1e-4)


class TestDenseAndDispatch:
    @pytest.mark.parametrize("causal", [False, True])
    def test_dense_matches_reference(self, causal):
        q, k, v, _ = _qkv(96)
        km = _key_mask(96)[:, None, None, :]
        want = A.dense_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 mask=jnp.asarray(km), causal=causal)
        got = T.dense_attention(*(torch.tensor(x) for x in (q, k, v)),
                                mask=torch.tensor(km), causal=causal)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)

    def test_public_flash_matches_dense_reference(self):
        q, k, v, _ = _qkv(128)
        want = A.dense_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal=True)
        got = T.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                                causal=True)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)

    @pytest.mark.parametrize("Lq,Lk,flash", [(128, 128, True),
                                             (384, 384, True),
                                             (96, 96, False),
                                             (128, 256, False)])
    def test_dispatch_rule(self, monkeypatch, Lq, Lk, flash):
        calls = []
        real = T.dense_attention
        monkeypatch.setattr(T, "dense_attention",
                            lambda *a, **kw: calls.append(1) or real(*a, **kw))
        r = np.random.RandomState(0)
        q = torch.tensor(r.standard_normal((1, Lq, 1, 64)).astype(np.float32))
        k = torch.tensor(r.standard_normal((1, Lk, 1, 64)).astype(np.float32))
        out = T.flash_attention(q, k, k, causal=False)
        assert out.shape == q.shape
        assert bool(calls) == (not flash)

    def test_dropout_needs_seed(self):
        q = torch.zeros(1, 128, 1, 64)
        with pytest.raises(ValueError, match="dropout_seed"):
            T.flash_attention(q, q, q, dropout_p=0.1)

    def test_misaligned_key_mask_view(self, monkeypatch):
        """A (B, L) key mask that is a view 4 bytes into its storage (the
        kernels copy the mask 16 bytes at a time) reaches _FlashAttention
        16-byte aligned and unchanged, and the output matches the
        reference's flash_attention on the same mask."""
        L = 128
        q, k, v, _ = _qkv(L, seed=5)
        km = _key_mask(L)
        big = torch.zeros(B * L + 1)
        view = big[1:].view(B, L)
        view.copy_(torch.tensor(km))
        assert view.is_contiguous() and view.data_ptr() % 16 == 4
        seen = []
        real = T._FlashAttention.apply
        monkeypatch.setattr(T._FlashAttention, "apply",
                            lambda *a: seen.append(a[3]) or real(*a))
        got = T.flash_attention(*(torch.tensor(x) for x in (q, k, v)),
                                causal=True, key_mask=view)
        assert len(seen) == 1 and seen[0].data_ptr() % 16 == 0
        assert torch.equal(seen[0], view)
        want = A.flash_attention(*(jnp.asarray(x) for x in (q, k, v)),
                                 causal=True, key_mask=jnp.asarray(km))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                                   atol=2e-5)

    def test_dense_dropout_draws_from_a_generator(self):
        q, k, v, _ = (torch.tensor(x) for x in _qkv(96))
        a = T.flash_attention(q, k, v, dropout_p=0.5, dropout_seed=3)
        b = T.flash_attention(q, k, v, dropout_p=0.5, dropout_seed=3)
        c = T.flash_attention(q, k, v)
        assert torch.equal(a, b) and not torch.allclose(a, c)


def _kernel_args(**over):
    L = over.pop("L", 128)
    dt = over.pop("dtype", torch.float32)
    d = over.pop("hd", 64)
    q = torch.zeros(B, L, H, d, dtype=dt)
    args = dict(q=q, k=q.clone(), v=q.clone(), kmask=torch.zeros(B, L),
                seed=0, causal=True, scale=0.125, dropout_p=0.0)
    args.update(over)
    return args


class TestKernelWrappers:
    @pytest.mark.parametrize("over,match", [
        (dict(dtype=torch.float64), "dtype"),
        (dict(hd=32), "head dim"),
        (dict(L=96), "multiple of 64"),
        (dict(kmask=torch.zeros(B, 128, dtype=torch.float16)), "key mask"),
        (dict(k=torch.zeros(B, 128, H, 128).transpose(1, 2)
              .contiguous().transpose(1, 2)[..., :64]), "contiguous"),
        (dict(v=torch.zeros(B, 128, H, 64, dtype=torch.bfloat16)), "match"),
        (dict(q=torch.zeros(B * 128 * H * 64 + 1)[1:]
              .view(B, 128, H, 64)), "aligned"),
        ({}, "CUDA"),
    ])
    def test_forward_refuses(self, over, match):
        with pytest.raises(ValueError, match=match):
            T.flash_fwd_cuda(**_kernel_args(**over))

    @pytest.mark.parametrize("fn", [T.flash_bwd_dq_cuda, T.flash_bwd_dkv_cuda])
    def test_backward_refuses(self, fn):
        a = _kernel_args()
        rows = torch.zeros(B * H, 128)
        do = torch.zeros_like(a["q"])
        common = (a["q"], a["k"], a["v"], a["kmask"], 0)
        with pytest.raises(ValueError, match="lse/delta"):
            fn(*common, do, rows[:, :64], rows, True, 0.125, 0.0)
        with pytest.raises(ValueError, match="contiguous"):
            fn(*common, do.transpose(1, 2).contiguous().transpose(1, 2),
               rows, rows, True, 0.125, 0.0)
        with pytest.raises(ValueError, match="CUDA"):
            fn(*common, do, rows, rows, True, 0.125, 0.0)

    @pytest.mark.parametrize("fn", [T.flash_fwd_cuda, T.flash_bwd_dq_cuda,
                                    T.flash_bwd_dkv_cuda])
    def test_refuses_misaligned_mask_and_rows(self, fn):
        # the 16-bit kernels bring the key mask, lse and delta in by bulk
        # copies, which need 16-byte aligned addresses
        a = _kernel_args()
        rows = torch.zeros(B * H, 128)
        shifted = torch.zeros(B * 128 + 1)[1:].view(B, 128)
        common = (a["q"], a["k"], a["v"])
        with pytest.raises(ValueError, match="16-byte aligned"):
            if fn is T.flash_fwd_cuda:
                fn(*common, shifted, 0, True, 0.125, 0.0)
            else:
                fn(*common, shifted, 0, torch.zeros_like(a["q"]), rows,
                   rows, True, 0.125, 0.0)
        if fn is not T.flash_fwd_cuda:
            bad = torch.zeros(B * H * 128 + 2)[2:].view(B * H, 128)
            with pytest.raises(ValueError, match="16-byte aligned"):
                fn(*common, a["kmask"], 0, torch.zeros_like(a["q"]), bad,
                   rows, True, 0.125, 0.0)

    def test_cpu_path_never_launches(self):
        before = (T.flash_fwd_cuda.launches, T.flash_bwd_dq_cuda.launches,
                  T.flash_bwd_dkv_cuda.launches)
        q = torch.randn(1, 128, 1, 64, requires_grad=True)
        T.flash_attention(q, q, q, causal=True).sum().backward()
        assert (T.flash_fwd_cuda.launches, T.flash_bwd_dq_cuda.launches,
                T.flash_bwd_dkv_cuda.launches) == before


class TestKernelSources:
    """The port's kernels are its own: no source of a kernel or of its
    wrappers reaches a library's attention, cuDNN or cuBLAS."""

    def test_no_library_kernels(self):
        import re
        from pathlib import Path

        root = Path(T.__file__).resolve().parent.parent
        files = sorted((root / "csrc").glob("*.cu")) + \
            sorted((root / "csrc").glob("*.cuh")) + \
            sorted((root / "ops").glob("*.py"))
        assert len(files) >= 10
        banned = re.compile(r"scaled_dot_product_attention|cudnn|cublas|"
                            r"flash_attn_|torch\.compile", re.IGNORECASE)
        for f in files:
            hits = [ln for ln in f.read_text().splitlines()
                    if banned.search(ln)]
            assert not hits, f"{f.name} names a library kernel: {hits}"

    def test_16bit_kernels_are_wgmma_and_tma(self):
        from pathlib import Path

        src = (Path(T.__file__).resolve().parent.parent / "csrc" /
               "flash_attention.cu").read_text()
        hdr = (Path(T.__file__).resolve().parent.parent / "csrc" /
               "sm90.cuh").read_text()
        for name in ("flash_fwd_wgmma", "flash_bwd_dq_wgmma",
                     "flash_bwd_dkv_wgmma"):
            assert f"\n{name}(" in src
        for gone in ("flash_fwd_mma", "flash_bwd_dq_mma", "flash_bwd_dkv_mma",
                     "mma.sync", "Kt + D"):
            assert gone not in src
        assert '#include "sm90.cuh"' in src
        for ptx in ("wgmma.mma_async", "cp.async.bulk.tensor",
                    "mbarrier.try_wait.parity", "setmaxnreg"):
            assert ptx in hdr

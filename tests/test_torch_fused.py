"""Port parity for the fused LN epilogue and the flat AdamW sweep
(paddle_tpu_torch/ops/fused.py): the same numpy inputs go through the JAX
package and the port.

The JAX side runs its Pallas kernels in interpret mode
(``FLAGS_use_fused_ln`` and ``FLAGS_fused_ln_interpret`` on, reset after
each test); the port's CPU tensors take the kernels' plain versions
(``ln_fwd_ref``, ``ln_bwd_ref``, ``adamw_flat_ref``).

Tolerances: forward out and rout fp32 rtol/atol 2e-6 (the same formula,
other summation order); bf16 1e-2 (one bf16 ulp: both round the same fp32
value, last-bit ties can differ).  Gradients dx, dres, dw, db, dbias fp32
1e-5 relative to the reference's max abs.  The dropout keep pattern is
bit-exact.  AdamW over 3 steps: fp32 rtol 1e-6 with an atol of 1e-6 of
the buffer's max abs (the same operation order, but XLA contracts
``b1 * m + (1 - b1) * g`` into an FMA: where the two terms cancel, the
last-bit difference of the operands shows); bf16 parameters 8e-3 (one
bf16 ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import paddle_tpu.ops.fused as JF
from paddle_tpu.core.flags import set_flags as j_set_flags
from paddle_tpu_torch.core import flags as TFL
from paddle_tpu_torch.ops import fused as TF

SEED = 7


@pytest.fixture
def kernel_on():
    j_set_flags({"FLAGS_use_fused_ln": True, "FLAGS_fused_ln_interpret": True})
    TFL.set_flags({"FLAGS_use_fused_ln": True})
    yield
    j_set_flags({"FLAGS_use_fused_ln": False,
                 "FLAGS_fused_ln_interpret": False})
    TFL.set_flags({"FLAGS_use_fused_ln": False})


def _inputs(B=2, L=32, H=64, seed=0):
    rs = np.random.RandomState(seed)
    return dict(x=rs.randn(B, L, H).astype(np.float32),
                res=rs.randn(B, L, H).astype(np.float32),
                w=(rs.rand(H) + 0.5).astype(np.float32),
                b=(rs.randn(H) * 0.1).astype(np.float32),
                bias=(rs.randn(H) * 0.1).astype(np.float32))


def _jax(d, dtype=jnp.float32, bias=True):
    return (jnp.asarray(d["x"], dtype), jnp.asarray(d["res"], dtype),
            jnp.asarray(d["w"]), jnp.asarray(d["b"]),
            jnp.asarray(d["bias"]) if bias else None)


def _torch(d, dtype=torch.float32, bias=True, grad=False):
    ts = [torch.tensor(d[k]) for k in ("x", "res", "w", "b")]
    ts[0], ts[1] = ts[0].to(dtype), ts[1].to(dtype)
    ts.append(torch.tensor(d["bias"]) if bias else None)
    if grad:
        ts = [t if t is None else t.requires_grad_() for t in ts]
    return ts


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


def _loss_j(p, seed):
    def f(x, res, w, b, bias):
        out, rout = JF.fused_ln_residual_dropout(
            x, res, w, b, bias=bias, dropout_p=p,
            dropout_seed=None if p == 0 else jnp.uint32(seed))
        return jnp.sum(out * out) + jnp.sum(jnp.sin(rout))
    return f


def _loss_t(x, res, w, b, bias, p, seed):
    out, rout = TF.fused_ln_residual_dropout(
        x, res, w, b, bias=bias, dropout_p=p,
        dropout_seed=None if p == 0 else seed)
    return (out * out).sum() + torch.sin(rout).sum()


# ------------------------------------------------------------- forward --

class TestForward:
    @pytest.mark.parametrize("bias", [True, False])
    @pytest.mark.parametrize("dtype,tol", [("float32", 2e-6),
                                           ("bfloat16", 1e-2)])
    def test_matches_reference(self, kernel_on, dtype, tol, bias):
        d = _inputs()
        jo, jr = JF.fused_ln_residual_dropout(
            *_jax(d, getattr(jnp, dtype), bias)[:4],
            bias=_jax(d)[4] if bias else None)
        to, tr = TF.fused_ln_residual_dropout(
            *_torch(d, getattr(torch, dtype), bias)[:4],
            bias=_torch(d)[4] if bias else None)
        assert to.dtype == tr.dtype == getattr(torch, dtype)
        _close(to, jo, tol)
        _close(tr, jr, tol)

    def test_width_not_a_multiple_of_eight(self, kernel_on):
        d = _inputs(H=100, seed=3)
        jo, jr = JF.fused_ln_residual_dropout(*_jax(d)[:4], bias=_jax(d)[4])
        to, tr = TF.fused_ln_residual_dropout(*_torch(d)[:4],
                                              bias=_torch(d)[4])
        _close(to, jo, 2e-6)
        _close(tr, jr, 2e-6)

    def test_statistics_match_the_pallas_kernel(self):
        d = _inputs(seed=4)
        x, res, w, b, bias = _jax(d)
        N, H = 64, 64
        _, _, jmu, jrstd = JF._ln_pallas_fwd(
            x.reshape(N, H), res.reshape(N, H), w, b, bias,
            jnp.full((1,), SEED, jnp.uint32), 0.1, 1e-5, True)
        tx, tres, tw, tb, tbias = _torch(d)
        _, _, mu, rstd = TF.ln_fwd_ref(tx.reshape(N, H), tres.reshape(N, H),
                                       tw, tb, tbias, SEED, 0.1, 1e-5)
        assert mu.shape == rstd.shape == (N,)
        _close(mu, np.asarray(jmu)[:, 0], 2e-6)
        _close(rstd, np.asarray(jrstd)[:, 0], 2e-6)


# ----------------------------------------------------------- gradients --

class TestGradients:
    @pytest.mark.parametrize("bias", [True, False])
    @pytest.mark.parametrize("p", [0.0, 0.1])
    def test_match_reference(self, kernel_on, bias, p):
        d = _inputs(seed=1)
        args = _jax(d, bias=bias)
        argnums = (0, 1, 2, 3, 4) if bias else (0, 1, 2, 3)
        jg = jax.grad(lambda *a: _loss_j(p, SEED)(*a, *(() if bias else
                                                      (None,))),
                      argnums=argnums)(*args[:len(argnums)])
        ts = _torch(d, bias=bias, grad=True)
        leaves = [t for t in ts if t is not None]
        tg = torch.autograd.grad(_loss_t(*ts, p, SEED), leaves)
        for got, want, name in zip(tg, jg, ("dx", "dres", "dw", "db",
                                            "dbias")):
            want = np.asarray(want)
            np.testing.assert_allclose(
                got.numpy(), want, rtol=1e-5,
                atol=1e-5 * np.abs(want).max(), err_msg=name)

    def test_plain_backward_is_the_plain_forward_autograd(self):
        d = _inputs(seed=2)
        N, H = 64, 64
        x, res, w, b, bias = _torch(d, grad=True)
        x2, res2 = x.reshape(N, H), res.reshape(N, H)
        out, rout, mu, rstd = TF.ln_fwd_ref(x2, res2, w, b, bias, SEED, 0.1,
                                            1e-5)
        r = np.random.RandomState(5)
        dout = torch.tensor(r.randn(N, H).astype(np.float32))
        drout = torch.tensor(r.randn(N, H).astype(np.float32))
        want = torch.autograd.grad((out, rout), (x2, res2, w, b, bias),
                                   (dout, drout))
        # the whole gradient: gm and gxm carry the paths through mu, rstd
        got = TF.ln_bwd_ref(dout, drout, rout.detach(), mu.detach(),
                            rstd.detach(), w.detach(), SEED, 0.1, True)
        for g, wnt in zip(got, want):
            torch.testing.assert_close(g, wnt, rtol=1e-4, atol=1e-4)

    def test_discarded_rout_needs_no_cotangent(self, kernel_on):
        d = _inputs(seed=6)
        x, res, w, b, bias = _torch(d, grad=True)
        out, _ = TF.fused_ln_residual_dropout(x, res, w, b, bias=bias)
        g1 = torch.autograd.grad(out.square().sum(), (x, res, w, b, bias))
        out, rout = TF.fused_ln_residual_dropout(x, res, w, b, bias=bias)
        g2 = torch.autograd.grad(out.square().sum() + 0.0 * rout.sum(),
                                 (x, res, w, b, bias))
        for a, c in zip(g1, g2):
            torch.testing.assert_close(a, c, rtol=0, atol=0)


# -------------------------------------------------------------- dropout --

class TestDropout:
    @pytest.mark.parametrize("seed", [0, SEED, 2**31 + 11, 2**32 - 1])
    @pytest.mark.parametrize("row0", [0, 64, 2**32 - 9])
    def test_keep_mask_bit_exact(self, seed, row0):
        want = np.asarray(JF._keep_mask(jnp.asarray(seed, jnp.uint32), row0,
                                        (16, 100), 0.1))
        got = TF._keep_mask(seed, row0, (16, 100), 0.1).numpy()
        np.testing.assert_array_equal(got, want)
        assert 0.8 < got.mean() < 0.97

    def test_pattern_matches_reference(self, kernel_on):
        """At p 0.1 with a seed: rout agrees, and dx is zero exactly where
        the reference's dx is (the kept positions' dy is never zero)."""
        d = _inputs(seed=8)
        x, res, w, b, _ = _jax(d)
        jo, jr = JF.fused_ln_residual_dropout(
            x, res, w, b, dropout_p=0.1, dropout_seed=jnp.uint32(SEED))
        jdx = jax.grad(lambda xx: jnp.sum(JF.fused_ln_residual_dropout(
            xx, res, w, b, dropout_p=0.1,
            dropout_seed=jnp.uint32(SEED))[0] ** 2))(x)
        tx, tres, tw, tb, _ = _torch(d, grad=True)
        to, tr = TF.fused_ln_residual_dropout(tx, tres, tw, tb, dropout_p=0.1,
                                              dropout_seed=SEED)
        _close(tr, jr, 2e-6)
        _close(to, jo, 2e-6)
        (tdx,) = torch.autograd.grad(to.square().sum(), tx)
        np.testing.assert_array_equal(tdx.numpy() == 0,
                                      np.asarray(jdx) == 0)
        keep = TF._keep_mask(SEED, 0, (64, 64), 0.1).reshape(2, 32, 64)
        np.testing.assert_array_equal(tdx.numpy() != 0, keep.numpy())

    def test_dense_path_drops_the_same_positions(self):
        d = _inputs(seed=9)
        x, res, w, b, bias = _jax(d)
        jo, jr = JF._dense_ln_residual_dropout(x, res, w, b, bias,
                                               jnp.uint32(SEED), 0.1, 1e-5)
        to, tr = TF._dense_ln_residual_dropout(*_torch(d), SEED, 0.1, 1e-5)
        _close(to, jo, 2e-6)
        _close(tr, jr, 2e-6)

    def test_missing_seed_raises(self):
        x, res, w, b, _ = _torch(_inputs())
        with pytest.raises(ValueError, match="dropout_seed"):
            TF.fused_ln_residual_dropout(x, res, w, b, dropout_p=0.1)


# ------------------------------------------------------------- dispatch --

class TestDispatch:
    def _count(self, monkeypatch):
        calls = []
        real = TF._FusedLN.apply
        monkeypatch.setattr(TF._FusedLN, "apply",
                            lambda *a: calls.append(1) or real(*a))
        return calls

    @pytest.mark.parametrize("L,fused", [(32, True), (13, False),
                                         (12, True), (3, False)])
    def test_row_block_rule(self, kernel_on, monkeypatch, L, fused):
        """Flag on: the fused path when N = B·L has a row block in (256 …
        8), else the dense two-pass math — as in the reference."""
        calls = self._count(monkeypatch)
        d = _inputs(L=L, seed=10)
        jo, jr = JF.fused_ln_residual_dropout(*_jax(d)[:4], bias=_jax(d)[4])
        to, tr = TF.fused_ln_residual_dropout(*_torch(d)[:4],
                                              bias=_torch(d)[4])
        assert bool(calls) == fused
        _close(to, jo, 2e-6)
        _close(tr, jr, 2e-6)

    def test_flag_off_takes_the_dense_path(self, monkeypatch):
        calls = self._count(monkeypatch)
        d = _inputs(seed=11)
        jo, _ = JF.fused_ln_residual_dropout(*_jax(d)[:4], bias=_jax(d)[4])
        to, _ = TF.fused_ln_residual_dropout(*_torch(d)[:4],
                                             bias=_torch(d)[4])
        assert not calls
        _close(to, jo, 2e-6)


# ---------------------------------------------------------------- AdamW --

class TestFusedAdamW:
    N = 2 * 8192 + 123

    def _state(self, seed=1):
        rs = np.random.RandomState(seed)
        return (rs.randn(self.N).astype(np.float32),
                (rs.randn(self.N) * 0.1).astype(np.float32),
                (rs.rand(self.N) * 0.01).astype(np.float32))

    @pytest.mark.parametrize("pdtype,tol", [("float32", 1e-6),
                                            ("bfloat16", 8e-3)])
    def test_three_steps_match_reference(self, pdtype, tol):
        p, m, v = self._state()
        rs = np.random.RandomState(2)
        jp = jnp.asarray(p, getattr(jnp, pdtype))
        jm, jv = jnp.asarray(m), jnp.asarray(v)
        tp = torch.tensor(p).to(getattr(torch, pdtype))
        tm, tv = torch.tensor(m), torch.tensor(v)
        for step in (1, 2, 3):
            g = rs.randn(self.N).astype(np.float32)
            kw = dict(lr=1e-3 * step, beta1=0.9, beta2=0.999, eps=1e-8,
                      weight_decay=0.01)
            jp, jm, jv = JF.fused_adamw_flat(
                jp, jnp.asarray(g, jp.dtype), jm, jv, step, **kw)
            tp, tm, tv = TF.fused_adamw_flat(tp, torch.tensor(g).to(tp.dtype),
                                             tm, tv, step, **kw)
        assert tp.dtype == getattr(torch, pdtype) and tm.dtype == torch.float32
        for got, want in ((tp, jp), (tm, jm), (tv, jv)):
            want = np.asarray(want, np.float32)
            np.testing.assert_allclose(got.float().numpy(), want, rtol=tol,
                                       atol=tol * np.abs(want).max())

    def test_scalars_match_reference(self):
        got = TF._adamw_scalars(3, 1e-3, 0.9, 0.999, 1e-8, 0.01)
        step_f = jnp.asarray(3, jnp.float32)
        b1, b2 = jnp.asarray(0.9, jnp.float32), jnp.asarray(0.999, jnp.float32)
        want = [np.float32(1e-3), b1, b2, np.float32(1e-8), np.float32(0.01),
                1.0 - b1 ** step_f, 1.0 - b2 ** step_f]
        np.testing.assert_allclose(got, np.asarray(want, np.float32),
                                   rtol=1e-7, atol=0)

    def test_odd_sizes(self):
        for n in (1, 127, 4096):
            po, mo, vo = TF.fused_adamw_flat(
                torch.ones(n), torch.full((n,), 0.5), torch.zeros(n),
                torch.zeros(n), 1, 0.1)
            assert po.shape == (n,) and bool((po < 1.0).all())
            torch.testing.assert_close(mo, torch.full((n,), 0.05))


# --------------------------------------------------------- the wrappers --

def _ln_args(**over):
    N, H = over.pop("N", 16), over.pop("H", 64)
    dt = over.pop("dtype", torch.float32)
    x = torch.zeros(N, H, dtype=dt)
    args = dict(x2=x, res2=x.clone(), w=torch.ones(H), b=torch.zeros(H),
                bias=None, seed=0, dropout_p=0.0, eps=1e-5)
    args.update(over)
    return args


class TestKernelWrappers:
    @pytest.mark.parametrize("over,match", [
        (dict(dtype=torch.float64), "dtype"),
        (dict(x2=torch.zeros(16 * 64)), "rows"),
        (dict(res2=torch.zeros(16, 64, dtype=torch.bfloat16)), "match"),
        (dict(res2=torch.zeros(64, 16).T), "contiguous"),
        (dict(w=torch.ones(32)), "weight vectors"),
        (dict(bias=torch.ones(65)), "weight vectors"),
        (dict(dropout_p=1.0), "dropout_p"),
        ({}, "CUDA"),
    ])
    def test_forward_refuses(self, over, match):
        with pytest.raises(ValueError, match=match):
            TF.fused_ln_fwd_cuda(**_ln_args(**over))

    def test_backward_refuses(self):
        rows, stats = torch.zeros(16, 64), torch.zeros(16)
        w = torch.ones(64)
        with pytest.raises(ValueError, match="mu/rstd"):
            TF.fused_ln_bwd_cuda(rows, None, rows, stats[:8], stats, w, 0,
                                 0.0, True)
        with pytest.raises(ValueError, match="match"):
            TF.fused_ln_bwd_cuda(rows, rows.half(), rows, stats, stats, w, 0,
                                 0.0, True)
        with pytest.raises(ValueError, match="CUDA"):
            TF.fused_ln_bwd_cuda(rows, None, rows, stats, stats, w, 0, 0.0,
                                 True)

    @pytest.mark.parametrize("over,match", [
        (dict(p=torch.zeros(4, 4)), "flat"),
        (dict(g=torch.zeros(8)), "every buffer"),
        (dict(g=torch.zeros(16, dtype=torch.bfloat16)), "g must match"),
        (dict(v=torch.zeros(16, dtype=torch.float16)), "g must match"),
        (dict(m=torch.zeros(16, dtype=torch.int32),
              v=torch.zeros(16, dtype=torch.int32)), "not supported"),
        (dict(m=torch.zeros(32)[::2]), "contiguous"),
        ({}, "CUDA"),
    ])
    def test_adamw_refuses(self, over, match):
        args = dict(p=torch.zeros(16), g=torch.zeros(16), m=torch.zeros(16),
                    v=torch.zeros(16))
        args.update(over)
        with pytest.raises(ValueError, match=match):
            TF.fused_adamw_flat_cuda(**args, scalars=[0.0] * 7)

    def test_cpu_path_never_launches(self, kernel_on):
        before = (TF.fused_ln_fwd_cuda.launches,
                  TF.fused_ln_bwd_cuda.launches,
                  TF.fused_adamw_flat_cuda.launches)
        x, res, w, b, bias = _torch(_inputs(), grad=True)
        out, _ = TF.fused_ln_residual_dropout(x, res, w, b, bias=bias)
        out.sum().backward()
        TF.fused_adamw_flat(torch.ones(8), torch.ones(8), torch.zeros(8),
                            torch.zeros(8), 1, 0.1)
        assert (TF.fused_ln_fwd_cuda.launches, TF.fused_ln_bwd_cuda.launches,
                TF.fused_adamw_flat_cuda.launches) == before


class TestPersistentBackwardGrid:
    """The LN backward's persistent grid, sized on the host: at most one
    block of 16 warps a streaming multiprocessor, as few blocks as give
    every warp the same row count, its partials one row a block."""

    @pytest.mark.parametrize("N,sms,blocks", [
        (8192, 132, 128), (5000, 132, 105), (1000, 132, 63), (24, 132, 2),
        (1, 132, 1), (200, 16, 13), (8192, 114, 103)])
    def test_blocks(self, N, sms, blocks):
        assert TF.ln_bwd_blocks(N, sms) == blocks

    @pytest.mark.parametrize("N,warps", [(8192, 16), (1000, 16), (24, 16),
                                         (4099, 8), (37, 1)])
    def test_walk_covers_every_row_once_and_sums_in_order(self, N, warps):
        """Warp w of block b takes rows b * W + w + k * blocks * W (the
        kernel's walk); per-block partials added in block order give the
        plain version's column sums."""
        blocks = TF.ln_bwd_blocks(N, 132)
        seen = np.zeros(N, np.int64)
        rs = np.random.RandomState(N)
        d = torch.tensor(rs.randn(N, 8).astype(np.float32))
        part = torch.zeros(blocks, 8)
        for b in range(blocks):
            for w in range(warps):
                rows = np.arange(b * warps + w, N, blocks * warps)
                seen[rows] += 1
                part[b] += d[rows].sum(0)
        assert (seen == 1).all()
        np.testing.assert_allclose(part.sum(0).numpy(), d.sum(0).numpy(),
                                   rtol=1e-5, atol=1e-5)

    def test_c_interface_matches_argtypes(self):
        """fused_ln_bwd's extern "C" signature takes the grid, and its
        parameter count is the wrapper's."""
        import re
        from paddle_tpu_torch.ops import _build
        text = (_build.CSRC / _build.SOURCES["fused"]).read_text()
        sig = re.search(r'extern "C" int fused_ln_bwd\((.*?)\)', text,
                        re.S).group(1)
        assert len(sig.split(",")) == len(TF._ARGTYPES["fused_ln_bwd"])
        assert "int N, int H, int blocks," in " ".join(sig.split())

    def test_partials_refuse_cpu_before_sizing(self):
        rows, stats = torch.zeros(16, 64), torch.zeros(16)
        with pytest.raises(ValueError, match="CUDA"):
            TF.ln_bwd_partials_cuda(rows, None, rows, stats, stats,
                                    torch.ones(64), 0, 0.0)


# ---------------------------------------------------------------- flags --

class TestFlags:
    def test_defaults_and_no_kill_switch(self):
        got = TFL.get_flags()
        assert got["FLAGS_use_fused_ln"] is False
        assert got["FLAGS_use_fused_adamw"] is False
        for name in ("FLAGS_use_pallas_kernels", "FLAGS_fused_ln_interpret",
                     "FLAGS_paged_attn_interpret"):
            assert name not in got

    def test_set_get_and_environment_seed(self, monkeypatch):
        monkeypatch.setenv("FLAGS_torch_test_only", "on")
        monkeypatch.setitem(TFL._REGISTRY, "FLAGS_torch_test_only", None)
        del TFL._REGISTRY["FLAGS_torch_test_only"]
        TFL.define_flag("FLAGS_torch_test_only", False)
        assert TFL.flag("FLAGS_torch_test_only") is True
        TFL.set_flags({"FLAGS_torch_test_only": False})
        assert TFL.get_flags("FLAGS_torch_test_only") == {
            "FLAGS_torch_test_only": False}

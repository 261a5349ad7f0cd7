"""Fused training kernels (counterpart of ``paddle_tpu/ops/fused.py``).

- The LayerNorm epilogue: ``residual_out = residual + dropout(x + bias)``,
  ``out = LayerNorm(residual_out) * ln_scale + ln_bias``, both returned.
  ``fused_ln_residual_dropout`` dispatches as the reference does: the fused
  path when ``FLAGS_use_fused_ln`` is on and the row count N has a row
  block in (256, 128, 64, 32, 16, 8), else ``_dense_ln_residual_dropout``
  (two-pass variance, PyTorch's own autograd).  The fused path is
  ``_FusedLN``, the counterpart of the reference's ``custom_vjp``: its
  forward and backward are two hand-written Hopper kernels
  (``csrc/fused.cu`` ``fused_ln_fwd`` and ``fused_ln_bwd``, replacing
  ``_ln_fwd_kernel`` and ``_ln_bwd_kernel``) with plain versions beside
  them (``ln_fwd_ref``, ``ln_bwd_ref``) that keep the kernels' math:
  variance E[y²] − μ², the backward's xhat rebuilt from the saved rout.
  The backward moves bytes: it runs a persistent grid (``ln_bwd_blocks``:
  a block of up to 16 warps a streaming multiprocessor) whose warps stage
  the next row with cp.async while the current one reduces, keep their
  columns' dw, db and dbias sums in registers and write one partial row a
  block; one PyTorch sum adds the ~132 rows.  At BERT's shape (N 8192, H
  768, bf16) 0.0405 ms with the sum against 0.0527 ms before the redesign
  (NVIDIA H100 80GB HBM3, 700.00 W, cold L2; ``PERF.md`` §6).
- ``fused_adamw_flat``: one AdamW sweep over a flat buffer (kernel
  ``fused_adamw_flat`` replacing ``_adamw_kernel``; plain version
  ``adamw_flat_ref``).  No trainer calls it, as in the reference.

The dropout mask is the position hash of ``ops/attention.py`` over global
row ids and feature ids, mixed with ``seed * 0xC2B2AE3D``: the same bits in
the forward and the backward, and in the dense and fused paths, so no
(N, H) mask is stored.  CPU tensors take the plain versions, CUDA tensors
the kernels; there is no fallback between the two.
"""

from __future__ import annotations

import ctypes

import torch

from ..core.flags import flag
from . import attention as _attn
from .attention import _DTYPE_CODE, _M32, position_hash_keep

_ROW_BLOCKS = (256, 128, 64, 32, 16, 8)


def _mixed(seed) -> int:
    """The LN mask's seed mix: seed * 0xC2B2AE3D mod 2**32."""
    return ((int(seed) & _M32) * 0xC2B2AE3D) & _M32


def _keep_mask(seed, row0, shape, dropout_p, device=None):
    """Keep-mask of ``shape`` = (rows, H): rows are global row ids from
    ``row0``, columns feature ids from 0."""
    return position_hash_keep(_mixed(seed), row0, 0, shape, dropout_p,
                              device=device)


def _keep_div(dropout_p, device):
    """float32(1 - p) on ``device``, so a kept element divides exactly (a
    CPU scalar would become a multiply by its reciprocal on CUDA)."""
    return torch.tensor(1.0 - dropout_p, dtype=torch.float32, device=device)


def _drop(x, seed, dropout_p):
    if dropout_p <= 0.0:
        return x
    keep = _keep_mask(seed, 0, x.shape, dropout_p, device=x.device)
    return torch.where(keep, x / _keep_div(dropout_p, x.device),
                       torch.zeros_like(x))


# ---------------------------------------------------------------------------
# Plain versions of the two LN kernels
# ---------------------------------------------------------------------------

def ln_fwd_ref(x2, res2, w, b, bias, seed, dropout_p, eps):
    """Plain version of ``fused_ln_fwd`` on (N, H) x and residual: returns
    (out, rout) in x's dtype and (mu, rstd) fp32 (N,)."""
    x = x2.float()
    if bias is not None:
        x = x + bias.float()
    y = res2.float() + _drop(x, seed, dropout_p)
    mu = y.mean(-1)
    var = y.square().mean(-1) - mu.square()
    rstd = torch.rsqrt(var + eps)
    out = (y - mu[:, None]) * rstd[:, None] * w.float() + b.float()
    return out.to(x2.dtype), y.to(x2.dtype), mu, rstd


def ln_bwd_ref(dout, drout, rout, mu, rstd, w, seed, dropout_p, has_bias):
    """Plain version of ``fused_ln_bwd``: returns (dx, dres) in dout's dtype
    and the fp32 column sums (dw, db, dbias); dbias is None without a bias.
    ``drout`` None reads as zeros."""
    xhat = (rout.float() - mu[:, None]) * rstd[:, None]
    d = dout.float()
    g = d * w.float()
    gm = g.mean(-1, keepdim=True)
    gxm = (g * xhat).mean(-1, keepdim=True)
    dy = (g - gm - xhat * gxm) * rstd[:, None]
    if drout is not None:
        dy = dy + drout.float()
    dx = _drop(dy, seed, dropout_p)
    return (dx.to(dout.dtype), dy.to(dout.dtype), (d * xhat).sum(0),
            d.sum(0), dx.sum(0) if has_bias else None)


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "fused_ln_fwd": ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 2 + [ctypes.c_float, ctypes.c_int]
                     + [ctypes.c_uint32] * 2
                     + [ctypes.c_float, ctypes.c_void_p]),
    "fused_ln_bwd": ([ctypes.c_int] + [ctypes.c_void_p] * 9
                     + [ctypes.c_int] * 4 + [ctypes.c_uint32] * 2
                     + [ctypes.c_float, ctypes.c_void_p]),
    "fused_adamw_flat": ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 7
                         + [ctypes.c_longlong] + [ctypes.c_float] * 7
                         + [ctypes.c_void_p]),
}

# The backward's persistent grid: one block a streaming multiprocessor, and
# no more blocks than N / _BWD_ROWS_PER_BLOCK (a block has up to 16 warps),
# so small N leaves no block without rows.
_BWD_BLOCKS_PER_SM = 1
_BWD_ROWS_PER_BLOCK = 16
_sm_counts = {}


def _kernel(name):
    from ._build import load_library

    fn = getattr(load_library("fused"), name)
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES[name]
        fn.restype = ctypes.c_int
    return fn


def _need(ok, name, what):
    if not ok:
        raise ValueError(f"{name}: {what}")


def _check_rows(name, ref, rows=(), vecs=(), stats=()):
    """Everything the LN kernels assume, checked before any pointer leaves
    Python: (N, H) operands of one supported dtype, (H,) weight vectors,
    fp32 (N,) statistics, contiguity, one CUDA device."""
    _need(ref.dim() == 2 and ref.numel() > 0, name,
          f"takes (N, H) rows, got {tuple(ref.shape)}")
    N, H = ref.shape
    _need(ref.dtype in _DTYPE_CODE, name, f"dtype {ref.dtype} not supported")
    for t in rows:
        _need(tuple(t.shape) == (N, H) and t.dtype == ref.dtype, name,
              f"every (N, H) operand must match {(N, H)} {ref.dtype}, got "
              f"{tuple(t.shape)} {t.dtype}")
    for t in vecs:
        _need(tuple(t.shape) == (H,), name,
              f"weight vectors must be (H,) = {(H,)}, got {tuple(t.shape)}")
    for t in stats:
        _need(tuple(t.shape) == (N,) and t.dtype == torch.float32, name,
              f"mu/rstd must be float32 (N,) = {(N,)}, got "
              f"{tuple(t.shape)} {t.dtype}")
    for t in (ref, *rows, *stats):
        _need(t.is_contiguous(), name, "every (N, H) operand and statistic "
                                       "must be contiguous")
    for t in (ref, *rows, *vecs, *stats):
        _need(t.device == ref.device, name, "every input must be on one "
                                            "device")
    _need(ref.device.type == "cuda", name,
          f"takes CUDA tensors, got {ref.device}")
    return N, H


def _dropout_args(seed, dropout_p):
    """The flash kernels' dropout arguments with the LN mask's seed mix."""
    drop, seed32, thresh, keep_div = _attn._dropout_args(seed, dropout_p)
    return drop, _mixed(seed32), thresh, keep_div


def _f32_vec(t):
    return None if t is None else t.to(torch.float32).contiguous()


def _ptr(t):
    return None if t is None else t.data_ptr()


def _launch(name, args, device):
    fn = _kernel(name)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*args, stream)
    if rc == -2:
        raise ValueError(f"{name}: the row width H needs more shared memory "
                         f"than a block has")
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")


def fused_ln_fwd_cuda(x2, res2, w, b, bias, seed, dropout_p, eps):
    """Launch ``fused_ln_fwd`` on PyTorch's current stream: returns (out,
    rout) in x's dtype and (mu, rstd) fp32 (N,).  w, b and bias go to the
    kernel as fp32.  Each launch adds one to ``fused_ln_fwd_cuda.launches``.
    """
    name = "fused_ln_fwd_cuda"
    vecs = (w, b) if bias is None else (w, b, bias)
    drop, mixed, thresh, keep_div = _dropout_args(seed, dropout_p)
    N, H = _check_rows(name, x2, (res2,), vecs)
    w32, b32, bias32 = _f32_vec(w), _f32_vec(b), _f32_vec(bias)
    out, rout = torch.empty_like(x2), torch.empty_like(x2)
    mu = torch.empty(N, dtype=torch.float32, device=x2.device)
    rstd = torch.empty_like(mu)
    _launch("fused_ln_fwd", (
        _DTYPE_CODE[x2.dtype], x2.data_ptr(), res2.data_ptr(),
        w32.data_ptr(), b32.data_ptr(), _ptr(bias32), out.data_ptr(),
        rout.data_ptr(), mu.data_ptr(), rstd.data_ptr(), N, H, float(eps),
        drop, mixed, thresh, keep_div), x2.device)
    fused_ln_fwd_cuda.launches += 1
    return out, rout, mu, rstd


def ln_bwd_blocks(n_rows, sm_count):
    """The backward kernel's grid, which is also its partial rows: at most
    ``_BWD_BLOCKS_PER_SM`` blocks a streaming multiprocessor, each
    ``_BWD_ROWS_PER_BLOCK`` warps taking the same number of rows where N
    allows (8192 rows on 132 SMs: 128 blocks, 4 rows a warp, rather than
    132 with 3 or 4), at least one."""
    per_warp = -(-n_rows // (sm_count * _BWD_BLOCKS_PER_SM
                             * _BWD_ROWS_PER_BLOCK))
    return max(1, -(-n_rows // (_BWD_ROWS_PER_BLOCK * per_warp)))


def _sm_count(device):
    n = _sm_counts.get(device)
    if n is None:
        n = _sm_counts[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return n


def ln_bwd_partials_cuda(dout, drout, rout, mu, rstd, w, seed, dropout_p):
    """Launch ``fused_ln_bwd``: returns (dx, dres) in dout's dtype and the
    kernel's fp32 (blocks, 3, H) partial column sums of dw, db and dbias,
    one row of each a block of its persistent grid (``ln_bwd_blocks``);
    ``drout`` None is not read.  Each launch adds one to
    ``fused_ln_bwd_cuda.launches``."""
    drop, mixed, thresh, keep_div = _dropout_args(seed, dropout_p)
    rows = (rout,) if drout is None else (rout, drout)
    N, H = _check_rows("fused_ln_bwd_cuda", dout, rows, (w,), (mu, rstd))
    nb = ln_bwd_blocks(N, _sm_count(dout.device))
    w32 = _f32_vec(w)                      # alive until after the launch
    dx, dres = torch.empty_like(dout), torch.empty_like(dout)
    part = torch.empty(nb, 3, H, dtype=torch.float32, device=dout.device)
    _launch("fused_ln_bwd", (
        _DTYPE_CODE[dout.dtype], dout.data_ptr(), _ptr(drout),
        rout.data_ptr(), mu.data_ptr(), rstd.data_ptr(),
        w32.data_ptr(), dx.data_ptr(), dres.data_ptr(),
        part.data_ptr(), N, H, nb, drop, mixed, thresh, keep_div),
        dout.device)
    fused_ln_bwd_cuda.launches += 1
    return dx, dres, part


def fused_ln_bwd_cuda(dout, drout, rout, mu, rstd, w, seed, dropout_p,
                      has_bias):
    """The kernel (``ln_bwd_partials_cuda``) and one PyTorch sum of its
    partials, as the reference sums the Pallas call's: returns (dx, dres)
    in dout's dtype and the fp32 column sums (dw, db, dbias); dbias is
    None without a bias."""
    dx, dres, part = ln_bwd_partials_cuda(dout, drout, rout, mu, rstd, w,
                                          seed, dropout_p)
    dw, db, dbias = part.sum(0).unbind(0)
    return dx, dres, dw, db, dbias if has_bias else None


fused_ln_fwd_cuda.launches = 0
fused_ln_bwd_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd plumbing
# ---------------------------------------------------------------------------

class _FusedLN(torch.autograd.Function):
    """Counterpart of the reference's ``_fused_ln_core`` ``custom_vjp`` on
    (N, H) rows: saves rout, mu, rstd, w and the seed.  The gradients of
    ln_scale, ln_bias and bias come back in ln_scale's dtype, as in the
    reference.  A cotangent that never arrives (BERT discards rout) is not
    materialised: the backward kernel skips its read."""

    @staticmethod
    def forward(ctx, x2, res2, w, b, bias, seed, dropout_p, eps):
        x2, res2 = x2.contiguous(), res2.contiguous()
        fwd = ln_fwd_ref if x2.device.type == "cpu" else fused_ln_fwd_cuda
        out, rout, mu, rstd = fwd(x2, res2, w, b, bias, seed, dropout_p, eps)
        ctx.save_for_backward(rout, mu, rstd, w)
        ctx.args = (seed, dropout_p, bias is not None)
        ctx.set_materialize_grads(False)
        return out, rout

    @staticmethod
    def backward(ctx, dout, drout):
        rout, mu, rstd, w = ctx.saved_tensors
        seed, dropout_p, has_bias = ctx.args
        dout = torch.zeros_like(rout) if dout is None else dout.contiguous()
        drout = None if drout is None else drout.contiguous()
        bwd = ln_bwd_ref if rout.device.type == "cpu" else fused_ln_bwd_cuda
        dx, dres, dw, db, dbias = bwd(dout, drout, rout, mu, rstd, w, seed,
                                      dropout_p, has_bias)
        return (dx, dres, dw.to(w.dtype), db.to(w.dtype),
                None if dbias is None else dbias.to(w.dtype), None, None,
                None)


def _pick_block_rows(n):
    return next((b for b in _ROW_BLOCKS if n % b == 0), None)


def _dense_ln_residual_dropout(x, residual, ln_scale, ln_bias, bias, seed,
                               dropout_p, eps):
    """The reference's fallback: the same function in plain PyTorch with
    the two-pass (population) variance; rows of the keep-mask are counted
    over the flattened leading dims from 0."""
    x32 = x.float()
    if bias is not None:
        x32 = x32 + bias.float()
    H = x32.shape[-1]
    x32 = _drop(x32.reshape(-1, H), seed, dropout_p).reshape(x32.shape)
    y = residual.float() + x32
    mu = y.mean(-1, keepdim=True)
    var = (y - mu).square().mean(-1, keepdim=True)
    out = (y - mu) * torch.rsqrt(var + eps) * ln_scale.float() \
        + ln_bias.float()
    return out.to(x.dtype), y.to(x.dtype)


def fused_ln_residual_dropout(x, residual, ln_scale, ln_bias, bias=None,
                              dropout_p=0.0, dropout_seed=None, eps=1e-5):
    """residual_out = residual + dropout(x + bias);
    out = LayerNorm(residual_out) * ln_scale + ln_bias.  Returns
    (out, residual_out), shapes (..., H), in x's dtype.

    ``dropout_seed`` (a uint32 value) selects the keep-mask, so it is
    required with ``dropout_p > 0``."""
    if dropout_p > 0.0 and dropout_seed is None:
        # a silent default seed would replay one fixed keep-mask every step
        raise ValueError("dropout_p > 0 requires dropout_seed (vary per "
                         "step)")
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32
    H = x.shape[-1]
    N = x.numel() // H
    if not (flag("FLAGS_use_fused_ln") and _pick_block_rows(N) is not None):
        return _dense_ln_residual_dropout(x, residual, ln_scale, ln_bias,
                                          bias, seed, dropout_p, eps)
    out2, rout2 = _FusedLN.apply(x.reshape(N, H), residual.reshape(N, H),
                                 ln_scale, ln_bias, bias, seed,
                                 float(dropout_p), float(eps))
    return out2.reshape(x.shape), rout2.reshape(x.shape)


# ---------------------------------------------------------------------------
# Fused AdamW over a flat buffer
# ---------------------------------------------------------------------------

def _adamw_scalars(step, lr, beta1, beta2, eps, weight_decay):
    """The reference's seven fp32 scalars [lr, b1, b2, eps, wd, 1 - b1^t,
    1 - b2^t], the powers taken in fp32 with t = float32(step)."""
    f = lambda v: torch.tensor(float(v), dtype=torch.float32)
    t, b1, b2 = f(step), f(beta1), f(beta2)
    return [float(v) for v in (f(lr), b1, b2, f(eps), f(weight_decay),
                               1.0 - b1 ** t, 1.0 - b2 ** t)]


def adamw_flat_ref(p, g, m, v, scalars):
    """Plain version of ``fused_adamw_flat`` in the reference's operation
    order, fp32 throughout: returns new (p, m, v) in their own dtypes."""
    lr, b1, b2, eps, wd, bc1, bc2 = torch.tensor(
        scalars, dtype=torch.float32, device=p.device).unbind()
    g32 = g.float()
    m32 = b1 * m.float() + (1.0 - b1) * g32
    v32 = b2 * v.float() + (1.0 - b2) * g32 * g32
    mhat, vhat = m32 / bc1, v32 / bc2
    p32 = p.float()
    p32 = p32 - lr * (mhat / (torch.sqrt(vhat) + eps) + wd * p32)
    return p32.to(p.dtype), m32.to(m.dtype), v32.to(v.dtype)


def fused_adamw_flat_cuda(p, g, m, v, scalars):
    """Launch ``fused_adamw_flat``: returns new (p, m, v).  p and g share a
    dtype, m and v share one.  Each launch adds one to
    ``fused_adamw_flat_cuda.launches``."""
    name = "fused_adamw_flat_cuda"
    _need(p.dim() == 1 and p.numel() > 0, name,
          f"takes flat (n,) buffers, got {tuple(p.shape)}")
    for t in (g, m, v):
        _need(tuple(t.shape) == tuple(p.shape), name,
              f"every buffer must be {tuple(p.shape)}, got {tuple(t.shape)}")
    _need(p.dtype in _DTYPE_CODE and m.dtype in _DTYPE_CODE, name,
          f"dtypes {p.dtype}/{m.dtype} not supported")
    _need(g.dtype == p.dtype and v.dtype == m.dtype, name,
          f"g must match p's dtype and v m's, got p {p.dtype} g {g.dtype} "
          f"m {m.dtype} v {v.dtype}")
    for t in (p, g, m, v):
        _need(t.is_contiguous(), name, "every buffer must be contiguous")
        _need(t.device == p.device, name, "every buffer must be on p's "
                                          "device")
    _need(p.device.type == "cuda", name, f"takes CUDA tensors, got "
                                         f"{p.device}")
    po, mo, vo = torch.empty_like(p), torch.empty_like(m), torch.empty_like(v)
    _launch("fused_adamw_flat", (
        _DTYPE_CODE[p.dtype], _DTYPE_CODE[m.dtype], p.data_ptr(),
        g.data_ptr(), m.data_ptr(), v.data_ptr(), po.data_ptr(),
        mo.data_ptr(), vo.data_ptr(), p.numel(), *scalars), p.device)
    fused_adamw_flat_cuda.launches += 1
    return po, mo, vo


fused_adamw_flat_cuda.launches = 0


def fused_adamw_flat(p, g, m, v, step, lr, beta1=0.9, beta2=0.999, eps=1e-8,
                     weight_decay=0.01, block=8192):
    """One AdamW sweep over flat (n,) buffers: ``p -= lr * (m̂ / (sqrt(v̂)
    + eps) + wd * p)`` with m̂, v̂ bias-corrected; returns new (p, m, v).
    ``step`` is the 1-based step after increment.  ``block`` (the
    reference's padding width) is accepted and not read: the kernel needs
    no padding."""
    scalars = _adamw_scalars(step, lr, beta1, beta2, eps, weight_decay)
    if p.device.type == "cpu":
        return adamw_flat_ref(p, g, m, v, scalars)
    return fused_adamw_flat_cuda(p, g, m, v, scalars)

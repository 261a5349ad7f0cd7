"""Attention for training (counterpart of ``paddle_tpu/ops/attention.py``).

Layout: (batch, seq, heads, head_dim) — BLHD — at every public function.

- ``dense_attention``: the plain einsum path (scores in q's dtype, fp32
  softmax, the -1e30 causal sentinel).  Its dropout mask is
  ``core.rng.bernoulli`` of its ``dropout_key``: the reference's
  ``jax.random.bernoulli`` mask from the same key, bit for bit.
- ``position_hash_keep``: the reference's counter-free dropout mask, a
  murmur3 finalizer of (row, col) mixed with a seed, bit for bit.
- Flash attention: ``flash_attention`` dispatches as the reference does
  (the flash path when L tiles by 512, 256 or 128 and ``q.shape ==
  k.shape``, else ``dense_attention``).  The flash path is
  ``_FlashAttention``, the counterpart of the reference's ``custom_vjp``:
  its forward and its two backward halves are three hand-written Hopper
  kernels (``csrc/flash_attention.cu``, replacing ``_flash_fwd_kernel``,
  ``_flash_bwd_dq_kernel`` and ``_flash_bwd_dkv_kernel``) with plain
  versions beside them (``flash_fwd_ref``, ``flash_bwd_ref``).  CPU
  tensors take the plain versions, CUDA tensors the kernels; there is no
  fallback between the two.  Its dense fallback draws the reference's
  mask of ``jax.random.PRNGKey(dropout_seed)``.
- ``masked_attention``: the tensor-level entry of
  ``nn.MultiHeadAttention`` and ``nn.functional``'s SDPA, the reference's
  ``ops.attention`` SDPA entry under another name (this directory names
  no library kernel, not even by coincidence).  No
  mask, or a key-padding mask (``_is_key_padding_mask``), goes through
  ``flash_attention`` (the kernels where L tiles by 128); any other mask
  takes ``dense_attention``.  With dropout on, the key is the next draw
  of ``core.rng``'s stream, and the flash seed the low 32 bits of
  ``jax.random.bits`` of it, as in the reference.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ..core import rng
from ._build import note_launch

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_KERNEL_TILE = 64            # rows of the CUDA kernels' q and k tiles
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_M32 = 0xFFFFFFFF


# ---------------------------------------------------------------------------
# Dense path
# ---------------------------------------------------------------------------

def dense_attention(q, k, v, mask=None, causal=False, scale=None,
                    dropout_p=0.0, dropout_key=None):
    """q, k, v: (B, L, H, D).  ``mask``: additive, broadcastable to
    (B, H, Lq, Lk).  Dropout applies when ``dropout_p > 0`` and a
    ``dropout_key`` (``core.rng`` key data) is given, as in the
    reference: keep = ``bernoulli(dropout_key, 1 - p, (B, H, Lq, Lk))``."""
    D = q.shape[-1]
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    scores = torch.einsum("blhd,bmhd->bhlm", q, k) * torch.full(
        (), scale, dtype=q.dtype, device=q.device)
    if causal:
        Lq, Lk = scores.shape[-2], scores.shape[-1]
        row = torch.arange(Lq, device=q.device)[:, None]
        col = torch.arange(Lk, device=q.device)[None, :]
        neg = torch.full((), _NEG_INF, device=q.device).to(scores.dtype)
        scores = torch.where(col <= row + (Lk - Lq), scores, neg)
    if mask is not None:
        scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores.float(), -1).to(q.dtype)
    if dropout_p > 0.0 and dropout_key is not None:
        keep = rng.bernoulli(dropout_key, 1.0 - dropout_p, probs.shape,
                             device=probs.device)
        probs = torch.where(keep, probs / (1.0 - dropout_p),
                            torch.zeros((), dtype=probs.dtype,
                                        device=probs.device))
    return torch.einsum("bhlm,bmhd->blhd", probs, v)


# ---------------------------------------------------------------------------
# Position-hash dropout mask (uint32 arithmetic carried in int64: CPU torch
# has no uint32 shifts or comparisons)
# ---------------------------------------------------------------------------

def _mul32(a, c: int):
    """(a * c) mod 2**32 for int64 ``a`` in [0, 2**32) and a constant
    ``c`` < 2**32, split in 16-bit halves so no product leaves int64."""
    return ((a & 0xFFFF) * c + ((((a >> 16) * c) & 0xFFFF) << 16)) & _M32


def _hash_keep(mixed, rows, cols, dropout_p):
    x = _mul32(rows, 0x9E3779B1) ^ _mul32(cols, 0x85EBCA77)
    x = x ^ mixed
    x = x ^ (x >> 16)
    x = _mul32(x, 0x85EBCA6B)
    x = x ^ (x >> 13)
    x = _mul32(x, 0xC2B2AE35)
    x = x ^ (x >> 16)
    return x >= _threshold(dropout_p)


def _threshold(dropout_p) -> int:
    return min(int(dropout_p * 4294967296.0), 4294967295)


def position_hash_keep(mixed_seed, row0, col0, shape, dropout_p,
                       device=None):
    """Keep-mask of shape ``shape`` = (rows, cols): murmur3-finalize
    hash((row, col) ^ mixed_seed) >= p * 2**32, rows from ``row0`` and
    columns from ``col0`` (both wrap at 2**32, as uint32 does).
    ``mixed_seed`` is a uint32 value (int or integer tensor, broadcast
    against the mask)."""
    rows = (torch.arange(shape[0], dtype=torch.int64, device=device)
            + int(row0)) & _M32
    cols = (torch.arange(shape[1], dtype=torch.int64, device=device)
            + int(col0)) & _M32
    mixed = torch.as_tensor(mixed_seed, device=device).to(torch.int64) & _M32
    return _hash_keep(mixed, rows[:, None], cols[None, :], dropout_p)


def _mixed_seed(seed, bh):
    return (int(seed) + _mul32(torch.as_tensor(bh, dtype=torch.int64),
                               0xC2B2AE3D)) & _M32


def _dropout_keep(seed, bh, q0, k0, shape, dropout_p, device=None):
    """The keep-mask of head ``bh``'s block at (q0, k0)."""
    return position_hash_keep(_mixed_seed(seed, bh), q0, k0, shape,
                              dropout_p, device=device)


def _keep_all_heads(seed, BH, L, dropout_p, device):
    """(BH, L, L) keep-mask of every head, for the plain versions."""
    bh = torch.arange(BH, dtype=torch.int64, device=device)
    mixed = _mixed_seed(seed, bh)[:, None, None]
    pos = torch.arange(L, dtype=torch.int64, device=device)
    return _hash_keep(mixed, pos[None, :, None], pos[None, None, :],
                      dropout_p)


# ---------------------------------------------------------------------------
# Plain versions of the three kernels
# ---------------------------------------------------------------------------

def _to_bh(x):
    B, L, H, D = x.shape
    return x.permute(0, 2, 1, 3).reshape(B * H, L, D)


def _from_bh(x, B, H):
    BH, L, D = x.shape
    return x.reshape(B, H, L, D).permute(0, 2, 1, 3)


def _scores(q, k, kmask, causal, scale, H):
    """fp32 (BH, L, L) scores with the kernels' order: q * scale, then
    the product with K, the key mask, the causal sentinel."""
    qf = _to_bh(q).float() * scale
    s = qf @ _to_bh(k).float().transpose(1, 2)
    BH, L = s.shape[0], s.shape[1]
    bidx = torch.arange(BH, device=q.device) // H
    s = s + kmask.float()[bidx][:, None, :]
    if causal:
        pos = torch.arange(L, device=q.device)
        neg = torch.tensor(_NEG_INF, dtype=s.dtype, device=s.device)
        s = torch.where(pos[None, :] <= pos[:, None], s, neg)
    return s


def _drop(p, seed, dropout_p):
    if dropout_p <= 0.0:
        return p
    keep = _keep_all_heads(seed, p.shape[0], p.shape[1], dropout_p, p.device)
    return torch.where(keep, p / (1.0 - dropout_p), torch.zeros_like(p))


def flash_fwd_ref(q, k, v, kmask, seed, causal, scale, dropout_p):
    """Plain version of the flash forward: returns (out (B, L, H, D) in
    q's dtype, lse (B*H, L) fp32).  Differentiable in q, k, v through
    PyTorch's own autograd."""
    B, L, H, D = q.shape
    s = _scores(q, k, kmask, causal, scale, H)
    m = s.amax(-1, keepdim=True).detach()
    p = torch.exp(s - m)
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = (_drop(p, seed, dropout_p) @ _to_bh(v).float()) / l
    lse = (m + torch.log(l))[..., 0]
    return _from_bh(out, B, H).to(q.dtype), lse


def flash_bwd_ref(q, k, v, kmask, seed, do, lse, delta, causal, scale,
                  dropout_p):
    """Plain version of the two backward kernels, with the math of the
    reference's ``_bwd_block``: P = exp(S - lse), Pd its dropped-out copy,
    dS = Pd * (dO V^T) - P * delta, dQ = scale dS K, dK = scale dS^T Q,
    dV = Pd^T dO.  ``delta`` = rowsum(dO * O), (B*H, L) fp32."""
    B, L, H, D = q.shape
    p = torch.exp(_scores(q, k, kmask, causal, scale, H) - lse[..., None])
    pd = _drop(p, seed, dropout_p)
    dof = _to_bh(do).float()
    ds = pd * (dof @ _to_bh(v).float().transpose(1, 2)) - p * delta[..., None]
    dq = scale * (ds @ _to_bh(k).float())
    dk = scale * (ds.transpose(1, 2) @ _to_bh(q).float())
    dv = pd.transpose(1, 2) @ dof
    return (_from_bh(dq, B, H).to(q.dtype), _from_bh(dk, B, H).to(k.dtype),
            _from_bh(dv, B, H).to(v.dtype))


# ---------------------------------------------------------------------------
# The kernels' wrappers
# ---------------------------------------------------------------------------

_ARGTYPES = {
    "flash_fwd": 3 + 1 + 2,       # q k v | kmask | out lse
    "flash_bwd_dq": 3 + 4 + 1,    # q k v | kmask do lse delta | dq
    "flash_bwd_dkv": 3 + 4 + 2,   # q k v | kmask do lse delta | dk dv
}


def _kernel(name):
    from ._build import load_library

    fn = getattr(load_library("flash_attention"), name)
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * _ARGTYPES[name]
                       + [ctypes.c_int] * 3 + [ctypes.c_float]
                       + [ctypes.c_int] * 2 + [ctypes.c_uint32] * 2
                       + [ctypes.c_float, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, kmask, extra=(), rows=()):
    """Everything the kernels assume, checked before any pointer leaves
    Python: dtype, (B, L, H, D) shapes, head dim, L a multiple of the
    kernel tile, contiguity, 16-byte alignment of every operand (the
    16-bit kernels read them by TMA and bulk copies), one CUDA device."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"{name}: {what}")

    need(q.dim() == 4, f"q must be (B, L, H, D), got {tuple(q.shape)}")
    B, L, H, D = q.shape
    need(q.dtype in _DTYPE_CODE, f"dtype {q.dtype} not supported")
    need(D in _HEAD_DIMS, f"head dim {D} not supported (need one of "
                          f"{_HEAD_DIMS})")
    need(L % _KERNEL_TILE == 0 and L > 0,
         f"sequence length {L} is not a multiple of {_KERNEL_TILE}")
    need(B * H <= 65535, f"B*H = {B * H} exceeds the grid's 65535")
    for t in (k, v, *extra):
        need(tuple(t.shape) == tuple(q.shape) and t.dtype == q.dtype,
             f"every (B, L, H, D) operand must match q's {tuple(q.shape)} "
             f"{q.dtype}, got {tuple(t.shape)} {t.dtype}")
    need(tuple(kmask.shape) == (B, L) and kmask.dtype == torch.float32,
         f"key mask must be float32 (B, L) = {(B, L)}, got "
         f"{tuple(kmask.shape)} {kmask.dtype}")
    for t in rows:
        need(tuple(t.shape) == (B * H, L) and t.dtype == torch.float32,
             f"lse/delta must be float32 (B*H, L), got {tuple(t.shape)} "
             f"{t.dtype}")
    for t in (q, k, v, kmask, *extra, *rows):
        need(t.is_contiguous(), "every input must be contiguous")
        need(t.device == q.device, "every input must be on q's device")
    for t in (q, k, v, *extra):           # TMA and 16-byte loads
        need(t.data_ptr() % 16 == 0, "every (B, L, H, D) operand must be "
                                     "16-byte aligned")
    for t in (kmask, *rows):              # bulk copies, 16 bytes at a time
        need(t.data_ptr() % 16 == 0, "the key mask and lse/delta must be "
                                     "16-byte aligned")
    need(q.device.type == "cuda", f"takes CUDA tensors, got {q.device}")
    return B, L, H, D


def _dropout_args(seed, dropout_p):
    if not 0.0 <= dropout_p < 1.0:
        raise ValueError(f"dropout_p must be in [0, 1), got {dropout_p}")
    keep_div = torch.tensor(1.0 - dropout_p, dtype=torch.float32).item()
    return (int(dropout_p > 0.0), int(seed) & _M32, _threshold(dropout_p),
            keep_div)


def _launch(name, q, args, stream_dev):
    fn = _kernel(name)
    with torch.cuda.device(stream_dev):
        stream = torch.cuda.current_stream(stream_dev).cuda_stream
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name} kernel launch failed (CUDA error {rc})")


def flash_fwd_cuda(q, k, v, kmask, seed, causal, scale, dropout_p):
    """Launch ``flash_fwd`` on PyTorch's current stream: returns (out in
    q's layout and dtype, lse (B*H, L) fp32).  Each launch adds one to
    ``flash_fwd_cuda.launches`` (``note_launch``: a launch inside a CUDA
    graph counts on each replay)."""
    B, L, H, D = _check("flash_fwd_cuda", q, k, v, kmask)
    drop, seed32, thresh, keep_div = _dropout_args(seed, dropout_p)
    out = torch.empty_like(q)
    lse = torch.empty(B * H, L, dtype=torch.float32, device=q.device)
    _launch("flash_fwd", q, (
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kmask.data_ptr(), out.data_ptr(), lse.data_ptr(), B, L, H,
        float(scale), int(causal), drop, seed32, thresh, keep_div),
        q.device)
    note_launch(flash_fwd_cuda)
    return out, lse


def flash_bwd_dq_cuda(q, k, v, kmask, seed, do, lse, delta, causal, scale,
                      dropout_p):
    """Launch ``flash_bwd_dq``: returns dq in q's layout and dtype.  Each
    launch adds one to ``flash_bwd_dq_cuda.launches``."""
    B, L, H, D = _check("flash_bwd_dq_cuda", q, k, v, kmask, (do,),
                        (lse, delta))
    drop, seed32, thresh, keep_div = _dropout_args(seed, dropout_p)
    dq = torch.empty_like(q)
    _launch("flash_bwd_dq", q, (
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kmask.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dq.data_ptr(), B, L, H, float(scale), int(causal), drop, seed32,
        thresh, keep_div), q.device)
    flash_bwd_dq_cuda.launches += 1
    return dq


def flash_bwd_dkv_cuda(q, k, v, kmask, seed, do, lse, delta, causal, scale,
                       dropout_p):
    """Launch ``flash_bwd_dkv``: returns (dk, dv) in k's and v's layout
    and dtype.  Each launch adds one to ``flash_bwd_dkv_cuda.launches``."""
    B, L, H, D = _check("flash_bwd_dkv_cuda", q, k, v, kmask, (do,),
                        (lse, delta))
    drop, seed32, thresh, keep_div = _dropout_args(seed, dropout_p)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    _launch("flash_bwd_dkv", q, (
        _DTYPE_CODE[q.dtype], D, q.data_ptr(), k.data_ptr(), v.data_ptr(),
        kmask.data_ptr(), do.data_ptr(), lse.data_ptr(), delta.data_ptr(),
        dk.data_ptr(), dv.data_ptr(), B, L, H, float(scale), int(causal),
        drop, seed32, thresh, keep_div), q.device)
    flash_bwd_dkv_cuda.launches += 1
    return dk, dv


flash_fwd_cuda.launches = 0
flash_bwd_dq_cuda.launches = 0
flash_bwd_dkv_cuda.launches = 0


# ---------------------------------------------------------------------------
# autograd plumbing (BLHD public layout)
# ---------------------------------------------------------------------------

class _FlashAttention(torch.autograd.Function):
    """Counterpart of the reference's ``custom_vjp``: saves (q, k, v,
    kmask, seed, out, lse); the backward computes delta = rowsum(dO * O)
    outside the kernels, then dQ and dK/dV.  The key mask is a constant:
    its gradient is zero."""

    @staticmethod
    def forward(ctx, q, k, v, kmask, seed, causal, scale, dropout_p):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        kmask = kmask.contiguous()
        fwd = flash_fwd_ref if q.device.type == "cpu" else flash_fwd_cuda
        out, lse = fwd(q, k, v, kmask, seed, causal, scale, dropout_p)
        ctx.save_for_backward(q, k, v, kmask, out, lse)
        ctx.args = (seed, causal, scale, dropout_p)
        return out

    @staticmethod
    def backward(ctx, g):
        q, k, v, kmask, out, lse = ctx.saved_tensors
        seed, causal, scale, dropout_p = ctx.args
        B, L, H, D = q.shape
        do = g.contiguous()
        delta = (do.float() * out.float()).sum(-1).permute(0, 2, 1) \
            .reshape(B * H, L).contiguous()
        if q.device.type == "cpu":
            dq, dk, dv = flash_bwd_ref(q, k, v, kmask, seed, do, lse, delta,
                                       causal, scale, dropout_p)
        else:
            args = (q, k, v, kmask, seed, do, lse, delta, causal, scale,
                    dropout_p)
            dq = flash_bwd_dq_cuda(*args)
            dk, dv = flash_bwd_dkv_cuda(*args)
        return dq, dk, dv, torch.zeros_like(kmask), None, None, None, None


def flash_attention(q, k, v, causal=False, scale=None, key_mask=None,
                    dropout_p=0.0, dropout_seed=None):
    """Public flash attention on (B, L, H, D) tensors.

    ``key_mask``: optional additive mask over keys, (B, Lk) or any shape
    reshapeable to it (e.g. the BERT (B, 1, 1, Lk) padding mask); it is a
    constant (zero gradient on the flash path).  ``dropout_p`` applies to
    the attention probabilities; ``dropout_seed`` (a uint32 value) selects
    the position-hash keep-mask, so it is required with ``dropout_p > 0``.
    """
    B, L, H, D = q.shape
    scale = scale if scale is not None else 1.0 / math.sqrt(D)
    if dropout_p > 0.0 and dropout_seed is None:
        # a silent default seed would replay one fixed keep-mask every step
        raise ValueError("dropout_p > 0 requires dropout_seed (vary it per "
                         "step)")
    seed = 0 if dropout_seed is None else int(dropout_seed) & _M32
    block = next((b for b in (512, 256, 128) if L % b == 0), None)
    if block is not None and q.shape == k.shape:
        kmask = (torch.zeros(B, L, dtype=torch.float32, device=q.device)
                 if key_mask is None
                 else key_mask.reshape(B, L).to(torch.float32))
        if kmask.data_ptr() % 16:
            # a view at an odd offset (e.g. big[:, 1:L + 1]): the kernels
            # copy the mask 16 bytes at a time
            kmask = kmask.clone(memory_format=torch.contiguous_format)
        return _FlashAttention.apply(q, k, v, kmask, seed, causal, scale,
                                     float(dropout_p))
    mask4 = None if key_mask is None else \
        key_mask.reshape(B, 1, 1, k.shape[1]).to(torch.float32)
    return dense_attention(q, k, v, mask=mask4, causal=causal, scale=scale,
                           dropout_p=dropout_p,
                           dropout_key=rng.make_key(seed)
                           if dropout_p > 0.0 else None)


def _is_key_padding_mask(m, B, Lk) -> bool:
    """True for masks that broadcast over heads and query rows: (B, 1, 1,
    Lk), (1, 1, 1, Lk) or (B, 1, Lk).  A 2-D (B, Lk) mask is not one: it
    is ambiguous with a (Lq, Lk) positional mask when B == Lq, which dense
    attention broadcasts over the batch."""
    if m is None:
        return False
    return tuple(m.shape) in ((B, 1, 1, Lk), (1, 1, 1, Lk), (B, 1, Lk))


def _seed_of(key) -> int:
    """``jax.random.bits(key, (), uint32)``: the flash kernels' seed, one
    scalar draw (the whole draw on every rank of a mesh step)."""
    with rng.batch_broadcast():
        return int(rng.random_bits(key, 32, (), device="cpu"))


def masked_attention(query, key, value, attn_mask=None, dropout_p=0.0,
                     is_causal=False, training=True, name=None):
    """Attention over (B, L, H, D) tensors with an additive
    ``attn_mask``.  No mask or a key-padding mask takes
    ``flash_attention`` (the mask broadcast to (B, Lk)); any other takes
    ``dense_attention``.  ``dropout_p`` applies in training only, keyed by
    the next draw of ``core.rng``'s stream."""
    B, Lk = key.shape[0], key.shape[1]
    p = dropout_p if training else 0.0
    dkey = rng.next_key() if p > 0.0 else None
    if attn_mask is None or _is_key_padding_mask(attn_mask, B, Lk):
        km = None if attn_mask is None else attn_mask.to(
            torch.float32).reshape(attn_mask.shape[0], Lk).expand(B, Lk)
        return flash_attention(query, key, value, causal=is_causal,
                               key_mask=km, dropout_p=p,
                               dropout_seed=None if dkey is None
                               else _seed_of(dkey))
    return dense_attention(query, key, value, mask=attn_mask,
                           causal=is_causal, dropout_p=p, dropout_key=dkey)

"""Ragged paged attention over a flattened mixed batch of prefill chunks and
decode rows (counterpart of ``paddle_tpu/ops/ragged_paged_attention.py``).

Sequence ``s`` of the pack owns rows ``[cu_q_lens[s], cu_q_lens[s+1])`` at
kv positions ``[kv_lens[s] - q_len[s], kv_lens[s])``; each row attends its
sequence's positions ``[pad_lens[s], row_pos]`` in a block pool
``(NB+1, bs, nh, hd)`` through the block table ``table[s]`` (block 0 is the
trash block).  int8 pools are ``(values, scales)`` pairs with scales
``(NB+1, bs, nh)``.

Two versions of one function:

- ``ragged_attention_cuda`` launches the hand-written Hopper kernel
  ``csrc/ragged_paged_attention.cu`` (it replaces the Pallas
  ``_ragged_kernel``); it takes CUDA tensors only and raises on anything it
  does not support.  Its work list is ``ragged_plan``'s: built once per
  pack and shared by every layer's call, or built by the call itself.
- ``ragged_attention_ref`` is the plain PyTorch version with the JAX
  reference's numerics (dense gather, scores in q's dtype, fp32 softmax).

``ragged_attention_rows`` picks by device: CPU tensors take the plain
version, CUDA tensors the kernel.  There is no fallback between the two.
"""

from __future__ import annotations

import ctypes
import math

import torch

from ._build import note_launch

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_TILE_ROWS = 16        # rows of a kernel tile (the mma's M)
_SPLIT = 64            # positions of a split, at the least
_MAX_SPLITS = 8        # splits of a tile, at the most
_PLAN_ROWS = 7 + 2 * _MAX_SPLITS


def ragged_rows(cu_q_lens, kv_lens, total_q: int):
    """Expand per-sequence metadata into per-ROW metadata: returns
    ``(row_seq, row_pos)``, both (total_q,) int32 — the owning sequence
    (clamped to [0, S)) and kv position of every row; rows beyond
    ``cu_q_lens[S]`` are padding with ``row_pos == -1``."""
    cu = torch.as_tensor(cu_q_lens, dtype=torch.int32)
    kv = torch.as_tensor(kv_lens, dtype=torch.int32, device=cu.device)
    S = kv.shape[0]
    rows = torch.arange(total_q, dtype=torch.int32, device=cu.device)
    seq = torch.searchsorted(cu[1:].contiguous(), rows, right=True)
    valid = seq < S
    seq_c = seq.clamp(max=S - 1)
    q_len = cu[1:] - cu[:-1]
    pos = kv[seq_c] - q_len[seq_c] + (rows - cu[seq_c])
    return (seq_c.to(torch.int32),
            torch.where(valid, pos, -1).to(torch.int32))


def ragged_plan(row_seq, row_pos, pad_lens):
    """The kernel's work list for one pack, from device tensors with no host
    sync: a (23, T) int32 table of three parts.

    A run is a maximal stretch of consecutive real rows (``row_pos >= 0``)
    of one sequence (``row_seq`` clamped to [0, S)); each run is cut into
    tiles of up to 16 rows, numbered in row order.  A tile's positions
    [pad, its last row's position] are cut into splits of ``_SPLIT``
    positions, or into ``_MAX_SPLITS`` equal multiples of ``_SPLIT`` when
    longer.  A work item is a (tile, split).

    - rows 0-4, per tile t: its first row, its row count, its sequence,
      the sequence's pad (``lo``) and its split length;
    - rows 5-6, per row i: ``lo`` and the split length of its tile;
    - rows 7-14 and 15-22, flattened, per item j < 8 T: its tile (T past
      the last item) and its split's index in the tile.

    Tiles past the last have no rows and no items; padding rows' entries
    in rows 5-6 are unused.  Each kernel read is then one hop from the
    item: its tile, then the tile's rows and the table."""
    T = row_seq.shape[0]
    S = pad_lens.shape[0]
    dev = row_seq.device
    seq = row_seq.long().clamp(0, S - 1)
    pos = row_pos.long()
    real = pos >= 0
    idx = torch.arange(T, device=dev)
    same = torch.zeros(T, dtype=torch.bool, device=dev)
    same[1:] = real[:-1] & (seq[1:] == seq[:-1])
    start = torch.cummax(torch.where(real & ~same, idx, 0), 0).values
    lead = real & ((idx - start) % _TILE_ROWS == 0)
    tile = torch.where(real, torch.cumsum(lead, 0) - 1, T)   # T: no tile
    row0 = torch.zeros(T + 1, dtype=torch.long, device=dev).scatter_(
        0, torch.where(lead, tile, T), idx)[:T]
    rows = torch.zeros(T + 1, dtype=torch.long, device=dev).scatter_add_(
        0, tile, torch.ones_like(idx))[:T]
    last = torch.full((T + 1,), -1, dtype=torch.long, device=dev) \
        .scatter_reduce_(0, tile, pos, "amax")[:T]
    tseq = seq[row0]
    lo = pad_lens.long()[tseq].clamp_min(0)
    span = last - lo + 1
    split = _SPLIT * torch.clamp(
        (span + _SPLIT * _MAX_SPLITS - 1) // (_SPLIT * _MAX_SPLITS), min=1)
    items = torch.where(span > 0, (span + split - 1) // split, 0)
    ends = torch.cumsum(items, 0)
    j = torch.arange(_MAX_SPLITS * T, device=dev)
    item_tile = torch.searchsorted(ends, j, right=True)
    item_k = j - (ends - items)[item_tile.clamp(max=T - 1)]
    of_row = tile.clamp(max=T - 1)
    per = torch.stack([row0, rows, tseq, lo, split, lo[of_row],
                       split[of_row]])
    return torch.cat([per, item_tile.view(_MAX_SPLITS, T),
                      item_k.view(_MAX_SPLITS, T)]).to(torch.int32)


def ragged_attention_ref(q, pool_k, pool_v, table, row_seq, row_pos,
                         pad_lens=None):
    """Plain version: densify each row's table-selected blocks and attend
    with the reference numerics (``paddle_tpu/models/_decode.py``
    ``cached_attention``: scores as an einsum in q's dtype divided by
    sqrt(hd), masked with -1e30, softmax in fp32 cast back, einsum with V).
    int8 pools dequantize after the gather.  Padding rows yield
    garbage-but-finite values."""
    from ..models._decode import dequantize_cache

    S, C = table.shape
    if pad_lens is None:
        pad_lens = torch.zeros(S, dtype=torch.int32, device=q.device)
    seq = row_seq.long().clamp(0, S - 1)
    tab = table.long()

    def dense(pool):
        picked = (tuple(p[tab] for p in pool) if isinstance(pool, tuple)
                  else pool[tab])                          # (S, C, bs, …)
        g = dequantize_cache(picked, q.dtype)
        g = g.reshape((S, C * g.shape[2]) + tuple(g.shape[3:]))
        return g[seq]                                      # (T, C·bs, nh, hd)

    ck, cv = dense(pool_k), dense(pool_v)
    hd = q.shape[-1]
    root = torch.sqrt(torch.tensor(float(hd), dtype=torch.float32,
                                   device=q.device)).to(q.dtype)
    scores = torch.einsum("thd,tkhd->thk", q, ck) / root   # (T, nh, C·bs)
    col = torch.arange(ck.shape[1], device=q.device)
    mask = ((col[None, :] <= row_pos.long()[:, None])
            & (col[None, :] >= pad_lens.long()[seq][:, None]))
    neg = torch.tensor(_NEG_INF, device=q.device).to(scores.dtype)
    scores = torch.where(mask[:, None, :], scores, neg)
    probs = torch.softmax(scores.float(), -1).to(q.dtype)
    return torch.einsum("thk,tkhd->thd", probs, cv)


def _kernel_lib():
    from ._build import load_library

    lib = load_library("ragged_paged_attention")
    fn = lib.ragged_paged_attention
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 10
                       + [ctypes.c_int] * 5 + [ctypes.c_float,
                                               ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, pool_k, pool_v, table, row_seq, row_pos,
                       pad_lens):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: dtypes, shapes, contiguity, one device, 16-byte alignment of
    q and the pools' values (the kernel copies 16 bytes at a time)."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"ragged_attention_cuda: {what}")

    need(q.dim() == 3, f"q must be (T, nh, hd), got {tuple(q.shape)}")
    T, nh, hd = q.shape
    need(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} not supported")
    need(hd in _HEAD_DIMS, f"head dim {hd} not supported (need one of "
                           f"{_HEAD_DIMS})")
    quantized = isinstance(pool_k, tuple)
    need(quantized == isinstance(pool_v, tuple),
         "pool_k and pool_v must both be int8 (values, scales) pairs or "
         "both plain tensors")
    planes = []
    for pool in (pool_k, pool_v):
        vals = pool[0] if quantized else pool
        need(vals.dim() == 4 and tuple(vals.shape[2:]) == (nh, hd),
             f"pool must be (NB+1, bs, {nh}, {hd}), got {tuple(vals.shape)}")
        need(vals.dtype == (torch.int8 if quantized else q.dtype),
             f"pool dtype {vals.dtype} does not match q dtype {q.dtype}")
        planes.append(vals)
        if quantized:
            sc = pool[1]
            need(sc.dtype == torch.float32
                 and tuple(sc.shape) == tuple(vals.shape[:3]),
                 f"int8 scales must be float32 {tuple(vals.shape[:3])}")
            planes.append(sc)
    need(planes[0].shape == planes[-2 if quantized else -1].shape,
         "pool_k and pool_v shapes differ")
    need(table.dim() == 2, "table must be (S, C)")
    S = table.shape[0]
    need(tuple(row_seq.shape) == (T,) and tuple(row_pos.shape) == (T,),
         "row_seq and row_pos must be (T,)")
    need(tuple(pad_lens.shape) == (S,), "pad_lens must be (S,)")
    for name, t in (("table", table), ("row_seq", row_seq),
                    ("row_pos", row_pos), ("pad_lens", pad_lens)):
        need(t.dtype == torch.int32, f"{name} must be int32")
    for t in (q, table, row_seq, row_pos, pad_lens, *planes):
        need(t.is_contiguous(), "every input must be contiguous")
        need(t.device == q.device, "every input must be on q's device")
    for t in (q, *planes[::2 if quantized else 1]):
        need(t.data_ptr() % 16 == 0, "q and the pools must be 16-byte "
                                     "aligned")
    return quantized, planes


def ragged_attention_cuda(q, pool_k, pool_v, table, row_seq, row_pos,
                          pad_lens=None, plan=None):
    """Launch the Hopper kernel on PyTorch's current stream.  Returns
    (T, nh, hd) in q's dtype; padding rows (row_pos == -1) and rows with
    nothing in [pad, row_pos] are zeros.  ``plan``: ``ragged_plan`` of
    these rows (built here when None).  Each call adds one to
    ``ragged_attention_cuda.launches`` (``note_launch``: a launch inside a
    CUDA graph counts on each replay)."""
    if q.device.type != "cuda":
        raise ValueError(f"ragged_attention_cuda takes CUDA tensors, got "
                         f"{q.device}")
    if pad_lens is None:
        pad_lens = torch.zeros(table.shape[0], dtype=torch.int32,
                               device=q.device)
    quantized, planes = _check_kernel_args(q, pool_k, pool_v, table,
                                           row_seq, row_pos, pad_lens)
    T, nh, hd = q.shape
    out = torch.empty_like(q)
    if T == 0:
        return out
    if plan is None:
        plan = ragged_plan(row_seq, row_pos, pad_lens)
    if (tuple(plan.shape) != (_PLAN_ROWS, T) or plan.dtype != torch.int32
            or not plan.is_contiguous() or plan.device != q.device):
        raise ValueError(f"ragged_attention_cuda: plan must be ragged_plan's "
                         f"({_PLAN_ROWS}, {T}) int32 on q's device")
    if quantized:
        pk, ks, pv, vs = planes
    else:
        (pk, pv), ks, vs = planes, None, None
    C = table.shape[1]
    bs = pk.shape[1]
    # split partials, at most _MAX_SPLITS a row (fewer when the table is
    # short): a (max, sum) pair and an hd accumulator each
    kmax = max(1, min(_MAX_SPLITS, -(-C * bs // _SPLIT)))
    part = torch.empty(T * nh * kmax * (hd + 2) + 2, dtype=torch.float32,
                       device=q.device)
    fn = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(_DTYPE_CODE[q.dtype], int(quantized), hd,
                q.data_ptr(), pk.data_ptr(), pv.data_ptr(),
                ks.data_ptr() if quantized else None,
                vs.data_ptr() if quantized else None,
                table.data_ptr(), row_pos.data_ptr(), plan.data_ptr(),
                out.data_ptr(), part.data_ptr(), T, nh, bs, C, kmax,
                1.0 / math.sqrt(hd), stream)
    if rc != 0:
        raise RuntimeError(f"ragged_paged_attention kernel launch failed "
                           f"(CUDA error {rc})")
    note_launch(ragged_attention_cuda)
    return out


ragged_attention_cuda.launches = 0


def ragged_attention_rows(q, pool_k, pool_v, table, row_seq, row_pos,
                          pad_lens=None, plan=None):
    """Row-metadata entry point (the engine packs rows directly): q
    (T, nh, hd); pools (NB+1, bs, nh, hd) or int8 ``(values, scales)``
    pairs; table (S, C) int32; row_seq/row_pos (T,) int32 (-1 = padding
    row); pad_lens (S,) int32 or None; ``plan`` the kernel's
    ``ragged_plan`` of these rows or None.  CPU tensors take the plain
    version, CUDA tensors the kernel."""
    if q.device.type == "cpu":
        return ragged_attention_ref(q, pool_k, pool_v, table, row_seq,
                                    row_pos, pad_lens)
    return ragged_attention_cuda(q, pool_k, pool_v, table, row_seq, row_pos,
                                 pad_lens, plan)

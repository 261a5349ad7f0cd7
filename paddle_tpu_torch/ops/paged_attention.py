"""Paged decode attention: one query per slot over the slot's
table-selected pool blocks (counterpart of
``paddle_tpu/ops/paged_attention.py``).

Slot ``s``'s query ``q[s]`` (nh, hd) attends pool positions
``[pad_lens[s], t[s]]``; position ``p`` lives in pool block
``table[s, p // bs]`` at offset ``p % bs`` of a ``(NB+1, bs, nh, hd)`` pool
(block 0 is the trash block; inactive slots' table rows are all 0).  Pools
are floating point only: int8 ``(values, scales)`` pairs take
``cached_attention``'s gather path and never come here.

Two versions of one function:

- ``paged_decode_attention_cuda`` launches the hand-written Hopper kernel
  ``csrc/paged_attention.cu`` (it replaces the Pallas
  ``_paged_decode_kernel``); it takes CUDA tensors only and raises on
  anything it does not support.  The kernel is bound by bytes and by the
  dependent trips before them: it cuts each slot's positions into tiles
  of ``decode_tile_positions`` positions across all heads, so one block
  stages a tile's K and V with one bulk copy each a pool block; tiles
  outside ``[pad, t]`` load nothing, and the slot's last tile to finish
  combines the tiles' partial softmaxes in tile order (a ticket a slot).
  The partials and tickets live in a workspace kept per device and stream
  (``_workspace``), allocated once and grown, never zeroed per call.  At
  the gpt2-small serve's decode shape it takes 0.0168 ms, the kernel
  before the redesign 0.0194 ms (NVIDIA H100 80GB HBM3, 700.00 W, cold L2;
  ``PERF.md`` §6).
- ``paged_decode_attention_ref`` is the plain PyTorch version with the
  kernel's arithmetic (fp32 scaled query, fp32 scores and softmax with the
  ``max(l, 1e-30)`` guard, fp32 P·V, one cast to q's dtype).

``paged_decode_attention`` picks by device: CPU tensors take the plain
version, CUDA tensors the kernel.  There is no fallback between the two.

A row with no position in ``[pad, t]`` is never read by the engines; the
plain version yields a finite average of V there (as the reference), the
kernel zeros.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from ._build import note_launch

_NEG_INF = -1e30
_HEAD_DIMS = (64, 128)
_DTYPE_CODE = {torch.float32: 0, torch.float16: 1, torch.bfloat16: 2}
_MAX_TILE = 16                  # positions a tile at most
_TILE_KV_BYTES = 64 * 1024      # a tile's K and V together at most
_MAX_SLOTS = 65535              # the grid's y extent
_MERGE_GROUP = 8                # tiles the kernel's first merge level takes

# (device, stream) -> (fp32 partials, int32 tickets), grown, never shrunk
_workspaces = {}


def paged_decode_attention_ref(q, pool_k, pool_v, table, t, pad_lens=None):
    """Plain version, the kernel's arithmetic step by step over the dense
    gather of every table column (masked positions get ``exp(-1e30 - m)``,
    exactly 0 in fp32, so the columns past the clock change nothing)."""
    S, nh, hd = q.shape
    C = table.shape[1]
    bs = pool_k.shape[1]
    tab = table.long()
    t = torch.as_tensor(t, device=q.device).long().expand(S)
    pad = (torch.zeros(S, dtype=torch.long, device=q.device)
           if pad_lens is None else pad_lens.long())
    k = pool_k[tab].reshape(S, C * bs, nh, hd).float()
    v = pool_v[tab].reshape(S, C * bs, nh, hd).float()
    qs = q.float() * (1.0 / math.sqrt(hd))
    sc = torch.einsum("shd,skhd->shk", qs, k)              # (S, nh, C·bs)
    pos = torch.arange(C * bs, device=q.device)
    valid = (pos[None] <= t[:, None]) & (pos[None] >= pad[:, None])
    sc = torch.where(valid[:, None, :], sc,
                     torch.tensor(_NEG_INF, device=q.device))
    p = torch.exp(sc - sc.amax(-1, keepdim=True))
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("shk,skhd->shd", p, v) / l
    return out.to(q.dtype)


def decode_tile_positions(nh, hd, itemsize):
    """Positions a kernel tile takes: ``_MAX_TILE``, halved until the
    tile's K and V (``nh * hd`` elements a position each) fit in
    ``_TILE_KV_BYTES``, at least 1."""
    tile = _MAX_TILE
    while tile > 1 and 2 * tile * nh * hd * itemsize > _TILE_KV_BYTES:
        tile //= 2
    return tile


def decode_tiles(C, bs, tile):
    """Tiles a slot's table covers: ceil(C * bs / tile)."""
    return -(-C * bs // tile)


def decode_workspace_sizes(S, C, bs, nh, hd, tile):
    """(fp32 partial floats, int32 tickets) one launch needs: per slot and
    per tile, and per group of ``_MERGE_GROUP`` tiles, nh rows of hd
    accumulators and nh (m, l) pairs; a ticket a slot and one a group."""
    tiles = decode_tiles(C, bs, tile)
    groups = -(-tiles // _MERGE_GROUP)
    return S * (tiles + groups) * nh * (hd + 2), S * (1 + groups)


@functools.lru_cache(maxsize=None)
def _launch_plan(S, nh, hd, itemsize, bs, C):
    """(tile, partial floats, tickets) of a launch: the host-side sizing,
    computed once a shape."""
    tile = decode_tile_positions(nh, hd, itemsize)
    return (tile, *decode_workspace_sizes(S, C, bs, nh, hd, tile))


def reserve_workspace(device, stream, S, nh, hd, itemsize, bs, C):
    """Grow the workspace of launches on ``stream`` to what a launch over
    up to ``C`` table columns needs (the sizes grow with C), before a CUDA
    graph captures a launch: a graph keeps the workspace's address, and a
    later launch that outgrew it would reallocate and free that memory.
    Returns (partials, tickets)."""
    _, n_part, n_tickets = _launch_plan(S, nh, hd, itemsize, bs, C)
    return _workspace(torch.device(device), stream, n_part, n_tickets)


def _workspace(device, stream, n_part, n_tickets):
    """The partials and tickets for launches on ``stream``: launches on one
    stream run in order, so they share one buffer.  Tickets start at zero
    and every launch leaves them zero, so they are zeroed only when
    allocated."""
    key = (device, stream)
    part, tickets = _workspaces.get(key, (None, None))
    if part is None or part.numel() < n_part:
        part = torch.empty(n_part, dtype=torch.float32, device=device)
    if tickets is None or tickets.numel() < n_tickets:
        tickets = torch.zeros(n_tickets, dtype=torch.int32, device=device)
    _workspaces[key] = (part, tickets)
    return part, tickets


# csrc/paged_attention.cu's C interface: dtype, hd; q, pools, table, clock,
# pad_lens, out, part, tickets; S, nh, bs, C, tile; sm_scale; stream
_ARGTYPES = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 9 + [ctypes.c_int] * 5
             + [ctypes.c_float, ctypes.c_void_p])


def _kernel_lib():
    from ._build import load_library

    fn = load_library("paged_attention").paged_decode_attention
    if fn.argtypes is None:
        fn.argtypes = _ARGTYPES
        fn.restype = ctypes.c_int
    return fn


def _check_kernel_args(q, pool_k, pool_v, table, t, pad_lens):
    """Everything the kernel assumes, checked before any pointer leaves
    Python: dtypes, shapes, contiguity, 16-byte aligned pools (the bulk
    copies), one device."""
    def need(ok, what):
        if not ok:
            raise ValueError(f"paged_decode_attention_cuda: {what}")

    need(not isinstance(pool_k, tuple) and not isinstance(pool_v, tuple),
         "int8 (values, scales) pools are not supported: they take "
         "cached_attention's gather path")
    need(q.dim() == 3, f"q must be (S, nh, hd), got {tuple(q.shape)}")
    S, nh, hd = q.shape
    need(q.dtype in _DTYPE_CODE, f"q dtype {q.dtype} not supported")
    need(hd in _HEAD_DIMS, f"head dim {hd} not supported (need one of "
                           f"{_HEAD_DIMS})")
    need(S <= _MAX_SLOTS, f"at most {_MAX_SLOTS} slots, got {S}")
    for pool in (pool_k, pool_v):
        need(pool.dim() == 4 and tuple(pool.shape[2:]) == (nh, hd),
             f"pool must be (NB+1, bs, {nh}, {hd}), got {tuple(pool.shape)}")
        need(pool.dtype == q.dtype,
             f"pool dtype {pool.dtype} does not match q dtype {q.dtype}")
        need(pool.data_ptr() % 16 == 0, "pools must start on a 16-byte "
                                        "boundary (bulk copies)")
    need(pool_k.shape == pool_v.shape, "pool_k and pool_v shapes differ")
    need(table.dim() == 2 and table.shape[0] == S and table.shape[1] >= 1,
         f"table must be ({S}, C) with C >= 1, got {tuple(table.shape)}")
    ints = [("table", table), ("t", t)]
    if pad_lens is not None:
        ints.append(("pad_lens", pad_lens))
    need(all(tuple(x.shape) == (S,) for _, x in ints[1:]),
         f"t and pad_lens must be ({S},)")
    for name, x in ints:
        need(x.dtype == torch.int32, f"{name} must be int32")
    for x in [q, pool_k, pool_v] + [x for _, x in ints]:
        need(x.is_contiguous(), "every input must be contiguous (pass "
                                "table[:, :C].contiguous(), not the slice)")
        need(x.device == q.device, "every input must be on q's device")


def paged_decode_attention_cuda(q, pool_k, pool_v, table, t, pad_lens=None):
    """Launch the Hopper kernel on PyTorch's current stream.  Returns
    (S, nh, hd) in q's dtype.  ``pad_lens=None`` reaches the kernel as a
    null pointer, which it reads as no left pads.  Each launch adds one to
    ``paged_decode_attention_cuda.launches`` (``note_launch``: a launch
    inside a CUDA graph counts on each replay)."""
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention_cuda takes CUDA tensors, "
                         f"got {q.device}")
    _check_kernel_args(q, pool_k, pool_v, table, t, pad_lens)
    S, nh, hd = q.shape
    out = torch.empty_like(q)
    if S == 0:
        return out
    bs, C = pool_k.shape[1], table.shape[1]
    tile, n_part, n_tickets = _launch_plan(S, nh, hd, q.element_size(), bs,
                                           C)
    fn = _kernel_lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        part, tickets = _workspace(q.device, stream, n_part, n_tickets)
        rc = fn(_DTYPE_CODE[q.dtype], hd, q.data_ptr(), pool_k.data_ptr(),
                pool_v.data_ptr(), table.data_ptr(), t.data_ptr(),
                None if pad_lens is None else pad_lens.data_ptr(),
                out.data_ptr(), part.data_ptr(), tickets.data_ptr(), S, nh,
                bs, C, tile, 1.0 / math.sqrt(hd), stream)
    if rc == -2:
        raise ValueError(f"paged_decode_attention_cuda: {nh} heads of {hd} "
                         f"need more shared memory than a block has")
    if rc != 0:
        raise RuntimeError(f"paged_decode_attention kernel launch failed "
                           f"(CUDA error {rc})")
    note_launch(paged_decode_attention_cuda)
    return out


paged_decode_attention_cuda.launches = 0


def paged_decode_attention(q, pool_k, pool_v, table, t, pad_lens=None):
    """Single-position attention over table-selected pool blocks: q
    (S, nh, hd); pool_k/pool_v (NB+1, bs, nh, hd); table (S, C) int32
    (inactive rows pre-zeroed to the trash block by the caller); t (S,)
    int32 per-slot clocks (the query attends positions <= t); pad_lens
    (S,) int32 left pads (positions < pad masked), or None.  Returns
    (S, nh, hd) in q's dtype.  CPU tensors take the plain version, CUDA
    tensors the kernel."""
    if q.device.type == "cpu":
        return paged_decode_attention_ref(q, pool_k, pool_v, table, t,
                                          pad_lens)
    return paged_decode_attention_cuda(q, pool_k, pool_v, table, t,
                                       pad_lens)

"""Port parity for the paged decode attention and the cache machinery under
it (paddle_tpu_torch/ops/paged_attention.py, models/_decode.py): the same
numpy inputs from a seed go through the JAX Pallas kernel in interpret
mode, through the JAX gather fallback (``cached_attention`` over a
``PagedKV``) and through the port on the CPU, where the wrapper takes the
kernel's plain version.  fp32 within 2e-5, the reference's own tolerance
for kernel against fallback (another summation order).  ``PagedKV.write``,
``gather`` and ``write_cache`` are pure data movement (plus the bit-defined
int8 quantization) and must match exactly; the dense ``cached_attention``
within 1e-6 in fp32.  Plus the CUDA wrapper's guards, which run before any
pointer leaves Python."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from paddle_tpu.models import _decode as jdec
from paddle_tpu.ops.paged_attention import \
    paged_decode_attention as j_paged_decode
from paddle_tpu_torch.models import _decode as tdec
from paddle_tpu_torch.ops import paged_attention as tpa

TOL = dict(rtol=2e-5, atol=2e-5)


def _case(seed, S=4, nh=4, hd=16, NB1=11, bs=8, C=4):
    """tests/test_paged_attention_kernel.py's random case, as numpy."""
    rng = np.random.RandomState(seed)
    pk = rng.randn(NB1, bs, nh, hd).astype(np.float32)
    pv = rng.randn(NB1, bs, nh, hd).astype(np.float32)
    table = rng.randint(0, NB1, (S, C)).astype(np.int32)
    t = rng.randint(0, C * bs, S).astype(np.int32)
    pad = np.minimum(rng.randint(0, bs, S), t).astype(np.int32)
    q = rng.randn(S, nh, hd).astype(np.float32)
    return q, pk, pv, table, t, pad


def _three_ways(q, pk, pv, table, t, pad):
    """(Pallas kernel in interpret mode, JAX gather fallback, port)."""
    jq, jk, jv, jt, jtab = (jnp.asarray(a) for a in (q, pk, pv, t, table))
    jpad = None if pad is None else jnp.asarray(pad)
    kern = np.asarray(j_paged_decode(jq, jk, jv, jtab, jt, jpad,
                                     interpret=True))
    fallback = np.asarray(jdec.cached_attention(
        jq[:, None], jdec.PagedKV(jk, jtab), jdec.PagedKV(jv, jtab), jt,
        pad_lens=jpad)[:, 0])
    tq, tk, tv, tt, ttab = (torch.from_numpy(a) for a in (q, pk, pv, t,
                                                          table))
    tpad = None if pad is None else torch.from_numpy(pad)
    port = tpa.paged_decode_attention(tq, tk, tv, ttab, tt, tpad).numpy()
    return kern, fallback, port


class TestPlainVersionParity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_matches_kernel_and_fallback(self, seed):
        kern, fallback, port = _three_ways(*_case(seed))
        np.testing.assert_allclose(port, kern, **TOL)
        np.testing.assert_allclose(port, fallback, **TOL)

    def test_no_pad_and_trash_row(self):
        """pad_lens=None; one row's table is all trash (an inactive slot):
        finite there, and the other rows are unaffected."""
        q, pk, pv, table, t, _ = _case(7)
        table[2] = 0
        kern, fallback, port = _three_ways(q, pk, pv, table, t, None)
        np.testing.assert_allclose(port, kern, **TOL)
        np.testing.assert_allclose(port, fallback, **TOL)
        assert np.isfinite(port).all()

    def test_clock_zero_and_full(self):
        C, bs = 4, 8
        q, pk, pv, table, _, pad = _case(11, C=C, bs=bs)
        t = np.asarray([0, C * bs - 1, 16, 0], np.int32)
        kern, fallback, port = _three_ways(q, pk, pv, table, t,
                                           np.zeros_like(pad))
        np.testing.assert_allclose(port, kern, **TOL)
        np.testing.assert_allclose(port, fallback, **TOL)

    def test_cached_attention_paged_arm_dispatch(self, monkeypatch):
        """kq == 1 on a floating-point pool goes to the kernel entry;
        kq > 1 and int8 pairs gather and take the dense path."""
        calls = []
        real = tdec.paged_decode_attention
        monkeypatch.setattr(
            tdec, "paged_decode_attention",
            lambda *a: calls.append(1) or real(*a))
        q, pk, pv, table, t, pad = (torch.from_numpy(a) for a in _case(5))
        kv = tdec.PagedKV(pk, table), tdec.PagedKV(pv, table)
        one = tdec.cached_attention(q[:, None], *kv, t, pad_lens=pad)
        assert len(calls) == 1 and one.shape == (4, 1, 4, 16)
        dense = tdec.cached_attention(q[:, None], kv[0].gather(q.dtype),
                                      kv[1].gather(q.dtype), t,
                                      pad_lens=pad)
        np.testing.assert_allclose(one.numpy(), dense.numpy(), **TOL)
        q2 = torch.stack([q, q], 1)                     # kq = 2
        tdec.cached_attention(q2, *kv, t.clamp(max=30), pad_lens=pad)
        quant = (tdec.PagedKV(tdec.quantize_kv(pk), table),
                 tdec.PagedKV(tdec.quantize_kv(pv), table))
        tdec.cached_attention(q[:, None], *quant, t, pad_lens=pad)
        assert len(calls) == 1


def _merge(ms, ls, accs):
    """The kernel's merge of partials (m, l, acc) in order, in batches of
    ``_MERGE_GROUP``: a running max, each batch's weights exp(m - max) side
    by side; a partial with m = -inf (no position) weighs 0 and an all-empty
    row stays (-inf, 0, 0) with no NaN."""
    G = tpa._MERGE_GROUP
    m_run = torch.full(ms[0].shape, -np.inf)
    l_run = torch.zeros(ls[0].shape)
    o = torch.zeros(accs[0].shape)
    for i0 in range(0, len(ms), G):
        batch = range(i0, min(i0 + G, len(ms)))
        m_new = torch.stack([m_run] + [ms[i] for i in batch]).amax(0)
        safe = torch.where(torch.isinf(m_new), 0.0, m_new)
        sa = torch.where(torch.isinf(m_run), 0.0, torch.exp(m_run - safe))
        l_run, o = l_run * sa, o * sa[..., None]
        for i in batch:
            w = torch.where(torch.isinf(ms[i]), 0.0, torch.exp(ms[i] - safe))
            l_run = l_run + w * ls[i]
            o = o + w[..., None] * accs[i]
        m_run = m_new
    return m_run, l_run, o


def _split_combine(q, pk, pv, table, t, pad, tile):
    """A plain version of the CUDA kernel's split (``csrc/
    paged_attention.cu``): every tile of ``tile`` table positions gives,
    per head, a partial (m, l, acc) over its positions in [pad, min(t, C*bs
    - 1)], with m = -inf, l = 0, acc = 0 for a tile that has none (the
    kernel skips those); groups of ``_MERGE_GROUP`` consecutive tiles merge
    in order, then the groups in order; a row with no position at all gives
    zeros.  Torch CPU tensors in, fp32 out."""
    S, nh, hd = q.shape
    C, bs = table.shape[1], pk.shape[1]
    n = tpa.decode_tiles(C, bs, tile)
    P = n * tile
    k = torch.zeros(S, P, nh, hd)
    v = torch.zeros(S, P, nh, hd)
    k[:, :C * bs] = pk[table.long()].reshape(S, C * bs, nh, hd).float()
    v[:, :C * bs] = pv[table.long()].reshape(S, C * bs, nh, hd).float()
    sc = torch.einsum("shd,sphd->shp", q.float() / np.sqrt(hd), k)
    pos = torch.arange(P)
    first = torch.zeros(S, dtype=torch.long) if pad is None else pad.long()
    last = t.long().clamp(max=C * bs - 1)
    valid = (pos[None] >= first[:, None]) & (pos[None] <= last[:, None])
    sc = torch.where(valid[:, None], sc, torch.tensor(-np.inf))
    sc = sc.reshape(S, nh, n, tile)
    m = sc.amax(-1)                                     # (S, nh, n)
    empty = torch.isinf(m)
    w = torch.where(empty[..., None], torch.zeros(()),
                    torch.exp(sc - torch.where(empty, 0.0, m)[..., None]))
    parts = [(m[..., j], w[..., j, :].sum(-1), torch.einsum(
        "sht,sthd->shd", w[..., j, :], v[:, j * tile:(j + 1) * tile]))
        for j in range(n)]
    G = tpa._MERGE_GROUP
    groups = [_merge(*zip(*parts[g:g + G])) for g in range(0, n, G)]
    m_all, l_all, o = _merge(*zip(*groups))
    return torch.where(torch.isinf(m_all)[..., None], torch.zeros(()),
                       o / torch.where(l_all > 0, l_all, 1.0)[..., None])


class TestTiledSplitCombine:
    """The kernel's split of a slot's positions into tiles and their
    combine, as plain PyTorch on the CPU, against the Pallas kernel in
    interpret mode: tiles wholly outside [pad, t] (m = -inf, l = 0) must
    weigh nothing and make no NaN."""

    @pytest.mark.parametrize("tile", [1, 4, 8, 16])
    @pytest.mark.parametrize("seed", [0, 3])
    def test_matches_pallas_kernel(self, tile, seed):
        case = _case(seed, C=5, bs=8)
        q, pk, pv, table, t, pad = (torch.from_numpy(a) for a in case)
        got = _split_combine(q, pk, pv, table, t, pad, tile)
        kern = _three_ways(*case)[0]
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got.numpy(), kern, **TOL)

    @pytest.mark.parametrize("bs,tile", [(3, 16), (4, 16), (32, 4), (5, 8)])
    def test_tiles_skipped_at_both_ends(self, bs, tile):
        """Pads and clocks that leave whole tiles empty on both sides, a
        tile spanning several pool blocks (bs < tile), a parked clock past
        the table, and a row with no position (zeros)."""
        C = -(-6 * tile // bs)                           # >= 6 tiles
        q, pk, pv, table, _, _ = _case(9, S=4, C=C, bs=bs)
        full = C * bs
        t = np.asarray([full - tile - 2, full + bs, 2 * tile + 1, 1],
                       np.int32)
        pad = np.asarray([tile + 1, 2 * tile, tile + 1, 3], np.int32)
        got = _split_combine(*(torch.from_numpy(a) for a in (
            q, pk, pv, table, t, pad)), tile)
        kern = _three_ways(q, pk, pv, table, t, pad)[0]
        assert torch.isfinite(got).all()
        np.testing.assert_allclose(got[:3].numpy(), kern[:3], **TOL)
        assert got[3].abs().max() == 0                   # pad 3 > clock 1

    def test_matches_plain_version(self):
        q, pk, pv, table, t, pad = (torch.from_numpy(a)
                                    for a in _case(4, C=6, bs=4))
        want = tpa.paged_decode_attention_ref(q, pk, pv, table, t, pad)
        got = _split_combine(q, pk, pv, table, t, pad,
                             tpa.decode_tile_positions(4, 16, 4))
        np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL)


class TestTileSizing:
    """The wrapper's host-side sizing of the kernel's tiles, shared
    memory and workspace."""

    @pytest.mark.parametrize("nh,hd,el,tile", [
        (12, 64, 2, 16),            # the gpt2-small serve: half a block
        (12, 128, 4, 4),            # fp32 hd 128: 48 KB of K and V
        (12, 64, 4, 8),
        (4, 16, 4, 16),
        (64, 128, 4, 1),
    ])
    def test_tile_positions(self, nh, hd, el, tile):
        assert tpa.decode_tile_positions(nh, hd, el) == tile
        assert 2 * tile * nh * hd * el <= tpa._TILE_KV_BYTES or tile == 1

    def test_tiles_and_workspace(self):
        assert tpa.decode_tiles(20, 32, 16) == 40
        assert tpa.decode_tiles(7, 5, 8) == 5             # 35 positions
        part, tickets = tpa.decode_workspace_sizes(8, 20, 32, 12, 64, 16)
        assert (part, tickets) == (8 * (40 + 5) * 12 * 66, 8 * (1 + 5))

    def test_workspace_is_kept_and_grown(self):
        dev = torch.device("cpu")
        key = object()                       # a stream no launch uses
        try:
            part, tickets = tpa._workspace(dev, key, 100, 4)
            assert part.dtype == torch.float32 and part.numel() == 100
            assert tickets.dtype == torch.int32 and not tickets.any()
            again = tpa._workspace(dev, key, 50, 2)
            assert again[0] is part and again[1] is tickets
            tickets[0] = 3                   # a launch leaves them zero
            grown = tpa._workspace(dev, key, 200, 8)
            assert grown[0].numel() == 200 and grown[1] is not tickets
            assert not grown[1].any()
        finally:
            tpa._workspaces.pop((dev, key), None)

    @pytest.mark.parametrize("S,nh,hd,el,bs,MB", [
        (8, 12, 64, 2, 32, 20),      # the phase-12 bucketed serve
        (8, 12, 64, 2, 16, 32),      # the speculative serve's draft
        (4, 4, 16, 4, 8, 4),
        (3, 2, 128, 4, 4, 9),
    ])
    def test_workspace_reserved_for_the_widest_table(self, S, nh, hd, el,
                                                     bs, MB):
        """``reserve_workspace`` sizes the workspace for MB columns before
        any graph captures a launch: every narrower launch then reuses the
        same tensors, so no launch reallocates (and frees) memory that a
        captured graph still points at."""
        dev = torch.device("cpu")
        key = object()
        try:
            part, tickets = tpa.reserve_workspace(dev, key, S, nh, hd, el,
                                                  bs, MB)
            sizes = [tpa._launch_plan(S, nh, hd, el, bs, C)[1:]
                     for C in range(1, MB + 1)]
            assert sizes == sorted(sizes)        # growing with C
            assert (part.numel(), tickets.numel()) == sizes[-1]
            for n_part, n_tickets in sizes:
                again = tpa._workspace(dev, key, n_part, n_tickets)
                assert again[0] is part and again[1] is tickets
        finally:
            tpa._workspaces.pop((dev, key), None)


def _pools(seed, quantized, L=None, NB1=9, bs=4, nh=2, hd=8):
    rng = np.random.RandomState(seed)
    shape = (NB1, bs, nh, hd) if L is None else (L, NB1, bs, nh, hd)
    vals = rng.randn(*shape).astype(np.float32)
    if not quantized:
        return vals
    q, s = jdec.quantize_kv(jnp.asarray(vals))
    return np.asarray(q), np.asarray(s)


def _to(mod, pool):
    conv = jnp.asarray if mod is jdec else \
        (lambda a: torch.from_numpy(np.array(a)))
    return tuple(conv(p) for p in pool) if isinstance(pool, tuple) \
        else conv(pool)


def _planes(pool):
    return [np.asarray(p) for p in (pool if isinstance(pool, tuple)
                                    else (pool,))]


class TestPagedKVBitExact:
    @pytest.mark.parametrize("quantized", [False, True])
    @pytest.mark.parametrize("per_row", [False, True])
    def test_write_and_gather(self, quantized, per_row):
        """Distinct real blocks per row, one all-trash row; kq 1 and 3;
        the last row's clock runs past the table (clamped column)."""
        rng = np.random.RandomState(3)
        pool = _pools(1, quantized)
        table = np.asarray([[1, 2, 3], [4, 5, 6], [0, 0, 0], [7, 8, 0]],
                           np.int32)
        for kq in (1, 3):
            chunk = rng.randn(4, kq, 2, 8).astype(np.float32)
            t = np.asarray([0, 5, 9, 7], np.int32) if per_row else 4
            jt = jnp.asarray(t)
            tt = torch.from_numpy(t) if per_row else t
            want = jdec.PagedKV(_to(jdec, pool), jnp.asarray(table)) \
                .write(jnp.asarray(chunk), jt)
            got = tdec.PagedKV(_to(tdec, pool), torch.from_numpy(table)) \
                .write(torch.from_numpy(chunk), tt)
            # the trash block takes every inactive row's write: skip it
            for w, g in zip(_planes(want.pool), _planes(got.pool)):
                np.testing.assert_array_equal(g[1:], w[1:])
            np.testing.assert_array_equal(
                got.gather(torch.float32).numpy()[[0, 1, 3]],
                np.asarray(want.gather(jnp.float32))[[0, 1, 3]])
            assert got.block_size == want.block_size == 4

    @pytest.mark.parametrize("quantized", [False, True])
    def test_write_cache_dense(self, quantized):
        """Scalar t (a slice) and per-row t (a scatter), kq 1 and 2; a
        row whose slot lies past the cache is dropped, as the reference's
        scatter drops it."""
        rng = np.random.RandomState(4)
        base = rng.randn(3, 10, 2, 8).astype(np.float32)
        if quantized:
            q, s = jdec.quantize_kv(jnp.asarray(base))
            base = (np.asarray(q), np.asarray(s))
        for kq in (1, 2):
            chunk = rng.randn(3, kq, 2, 8).astype(np.float32)
            for t in (3, np.asarray([0, 8, 10], np.int32)):
                want = jdec.write_cache(_to(jdec, base), jnp.asarray(chunk),
                                        jnp.asarray(t))
                got = tdec.write_cache(
                    _to(tdec, base), torch.from_numpy(chunk),
                    t if isinstance(t, int) else torch.from_numpy(t))
                for w, g in zip(_planes(want), _planes(got)):
                    np.testing.assert_array_equal(g, w)

    def test_write_cache_dispatches_to_pagedkv(self):
        pool = torch.zeros(3, 2, 1, 4)
        kv = tdec.PagedKV(pool, torch.tensor([[1, 2]], dtype=torch.int32))
        out = tdec.write_cache(kv, torch.ones(1, 1, 1, 4), 3)
        assert out is kv and pool[2, 1].eq(1).all() and pool.sum() == 4


class TestCachedAttentionDense:
    @pytest.mark.parametrize("kq", [1, 4])
    @pytest.mark.parametrize("per_row", [False, True])
    @pytest.mark.parametrize("padded", [False, True])
    def test_matches_reference(self, kq, per_row, padded):
        rng = np.random.RandomState(kq + 10 * per_row + 100 * padded)
        B, T, nh, hd = 3, 12, 2, 8
        q = rng.randn(B, kq, nh, hd).astype(np.float32)
        ck = rng.randn(B, T, nh, hd).astype(np.float32)
        cv = rng.randn(B, T, nh, hd).astype(np.float32)
        t = np.asarray([2, 7, 5], np.int32) if per_row else 6
        pad = np.asarray([0, 3, 1], np.int32) if padded else None
        want = jdec.cached_attention(
            jnp.asarray(q), jnp.asarray(ck), jnp.asarray(cv), jnp.asarray(t),
            pad_lens=None if pad is None else jnp.asarray(pad))
        got = tdec.cached_attention(
            torch.from_numpy(q), torch.from_numpy(ck), torch.from_numpy(cv),
            torch.from_numpy(t) if per_row else t,
            pad_lens=None if pad is None else torch.from_numpy(pad))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                                   atol=1e-6)


class TestKernelWrapperGuards:
    """The CUDA wrapper's checks run before any pointer leaves Python; on
    a machine without a card they are what can be exercised."""

    def _args(self, hd=64, dtype=torch.bfloat16):
        q = torch.zeros(5, 2, hd, dtype=dtype)
        pool = torch.zeros(3, 4, 2, hd, dtype=dtype)
        i32 = dict(dtype=torch.int32)
        return (q, pool, pool.clone(), torch.zeros(5, 3, **i32),
                torch.zeros(5, **i32), torch.zeros(5, **i32))

    def test_cpu_tensor_refused(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpa.paged_decode_attention_cuda(*self._args())

    def test_dispatch_refuses_other_devices(self):
        q = torch.zeros(2, 2, 64, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            tpa.paged_decode_attention(q, q, q, q, q)

    def test_int8_pair_refused(self):
        q, pk, pv, tab, t, pad = self._args()
        quant = (pk.to(torch.int8), torch.zeros(3, 4, 2))
        with pytest.raises(ValueError, match="int8"):
            tpa._check_kernel_args(q, quant, quant, tab, t, pad)

    @pytest.mark.parametrize("hd", [16, 48, 256])
    def test_unsupported_head_dim(self, hd):
        with pytest.raises(ValueError, match="head dim"):
            tpa._check_kernel_args(*self._args(hd=hd))

    def test_dtype_shape_contiguity(self):
        q, pk, pv, tab, t, pad = self._args()
        tpa._check_kernel_args(q, pk, pv, tab, t, pad)           # accepted
        with pytest.raises(ValueError, match="dtype"):
            tpa._check_kernel_args(q, pk.float(), pv, tab, t, pad)
        with pytest.raises(ValueError, match="dtype"):
            tpa._check_kernel_args(q.to(torch.int8), pk, pv, tab, t, pad)
        with pytest.raises(ValueError, match="int32"):
            tpa._check_kernel_args(q, pk, pv, tab.long(), t, pad)
        with pytest.raises(ValueError, match="int32"):
            tpa._check_kernel_args(q, pk, pv, tab, t.long(), pad)
        with pytest.raises(ValueError, match="contiguous"):
            wide = torch.zeros(5, 6, dtype=torch.int32)
            tpa._check_kernel_args(q, pk, pv, wide[:, :3], t, pad)
        with pytest.raises(ValueError, match="table must be"):
            tpa._check_kernel_args(q, pk, pv, tab[:4], t, pad)
        with pytest.raises(ValueError, match="shapes differ"):
            tpa._check_kernel_args(q, pk, pv[:2], tab, t, pad)
        with pytest.raises(ValueError, match=r"\(5,\)"):
            tpa._check_kernel_args(q, pk, pv, tab, t[:4], pad)

    def test_pools_misaligned_refused(self):
        q, pk, pv, tab, t, pad = self._args()
        flat = torch.zeros(pk.numel() + 1, dtype=pk.dtype)
        shifted = flat[1:].view(pk.shape)                # 2 bytes in
        with pytest.raises(ValueError, match="16-byte"):
            tpa._check_kernel_args(q, shifted, pv, tab, t, pad)

    def test_c_interface_matches_argtypes(self):
        """The extern "C" signature's parameter count is the wrapper's."""
        import re
        from paddle_tpu_torch.ops import _build
        text = (_build.CSRC / _build.SOURCES["paged_attention"]).read_text()
        sig = re.search(r'extern "C" int paged_decode_attention\((.*?)\)',
                        text, re.S).group(1)
        assert len(sig.split(",")) == len(tpa._ARGTYPES)
        assert "void* part, void* tickets" in " ".join(sig.split())

    def test_build_table_names_the_kernel_source(self):
        from paddle_tpu_torch.ops import _build
        src = _build.CSRC / _build.SOURCES["paged_attention"]
        text = src.read_text()
        assert "paged_decode_attention_kernel" in text
        assert 'extern "C" int paged_decode_attention(' in text
        assert (_build.CSRC / "paged_common.cuh").is_file()

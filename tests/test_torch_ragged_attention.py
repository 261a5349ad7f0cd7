"""Port parity for ragged paged attention and the pool writes
(paddle_tpu_torch/ops/ragged_paged_attention.py, models/_decode.py)
against the JAX reference on the same numpy inputs.

On the CPU the port's ``ragged_attention_rows`` runs its plain version; it
must match both the reference's gather version and its Pallas kernel in
interpret mode on every real row (fp32 atol/rtol 1e-5: the same math in
another framework, differing only in summation order).  Row metadata, the
int8 quantization and the pool writes are bit-exact."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.models import _decode as jdec
from paddle_tpu.ops import ragged_paged_attention as jrpa
from paddle_tpu_torch.models import _decode as tdec
from paddle_tpu_torch.ops import ragged_paged_attention as trpa

TOL = dict(rtol=1e-5, atol=1e-5)


def _case(seed, S=4, nh=4, hd=16, NB1=11, bs=8, C=4, T=24, quantized=False):
    """The generator of tests/test_ragged_paged_attention.py, as numpy:
    random pools and tables, ragged q lengths (zero-length sequences
    included), left pads at most each sequence's first row position, and
    padding rows past the real ones."""
    rng = np.random.RandomState(seed)
    pk = rng.randn(NB1, bs, nh, hd).astype(np.float32)
    pv = rng.randn(NB1, bs, nh, hd).astype(np.float32)
    table = rng.randint(0, NB1, (S, C)).astype(np.int32)
    q_lens = rng.randint(0, 6, S)
    while q_lens.sum() > T:
        q_lens[rng.randint(S)] = 0
    cu = np.concatenate([[0], np.cumsum(q_lens)]).astype(np.int32)
    kv = np.asarray([rng.randint(q, C * bs + 1) if q else 0
                     for q in q_lens], np.int32)
    pad = np.asarray([rng.randint(0, max(int(k) - int(q), 0) + 1)
                      for k, q in zip(kv, q_lens)], np.int32)
    q = rng.randn(T, nh, hd).astype(np.float32)
    return dict(q=q, pk=pk, pv=pv, table=table, cu=cu, kv=kv, pad=pad,
                n_real=int(q_lens.sum()), quantized=quantized)


def _pools(c, jax_side):
    """(pool_k, pool_v) for one side; int8 pairs come from the REFERENCE's
    quantize_kv on both sides so the inputs are identical."""
    out = []
    for name in ("pk", "pv"):
        x = c[name]
        if c["quantized"]:
            v, s = (np.array(a) for a in jdec.quantize_kv(jnp.asarray(x)))
            out.append((jnp.asarray(v), jnp.asarray(s)) if jax_side
                       else (torch.from_numpy(v), torch.from_numpy(s)))
        else:
            out.append(jnp.asarray(x) if jax_side else torch.from_numpy(x))
    return out


def _rows(c):
    rs, rp = jrpa.ragged_rows(jnp.asarray(c["cu"]), jnp.asarray(c["kv"]),
                              c["q"].shape[0])
    return np.array(rs), np.array(rp)


class TestRaggedRows:
    def test_hand_case(self):
        seq, pos = trpa.ragged_rows([0, 3, 3, 4, 6], [10, 0, 5, 2], 8)
        assert seq.dtype == pos.dtype == torch.int32
        np.testing.assert_array_equal(seq.numpy()[:6], [0, 0, 0, 2, 3, 3])
        np.testing.assert_array_equal(pos.numpy(),
                                      [7, 8, 9, 4, 0, 1, -1, -1])

    @pytest.mark.parametrize("seed", range(6))
    def test_matches_reference_exactly(self, seed):
        c = _case(seed)
        want_seq, want_pos = _rows(c)
        seq, pos = trpa.ragged_rows(torch.from_numpy(c["cu"]),
                                    torch.from_numpy(c["kv"]),
                                    c["q"].shape[0])
        np.testing.assert_array_equal(seq.numpy(), want_seq)
        np.testing.assert_array_equal(pos.numpy(), want_pos)


class TestPlainAttentionParity:
    def _both(self, c, pad=True):
        rs, rp = _rows(c)
        jk, jv = _pools(c, True)
        tk, tv = _pools(c, False)
        jpad = jnp.asarray(c["pad"]) if pad else None
        ref = jrpa.ragged_attention_ref(
            jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["table"]),
            jnp.asarray(rs), jnp.asarray(rp), jpad)
        kern = jrpa.ragged_paged_attention(
            jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["table"]),
            jnp.asarray(c["cu"]), jnp.asarray(c["kv"]), jpad,
            interpret=True)
        got = trpa.ragged_attention_rows(
            torch.from_numpy(c["q"]), tk, tv, torch.from_numpy(c["table"]),
            torch.from_numpy(rs), torch.from_numpy(rp),
            torch.from_numpy(c["pad"]) if pad else None)
        n = c["n_real"]
        return got.numpy()[:n], np.asarray(ref)[:n], np.asarray(kern)[:n]

    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_fp32_pools(self, seed):
        got, ref, kern = self._both(_case(seed))
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)

    @pytest.mark.parametrize("seed", [5, 6])
    def test_int8_pools(self, seed):
        got, ref, kern = self._both(_case(seed, quantized=True))
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)

    def test_no_pad_lens(self):
        got, ref, kern = self._both(_case(11), pad=False)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)

    def test_pads_of_whole_blocks(self):
        """Left pads of at least one block (bs=4) with real rows past
        them — the case where a whole block lies inside the pad."""
        c = _case(21, bs=4, C=6)
        c["kv"] = np.asarray([20, 9, 0, 24], np.int32)
        c["cu"] = np.asarray([0, 3, 4, 4, 6], np.int32)
        c["pad"] = np.asarray([9, 4, 0, 12], np.int32)
        c["n_real"] = 6
        got, ref, kern = self._both(c)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)


class TestRowOrderAndTableEdge:
    """Packs the engine does not build but the kernel must take: rows out
    of sequence order, and decode rows at the table's last column."""

    def _three(self, c, rs, rp):
        """(port plain, JAX gather reference, Pallas kernel in interpret
        mode) on row metadata, real rows only."""
        jk, jv = _pools(c, True)
        tk, tv = _pools(c, False)
        jargs = (jnp.asarray(c["q"]), jk, jv, jnp.asarray(c["table"]),
                 jnp.asarray(rs), jnp.asarray(rp), jnp.asarray(c["pad"]))
        ref = jrpa.ragged_attention_ref(*jargs)
        kern = jrpa.ragged_attention_rows(*jargs, interpret=True)
        got = trpa.ragged_attention_rows(
            torch.from_numpy(c["q"]), tk, tv, torch.from_numpy(c["table"]),
            torch.from_numpy(rs), torch.from_numpy(rp),
            torch.from_numpy(c["pad"]))
        real = rp >= 0
        return got.numpy()[real], np.asarray(ref)[real], \
            np.asarray(kern)[real]

    @pytest.mark.parametrize("seed", [0, 3])
    def test_rows_out_of_sequence_order(self, seed):
        c = _case(seed)
        rs, rp = _rows(c)
        perm = np.random.RandomState(seed + 50).permutation(len(rs))
        c["q"] = c["q"][perm]
        got, ref, kern = self._three(c, rs[perm], rp[perm])
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)

    @pytest.mark.parametrize("quantized", [False, True])
    def test_decode_only_to_the_last_column(self, quantized):
        """One decode row a sequence, two at C * bs - 1, padding after."""
        c = _case(13, quantized=quantized)                  # C 4, bs 8
        c["cu"] = np.asarray([0, 1, 2, 3, 4], np.int32)
        c["kv"] = np.asarray([32, 32, 17, 9], np.int32)
        c["pad"] = np.asarray([0, 5, 3, 8], np.int32)
        rs, rp = _rows(c)
        assert list(rp[:4]) == [31, 31, 16, 8] and (rp[4:] == -1).all()
        got, ref, kern = self._three(c, rs, rp)
        np.testing.assert_allclose(got, ref, **TOL)
        np.testing.assert_allclose(got, kern, **TOL)


class TestRaggedPlan:
    """The kernel's work list (``ragged_plan``) on hand cases: tiles are
    runs of one sequence cut every 16 rows, splits cover [pad, a tile's
    last position], padding rows belong to no tile."""

    def _plan(self, rows, pads, T):
        """(tiles as (first row, rows), items a tile, split a tile) from
        ``ragged_plan``, after checking its layout: zeros past the last
        tile, the per-row copies of each tile's pad and split, and the items
        numbered 0.. in each tile in tile order."""
        rows = list(rows) + [(len(pads) - 1, -1)] * (T - len(rows))
        rs = torch.tensor([s for s, _ in rows], dtype=torch.int32)
        rp = torch.tensor([p for _, p in rows], dtype=torch.int32)
        plan = trpa.ragged_plan(rs, rp, torch.tensor(pads, dtype=torch.int32))
        assert plan.dtype == torch.int32 and tuple(plan.shape) == (23, T)
        row0, nrows, seq, lo, split, row_lo, row_split = plan.numpy()[:7]
        item_tile = plan.numpy()[7:15].ravel()
        item_k = plan.numpy()[15:].ravel()
        n = int((nrows > 0).sum())
        assert (nrows[n:] == 0).all()
        tiles = [(int(a), int(b)) for a, b in zip(row0[:n], nrows[:n])]
        for t, (a, b) in enumerate(tiles):
            assert seq[t] == rs[a] and lo[t] == max(pads[rs[a]], 0)
            assert (row_lo[a:a + b] == lo[t]).all()
            assert (row_split[a:a + b] == split[t]).all()
        used = item_tile < T
        assert used.sum() == 0 or used[:used.sum()].all()   # items first
        items = np.bincount(item_tile[used], minlength=n)[:n]
        assert list(item_tile[used]) == sorted(item_tile[used])
        assert list(item_k[used]) == [k for c in items for k in range(c)]
        return tiles, [int(i) for i in items], split
    def test_runs_tiles_and_padding_rows(self):
        # seq 2 x 20 rows, a padding row, seq 0 x 3, seq 2 x 2 (a new run)
        rows = ([(2, p) for p in range(20)] + [(1, -1)]
                + [(0, p) for p in (5, 6, 7)] + [(2, 20), (2, 21)])
        tiles, items, split = self._plan(rows, [0, 0, 0], 32)
        assert tiles == [(0, 16), (16, 4), (21, 3), (24, 2)]
        # last positions 15, 19, 7, 21 from pad 0: one 64-position split
        assert items == [1, 1, 1, 1] and list(split[:4]) == [64] * 4

    def test_splits(self):
        rows = [(0, 511), (1, 1000), (2, 63), (3, 73), (3, 74), (4, 3)]
        pads = [0, 0, 0, 10, 5]
        tiles, items, split = self._plan(rows, pads, 8)
        assert tiles == [(0, 1), (1, 1), (2, 1), (3, 2), (5, 1)]
        # 512 positions: 8 splits of 64; 1001: at most 8, so 8 of 128;
        # 64: one; [10, 74] is 65: two; pad 5 past position 3: none
        assert items == [8, 8, 1, 2, 0]
        assert list(split[:5]) == [64, 128, 64, 64, 64]

    def test_kernel_reads_the_same_layout(self):
        """The CUDA kernel reads the plan with its own copies of the tile
        height and the split cap: they must be the plan's."""
        from pathlib import Path

        src = (Path(trpa.__file__).resolve().parent.parent / "csrc" /
               "ragged_paged_attention.cu").read_text()
        assert f"kTileRows = {trpa._TILE_ROWS};" in src
        assert f"kMaxSplits = {trpa._MAX_SPLITS};" in src
        assert trpa._PLAN_ROWS == 7 + 2 * trpa._MAX_SPLITS

    @pytest.mark.parametrize("seed", range(4))
    def test_tiles_cover_ragged_rows(self, seed):
        """On the generator's packs (in order and shuffled): every real row
        lies in exactly one tile, a tile is at most 16 consecutive rows of
        one sequence, and its splits cover [pad, its last position]."""
        c = _case(seed, T=40)
        rs, rp = _rows(c)
        for order in (np.arange(len(rs)),
                      np.random.RandomState(seed).permutation(len(rs))):
            s, p = rs[order], rp[order]
            tiles, items, split = self._plan(list(zip(s, p)), list(c["pad"]),
                                             len(s))
            covered = sorted(r for a, n in tiles for r in range(a, a + n))
            assert covered == sorted(np.flatnonzero(p >= 0))
            for (a, n), k, sp in zip(tiles, items, split):
                assert 1 <= n <= 16 and len(set(s[a:a + n])) == 1
                span = int(p[a:a + n].max()) - int(c["pad"][s[a]]) + 1
                assert k == max(0, -(-span // int(sp))) <= 8


class TestKernelWrapperGuards:
    """The CUDA wrapper's checks run before any pointer leaves Python; on
    a machine without a card they are what can be exercised."""

    def _args(self, hd=64, dtype=torch.bfloat16):
        q = torch.zeros(5, 2, hd, dtype=dtype)
        pool = torch.zeros(3, 4, 2, hd, dtype=dtype)
        i32 = dict(dtype=torch.int32)
        return (q, pool, pool.clone(), torch.zeros(2, 3, **i32),
                torch.zeros(5, **i32), torch.zeros(5, **i32),
                torch.zeros(2, **i32))

    def test_cpu_tensor_refused(self):
        with pytest.raises(ValueError, match="CUDA tensors"):
            trpa.ragged_attention_cuda(*self._args())

    def test_rows_dispatch_refuses_other_devices(self):
        q = torch.zeros(2, 2, 64, device="meta")
        with pytest.raises(ValueError, match="CUDA tensors"):
            trpa.ragged_attention_rows(q, q, q, q, q, q)

    @pytest.mark.parametrize("hd", [16, 48, 256])
    def test_unsupported_head_dim(self, hd):
        with pytest.raises(ValueError, match="head dim"):
            trpa._check_kernel_args(*self._args(hd=hd))

    def test_dtype_shape_contiguity(self):
        q, pk, pv, tab, rs, rp, pad = self._args()
        trpa._check_kernel_args(q, pk, pv, tab, rs, rp, pad)     # accepted
        with pytest.raises(ValueError, match="dtype"):
            trpa._check_kernel_args(q, pk.float(), pv, tab, rs, rp, pad)
        with pytest.raises(ValueError, match="int32"):
            trpa._check_kernel_args(q, pk, pv, tab.long(), rs, rp, pad)
        with pytest.raises(ValueError, match="contiguous"):
            trpa._check_kernel_args(q.transpose(0, 1).contiguous()
                                    .transpose(0, 1), pk, pv, tab, rs, rp,
                                    pad)
        with pytest.raises(ValueError, match="both"):
            trpa._check_kernel_args(q, (pk.to(torch.int8),
                                        torch.zeros(3, 4, 2)), pv, tab, rs,
                                    rp, pad)
        quant = (pk.to(torch.int8), torch.zeros(3, 4, 2))
        trpa._check_kernel_args(q, quant, quant, tab, rs, rp, pad)


class TestQuantizeAndWrite:
    @pytest.mark.parametrize("seed", [0, 1])
    def test_quantize_kv_bit_exact(self, seed):
        rng = np.random.RandomState(seed)
        x = (rng.randn(6, 5, 4, 16) * rng.rand(6, 5, 4, 1) * 3
             ).astype(np.float32)
        # exact .5 ties after scaling, to pin round-half-to-even
        x[0, 0, 0, :4] = [127.0, 63.5, -0.5 * 127 / 127, 1.5]
        x[1, 0, 0] = 0.0                                  # amax floor
        jq, js = jdec.quantize_kv(jnp.asarray(x))
        tq, ts = tdec.quantize_kv(torch.from_numpy(x))
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32

    def test_dequantize(self):
        x = np.random.RandomState(3).randn(4, 8, 2, 16).astype(np.float32)
        jq, js = jdec.quantize_kv(jnp.asarray(x))
        want = jdec.dequantize_cache((jq, js), jnp.float32)
        got = tdec.dequantize_cache(
            (torch.from_numpy(np.array(jq)),
             torch.from_numpy(np.array(js))), torch.float32)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    @pytest.mark.parametrize("quantized", [False, True])
    def test_ragged_write_bit_exact(self, quantized):
        """Real rows land bit-exactly where the reference puts them; the
        padding rows go to trash block 0 (compared apart: several padding
        rows race for the same trash slot on both sides)."""
        rng = np.random.RandomState(7)
        S, C, bs, nh, hd, NB = 3, 4, 4, 2, 16, 12
        table = (rng.permutation(NB)[:S * C] + 1).reshape(S, C).astype(
            np.int32)
        cu = np.asarray([0, 5, 6, 9], np.int32)
        kv = np.asarray([12, 3, 16], np.int32)
        T = 12                                              # 3 padding rows
        rs, rp = (np.array(a) for a in jrpa.ragged_rows(
            jnp.asarray(cu), jnp.asarray(kv), T))
        chunk = rng.randn(T, nh, hd).astype(np.float32)
        if quantized:
            jpool = (jnp.zeros((NB + 1, bs, nh, hd), jnp.int8),
                     jnp.zeros((NB + 1, bs, nh), jnp.float32))
            tpool = (torch.zeros(NB + 1, bs, nh, hd, dtype=torch.int8),
                     torch.zeros(NB + 1, bs, nh))
        else:
            jpool = jnp.zeros((NB + 1, bs, nh, hd), jnp.float32)
            tpool = torch.zeros(NB + 1, bs, nh, hd)
        want = jdec.ragged_write(jpool, jnp.asarray(chunk),
                                 jnp.asarray(table), jnp.asarray(rs),
                                 jnp.asarray(rp))
        got = tdec.ragged_write(tpool, torch.from_numpy(chunk),
                                torch.from_numpy(table),
                                torch.from_numpy(rs), torch.from_numpy(rp))
        pairs = (zip(got, want) if quantized else [(got, want)])
        for g, w in pairs:
            np.testing.assert_array_equal(g.numpy()[1:], np.asarray(w)[1:])
        # in place: the port returned the very pool it was given
        assert (got[0] if quantized else got) is \
            (tpool[0] if quantized else tpool)

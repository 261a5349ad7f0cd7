// Ragged paged attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/ragged_paged_attention.py:_ragged_kernel (the
// Pallas kernel the ragged serving tick runs once per layer).  For every
// row i of a flattened (T, nh, hd) pack of prefill and decode rows, and
// every head, it computes attention over the row's sequence's pool
// positions [pad_lens[s], row_pos[i]], where s = row_seq[i] and position p
// lives in pool block table[s, p / bs] at offset p % bs.  Pools are
// (NB+1, bs, nh, hd) in the query's dtype (fp32, fp16, bf16), or int8
// values with fp32 (NB+1, bs, nh) scales, dequantized on the fly.  Rows
// with row_pos == -1 are padding and write zeros, as do rows with nothing
// in [pad, row_pos].
//
// What bounds it on this card: bytes, and before them latency.  Each
// sequence's K/V is read once at ~4 flops a row per element, far below the
// ~295 flops a byte the H100 needs before compute matters; a pack moves a
// few MB (~1-2 us at 3.35 TB/s).  What held the first version (one warp a
// (row, head) walking its positions in serial chunks) at 50x that was one
// chain of dependent round trips a row: a decode row at position 511 made
// ~64 of them in one warp, and each prefill row re-read its sequence's K/V.
// What the design does:
//   - a plan, built once per pack (ops/ragged_paged_attention.py
//     ragged_plan, shared by every layer), cuts each maximal run of rows of
//     one sequence into tiles of up to 16 rows and each tile's positions
//     [pad, last row's position] into at most 8 splits of 64 or more
//     positions.  Any row order is correct: a run is a run;
//   - a work item is (tile, split, head).  A warp stages its item's K and V
//     rows into shared memory with every load in flight at once (cp.async
//     for 16-bit and fp32 pools; int8 rows and their scales through
//     registers, dequantized to q's type on the way), so an item costs two
//     round trips (the table, then the rows) however long the sequence,
//     and the tile's rows share one staging of K/V.  Warps walk the items
//     of the pack persistently, one block an SM's worth;
//   - 16-bit queries score a 16-position chunk with mma.sync m16n8k16
//     (S = Q K^T from shared memory, O += P V with P from registers and V
//     through ldmatrix.trans), fp32 queries with exact fp32 FMAs on the
//     CUDA cores in the same register layout; an fp32 online softmax in
//     the log2 domain with per-row causal masking over [pad, row_pos].
//     P enters the 16-bit product as two parts, its rounded value and the
//     rounding's remainder, so O keeps the fp32 accuracy of the paged
//     decode kernel and of this kernel's first version (the products are
//     latency's, not throughput's, so the second mma is free);
//   - a row whose positions fit one split is written at once; a longer
//     row's splits leave (max, sum, fp32 accumulator) partials that a
//     second kernel of the same call combines in split order, so results
//     are run-to-run deterministic (no float atomics).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "paged_common.cuh"   // to_float, from_float, load_row
#include "sm90.cuh"           // smem_u32, pack2

namespace {

constexpr int kTileRows = 16;     // rows of a tile: the mma's M
constexpr int kMaxSplits = 8;     // splits of a tile, at the most
constexpr int kWarps = 4;         // warps a block, each on its own items
constexpr int kCombineWarps = 8;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kFloor = -1e30f;  // the running max's start (finite)

struct Args {
  const void *q, *pk, *pv;
  const float *ks, *vs;           // int8 pools' scales, else null
  const int32_t *table, *row_pos;
  const int32_t* plan;            // ragged_plan's (7 + 2 kMaxSplits, T)
  void* out;
  float2* part_ml;                // (T, nh, kmax) running max (log2), sum
  float* part_acc;                // (T, nh, kmax, hd) fp32 accumulators
  int T, nh, bs, C, kmax;
  float sm_scale;
};

// A warp's shared memory: the Q tile, a stage of K and V rows (pitch hd +
// 16 bytes, so fragment reads and ldmatrix rows fall in distinct banks),
// fp32 queries' P chunk, the stage's pool slots.
template <typename T, int HD>
struct Cfg {
  static constexpr bool F32 = sizeof(T) == 4;
  static constexpr int LD = HD + 16 / static_cast<int>(sizeof(T));
  static constexpr int ROW = LD * static_cast<int>(sizeof(T));
  static constexpr int STAGE = 8192 / (HD * static_cast<int>(sizeof(T)));
  static constexpr int OFF_K = kTileRows * ROW;
  static constexpr int OFF_V = OFF_K + STAGE * ROW;
  static constexpr int OFF_P = OFF_V + STAGE * ROW;
  static constexpr int OFF_SLOT = OFF_P + (F32 ? kTileRows * 17 * 4 : 0);
  static constexpr int WARP_BYTES = (OFF_SLOT + STAGE * 4 + 15) / 16 * 16;
  static constexpr int BYTES = kWarps * WARP_BYTES;
};

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// 16 bytes global -> shared, zero-filled when !valid (src is then only a
// valid address, never read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(sm90::smem_u32(dst)), "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

template <typename T>
__device__ __forceinline__ void mma16816(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1);
template <>
__device__ __forceinline__ void mma16816<__nv_bfloat16>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
template <>
__device__ __forceinline__ void mma16816<__half>(
    float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ uint32_t lds32(const T* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// B fragments of two n8 tiles of a k16 step from a row-major [k][n] tile:
// lanes 8i..8i+7 address rows k = 8 (i % 2) + 0..7 at column 8 (i / 2)
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(sm90::smem_u32(p)));
}

// (a, b) as two packed 16-bit pairs, hi the rounded values and lo what
// rounding left out: hi + lo carries (a, b) to ~16 bits of mantissa, so a
// product with 16-bit V keeps the fp32 accuracy of the plain arithmetic
template <typename T>
__device__ __forceinline__ void split2(float a, float b, uint32_t& hi,
                                       uint32_t& lo) {
  const T ta = from_float<T>(a), tb = from_float<T>(b);
  hi = static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&ta)) |
       (static_cast<uint32_t>(*reinterpret_cast<const uint16_t*>(&tb)) << 16);
  lo = sm90::pack2<T>(a - to_float(ta), b - to_float(tb));
}

template <typename T>
__device__ __forceinline__ void store2(T* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = sm90::pack2<T>(a, b);
}
template <>
__device__ __forceinline__ void store2<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The stage's K and V rows of head h at the slots in `slots` (-1: zero).
template <typename T, typename KT, int HD>
__device__ __forceinline__ void stage_kv(T* Ks, T* Vs, const int* slots,
                                         const Args& a, int h, int lane) {
  using C = Cfg<T, HD>;
  if constexpr (std::is_same<KT, T>::value) {      // cp.async, no registers
    constexpr int EPC = 16 / sizeof(T), CPR = HD / EPC;
    const T* pk = static_cast<const T*>(a.pk);
    const T* pv = static_cast<const T*>(a.pv);
#pragma unroll 4
    for (int c = lane; c < C::STAGE * CPR; c += 32) {
      const int i = c / CPR, e = (c % CPR) * EPC, slot = slots[i];
      const long long off =
          (static_cast<long long>(max(slot, 0)) * a.nh + h) * HD + e;
      cp_async16(Ks + i * C::LD + e, pk + off, slot >= 0);
      cp_async16(Vs + i * C::LD + e, pv + off, slot >= 0);
    }
  } else {                      // int8: loads first, then dequantize to T
    constexpr int CPR = HD / 16, NL = C::STAGE * CPR / 32;
    const int8_t* pk = static_cast<const int8_t*>(a.pk);
    const int8_t* pv = static_cast<const int8_t*>(a.pv);
    uint4 kr[NL], vr[NL];
    float sk[NL], sv[NL];
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      const int c = lane + 32 * n, i = c / CPR, slot = slots[i];
      const long long sh = static_cast<long long>(max(slot, 0)) * a.nh + h;
      const long long off = sh * HD + 16 * (c % CPR);
      const bool ok = slot >= 0;
      kr[n] = ok ? *reinterpret_cast<const uint4*>(pk + off)
                 : make_uint4(0, 0, 0, 0);
      vr[n] = ok ? *reinterpret_cast<const uint4*>(pv + off)
                 : make_uint4(0, 0, 0, 0);
      sk[n] = ok ? a.ks[sh] : 0.f;
      sv[n] = ok ? a.vs[sh] : 0.f;
    }
#pragma unroll
    for (int n = 0; n < NL; ++n) {
      const int c = lane + 32 * n, i = c / CPR, e = 16 * (c % CPR);
      const int8_t* kb = reinterpret_cast<const int8_t*>(&kr[n]);
      const int8_t* vb = reinterpret_cast<const int8_t*>(&vr[n]);
#pragma unroll
      for (int x = 0; x < 16; x += 2) {
        // the reference's dequantize: (int8 as fp32) * scale, then q's type
        store2<T>(Ks + i * C::LD + e + x, static_cast<float>(kb[x]) * sk[n],
                  static_cast<float>(kb[x + 1]) * sk[n]);
        store2<T>(Vs + i * C::LD + e + x, static_cast<float>(vb[x]) * sv[n],
                  static_cast<float>(vb[x + 1]) * sv[n]);
      }
    }
  }
}

// Work items (tile, split, head) over a pack, walked persistently.  Lane
// (g, tq) holds rows g and g + 8 of the tile in the mma accumulator
// layout: sc[nt][e] / acc[n][e] at row g + 8 (e / 2), column 8 nt (or n)
// + 2 tq + e % 2.
template <typename T, typename KT, int HD>
__global__ void __launch_bounds__(kWarps * 32)
ragged_tiles(const Args a) {
  using C = Cfg<T, HD>;
  extern __shared__ __align__(16) uint8_t smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  uint8_t* ws = smem + warp * C::WARP_BYTES;
  T* Qs = reinterpret_cast<T*>(ws);
  T* Ks = reinterpret_cast<T*>(ws + C::OFF_K);
  T* Vs = reinterpret_cast<T*>(ws + C::OFF_V);
  float* Ps = reinterpret_cast<float*>(ws + C::OFF_P);
  int* slots = reinterpret_cast<int*>(ws + C::OFF_SLOT);

  const int R = a.T;                              // rows of the pack
  const int* item_tile = a.plan + 7 * R;          // ragged_plan's rows
  const int* item_k = a.plan + (7 + kMaxSplits) * R;
  const int CB = a.C * a.bs;                      // positions the table holds
  const float sl2 = a.sm_scale * kLog2e;

  for (long long u = static_cast<long long>(blockIdx.x) * kWarps + warp;
       u < static_cast<long long>(kMaxSplits) * R * a.nh;
       u += static_cast<long long>(gridDim.x) * kWarps) {
    const int j = static_cast<int>(u / a.nh), h = static_cast<int>(u % a.nh);
    const int t = item_tile[j];
    if (t >= R) break;                  // past the last item: so are the rest
    const int k = item_k[j];
    const int r0 = a.plan[t], nr = a.plan[R + t], s = a.plan[2 * R + t];
    const int lo = a.plan[3 * R + t], split = a.plan[4 * R + t];
    int hi[2];                          // rows g, g + 8: last position
#pragma unroll
    for (int r = 0; r < 2; ++r)
      hi[r] = g + 8 * r < nr ? a.row_pos[r0 + g + 8 * r] : -1;
    const int p0 = lo + k * split;
    const int pend = min(p0 + split, CB);   // the table's reach, row_pos aside
    if (p0 >= pend) continue;           // past the table's columns
    __syncwarp();                       // the last item's reads are done
    // the first stage's slots while row_pos is in flight: both one trip
    for (int i = lane; i < C::STAGE; i += 32) {
      const int p = p0 + i;
      slots[i] = p < pend ? a.table[s * a.C + p / a.bs] * a.bs + p % a.bs : -1;
    }
    int nsp[2];                         // rows g, g + 8: splits
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      hi[r] = min(hi[r], CB - 1);
      nsp[r] = hi[r] >= lo ? (hi[r] - lo) / split + 1 : 0;
    }
    int last = max(hi[0], hi[1]);
#pragma unroll
    for (int o = 4; o < 32; o <<= 1)
      last = max(last, __shfl_xor_sync(0xffffffffu, last, o));
    const int p1 = min(pend, last + 1);     // the item's positions [p0, p1)
    if (p0 >= p1) continue;
    {                                   // the Q tile; rows past nr zero
      constexpr int EPC = 16 / sizeof(T), CPR = HD / EPC;
      const T* q = static_cast<const T*>(a.q);
      for (int c = lane; c < kTileRows * CPR; c += 32) {
        const int row = c / CPR, e = (c % CPR) * EPC;
        const long long qrow = r0 + min(row, nr - 1);
        const long long off = (qrow * a.nh + h) * HD + e;
        cp_async16(Qs + row * C::LD + e, q + off, row < nr);
      }
    }
    float m[2] = {kFloor, kFloor}, l[2] = {0.f, 0.f};
    float acc[HD / 8][4];
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
    uint32_t qa[C::F32 ? 1 : HD / 16][4];

    for (int st = p0; st < p1; st += C::STAGE) {
      const int n = min(C::STAGE, p1 - st);
      if (st > p0) {
        __syncwarp();                   // the last stage's reads are done
        for (int i = lane; i < C::STAGE; i += 32) {
          const int p = st + i;
          slots[i] = i < n ? a.table[s * a.C + p / a.bs] * a.bs + p % a.bs
                           : -1;
        }
      }
      __syncwarp();
      stage_kv<T, KT, HD>(Ks, Vs, slots, a, h, lane);
      cp_async_wait_all();
      __syncwarp();
      if constexpr (!C::F32) {
        if (st == p0) {
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk) {
            const T* qr = Qs + g * C::LD + 16 * kk + 2 * tq;
            qa[kk][0] = lds32(qr);
            qa[kk][1] = lds32(qr + 8 * C::LD);
            qa[kk][2] = lds32(qr + 8);
            qa[kk][3] = lds32(qr + 8 * C::LD + 8);
          }
        }
      }
      for (int c0 = 0; c0 < n; c0 += 16) {          // 16-position chunks
        float sc[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
        if constexpr (!C::F32) {                    // S = Q K^T
#pragma unroll
          for (int kk = 0; kk < HD / 16; ++kk)
#pragma unroll
            for (int nt = 0; nt < 2; ++nt) {
              const T* kr = Ks + (c0 + 8 * nt + g) * C::LD + 16 * kk + 2 * tq;
              mma16816<T>(sc[nt], qa[kk], lds32(kr), lds32(kr + 8));
            }
        } else {
#pragma unroll 4
          for (int d = 0; d < HD; d += 4) {
            const float4 q0 = *reinterpret_cast<const float4*>(
                Qs + g * C::LD + d);
            const float4 q1 = *reinterpret_cast<const float4*>(
                Qs + (g + 8) * C::LD + d);
#pragma unroll
            for (int nt = 0; nt < 2; ++nt)
#pragma unroll
              for (int e = 0; e < 2; ++e) {
                const float4 kv = *reinterpret_cast<const float4*>(
                    Ks + (c0 + 8 * nt + 2 * tq + e) * C::LD + d);
                sc[nt][e] = fmaf(q0.x, kv.x, fmaf(q0.y, kv.y, fmaf(
                    q0.z, kv.z, fmaf(q0.w, kv.w, sc[nt][e]))));
                sc[nt][2 + e] = fmaf(q1.x, kv.x, fmaf(q1.y, kv.y, fmaf(
                    q1.z, kv.z, fmaf(q1.w, kv.w, sc[nt][2 + e]))));
              }
          }
        }
        // mask to each row's [lo, hi]; online softmax, log2 domain
        float mc[2] = {m[0], m[1]};
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int p = st + c0 + 8 * nt + 2 * tq + (e & 1);
            sc[nt][e] = p <= hi[e >> 1] ? sc[nt][e] * sl2 : -INFINITY;
            mc[e >> 1] = fmaxf(mc[e >> 1], sc[nt][e]);
          }
        float alpha[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
          mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
          alpha[r] = ex2(m[r] - mc[r]);
          m[r] = mc[r];
          l[r] *= alpha[r];                         // this lane's share
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[nt][e] = ex2(sc[nt][e] - m[e >> 1]);
            l[e >> 1] += sc[nt][e];
          }
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[nn][e] *= alpha[e >> 1];
        if constexpr (!C::F32) {    // O += P V, P as hi + lo 16-bit parts
          uint32_t ph[4], pl[4];
#pragma unroll
          for (int x = 0; x < 4; ++x)
            split2<T>(sc[x / 2][2 * (x % 2)], sc[x / 2][2 * (x % 2) + 1],
                      ph[x], pl[x]);
          const int mi = lane / 8;
          const T* vr = Vs + (c0 + (mi & 1) * 8 + (lane & 7)) * C::LD +
                        (mi >> 1) * 8;
#pragma unroll
          for (int n2 = 0; n2 < HD / 16; ++n2) {
            uint32_t b[4];
            ldsm_x4_t(b, vr + 16 * n2);
            mma16816<T>(acc[2 * n2], ph, b[0], b[1]);
            mma16816<T>(acc[2 * n2 + 1], ph, b[2], b[3]);
            mma16816<T>(acc[2 * n2], pl, b[0], b[1]);
            mma16816<T>(acc[2 * n2 + 1], pl, b[2], b[3]);
          }
        } else {
#pragma unroll
          for (int nt = 0; nt < 2; ++nt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              Ps[(g + 8 * (e >> 1)) * 17 + 8 * nt + 2 * tq + (e & 1)] =
                  sc[nt][e];
          __syncwarp();
#pragma unroll 4
          for (int kp = 0; kp < 16; ++kp) {
            const float w0 = Ps[g * 17 + kp], w1 = Ps[(g + 8) * 17 + kp];
            const float* vr = reinterpret_cast<const float*>(Vs) +
                              (c0 + kp) * C::LD + 2 * tq;
#pragma unroll
            for (int nn = 0; nn < HD / 8; ++nn) {
              const float2 v2 = *reinterpret_cast<const float2*>(vr + 8 * nn);
              acc[nn][0] = fmaf(w0, v2.x, acc[nn][0]);
              acc[nn][1] = fmaf(w0, v2.y, acc[nn][1]);
              acc[nn][2] = fmaf(w1, v2.x, acc[nn][2]);
              acc[nn][3] = fmaf(w1, v2.y, acc[nn][3]);
            }
          }
          __syncwarp();
        }
      }
    }

    // a row whose positions fit one split is done; a longer one leaves
    // this split's partial for the combine
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      if (k >= nsp[r]) continue;
      const long long ro = static_cast<long long>(r0 + g + 8 * r) * a.nh + h;
      if (nsp[r] == 1) {
        const float inv = 1.f / l[r];
        T* o = static_cast<T*>(a.out) + ro * HD + 2 * tq;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          store2<T>(o + 8 * nn, acc[nn][2 * r] * inv,
                    acc[nn][2 * r + 1] * inv);
      } else {
        const long long pi = ro * a.kmax + k;
        if (tq == 0) a.part_ml[pi] = make_float2(m[r], l[r]);
        float* pa = a.part_acc + pi * HD + 2 * tq;
#pragma unroll
        for (int nn = 0; nn < HD / 8; ++nn)
          store2<float>(pa + 8 * nn, acc[nn][2 * r], acc[nn][2 * r + 1]);
      }
    }
  }
}

// One warp a (row, head): rows of more than one split combine their
// partials in split order; padding rows and rows with nothing to attend
// write zeros; rows of one split were written by ragged_tiles.
template <typename T, int HD>
__global__ void __launch_bounds__(kCombineWarps * 32)
ragged_combine(const Args a) {
  constexpr int EPL = HD / 32;
  const long long w =
      static_cast<long long>(blockIdx.x) * kCombineWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (w >= static_cast<long long>(a.T) * a.nh) return;
  const int i = static_cast<int>(w / a.nh);
  const int pos = a.row_pos[i];
  const int lo = a.plan[5 * a.T + i], split = a.plan[6 * a.T + i];
  const int hi = min(pos, a.C * a.bs - 1);
  const int n = pos >= 0 && hi >= lo ? (hi - lo) / split + 1 : 0;
  if (n == 1) return;
  float o[EPL];
#pragma unroll
  for (int e = 0; e < EPL; ++e) o[e] = 0.f;
  if (n > 1) {
    const float2* ml = a.part_ml + w * a.kmax;
    float mx = kFloor, sum = 0.f;
    for (int k = 0; k < n; ++k) mx = fmaxf(mx, ml[k].x);
    for (int k = 0; k < n; ++k) {
      const float2 mk = ml[k];
      const float wk = ex2(mk.x - mx);
      sum += wk * mk.y;
      float pv[EPL];
      load_row<EPL>(a.part_acc + (w * a.kmax + k) * HD + lane * EPL, pv);
#pragma unroll
      for (int e = 0; e < EPL; ++e) o[e] = fmaf(wk, pv[e], o[e]);
    }
    const float inv = 1.f / sum;
#pragma unroll
    for (int e = 0; e < EPL; ++e) o[e] *= inv;
  }
  T* out = static_cast<T*>(a.out) + w * HD + lane * EPL;
#pragma unroll
  for (int e = 0; e < EPL; ++e) out[e] = from_float<T>(o[e]);
}

template <typename T, typename KT, int HD>
int launch(const Args& a, cudaStream_t stream) {
  using C = Cfg<T, HD>;
  auto kern = ragged_tiles<T, KT, HD>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, C::BYTES);
  if (e != cudaSuccess) return static_cast<int>(e);
  static int blocks = 0;              // as many as the card holds at once
  if (blocks == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    if ((e = cudaGetDevice(&dev)) != cudaSuccess ||
        (e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
        (e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
             &per_sm, kern, kWarps * 32, C::BYTES)) != cudaSuccess)
      return static_cast<int>(e);
    blocks = sms * max(per_sm, 1);
  }
  kern<<<blocks, kWarps * 32, C::BYTES, stream>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  const long long warps = static_cast<long long>(a.T) * a.nh;
  ragged_combine<T, HD><<<static_cast<int>((warps + kCombineWarps - 1) /
                                           kCombineWarps),
                          kCombineWarps * 32, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename QT>
int dispatch_pool(const Args& a, int quantized, int hd, cudaStream_t s) {
  if (quantized) {
    if (hd == 64) return launch<QT, int8_t, 64>(a, s);
    if (hd == 128) return launch<QT, int8_t, 128>(a, s);
  } else {
    if (hd == 64) return launch<QT, QT, 64>(a, s);
    if (hd == 128) return launch<QT, QT, 128>(a, s);
  }
  return -1;
}

}  // namespace

// q_dtype: 0 float32, 1 float16, 2 bfloat16.  quantized: pools are int8
// values with fp32 scales (else the pools share q's dtype).  plan: the
// int32 work list of ragged_plan, which holds the rows' sequences and
// pads; part: fp32 scratch of T nh kmax (hd + 2) + 2 floats, the (T, nh,
// kmax) (max, sum) pairs then the (T, nh, kmax, hd) accumulators.  Launches the tile kernel and the
// combine on `stream`; returns the first cudaGetLastError(), or -1 for an
// unsupported combination.
extern "C" int ragged_paged_attention(
    int q_dtype, int quantized, int hd, const void* q, const void* pool_k,
    const void* pool_v, const void* scale_k, const void* scale_v,
    const void* table, const void* row_pos, const void* plan, void* out,
    void* part, int T, int nh, int bs, int C, int kmax, float sm_scale,
    void* stream) {
  // the accumulators start at the first 16 bytes after the pairs (one
  // lane's 4 floats are read as one 16-byte load)
  float2* part_ml = static_cast<float2*>(part);
  float* part_acc =
      static_cast<float*>(part) + ((2LL * T * nh * kmax + 3) & ~3LL);
  const Args a{q, pool_k, pool_v,
               static_cast<const float*>(scale_k),
               static_cast<const float*>(scale_v),
               static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(row_pos),
               static_cast<const int32_t*>(plan), out, part_ml, part_acc,
               T, nh, bs, C, kmax, sm_scale};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (q_dtype) {
    case 0: return dispatch_pool<float>(a, quantized, hd, s);
    case 1: return dispatch_pool<__half>(a, quantized, hd, s);
    case 2: return dispatch_pool<__nv_bfloat16>(a, quantized, hd, s);
    default: return -1;
  }
}

// Dynamic shared memory of the tile kernel for q_dtype (as above) and hd.
extern "C" int ragged_smem_bytes(int q_dtype, int hd) {
  const bool d64 = hd == 64;
  if (!d64 && hd != 128) return -1;
  switch (q_dtype) {
    case 0: return d64 ? Cfg<float, 64>::BYTES : Cfg<float, 128>::BYTES;
    case 1:
    case 2: return d64 ? Cfg<__half, 64>::BYTES : Cfg<__half, 128>::BYTES;
    default: return -1;
  }
}

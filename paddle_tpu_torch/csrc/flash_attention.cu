// Flash attention forward and backward for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of paddle_tpu/ops/attention.py:
//   flash_fwd      <- :103 _flash_fwd_kernel      (O and the fp32 logsumexp)
//   flash_bwd_dq   <- :241 _flash_bwd_dq_kernel   (dQ)
//   flash_bwd_dkv  <- :273 _flash_bwd_dkv_kernel  (dK, dV)
// over q, k, v in the public (B, L, H, D) layout, read directly (no
// (B*H, L, D) transpose), fp32, fp16 or bf16, head dim 64 or 128, L a
// multiple of 64.  The key mask is additive fp32 (B, L), shared by a batch
// row's heads; lse and delta = rowsum(dO * O) are fp32 (B*H, L).  Numerics
// follow the Pallas kernels: S = (q.k) scale + key mask and the softmax in
// fp32 (16-bit inputs round P and dS to their type before the products
// that use them), the -1e30 sentinel for causal masking, an online softmax
// whose running max starts at -1e30 (a row whose keys are all masked
// averages V uniformly over the tiles it visits), l clamped at 1e-30.
// Keys past L (a 128-key tile over L = 64 * odd) are left out of the
// softmax entirely.  Dropout is the reference's position hash
// (position_hash.cuh) of the global (row, col), mixed with seed + bh *
// 0xC2B2AE3D; kept probabilities are divided by (1 - p) where they multiply
// V (or build dV, dS), never in the normaliser l.  The hash depends on
// positions only, so any tiling gives the TPU's 128..512 blocks' bits.
//
// What bounds them on this card: at the training shapes (L 1024, D 64,
// bf16, causal) the forward does 25.8 GFLOP, dQ 38.7 and dK/dV 51.5 over
// ~100-150 MB, so the tensor cores (989 TFLOP/s dense) bound them at about
// 26, 39 and 52 us, HBM (3.35 TB/s) at 30-40 us; at D 64 the softmax's
// exponentials (16 a clock on an SM) cost as much as the products.
// What the design does:
//   - 16-bit forward, dQ and dK/dV (the training and prefill paths): one
//     block of three warpgroups per (bh, 128-row tile).  A producer warp
//     streams the other axis's tiles by TMA (128-byte swizzle, 64-column
//     boxes) into a ring of two shared-memory stages guarded by full/empty
//     mbarriers, so loads run under the products; two consumer
//     warpgroups of 64 rows each run every product as wgmma, the only
//     instruction that reaches the tensor cores' rate.  The forward
//     computes S = Q K^T with both operands K-major in shared memory and
//     O += P V with P from registers (the S accumulator, rounded in place)
//     and V read as an MN-major operand straight from its [key][D] tile:
//     no transposed copy.  dQ keeps its 128 queries' Q and dO resident and
//     streams K, V and the key mask in the forward's key tiles; S = Q K^T
//     and dP = dO V^T from shared memory, dQ += dS K with dS from registers
//     and K read MN-major in place, as the forward reads V.  dK/dV keeps
//     its 128 keys' K and V resident and streams 64-query tiles (32 at
//     head dim 128, so dK, dV, S^T and dP^T fit in registers) of Q, dO,
//     lse and delta; S^T = K Q^T and dP^T =
//     V dO^T from shared memory, dV += P^T dO and dK += dS^T Q with A from
//     registers and dO, Q MN-major in place.  Key tiles are 128 at head
//     dim 64 and 64 at 128 (register budget).  The softmax runs in the
//     log2 domain: scale log2(e) and the mask in one FMA, ex2.approx.
//     Uniform branches (the causal/length edge, dropout) sit outside the
//     unrolled loops.  Results leave through shared memory and TMA stores
//     that clip rows past L.  setmaxnreg gives the consumers 232
//     registers, the producer 40.  The shared helpers are sm90.cuh;
//   - fp32 inputs keep an exact fp32 path on the CUDA cores: tiles staged
//     as fp32 in shared memory with one float of padding per row, a
//     256-thread block as a 16x16 grid computing 4x4 patches of the 64x64
//     score tile (8 shared loads per 16 FMAs), a row's max and sum a
//     16-lane shuffle;
//   - a block owns its rows and loops over the other axis in order, so
//     the running softmax state (forward) and the dQ or dK/dV sums
//     (backward) stay in registers: no atomics, no cross-block reduction,
//     results are run-to-run deterministic;
//   - causal tiles above the diagonal are skipped (forward and dQ stop at
//     the diagonal, dK/dV starts there), and the heaviest tiles are
//     scheduled first.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "position_hash.cuh"   // keep_bit
#include "sm90.cuh"            // mbarrier, TMA, wgmma

namespace {

constexpr int kTile = 64;            // rows of a q tile and of a k tile
constexpr int kThreads = 256;        // a 16 x 16 thread grid
constexpr int kTP = kTile + 1;       // padded row of a 64x64 score tile
constexpr float kNegInf = -1e30f;    // the reference's masking sentinel

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  return __float2half_rn(x);
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

struct Params {
  const void *q, *k, *v, *dout;
  const float *kmask, *lse, *delta;
  void *out, *dq, *dk, *dv;
  float* lse_out;
  int B, L, H;
  float scale;
  int causal, dropout;
  uint32_t seed, thresh;
  float keep_div;     // float32(1 - p), the divisor of kept probabilities
};

// Rows [row0, row0 + 64) of head bh of a (B, L, H, D) tensor into a padded
// fp32 tile (row stride D + 1), times `mul`.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* __restrict__ dst,
                                          const T* __restrict__ src,
                                          const Params& p, int bh, int row0,
                                          float mul) {
  const int b = bh / p.H, h = bh % p.H;
  for (int e = threadIdx.x; e < kTile * D; e += kThreads) {
    const int r = e / D, c = e % D;
    const long long g =
        ((static_cast<long long>(b) * p.L + row0 + r) * p.H + h) * D + c;
    dst[r * (D + 1) + c] = to_float(src[g]) * mul;
  }
}

// acc[i][j] = sum_d A[4*ty + i][d] * Bm[tx + 16*j][d] over padded tiles
template <int D>
__device__ __forceinline__ void tile_dot_nt(const float* __restrict__ A,
                                            const float* __restrict__ Bm,
                                            int ty, int tx,
                                            float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float a[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = A[(4 * ty + i) * (D + 1) + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = Bm[(tx + 16 * j) * (D + 1) + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
  }
}

// out[i][j] (+)= mul * sum_c P[4*ty + i][c] * V[c][tx + 16*j], P a padded
// 64x64 tile, V a padded 64xD tile; out covers D/16 columns per row.
template <int D>
__device__ __forceinline__ void tile_dot_nn(const float* __restrict__ P,
                                            const float* __restrict__ V,
                                            int ty, int tx, float mul,
                                            float (&out)[4][D / 16]) {
  constexpr int NJ = D / 16;
  float t[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) t[i][j] = 0.f;
#pragma unroll 4
  for (int c = 0; c < kTile; ++c) {
    float a[4], bv[NJ];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = P[(4 * ty + i) * kTP + c];
#pragma unroll
    for (int j = 0; j < NJ; ++j) bv[j] = V[c * (D + 1) + tx + 16 * j];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < NJ; ++j) t[i][j] = fmaf(a[i], bv[j], t[i][j]);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) out[i][j] += mul * t[i][j];
}

// reductions over the 16 lanes that share a row group (tx = lane & 15)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ----------------------------------------------------------- forward --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(Params p) {
  constexpr int SD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // q * scale
  float* Ks = Qs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* Ps = Vs + kTile * SD;         // dropped-out probabilities
  float* Km = Ps + kTile * kTP;        // key-mask tile

  const int nq = p.L / kTile;
  const int qt = nq - 1 - blockIdx.x;  // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;

  load_tile<T, D>(Qs, static_cast<const T*>(p.q), p, bh, qt * kTile,
                  p.scale);
  float acc[4][NJ], m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }
  const int kt_end = p.causal ? qt + 1 : nq;
  for (int kt = 0; kt < kt_end; ++kt) {
    load_tile<T, D>(Ks, static_cast<const T*>(p.k), p, bh, kt * kTile, 1.f);
    load_tile<T, D>(Vs, static_cast<const T*>(p.v), p, bh, kt * kTile, 1.f);
    if (threadIdx.x < kTile)
      Km[threadIdx.x] =
          p.kmask[static_cast<long long>(b) * p.L + kt * kTile + threadIdx.x];
    __syncthreads();
    float s[4][4];
    tile_dot_nt<D>(Qs, Ks, ty, tx, s);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = qt * kTile + 4 * ty + i;
      float mc = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        s[i][j] += Km[tx + 16 * j];
        if (p.causal && col > row) s[i][j] = kNegInf;
        mc = fmaxf(mc, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mc));
      const float alpha = expf(m[i] - m_new);
      float ls = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float pr = expf(s[i][j] - m_new);
        ls += pr;
        float pv = pr;
        if (p.dropout)
          pv = keep_bit(mixed, row, kt * kTile + tx + 16 * j, p.thresh)
                   ? pr / p.keep_div : 0.f;
        Ps[(4 * ty + i) * kTP + tx + 16 * j] = pv;
      }
      l[i] = alpha * l[i] + row_sum(ls);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    tile_dot_nn<D>(Ps, Vs, ty, tx, 1.f, acc);
    __syncthreads();
  }
  T* out = static_cast<T*>(p.out);
  const int h = bh % p.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + 4 * ty + i;
    const float li = fmaxf(l[i], 1e-30f);
    const long long g = ((static_cast<long long>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j)
      out[g + tx + 16 * j] = from_float<T>(acc[i][j] / li);
    if (tx == 0)
      p.lse_out[static_cast<long long>(bh) * p.L + row] = m[i] + logf(li);
  }
}

// ---------------------------------------------------------------- dQ --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(Params p) {
  constexpr int SD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Qs = smem;                    // q * scale
  float* dOs = Qs + kTile * SD;
  float* Ks = dOs + kTile * SD;
  float* Vs = Ks + kTile * SD;
  float* dSs = Vs + kTile * SD;
  float* Km = dSs + kTile * kTP;
  float* Lse = Km + kTile;
  float* Dl = Lse + kTile;

  const int nq = p.L / kTile;
  const int qt = nq - 1 - blockIdx.x;
  const int bh = blockIdx.y, b = bh / p.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;

  load_tile<T, D>(Qs, static_cast<const T*>(p.q), p, bh, qt * kTile,
                  p.scale);
  load_tile<T, D>(dOs, static_cast<const T*>(p.dout), p, bh, qt * kTile,
                  1.f);
  if (threadIdx.x < kTile) {
    const long long r = static_cast<long long>(bh) * p.L + qt * kTile +
                        threadIdx.x;
    Lse[threadIdx.x] = p.lse[r];
    Dl[threadIdx.x] = p.delta[r];
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  const int kt_end = p.causal ? qt + 1 : nq;
  for (int kt = 0; kt < kt_end; ++kt) {
    load_tile<T, D>(Ks, static_cast<const T*>(p.k), p, bh, kt * kTile, 1.f);
    load_tile<T, D>(Vs, static_cast<const T*>(p.v), p, bh, kt * kTile, 1.f);
    if (threadIdx.x < kTile)
      Km[threadIdx.x] =
          p.kmask[static_cast<long long>(b) * p.L + kt * kTile + threadIdx.x];
    __syncthreads();
    float s[4][4], dp[4][4];
    tile_dot_nt<D>(Qs, Ks, ty, tx, s);
    tile_dot_nt<D>(dOs, Vs, ty, tx, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = 4 * ty + i, row = qt * kTile + r;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = kt * kTile + tx + 16 * j;
        float sv = s[i][j] + Km[tx + 16 * j];
        if (p.causal && col > row) sv = kNegInf;
        const float pr = expf(sv - Lse[r]);
        float pd = pr;
        if (p.dropout)
          pd = keep_bit(mixed, row, col, p.thresh) ? pr / p.keep_div : 0.f;
        dSs[r * kTP + tx + 16 * j] = pd * dp[i][j] - pr * Dl[r];
      }
    }
    __syncthreads();
    tile_dot_nn<D>(dSs, Ks, ty, tx, p.scale, acc);
    __syncthreads();
  }
  T* dq = static_cast<T*>(p.dq);
  const int h = bh % p.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = qt * kTile + 4 * ty + i;
    const long long g = ((static_cast<long long>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) dq[g + tx + 16 * j] = from_float<T>(acc[i][j]);
  }
}

// ------------------------------------------------------------- dK, dV --

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(Params p) {
  constexpr int SD = D + 1, NJ = D / 16;
  extern __shared__ float smem[];
  float* Ks = smem;
  float* Vs = Ks + kTile * SD;
  float* Qs = Vs + kTile * SD;         // q, unscaled (dK = scale * dS^T Q)
  float* dOs = Qs + kTile * SD;
  float* PdT = dOs + kTile * SD;       // [key][query]
  float* dST = PdT + kTile * kTP;
  float* Km = dST + kTile * kTP;
  float* Lse = Km + kTile;
  float* Dl = Lse + kTile;

  const int nk = p.L / kTile;
  const int kt = blockIdx.x;           // heaviest causal tiles first
  const int bh = blockIdx.y, b = bh / p.H;
  const int ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;

  load_tile<T, D>(Ks, static_cast<const T*>(p.k), p, bh, kt * kTile, 1.f);
  load_tile<T, D>(Vs, static_cast<const T*>(p.v), p, bh, kt * kTile, 1.f);
  if (threadIdx.x < kTile)
    Km[threadIdx.x] =
        p.kmask[static_cast<long long>(b) * p.L + kt * kTile + threadIdx.x];
  float dk[4][NJ], dv[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) dk[i][j] = dv[i][j] = 0.f;

  // causal: q tiles above the diagonal hold no row that attends this tile
  for (int qt = p.causal ? kt : 0; qt < nk; ++qt) {
    load_tile<T, D>(Qs, static_cast<const T*>(p.q), p, bh, qt * kTile, 1.f);
    load_tile<T, D>(dOs, static_cast<const T*>(p.dout), p, bh, qt * kTile,
                    1.f);
    if (threadIdx.x < kTile) {
      const long long r = static_cast<long long>(bh) * p.L + qt * kTile +
                          threadIdx.x;
      Lse[threadIdx.x] = p.lse[r];
      Dl[threadIdx.x] = p.delta[r];
    }
    __syncthreads();
    // transposed tiles: rows are this block's keys, columns the queries
    float st[4][4], dpt[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) st[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Ks[(4 * ty + i) * SD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Qs[(tx + 16 * j) * SD + d] * p.scale;
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) st[i][j] = fmaf(bv[j], a[i], st[i][j]);
    }
    tile_dot_nt<D>(Vs, dOs, ty, tx, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int kr = 4 * ty + i, col = kt * kTile + kr;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int qr = tx + 16 * j, row = qt * kTile + qr;
        float sv = st[i][j] + Km[kr];
        if (p.causal && col > row) sv = kNegInf;
        const float pr = expf(sv - Lse[qr]);
        float pd = pr;
        if (p.dropout)
          pd = keep_bit(mixed, row, col, p.thresh) ? pr / p.keep_div : 0.f;
        PdT[kr * kTP + qr] = pd;
        dST[kr * kTP + qr] = pd * dpt[i][j] - pr * Dl[qr];
      }
    }
    __syncthreads();
    tile_dot_nn<D>(PdT, dOs, ty, tx, 1.f, dv);
    tile_dot_nn<D>(dST, Qs, ty, tx, p.scale, dk);
    __syncthreads();
  }
  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
  const int h = bh % p.H;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = kt * kTile + 4 * ty + i;
    const long long g = ((static_cast<long long>(b) * p.L + row) * p.H + h) * D;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      dkp[g + tx + 16 * j] = from_float<T>(dk[i][j]);
      dvp[g + tx + 16 * j] = from_float<T>(dv[i][j]);
    }
  }
}

// ===================================================================
// 16-bit forward and dK/dV: warp-specialised wgmma kernels (sm90.cuh).
//
// A block is three warpgroups: two consumers (warpgroups 0 and 1, 64 rows
// of the block's 128-row tile each) and one producer (warpgroup 2, whose
// first thread issues every TMA load).  The producer fills a ring of
// kStages shared-memory stages, each guarded by a full barrier (one
// arrival with the stage's byte count, completed by TMA) and an empty
// barrier (256 arrivals, one per consumer thread, once the stage's last
// wgmma has read it).  setmaxnreg moves registers from the producer (40)
// to the consumers (232).  Scores live in wgmma accumulators; the softmax
// runs on them in registers, in the log2 domain (scale * log2(e) folded
// into one FMA with the key mask, ex2 on the special-function unit).
// ===================================================================

constexpr int kWgThreads = 384;      // 2 consumer warpgroups + 1 producer
constexpr int kStages = 2;           // the ring of K/V (or Q/dO) tiles
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kNegInf2 = kNegInf * kLog2e;   // the sentinel, log2 domain

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// The first 1024-byte boundary at or after `p`, a pointer into dynamic
// shared memory; arithmetic on `p` itself keeps the address space known,
// so accesses through the result compile to shared loads and stores.
__device__ __forceinline__ uint8_t* align1024(uint8_t* p) {
  return p + ((1024 - (sm90::smem_u32(p) & 1023)) & 1023);
}

// Byte `col` of swizzled row `row` of a tile of 128-byte rows (1024-byte
// aligned), for a 16-bit column pair (col even).
__device__ __forceinline__ int swz(int row, int col) {
  return row * 128 + ((((col >> 3) ^ row) & 7) << 4) + (col & 7) * 2;
}

template <int D>
struct FwdCfg {
  static constexpr int BM = 128;                    // queries a block
  static constexpr int BN = D == 64 ? 128 : 64;     // keys a tile
  static constexpr int Q_BYTES = BM * D * 2;
  static constexpr int KV_BYTES = BN * D * 2;       // a K or a V tile
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_KM = OFF_V + kStages * KV_BYTES;
  static constexpr int OFF_BAR = OFF_KM + kStages * BN * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * kStages + 1) + 1024;
};

// One block per (bh, 128-query tile), heaviest causal tiles first.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_fwd_wgmma(const __grid_constant__ CUtensorMap tmQ,
                const __grid_constant__ CUtensorMap tmK,
                const __grid_constant__ CUtensorMap tmV,
                const __grid_constant__ CUtensorMap tmO, Params p) {
  using C = FwdCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NB = D / 64;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* sm = align1024(smem_wg);
  uint8_t* Qs = sm;                                 // NB boxes of BM rows
  uint8_t* Ks = sm + C::OFF_K;                      // stages of NB boxes
  uint8_t* Vs = sm + C::OFF_V;
  float* Kms = reinterpret_cast<float*>(sm + C::OFF_KM);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const int nq = (p.L + BM - 1) / BM, qt = nq - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  // causal: key tiles past the tile's last row hold no key it attends
  const int last = p.causal ? min(q0 + BM - 1, p.L - 1) : p.L - 1;
  const int nkt = last / BN + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                                    // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_tx(qfull, C::Q_BYTES);
      for (int c = 0; c < NB; ++c)
        sm90::tma_load_4d(Qs + c * BM * 128, &tmQ, qfull, 64 * c, h, q0, b);
      for (int i = 0; i < nkt; ++i) {
        const int s = i % kStages, k0 = i * BN;
        if (i >= kStages) sm90::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const int kmb = min(BN, p.L - k0) * 4;      // the key mask, to L
        sm90::mbar_arrive_tx(&full[s], 2 * C::KV_BYTES + kmb);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_4d(Ks + s * C::KV_BYTES + c * BN * 128, &tmK,
                            &full[s], 64 * c, h, k0, b);
          sm90::tma_load_4d(Vs + s * C::KV_BYTES + c * BN * 128, &tmV,
                            &full[s], 64 * c, h, k0, b);
        }
        sm90::bulk_load(Kms + s * BN,
                        p.kmask + static_cast<long long>(b) * p.L + k0, kmb,
                        &full[s]);
      }
    }
  } else {                                          // consumers
    sm90::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
    const float sl2 = p.scale * kLog2e;
    const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
    float o[D / 2], m[2] = {kNegInf2, kNegInf2}, l[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < D / 2; ++j) o[j] = 0.f;
    const uint8_t* Qw = Qs + wg * 64 * 128;         // this warpgroup's rows
    // descriptors: a k16 step adds its byte offset / 16 to the start address
    const uint64_t dq0 = sm90::desc_b128(Qw, 16, 1024);

    sm90::mbar_wait(qfull, 0);
    for (int i = 0; i < nkt; ++i) {
      const int s = i % kStages, k0 = i * BN;
      sm90::mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* Kt = Ks + s * C::KV_BYTES;
      const uint8_t* Vt = Vs + s * C::KV_BYTES;
      const float* km = Kms + s * BN;

      float sc[BN / 2];                             // S = Q K^T
      const uint64_t dk0 = sm90::desc_b128(Kt, 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k)
        sm90::Wgmma<T, BN>::ss(
            sc, dq0 + (((k / 4) * BM * 128 + (k % 4) * 32) >> 4),
            dk0 + (((k / 4) * BN * 128 + (k % 4) * 32) >> 4), k > 0);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);

      // a tile that crosses the diagonal or the end of the keys
      const bool edge = (p.causal && k0 + BN - 1 > q0 + 64 * wg) ||
                        k0 + BN > p.L;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        sc[j] = fmaf(sc[j], sl2, km[8 * (j / 4) + 2 * tq + (j % 2)] * kLog2e);
      if (edge) {                         // one branch, outside the loops
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int c = k0 + 8 * (j / 4) + 2 * tq + (j % 2);
          if (p.causal && c > row0 + 8 * ((j / 2) % 2)) sc[j] = kNegInf2;
          if (c >= p.L) sc[j] = -INFINITY;          // no key: out entirely
        }
      }
      float mc[2] = {m[0], m[1]};
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        mc[(j / 2) % 2] = fmaxf(mc[(j / 2) % 2], sc[j]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 1));
        mc[r] = fmaxf(mc[r], __shfl_xor_sync(0xffffffffu, mc[r], 2));
        alpha[r] = ex2(m[r] - mc[r]);
        m[r] = mc[r];
        l[r] *= alpha[r];                           // this thread's share
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) {
        sc[j] = ex2(sc[j] - m[(j / 2) % 2]);
        l[(j / 2) % 2] += sc[j];
      }
      if (p.dropout) {                    // kept ones / (1 - p), after l
#pragma unroll
        for (int j = 0; j < BN / 2; ++j)
          sc[j] = keep_bit(mixed, row0 + 8 * ((j / 2) % 2),
                           k0 + 8 * (j / 4) + 2 * tq + (j % 2), p.thresh)
                      ? sc[j] / p.keep_div : 0.f;
      }
#pragma unroll
      for (int j = 0; j < D / 2; ++j) o[j] *= alpha[(j / 2) % 2];
      // P as the A fragments, all converted before the fence: a register
      // written between two wgmmas of one group serialises them
      uint32_t pa[BN / 16][4];
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) sm90::acc_to_a<T>(sc, kk, pa[kk]);

      const uint64_t dv0 = sm90::desc_b128(Vt, BN * 128, 1024);
      sm90::fence_regs(o);                          // O += P V
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<T, D>::rs(o, pa[kk], dv0 + kk * 16 * 128 / 16, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(o);
      sm90::mbar_arrive(&empty[s]);
    }

    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
      inv[r] = 1.f / l[r];
    }
    // O to this warpgroup's own rows of the Q tile (no longer read), in
    // TMA's swizzled layout, then one TMA store per box; rows past L clip
    uint8_t* Ow = Qs + wg * 64 * 128;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int r = (j / 2) % 2, lr = 16 * warp + g + 8 * r;
      const int col = 8 * (j / 4) + 2 * tq;
      *reinterpret_cast<uint32_t*>(Ow + (col / 64) * BM * 128 +
                                   swz(lr, col % 64)) =
          sm90::pack2<T>(o[j] * inv[r], o[j + 1] * inv[r]);
    }
    sm90::fence_async();
    sm90::named_sync(1 + wg, 128);
    if (t == 0 && q0 + 64 * wg < p.L) {
      for (int c = 0; c < NB; ++c)
        sm90::tma_store_4d(&tmO, Ow + c * BM * 128, 64 * c, h, q0 + 64 * wg,
                           b);
      sm90::tma_store_wait();
    }
    if (tq == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r)
        if (row0 + 8 * r < p.L)
          p.lse_out[static_cast<long long>(bh) * p.L + row0 + 8 * r] =
              m[r] / kLog2e + logf(l[r]);
    }
  }
}

template <int D>
struct BwdCfg {
  static constexpr int BK = 128;                    // keys a block
  static constexpr int BQ = D == 64 ? 64 : 32;      // queries a tile
  static constexpr int KV_BYTES = BK * D * 2;       // K or V
  static constexpr int QT_BYTES = BQ * D * 2;       // a Q or a dO tile
  static constexpr int OFF_V = KV_BYTES;
  static constexpr int OFF_Q = 2 * KV_BYTES;
  static constexpr int OFF_DO = OFF_Q + kStages * QT_BYTES;
  static constexpr int OFF_LSE = OFF_DO + kStages * QT_BYTES;
  static constexpr int OFF_DL = OFF_LSE + kStages * BQ * 4;
  static constexpr int OFF_BAR = OFF_DL + kStages * BQ * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * kStages + 1) + 1024;
};

// One block per (bh, 128-key tile): it owns dK and dV of its keys and walks
// the query tiles in order (from the diagonal under causal masking), so no
// atomics and run-to-run identical results.
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap tmQ,
                    const __grid_constant__ CUtensorMap tmK,
                    const __grid_constant__ CUtensorMap tmV,
                    const __grid_constant__ CUtensorMap tmdO,
                    const __grid_constant__ CUtensorMap tmdK,
                    const __grid_constant__ CUtensorMap tmdV, Params p) {
  using C = BwdCfg<D>;
  constexpr int BK = C::BK, BQ = C::BQ, NB = D / 64;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* sm = align1024(smem_wg);
  uint8_t* Ks = sm;                                 // NB boxes of BK rows
  uint8_t* Vs = sm + C::OFF_V;
  uint8_t* Qs = sm + C::OFF_Q;                      // stages of NB boxes
  uint8_t* dOs = sm + C::OFF_DO;
  float* Lses = reinterpret_cast<float*>(sm + C::OFF_LSE);
  float* Dls = reinterpret_cast<float*>(sm + C::OFF_DL);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* kvfull = empty + kStages;

  const int k0 = blockIdx.x * BK;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  const int qt0 = p.causal ? k0 / BQ : 0;           // the diagonal tile
  const int nqt = p.L / BQ - qt0;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init(kvfull, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                                    // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_tx(kvfull, 2 * C::KV_BYTES);
      for (int c = 0; c < NB; ++c) {
        sm90::tma_load_4d(Ks + c * BK * 128, &tmK, kvfull, 64 * c, h, k0, b);
        sm90::tma_load_4d(Vs + c * BK * 128, &tmV, kvfull, 64 * c, h, k0, b);
      }
      for (int i = 0; i < nqt; ++i) {
        const int s = i % kStages, q0 = (qt0 + i) * BQ;
        if (i >= kStages) sm90::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        sm90::mbar_arrive_tx(&full[s], 2 * C::QT_BYTES + 2 * BQ * 4);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_4d(Qs + s * C::QT_BYTES + c * BQ * 128, &tmQ,
                            &full[s], 64 * c, h, q0, b);
          sm90::tma_load_4d(dOs + s * C::QT_BYTES + c * BQ * 128, &tmdO,
                            &full[s], 64 * c, h, q0, b);
        }
        const long long r = static_cast<long long>(bh) * p.L + q0;
        sm90::bulk_load(Lses + s * BQ, p.lse + r, BQ * 4, &full[s]);
        sm90::bulk_load(Dls + s * BQ, p.delta + r, BQ * 4, &full[s]);
      }
    }
  } else {                                          // consumers
    sm90::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;
    const int key0 = k0 + 64 * wg + 16 * warp + g;  // and key0 + 8
    const float sl2 = p.scale * kLog2e;
    const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
    float km2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int key = key0 + 8 * r;
      km2[r] = key < p.L
                   ? p.kmask[static_cast<long long>(b) * p.L + key] * kLog2e
                   : 0.f;
    }
    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dk[j] = dv[j] = 0.f;
    // this warpgroup's keys; a k16 step adds its byte offset / 16
    const uint64_t dk0 = sm90::desc_b128(Ks + wg * 64 * 128, 16, 1024);
    const uint64_t dv0 = sm90::desc_b128(Vs + wg * 64 * 128, 16, 1024);

    sm90::mbar_wait(kvfull, 0);
    for (int i = 0; i < nqt; ++i) {
      const int s = i % kStages, q0 = (qt0 + i) * BQ;
      sm90::mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* Qt = Qs + s * C::QT_BYTES;
      const uint8_t* dOt = dOs + s * C::QT_BYTES;
      const float* lse = Lses + s * BQ;
      const float* dl = Dls + s * BQ;

      float st[BQ / 2], dpt[BQ / 2];      // S^T = K Q^T, dP^T = V dO^T
      const uint64_t dq0 = sm90::desc_b128(Qt, 16, 1024);
      const uint64_t ddo0 = sm90::desc_b128(dOt, 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int ka = ((k / 4) * BK * 128 + (k % 4) * 32) >> 4;
        const int kb = ((k / 4) * BQ * 128 + (k % 4) * 32) >> 4;
        sm90::Wgmma<T, BQ>::ss(st, dk0 + ka, dq0 + kb, k > 0);
        sm90::Wgmma<T, BQ>::ss(dpt, dv0 + ka, ddo0 + kb, k > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(st);
      sm90::fence_regs(dpt);

#pragma unroll
      for (int j = 0; j < BQ / 2; ++j) {
        const int qc = 8 * (j / 4) + 2 * tq + (j % 2), r = (j / 2) % 2;
        float v = fmaf(st[j], sl2, km2[r]);
        if (p.causal && key0 + 8 * r > q0 + qc) v = kNegInf2;
        st[j] = ex2(v - lse[qc] * kLog2e);
      }
      if (p.dropout) {                  // one branch, outside the loops
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qc = 8 * (j / 4) + 2 * tq + (j % 2);
          const float pd = keep_bit(mixed, q0 + qc, key0 + 8 * ((j / 2) % 2),
                                    p.thresh) ? st[j] / p.keep_div : 0.f;
          dpt[j] = pd * dpt[j] - st[j] * dl[qc];
          st[j] = pd;
        }
      } else {
#pragma unroll
        for (int j = 0; j < BQ / 2; ++j) {
          const int qc = 8 * (j / 4) + 2 * tq + (j % 2);
          dpt[j] = st[j] * dpt[j] - st[j] * dl[qc];
        }
      }

      uint32_t pa[BQ / 16][4], sa[BQ / 16][4];      // before the fence
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::acc_to_a<T>(st, kk, pa[kk]);
        sm90::acc_to_a<T>(dpt, kk, sa[kk]);
      }
      // dO and Q again, MN-major: the leading byte offset is a box
      const uint64_t ddoT = sm90::desc_b128(dOt, BQ * 128, 1024);
      const uint64_t dqT = sm90::desc_b128(Qt, BQ * 128, 1024);
      sm90::fence_regs(dv);                         // dV += P^T dO
      sm90::fence_regs(dk);                         // dK += dS^T Q
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BQ / 16; ++kk) {
        sm90::Wgmma<T, D>::rs(dv, pa[kk], ddoT + kk * 16 * 128 / 16, 1);
        sm90::Wgmma<T, D>::rs(dk, sa[kk], dqT + kk * 16 * 128 / 16, 1);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dv);
      sm90::fence_regs(dk);
      sm90::mbar_arrive(&empty[s]);
    }

    // dK and dV to this warpgroup's own K and V rows (no longer read), in
    // TMA's swizzled layout, then TMA stores; keys past L clip
    uint8_t* dKw = Ks + wg * 64 * 128;
    uint8_t* dVw = Vs + wg * 64 * 128;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int lr = 16 * warp + g + 8 * ((j / 2) % 2);
      const int col = 8 * (j / 4) + 2 * tq;
      const int off = (col / 64) * BK * 128 + swz(lr, col % 64);
      *reinterpret_cast<uint32_t*>(dKw + off) =
          sm90::pack2<T>(dk[j] * p.scale, dk[j + 1] * p.scale);
      *reinterpret_cast<uint32_t*>(dVw + off) =
          sm90::pack2<T>(dv[j], dv[j + 1]);
    }
    sm90::fence_async();
    sm90::named_sync(1 + wg, 128);
    if (t == 0 && k0 + 64 * wg < p.L) {
      for (int c = 0; c < NB; ++c) {
        sm90::tma_store_4d(&tmdK, dKw + c * BK * 128, 64 * c, h,
                           k0 + 64 * wg, b);
        sm90::tma_store_4d(&tmdV, dVw + c * BK * 128, 64 * c, h,
                           k0 + 64 * wg, b);
      }
      sm90::tma_store_wait();
    }
  }
}

template <int D>
struct DqCfg {
  static constexpr int BM = 128;                    // queries a block
  static constexpr int BN = D == 64 ? 128 : 64;     // keys a tile
  static constexpr int Q_BYTES = BM * D * 2;        // Q or dO
  static constexpr int KV_BYTES = BN * D * 2;       // a K or a V tile
  static constexpr int OFF_DO = Q_BYTES;
  static constexpr int OFF_K = 2 * Q_BYTES;
  static constexpr int OFF_V = OFF_K + kStages * KV_BYTES;
  static constexpr int OFF_KM = OFF_V + kStages * KV_BYTES;
  static constexpr int OFF_BAR = OFF_KM + kStages * BN * 4;
  static constexpr int BYTES = OFF_BAR + 8 * (2 * kStages + 1) + 1024;
};

// One block per (bh, 128-query tile), heaviest causal tiles first: Q and
// dO stay resident, K, V and the key mask stream through the ring; it owns
// dQ of its rows and walks the key tiles in order (no atomics).
template <typename T, int D>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmQ,
                   const __grid_constant__ CUtensorMap tmK,
                   const __grid_constant__ CUtensorMap tmV,
                   const __grid_constant__ CUtensorMap tmdO,
                   const __grid_constant__ CUtensorMap tmdQ, Params p) {
  using C = DqCfg<D>;
  constexpr int BM = C::BM, BN = C::BN, NB = D / 64;
  extern __shared__ uint8_t smem_wg[];
  uint8_t* sm = align1024(smem_wg);
  uint8_t* Qs = sm;                                 // NB boxes of BM rows
  uint8_t* dOs = sm + C::OFF_DO;
  uint8_t* Ks = sm + C::OFF_K;                      // stages of NB boxes
  uint8_t* Vs = sm + C::OFF_V;
  float* Kms = reinterpret_cast<float*>(sm + C::OFF_KM);
  uint64_t* full = reinterpret_cast<uint64_t*>(sm + C::OFF_BAR);
  uint64_t* empty = full + kStages;
  uint64_t* qfull = empty + kStages;

  const int nq = (p.L + BM - 1) / BM, qt = nq - 1 - blockIdx.x;
  const int q0 = qt * BM;
  const int bh = blockIdx.y, b = bh / p.H, h = bh % p.H;
  // causal: key tiles past the tile's last row hold no key it attends
  const int last = p.causal ? min(q0 + BM - 1, p.L - 1) : p.L - 1;
  const int nkt = last / BN + 1;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      sm90::mbar_init(&full[s], 1);
      sm90::mbar_init(&empty[s], 256);
    }
    sm90::mbar_init(qfull, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 2) {                                    // producer
    sm90::setmaxnreg_dec<40>();
    if (threadIdx.x == 256) {
      sm90::mbar_arrive_tx(qfull, 2 * C::Q_BYTES);
      for (int c = 0; c < NB; ++c) {
        sm90::tma_load_4d(Qs + c * BM * 128, &tmQ, qfull, 64 * c, h, q0, b);
        sm90::tma_load_4d(dOs + c * BM * 128, &tmdO, qfull, 64 * c, h, q0,
                          b);
      }
      for (int i = 0; i < nkt; ++i) {
        const int s = i % kStages, k0 = i * BN;
        if (i >= kStages) sm90::mbar_wait(&empty[s], (i / kStages - 1) & 1);
        const int kmb = min(BN, p.L - k0) * 4;      // the key mask, to L
        sm90::mbar_arrive_tx(&full[s], 2 * C::KV_BYTES + kmb);
        for (int c = 0; c < NB; ++c) {
          sm90::tma_load_4d(Ks + s * C::KV_BYTES + c * BN * 128, &tmK,
                            &full[s], 64 * c, h, k0, b);
          sm90::tma_load_4d(Vs + s * C::KV_BYTES + c * BN * 128, &tmV,
                            &full[s], 64 * c, h, k0, b);
        }
        sm90::bulk_load(Kms + s * BN,
                        p.kmask + static_cast<long long>(b) * p.L + k0, kmb,
                        &full[s]);
      }
    }
  } else {                                          // consumers
    sm90::setmaxnreg_inc<232>();
    const int t = threadIdx.x % 128, warp = t / 32, lane = t % 32;
    const int g = lane / 4, tq = lane % 4;
    const int row0 = q0 + 64 * wg + 16 * warp + g;  // and row0 + 8
    const float sl2 = p.scale * kLog2e;
    const uint32_t mixed = p.seed + static_cast<uint32_t>(bh) * 0xC2B2AE3Du;
    float lse2[2], dl[2];                           // rows past L: unused
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const long long i = static_cast<long long>(bh) * p.L + row0 + 8 * r;
      const bool in = row0 + 8 * r < p.L;
      lse2[r] = in ? p.lse[i] * kLog2e : 0.f;
      dl[r] = in ? p.delta[i] : 0.f;
    }
    float dq[D / 2];
#pragma unroll
    for (int j = 0; j < D / 2; ++j) dq[j] = 0.f;
    // this warpgroup's rows of Q and dO; a k16 step adds its byte offset / 16
    const uint64_t dq0 = sm90::desc_b128(Qs + wg * 64 * 128, 16, 1024);
    const uint64_t ddo0 = sm90::desc_b128(dOs + wg * 64 * 128, 16, 1024);

    sm90::mbar_wait(qfull, 0);
    for (int i = 0; i < nkt; ++i) {
      const int s = i % kStages, k0 = i * BN;
      sm90::mbar_wait(&full[s], (i / kStages) & 1);
      const uint8_t* Kt = Ks + s * C::KV_BYTES;
      const uint8_t* Vt = Vs + s * C::KV_BYTES;
      const float* km = Kms + s * BN;

      float sc[BN / 2], dp[BN / 2];                 // S = Q K^T, dP = dO V^T
      const uint64_t dk0 = sm90::desc_b128(Kt, 16, 1024);
      const uint64_t dv0 = sm90::desc_b128(Vt, 16, 1024);
      sm90::wgmma_fence();
#pragma unroll
      for (int k = 0; k < D / 16; ++k) {
        const int ka = ((k / 4) * BM * 128 + (k % 4) * 32) >> 4;
        const int kb = ((k / 4) * BN * 128 + (k % 4) * 32) >> 4;
        sm90::Wgmma<T, BN>::ss(sc, dq0 + ka, dk0 + kb, k > 0);
        sm90::Wgmma<T, BN>::ss(dp, ddo0 + ka, dv0 + kb, k > 0);
      }
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(sc);
      sm90::fence_regs(dp);

      // P = exp(S scale + mask - lse) in the log2 domain
      const bool edge = (p.causal && k0 + BN - 1 > q0 + 64 * wg) ||
                        k0 + BN > p.L;
#pragma unroll
      for (int j = 0; j < BN / 2; ++j)
        sc[j] = fmaf(sc[j], sl2, km[8 * (j / 4) + 2 * tq + (j % 2)] * kLog2e);
      if (edge) {                         // one branch, outside the loops
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int c = k0 + 8 * (j / 4) + 2 * tq + (j % 2);
          if (p.causal && c > row0 + 8 * ((j / 2) % 2)) sc[j] = kNegInf2;
          if (c >= p.L) sc[j] = -INFINITY;          // no key: out entirely
        }
      }
#pragma unroll
      for (int j = 0; j < BN / 2; ++j) sc[j] = ex2(sc[j] - lse2[(j / 2) % 2]);
      // dS = Pd dP - P delta, Pd the kept probabilities / (1 - p)
      if (p.dropout) {                    // one branch, outside the loops
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) {
          const int r = (j / 2) % 2;
          const float pd = keep_bit(mixed, row0 + 8 * r,
                                    k0 + 8 * (j / 4) + 2 * tq + (j % 2),
                                    p.thresh) ? sc[j] / p.keep_div : 0.f;
          dp[j] = pd * dp[j] - sc[j] * dl[r];
        }
      } else {
#pragma unroll
        for (int j = 0; j < BN / 2; ++j)
          dp[j] = sc[j] * (dp[j] - dl[(j / 2) % 2]);
      }

      uint32_t sa[BN / 16][4];                      // dS, before the fence
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk) sm90::acc_to_a<T>(dp, kk, sa[kk]);
      // K again, MN-major in place: the leading byte offset is a box
      const uint64_t dkT = sm90::desc_b128(Kt, BN * 128, 1024);
      sm90::fence_regs(dq);                         // dQ += dS K
      sm90::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BN / 16; ++kk)
        sm90::Wgmma<T, D>::rs(dq, sa[kk], dkT + kk * 16 * 128 / 16, 1);
      sm90::wgmma_commit();
      sm90::wgmma_wait<0>();
      sm90::fence_regs(dq);
      sm90::mbar_arrive(&empty[s]);
    }

    // scale dQ into this warpgroup's own Q rows (no longer read), in TMA's
    // swizzled layout, then one TMA store per box; rows past L clip
    uint8_t* dQw = Qs + wg * 64 * 128;
#pragma unroll
    for (int j = 0; j < D / 2; j += 2) {
      const int lr = 16 * warp + g + 8 * ((j / 2) % 2);
      const int col = 8 * (j / 4) + 2 * tq;
      *reinterpret_cast<uint32_t*>(dQw + (col / 64) * BM * 128 +
                                   swz(lr, col % 64)) =
          sm90::pack2<T>(dq[j] * p.scale, dq[j + 1] * p.scale);
    }
    sm90::fence_async();
    sm90::named_sync(1 + wg, 128);
    if (t == 0 && q0 + 64 * wg < p.L) {
      for (int c = 0; c < NB; ++c)
        sm90::tma_store_4d(&tmdQ, dQw + c * BM * 128, 64 * c, h,
                           q0 + 64 * wg, b);
      sm90::tma_store_wait();
    }
  }
}

// shared bytes of the fp32 kernels (padded D-wide tiles, 64x64 tiles,
// rows)
template <int D>
constexpr int fwd_bytes() {
  return 4 * (3 * kTile * (D + 1) + kTile * kTP + kTile);
}
template <int D>
constexpr int dq_bytes() {
  return 4 * (4 * kTile * (D + 1) + kTile * kTP + 3 * kTile);
}
template <int D>
constexpr int dkv_bytes() {
  return 4 * (4 * kTile * (D + 1) + 2 * kTile * kTP + 3 * kTile);
}
template <typename Kern>
int launch(Kern kernel, int bytes, int threads, const Params& p,
           cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(p.L / kTile, p.B * p.H);
  kernel<<<grid, threads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The 16-bit kernels: tensor maps of the (B, L, H, D) operands
// built here, on the host, and passed by value as __grid_constant__.
template <typename Kern, typename... Args>
int launch_wg(Kern kernel, int bytes, dim3 grid, cudaStream_t stream,
              const Args&... args) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  kernel<<<grid, kWgThreads, bytes, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int D>
int launch_fwd_wgmma(const Params& p, cudaStream_t stream) {
  using C = FwdCfg<D>;
  CUtensorMap tq, tk, tv, to;
  int e;
  if ((e = sm90::blhd_map<T>(&tq, p.q, p.B, p.L, p.H, D, C::BM)) ||
      (e = sm90::blhd_map<T>(&tk, p.k, p.B, p.L, p.H, D, C::BN)) ||
      (e = sm90::blhd_map<T>(&tv, p.v, p.B, p.L, p.H, D, C::BN)) ||
      (e = sm90::blhd_map<T>(&to, p.out, p.B, p.L, p.H, D, 64)))
    return e;
  return launch_wg(flash_fwd_wgmma<T, D>, C::BYTES,
                   dim3((p.L + C::BM - 1) / C::BM, p.B * p.H), stream, tq, tk,
                   tv, to, p);
}

template <typename T, int D>
int launch_dkv_wgmma(const Params& p, cudaStream_t stream) {
  using C = BwdCfg<D>;
  CUtensorMap tq, tk, tv, tdo, tdk, tdv;
  int e;
  if ((e = sm90::blhd_map<T>(&tq, p.q, p.B, p.L, p.H, D, C::BQ)) ||
      (e = sm90::blhd_map<T>(&tk, p.k, p.B, p.L, p.H, D, C::BK)) ||
      (e = sm90::blhd_map<T>(&tv, p.v, p.B, p.L, p.H, D, C::BK)) ||
      (e = sm90::blhd_map<T>(&tdo, p.dout, p.B, p.L, p.H, D, C::BQ)) ||
      (e = sm90::blhd_map<T>(&tdk, p.dk, p.B, p.L, p.H, D, 64)) ||
      (e = sm90::blhd_map<T>(&tdv, p.dv, p.B, p.L, p.H, D, 64)))
    return e;
  return launch_wg(flash_bwd_dkv_wgmma<T, D>, C::BYTES,
                   dim3((p.L + C::BK - 1) / C::BK, p.B * p.H), stream, tq, tk,
                   tv, tdo, tdk, tdv, p);
}

template <typename T, int D>
int launch_dq_wgmma(const Params& p, cudaStream_t stream) {
  using C = DqCfg<D>;
  CUtensorMap tq, tk, tv, tdo, tdq;
  int e;
  if ((e = sm90::blhd_map<T>(&tq, p.q, p.B, p.L, p.H, D, C::BM)) ||
      (e = sm90::blhd_map<T>(&tk, p.k, p.B, p.L, p.H, D, C::BN)) ||
      (e = sm90::blhd_map<T>(&tv, p.v, p.B, p.L, p.H, D, C::BN)) ||
      (e = sm90::blhd_map<T>(&tdo, p.dout, p.B, p.L, p.H, D, C::BM)) ||
      (e = sm90::blhd_map<T>(&tdq, p.dq, p.B, p.L, p.H, D, 64)))
    return e;
  return launch_wg(flash_bwd_dq_wgmma<T, D>, C::BYTES,
                   dim3((p.L + C::BM - 1) / C::BM, p.B * p.H), stream, tq, tk,
                   tv, tdo, tdq, p);
}

template <typename T, int D>
int run_d(int which, const Params& p, cudaStream_t s) {
  if constexpr (std::is_same<T, float>::value) {
    if (which == 0)
      return launch(flash_fwd_kernel<T, D>, fwd_bytes<D>(), kThreads, p, s);
    if (which == 1)
      return launch(flash_bwd_dq_kernel<T, D>, dq_bytes<D>(), kThreads, p, s);
    return launch(flash_bwd_dkv_kernel<T, D>, dkv_bytes<D>(), kThreads, p, s);
  } else {
    if (which == 0) return launch_fwd_wgmma<T, D>(p, s);
    if (which == 1) return launch_dq_wgmma<T, D>(p, s);
    return launch_dkv_wgmma<T, D>(p, s);
  }
}

template <typename T>
int run(int which, int hd, const Params& p, cudaStream_t s) {
  if (hd == 64) return run_d<T, 64>(which, p, s);
  if (hd == 128) return run_d<T, 128>(which, p, s);
  return -1;
}

int dispatch(int which, int dtype, int hd, const Params& p, void* stream) {
  if (p.L % kTile != 0 || p.L <= 0 || p.B * p.H <= 0 || p.B * p.H > 65535)
    return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run<float>(which, hd, p, s);
    case 1: return run<__half>(which, hd, p, s);
    case 2: return run<__nv_bfloat16>(which, hd, p, s);
    default: return -1;
  }
}

Params make_params(const void* q, const void* k, const void* v,
                   const float* kmask, int B, int L, int H, float scale,
                   int causal, int dropout, uint32_t seed, uint32_t thresh,
                   float keep_div) {
  Params p{};
  p.q = q;
  p.k = k;
  p.v = v;
  p.kmask = kmask;
  p.B = B;
  p.L = L;
  p.H = H;
  p.scale = scale;
  p.causal = causal;
  p.dropout = dropout;
  p.seed = seed;
  p.thresh = thresh;
  p.keep_div = keep_div;
  return p;
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16; hd 64 or 128; L a multiple of
// 64.  q, k, v, out, dout, dq, dk, dv are contiguous (B, L, H, hd) in
// dtype; kmask (B, L), lse and delta (B*H, L) are contiguous fp32.  Each
// returns the launch's cudaGetLastError() (or the shared-memory attribute
// call's error), or -1 for an unsupported combination.
extern "C" int flash_fwd(int dtype, int hd, const void* q, const void* k,
                         const void* v, const float* kmask, void* out,
                         float* lse, int B, int L, int H, float scale,
                         int causal, int dropout, uint32_t seed,
                         uint32_t thresh, float keep_div, void* stream) {
  Params p = make_params(q, k, v, kmask, B, L, H, scale, causal, dropout,
                         seed, thresh, keep_div);
  p.out = out;
  p.lse_out = lse;
  return dispatch(0, dtype, hd, p, stream);
}

extern "C" int flash_bwd_dq(int dtype, int hd, const void* q, const void* k,
                            const void* v, const float* kmask,
                            const void* dout, const float* lse,
                            const float* delta, void* dq, int B, int L, int H,
                            float scale, int causal, int dropout,
                            uint32_t seed, uint32_t thresh, float keep_div,
                            void* stream) {
  Params p = make_params(q, k, v, kmask, B, L, H, scale, causal, dropout,
                         seed, thresh, keep_div);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dq = dq;
  return dispatch(1, dtype, hd, p, stream);
}

extern "C" int flash_bwd_dkv(int dtype, int hd, const void* q, const void* k,
                             const void* v, const float* kmask,
                             const void* dout, const float* lse,
                             const float* delta, void* dk, void* dv, int B,
                             int L, int H, float scale, int causal,
                             int dropout, uint32_t seed, uint32_t thresh,
                             float keep_div, void* stream) {
  Params p = make_params(q, k, v, kmask, B, L, H, scale, causal, dropout,
                         seed, thresh, keep_div);
  p.dout = dout;
  p.lse = lse;
  p.delta = delta;
  p.dk = dk;
  p.dv = dv;
  return dispatch(2, dtype, hd, p, stream);
}

// Dynamic shared memory a 16-bit kernel takes at head dim hd (64 or 128):
// which 0 forward, 1 dQ, 2 dK/dV; -1 otherwise.
extern "C" int flash_smem_bytes(int which, int hd) {
  if (hd != 64 && hd != 128) return -1;
  const bool d64 = hd == 64;
  switch (which) {
    case 0: return d64 ? FwdCfg<64>::BYTES : FwdCfg<128>::BYTES;
    case 1: return d64 ? DqCfg<64>::BYTES : DqCfg<128>::BYTES;
    case 2: return d64 ? BwdCfg<64>::BYTES : BwdCfg<128>::BYTES;
    default: return -1;
  }
}

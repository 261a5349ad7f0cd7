// Fused LayerNorm epilogue (forward and backward) and a flat AdamW sweep
// for Hopper (sm_90a).
//
// Replaces the three Pallas kernels of paddle_tpu/ops/fused.py:
//   fused_ln_fwd      <- _ln_fwd_kernel   rout = residual + dropout(x + bias),
//                                         out = LN(rout) * w + b; mu, rstd
//   fused_ln_bwd      <- _ln_bwd_kernel   dres, dx through the same mask, and
//                                         per-block column partials of dw, db
//                                         and dbias (summed by the caller)
//   fused_adamw_flat  <- _adamw_kernel    one AdamW sweep over a flat buffer
// x, residual, out, rout, dout, drout, dx, dres are (N, H) in one dtype
// (fp32, fp16 or bf16); w, b, bias are fp32 (H,); mu and rstd fp32 (N,).
//
// Numerics follow the Pallas kernels: everything in fp32, the variance as
// E[y^2] - mu^2 with no clamp, kept elements divided by float32(1 - p), the
// backward's xhat rebuilt from the saved rout (in its own dtype) and the
// saved mu, rstd.  The dropout mask is position_hash.cuh's keep_bit over
// the global row id and the feature id, mixed with seed * 0xC2B2AE3D, so it
// does not depend on how rows are blocked here.
//
// What bounds them on this card: all three move bytes and do a few flops a
// byte.  At BERT-base's epilogue (N 8192, H 768, bf16) the forward moves
// ~50 MB and the backward ~63 MB: 15-19 us at 3.35 TB/s; AdamW over
// BERT-base's 110M fp32 parameters moves 3.1 GB: 0.92 ms.  What the design
// does about it:
//   - one warp per row, 16-byte loads and stores where H allows (H a
//     multiple of 16 bytes' worth of elements, every pointer aligned),
//     scalar otherwise, so any H runs;
//   - the forward keeps its fp32 row y in shared memory (a layout private
//     to each lane: no bank conflicts, no barriers) so the normalisation
//     reads no second copy from device memory;
//   - the backward runs a persistent grid (one block of up to 16 warps a
//     streaming multiprocessor) whose warps walk rows grid-stride.  On the
//     16-byte path each lane stages its own chunks of the next row's dout,
//     rout and drout in a two-row shared-memory ring with cp.async while
//     the current row reduces, so no row waits for its loads after the
//     first and pass 2 re-reads shared memory, not device memory.  A lane
//     keeps the dw, db and dbias sums of the columns it owns in registers
//     (up to 32 columns a lane: H <= 1024; wider rows keep them in shared
//     memory); a block adds its warps in a fixed tree and writes one fp32
//     partial row of each, ~132 rows that one PyTorch sum adds in a fixed
//     order: no atomics, so runs are bit-reproducible.  On an NVIDIA H100
//     80GB HBM3 at 700.00 W, cold L2, BERT's shape takes 0.0346 ms and
//     0.0405 ms with the sum (bound 0.0188); before the redesign (512
//     blocks of 4 warps, 4 rows a warp one after another, sums in shared
//     memory) 0.0411 and 0.0527 ms.  A third ring stage, 8-warp blocks or
//     more blocks moved nothing or lost; the warps' tree costs ~2 us;
//   - AdamW is one grid-stride pass, 8 elements a thread-iteration with
//     16-byte loads, and a scalar tail; it needs no padding.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

#include "position_hash.cuh"   // keep_bit

namespace {

constexpr int kWarp = 32;
constexpr int kFwdWarps = 4;             // rows a forward block, one a warp
constexpr int kBwdStages = 2;            // rows a warp has staged: now, next
constexpr int kBwdSmemBudget = 200 * 1024;   // a backward block's target
constexpr int kAdamThreads = 256;
constexpr int kAdamVec = 8;              // elements a thread-iteration
constexpr int kMaxSmem = 227 * 1024;

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

// VEC consecutive elements at src as floats: 16-byte loads when they span
// whole 16-byte words (the caller guarantees the alignment), else scalar.
template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&dst)[VEC],
                                         const T* __restrict__ src) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      const uint4 raw = reinterpret_cast<const uint4*>(src)[k];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) dst[k * kPer + i] = to_float(e[i]);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = to_float(src[i]);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_vec(T* __restrict__ dst,
                                          const float (&src)[VEC]) {
  constexpr int kBytes = VEC * static_cast<int>(sizeof(T));
  if constexpr (kBytes % 16 == 0) {
    constexpr int kPer = 16 / static_cast<int>(sizeof(T));
#pragma unroll
    for (int k = 0; k < kBytes / 16; ++k) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int i = 0; i < kPer; ++i) e[i] = from_float<T>(src[k * kPer + i]);
      reinterpret_cast<uint4*>(dst)[k] = raw;
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) dst[i] = from_float<T>(src[i]);
  }
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

struct LnArgs {
  const void *x, *res, *dout, *drout, *rout_in;
  const float *w, *b, *bias, *mu_in, *rstd_in;
  void *out, *rout, *dx, *dres;
  float *mu, *rstd;
  float* part;         // backward: (blocks, 3, H) partials of dw, db, dbias
  int N, H;
  int Hp;              // H rounded up to whole warp-wide chunks
  float eps;
  int dropout;
  uint32_t mixed, thresh;
  float keep_div;      // float32(1 - p), the divisor of kept elements
};

// A lane's chunks of a row: columns c = lane * VEC + k * 32 * VEC + i.  Its
// shared-memory slot for (k, i) is (k * VEC + i) * 32 + lane, private to
// the lane and conflict-free across the warp.
__device__ __forceinline__ int slot(int k, int i, int lane, int vec) {
  return (k * vec + i) * kWarp + lane;
}

// ----------------------------------------------------------- LN forward --

template <typename T, int VEC>
__global__ void __launch_bounds__(kFwdWarps * kWarp)
ln_fwd_kernel(LnArgs a) {
  extern __shared__ float ybuf[];          // kFwdWarps rows of Hp floats
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int row = blockIdx.x * kFwdWarps + warp;
  if (row >= a.N) return;                  // no barrier below
  float* y = ybuf + static_cast<size_t>(warp) * a.Hp;
  const size_t base = static_cast<size_t>(row) * a.H;
  const T* x = static_cast<const T*>(a.x) + base;
  const T* res = static_cast<const T*>(a.res) + base;
  T* rout = static_cast<T*>(a.rout) + base;
  T* out = static_cast<T*>(a.out) + base;

  float s = 0.f, ss = 0.f;
  for (int k = 0, c = lane * VEC; c < a.H; ++k, c += kWarp * VEC) {
    float xv[VEC], rv[VEC];
    load_vec<T, VEC>(xv, x + c);
    load_vec<T, VEC>(rv, res + c);
    if (a.bias != nullptr) {
      float bv[VEC];
      load_vec<float, VEC>(bv, a.bias + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) xv[i] += bv[i];
    }
    if (a.dropout) {
#pragma unroll
      for (int i = 0; i < VEC; ++i)
        xv[i] = keep_bit(a.mixed, static_cast<uint32_t>(row),
                         static_cast<uint32_t>(c + i), a.thresh)
                    ? xv[i] / a.keep_div : 0.f;
    }
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      rv[i] += xv[i];                      // y = residual + x
      y[slot(k, i, lane, VEC)] = rv[i];
      s += rv[i];
      ss += rv[i] * rv[i];
    }
    store_vec<T, VEC>(rout + c, rv);
  }
  s = warp_sum(s);
  ss = warp_sum(ss);
  const float mean = s / a.H;
  const float var = ss / a.H - mean * mean;
  const float rs = rsqrtf(var + a.eps);
  for (int k = 0, c = lane * VEC; c < a.H; ++k, c += kWarp * VEC) {
    float wv[VEC], bv[VEC], o[VEC];
    load_vec<float, VEC>(wv, a.w + c);
    load_vec<float, VEC>(bv, a.b + c);
#pragma unroll
    for (int i = 0; i < VEC; ++i)
      o[i] = (y[slot(k, i, lane, VEC)] - mean) * rs * wv[i] + bv[i];
    store_vec<T, VEC>(out + c, o);
  }
  if (lane == 0) {
    a.mu[row] = mean;
    a.rstd[row] = rs;
  }
}

// ---------------------------------------------------------- LN backward --

// A lane's column sums of dw, db and dbias (t = 0, 1, 2) for its chunks
// k < NCH of VEC columns: registers, every loop over them unrolled.
template <int NCH, int VEC>
struct RegSums {
  float v[3][NCH * VEC];
  __device__ __forceinline__ float& at(int t, int k, int i) {
    return v[t][k * VEC + i];
  }
};

// The same sums for rows too wide for registers: the warp's own slots in
// shared memory, [3][warps][Hp] in slot() order.
struct SmemSums {
  float* warp_base;
  size_t plane;
  int lane, vec;
  __device__ __forceinline__ float& at(int t, int k, int i) {
    return warp_base[t * plane + slot(k, i, lane, vec)];
  }
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               ::"r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
                 "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int PENDING>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(PENDING) : "memory");
}

// One row's two passes for one lane.  d, y and dr point at the row's
// dout, rout and drout (dr null: no rout cotangent), in shared memory
// (staged) or device memory; ws is w in shared memory as fp32.
template <typename T, int VEC, int NCH, typename Sums>
__device__ __forceinline__ void ln_bwd_row(const LnArgs& a, int row, int nch,
                                           int lane, const T* d, const T* y,
                                           const T* dr, const float* ws,
                                           float mean, float rs, Sums& sums) {
  const int nk = NCH > 0 ? NCH : nch;
  float sg = 0.f, sgx = 0.f;               // row sums of g and g * xhat
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const int c = k * kWarp * VEC + lane * VEC;
    if (c < a.H) {
      float dv[VEC], yv[VEC], wv[VEC];
      load_vec<T, VEC>(dv, d + c);
      load_vec<T, VEC>(yv, y + c);
      load_vec<float, VEC>(wv, ws + c);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float g = dv[i] * wv[i];
        const float xhat = (yv[i] - mean) * rs;
        sg += g;
        sgx += g * xhat;
      }
    }
  }
  const float gm = warp_sum(sg) / a.H;
  const float gxm = warp_sum(sgx) / a.H;
  const size_t base = static_cast<size_t>(row) * a.H;
  T* dx = static_cast<T*>(a.dx) + base;
  T* dres = static_cast<T*>(a.dres) + base;
#pragma unroll
  for (int k = 0; k < nk; ++k) {
    const int c = k * kWarp * VEC + lane * VEC;
    if (c < a.H) {
      // one array holds drout, then dres, then dx: fewer live registers
      // beside the sums
      float dv[VEC], yv[VEC], wv[VEC], o[VEC];
      load_vec<T, VEC>(dv, d + c);
      load_vec<T, VEC>(yv, y + c);
      load_vec<float, VEC>(wv, ws + c);
      if (dr != nullptr) {
        load_vec<T, VEC>(o, dr + c);
      } else {
#pragma unroll
        for (int i = 0; i < VEC; ++i) o[i] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        const float g = dv[i] * wv[i];
        const float xhat = (yv[i] - mean) * rs;
        o[i] = (g - gm - xhat * gxm) * rs + o[i];
        sums.at(0, k, i) += dv[i] * xhat;
        sums.at(1, k, i) += dv[i];
      }
      store_vec<T, VEC>(dres + c, o);
#pragma unroll
      for (int i = 0; i < VEC; ++i) {
        if (a.dropout)
          o[i] = keep_bit(a.mixed, static_cast<uint32_t>(row),
                          static_cast<uint32_t>(c + i), a.thresh)
                     ? o[i] / a.keep_div : 0.f;
        sums.at(2, k, i) += o[i];
      }
      store_vec<T, VEC>(dx + c, o);
    }
  }
}

// A persistent grid: gridDim.x blocks of W warps; warp gw takes rows gw,
// gw + gridDim.x * W, ...  On the 16-byte path (VEC > 1) each lane copies
// its own 16-byte chunks of the next row's dout, rout and drout into its
// warp's stage of a two-row shared-memory ring with cp.async while the
// current row reduces, so both passes read shared memory; the scalar path
// reads device memory twice.  NCH > 0 keeps the column sums in registers
// and adds the warps' sums in a fixed tree through shared memory at the
// end; NCH == 0 (wide rows) keeps them in shared memory and adds them in
// warp order.  Block b writes partial row b of (gridDim.x, 3, H).
template <typename T, int VEC, int NCH, int WARPS>
__global__ void __launch_bounds__(WARPS * kWarp)
ln_bwd_kernel(LnArgs a) {
  constexpr bool kRing = VEC > 1;
  extern __shared__ __align__(16) unsigned char smem[];
  const int W = blockDim.x / kWarp;
  const int warp = threadIdx.x / kWarp, lane = threadIdx.x % kWarp;
  const int nch = a.Hp / (kWarp * VEC);
  float* ws = reinterpret_cast<float*>(smem);                 // [Hp] w
  unsigned char* region = smem + sizeof(float) * a.Hp;
  T* ring = reinterpret_cast<T*>(region) +
            static_cast<size_t>(warp) * kBwdStages * 3 * a.H;
  const size_t ring_bytes =
      kRing ? static_cast<size_t>(W) * kBwdStages * 3 * a.H * sizeof(T) : 0;
  const T* dout = static_cast<const T*>(a.dout);
  const T* rin = static_cast<const T*>(a.rout_in);
  const T* drout = static_cast<const T*>(a.drout);
  auto stage = [&](int s, int t) {
    return ring + (static_cast<size_t>(s) * 3 + t) * a.H;
  };
  // lane j copies 16-byte chunks j, j + 32, ...: the columns it computes
  auto issue = [&](int row, int s) {
    const size_t base = static_cast<size_t>(row) * a.H;
    const int chunks = a.H / VEC;
    for (int j = lane; j < chunks; j += kWarp) {
      cp_async16(stage(s, 0) + j * VEC, dout + base + j * VEC);
      cp_async16(stage(s, 1) + j * VEC, rin + base + j * VEC);
      if (drout != nullptr)
        cp_async16(stage(s, 2) + j * VEC, drout + base + j * VEC);
    }
  };

  using Sums = typename std::conditional<(NCH > 0), RegSums<NCH, VEC>,
                                         SmemSums>::type;
  Sums sums;
  if constexpr (NCH > 0) {
#pragma unroll
    for (int t = 0; t < 3; ++t)
#pragma unroll
      for (int e = 0; e < NCH * VEC; ++e) sums.v[t][e] = 0.f;
  } else {
    sums.warp_base = reinterpret_cast<float*>(region + ring_bytes) +
                     static_cast<size_t>(warp) * a.Hp;
    sums.plane = static_cast<size_t>(W) * a.Hp;
    sums.lane = lane;
    sums.vec = VEC;
    for (int k = 0; k < nch; ++k)
      for (int i = 0; i < VEC; ++i)
        for (int t = 0; t < 3; ++t) sums.at(t, k, i) = 0.f;
  }
  // the first row's copies go out before w is staged: both are a trip
  const int stride = gridDim.x * W;
  int row = blockIdx.x * W + warp;
  float mean = 0.f, rs = 0.f;
  if (row < a.N) {
    if constexpr (kRing) issue(row, 0);
    mean = a.mu_in[row];
    rs = a.rstd_in[row];
  }
  if constexpr (kRing) cp_async_commit();
  for (int c = threadIdx.x; c < a.Hp; c += blockDim.x)
    ws[c] = c < a.H ? a.w[c] : 0.f;
  __syncthreads();                                           // ws

  for (int it = 0; row < a.N; ++it, row += stride) {
    const int next = row + stride, s = it & 1;
    float mean_n = 0.f, rs_n = 0.f;
    if (next < a.N) {                      // the next row, in flight now
      if constexpr (kRing) issue(next, s ^ 1);
      mean_n = a.mu_in[next];
      rs_n = a.rstd_in[next];
    }
    const size_t base = static_cast<size_t>(row) * a.H;
    if constexpr (kRing) {
      cp_async_commit();
      cp_async_wait<1>();                  // this row's copies have landed
      ln_bwd_row<T, VEC, NCH>(a, row, nch, lane, stage(s, 0), stage(s, 1),
                              drout != nullptr ? stage(s, 2) : nullptr, ws,
                              mean, rs, sums);
    } else {
      ln_bwd_row<T, VEC, NCH>(a, row, nch, lane, dout + base, rin + base,
                              drout != nullptr ? drout + base : nullptr, ws,
                              mean, rs, sums);
    }
    mean = mean_n;
    rs = rs_n;
  }
  if constexpr (kRing) cp_async_wait<0>();

  float* part = a.part + static_cast<size_t>(blockIdx.x) * 3 * a.H;
  if constexpr (NCH > 0) {
    // warps w and w + half meet in a fixed tree (the ring is drained and
    // reused), so the block's sum never depends on timing
    constexpr int E = NCH * VEC;
    float* red = reinterpret_cast<float*>(region);
    for (int half = W / 2; half >= 1; half /= 2) {
      __syncthreads();
      if (warp >= half && warp < 2 * half) {
        float* dst = red + static_cast<size_t>(warp - half) * 3 * E * kWarp;
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e) dst[(t * E + e) * kWarp + lane] =
              sums.v[t][e];
      }
      __syncthreads();
      if (warp < half) {
        const float* src = red + static_cast<size_t>(warp) * 3 * E * kWarp;
#pragma unroll
        for (int t = 0; t < 3; ++t)
#pragma unroll
          for (int e = 0; e < E; ++e)
            sums.v[t][e] += src[(t * E + e) * kWarp + lane];
      }
    }
    if (warp == 0) {
#pragma unroll
      for (int k = 0; k < NCH; ++k) {
        const int c = k * kWarp * VEC + lane * VEC;
        if (c < a.H)
#pragma unroll
          for (int t = 0; t < 3; ++t)
#pragma unroll
            for (int i = 0; i < VEC; ++i)
              part[t * a.H + c + i] = sums.v[t][k * VEC + i];
      }
    }
  } else {
    __syncthreads();
    // this block's partial rows: its warps' sums added in warp order
    const float* acc = reinterpret_cast<const float*>(region + ring_bytes);
    const size_t plane = static_cast<size_t>(W) * a.Hp;
    for (int col = threadIdx.x; col < a.H; col += blockDim.x) {
      const int k = col / (kWarp * VEC), rem = col % (kWarp * VEC);
      const int j = slot(k, rem % VEC, rem / VEC, VEC);
      float sw = 0.f, sb = 0.f, sbias = 0.f;
      for (int w = 0; w < W; ++w) {
        sw += acc[static_cast<size_t>(w) * a.Hp + j];
        sb += acc[plane + static_cast<size_t>(w) * a.Hp + j];
        sbias += acc[2 * plane + static_cast<size_t>(w) * a.Hp + j];
      }
      part[col] = sw;
      part[a.H + col] = sb;
      part[2 * a.H + col] = sbias;
    }
  }
}

// ---------------------------------------------------------------- AdamW --

struct AdamArgs {
  void* p;
  const void* g;
  void *m, *v, *po, *mo, *vo;
  long long n;
  float lr, b1, b2, eps, wd, bc1, bc2;   // bc = 1 - beta^t, from the host
};

// the reference's _adamw_kernel, one element, in its operation order
__device__ __forceinline__ void adamw_elem(const AdamArgs& a, float& p,
                                           float g, float& m, float& v) {
  m = a.b1 * m + (1.f - a.b1) * g;
  v = a.b2 * v + (1.f - a.b2) * g * g;
  const float mhat = m / a.bc1;
  const float vhat = v / a.bc2;
  p = p - a.lr * (mhat / (sqrtf(vhat) + a.eps) + a.wd * p);
}

template <typename TP, typename TS, bool kVector>
__global__ void __launch_bounds__(kAdamThreads)
adamw_kernel(AdamArgs a) {
  const long long tid =
      static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  const TP* P = static_cast<const TP*>(a.p);
  const TP* G = static_cast<const TP*>(a.g);
  const TS* M = static_cast<const TS*>(a.m);
  const TS* V = static_cast<const TS*>(a.v);
  TP* PO = static_cast<TP*>(a.po);
  TS* MO = static_cast<TS*>(a.mo);
  TS* VO = static_cast<TS*>(a.vo);
  long long done = 0;
  if constexpr (kVector) {
    const long long chunks = a.n / kAdamVec;
    for (long long ch = tid; ch < chunks; ch += stride) {
      const long long e = ch * kAdamVec;
      float p[kAdamVec], g[kAdamVec], m[kAdamVec], v[kAdamVec];
      load_vec<TP, kAdamVec>(p, P + e);
      load_vec<TP, kAdamVec>(g, G + e);
      load_vec<TS, kAdamVec>(m, M + e);
      load_vec<TS, kAdamVec>(v, V + e);
#pragma unroll
      for (int i = 0; i < kAdamVec; ++i) adamw_elem(a, p[i], g[i], m[i], v[i]);
      store_vec<TP, kAdamVec>(PO + e, p);
      store_vec<TS, kAdamVec>(MO + e, m);
      store_vec<TS, kAdamVec>(VO + e, v);
    }
    done = chunks * kAdamVec;
  }
  for (long long e = done + tid; e < a.n; e += stride) {
    float p = to_float(P[e]), g = to_float(G[e]);
    float m = to_float(M[e]), v = to_float(V[e]);
    adamw_elem(a, p, g, m, v);
    PO[e] = from_float<TP>(p);
    MO[e] = from_float<TS>(m);
    VO[e] = from_float<TS>(v);
  }
}

// ------------------------------------------------------------------ host --

bool aligned16(const void* ptr) {
  return ptr == nullptr || reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
}

template <typename K>
int launch(K kernel, int blocks, int threads, size_t smem, cudaStream_t s,
           const LnArgs& a) {
  if (smem > static_cast<size_t>(kMaxSmem)) return -2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  kernel<<<blocks, threads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int VEC>
int run_ln_fwd(LnArgs a, cudaStream_t s) {
  const int chunk = kWarp * VEC;
  a.Hp = (a.H + chunk - 1) / chunk * chunk;
  const int blocks = (a.N + kFwdWarps - 1) / kFwdWarps;
  return launch(ln_fwd_kernel<T, VEC>, blocks, kFwdWarps * kWarp,
                sizeof(float) * kFwdWarps * static_cast<size_t>(a.Hp), s, a);
}

// The backward with NCH chunks a lane (0: as many as H needs, sums in
// shared memory) on `blocks` blocks of up to WARPS warps, halved until the
// ring, w and the sums fit kBwdSmemBudget (one warp may take up to the
// card's limit).
template <typename T, int VEC, int NCH, int WARPS>
int run_ln_bwd(LnArgs a, int blocks, cudaStream_t s, int* shape) {
  const int chunk = kWarp * VEC;
  a.Hp = NCH > 0 ? NCH * chunk : (a.H + chunk - 1) / chunk * chunk;
  const size_t row = sizeof(T) * static_cast<size_t>(a.H);
  const size_t hp = static_cast<size_t>(a.Hp);
  for (int w = WARPS;; w /= 2) {
    const size_t ring = VEC > 1 ? w * kBwdStages * 3 * row : 0;
    const size_t sums = NCH > 0 ? (w / 2) * 3 * hp * sizeof(float)
                                : w * 3 * hp * sizeof(float);
    const size_t smem = sizeof(float) * hp +
                        (NCH > 0 ? (ring > sums ? ring : sums) : ring + sums);
    if (smem > static_cast<size_t>(kBwdSmemBudget) && w > 1) continue;
    if (shape != nullptr) {                  // report, do not launch
      shape[0] = w;
      shape[1] = static_cast<int>(smem);
      shape[2] = NCH;
      return 0;
    }
    return launch(ln_bwd_kernel<T, VEC, NCH, WARPS>, blocks, w * kWarp,
                  smem, s, a);
  }
}

// Column sums in registers while a lane's share of a row is at most 32
// elements (H <= 1024 on the 16-byte path, <= 1024 scalar), with 16 warps
// a block up to 24 elements and 8 above; wider rows keep them in shared
// memory.
template <typename T>
int run_ln_bwd_t(const LnArgs& a, int blocks, bool vec, cudaStream_t s,
                 int* shape = nullptr) {
  if (vec) {
    constexpr int V = 16 / static_cast<int>(sizeof(T));
    const int need = (a.H + kWarp * V - 1) / (kWarp * V);
    if constexpr (V == 4) {
      if (need <= 1) return run_ln_bwd<T, V, 1, 16>(a, blocks, s, shape);
      if (need <= 2) return run_ln_bwd<T, V, 2, 16>(a, blocks, s, shape);
      if (need <= 4) return run_ln_bwd<T, V, 4, 16>(a, blocks, s, shape);
      if (need <= 6) return run_ln_bwd<T, V, 6, 16>(a, blocks, s, shape);
      if (need <= 8) return run_ln_bwd<T, V, 8, 8>(a, blocks, s, shape);
    } else {
      if (need <= 1) return run_ln_bwd<T, V, 1, 16>(a, blocks, s, shape);
      if (need <= 2) return run_ln_bwd<T, V, 2, 16>(a, blocks, s, shape);
      if (need <= 3) return run_ln_bwd<T, V, 3, 16>(a, blocks, s, shape);
      if (need <= 4) return run_ln_bwd<T, V, 4, 8>(a, blocks, s, shape);
    }
    return run_ln_bwd<T, V, 0, 16>(a, blocks, s, shape);
  }
  const int need = (a.H + kWarp - 1) / kWarp;
  if (need <= 4) return run_ln_bwd<T, 1, 4, 16>(a, blocks, s, shape);
  if (need <= 32) return run_ln_bwd<T, 1, 32, 8>(a, blocks, s, shape);
  return run_ln_bwd<T, 1, 0, 16>(a, blocks, s, shape);
}

// 16-byte accesses when every row starts on a 16-byte boundary and every
// pointer is aligned; one element at a time otherwise
template <typename T>
int run_ln_t(bool backward, const LnArgs& a, int blocks, cudaStream_t s) {
  constexpr int kVec = 16 / static_cast<int>(sizeof(T));
  const void* ptrs[] = {a.x, a.res, a.dout, a.drout, a.rout_in, a.w, a.b,
                        a.bias, a.out, a.rout, a.dx, a.dres};
  bool vec = a.H % kVec == 0;
  for (const void* ptr : ptrs) vec = vec && aligned16(ptr);
  if (backward) return run_ln_bwd_t<T>(a, blocks, vec, s);
  return vec ? run_ln_fwd<T, kVec>(a, s) : run_ln_fwd<T, 1>(a, s);
}

int dispatch_ln(bool backward, int dtype, const LnArgs& a, int blocks,
                void* stream) {
  if (a.N <= 0 || a.H <= 0 || (backward && blocks <= 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return run_ln_t<float>(backward, a, blocks, s);
    case 1: return run_ln_t<__half>(backward, a, blocks, s);
    case 2: return run_ln_t<__nv_bfloat16>(backward, a, blocks, s);
    default: return -1;
  }
}

template <typename TP, typename TS>
int run_adamw(const AdamArgs& a, cudaStream_t s) {
  const void* ptrs[] = {a.p, a.g, a.m, a.v, a.po, a.mo, a.vo};
  bool vec = true;
  for (const void* ptr : ptrs) vec = vec && aligned16(ptr);
  const long long work = vec ? a.n / kAdamVec + kAdamVec : a.n;
  long long blocks = (work + kAdamThreads - 1) / kAdamThreads;
  if (blocks > 132 * 16) blocks = 132 * 16;     // grid-stride beyond that
  if (blocks < 1) blocks = 1;
  if (vec)
    adamw_kernel<TP, TS, true><<<static_cast<int>(blocks), kAdamThreads, 0,
                                 s>>>(a);
  else
    adamw_kernel<TP, TS, false><<<static_cast<int>(blocks), kAdamThreads, 0,
                                  s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename TP>
int run_adamw_p(int sdtype, const AdamArgs& a, cudaStream_t s) {
  switch (sdtype) {
    case 0: return run_adamw<TP, float>(a, s);
    case 1: return run_adamw<TP, __half>(a, s);
    case 2: return run_adamw<TP, __nv_bfloat16>(a, s);
    default: return -1;
  }
}

}  // namespace

// dtype: 0 float32, 1 float16, 2 bfloat16.  Every (N, H) operand is
// contiguous in dtype; w, b, bias (nullable) are contiguous fp32 (H,); mu,
// rstd fp32 (N,).  mixed = seed * 0xC2B2AE3D mod 2^32; thresh and keep_div
// as in position_hash_keep.  Each returns the launch's cudaGetLastError()
// (or the shared-memory attribute call's error), -1 for an unsupported
// argument, -2 when H needs more shared memory than a block has.
extern "C" int fused_ln_fwd(int dtype, const void* x, const void* res,
                            const float* w, const float* b, const float* bias,
                            void* out, void* rout, float* mu, float* rstd,
                            int N, int H, float eps, int dropout,
                            uint32_t mixed, uint32_t thresh, float keep_div,
                            void* stream) {
  LnArgs a{};
  a.x = x;
  a.res = res;
  a.w = w;
  a.b = b;
  a.bias = bias;
  a.out = out;
  a.rout = rout;
  a.mu = mu;
  a.rstd = rstd;
  a.N = N;
  a.H = H;
  a.eps = eps;
  a.dropout = dropout;
  a.mixed = mixed;
  a.thresh = thresh;
  a.keep_div = keep_div;
  return dispatch_ln(false, dtype, a, 0, stream);
}

// drout is nullable (no rout cotangent).  The grid is `blocks` blocks
// (ops/fused.py ln_bwd_blocks: one a streaming multiprocessor, fewer for
// small N); part is (blocks, 3, H) fp32: per block, the column sums of
// dout * xhat, dout and dx (dw, db and dbias) over the rows it took.
extern "C" int fused_ln_bwd(int dtype, const void* dout, const void* drout,
                            const void* rout, const float* mu,
                            const float* rstd, const float* w, void* dx,
                            void* dres, float* part, int N, int H, int blocks,
                            int dropout, uint32_t mixed, uint32_t thresh,
                            float keep_div, void* stream) {
  LnArgs a{};
  a.dout = dout;
  a.drout = drout;
  a.rout_in = rout;
  a.mu_in = mu;
  a.rstd_in = rstd;
  a.w = w;
  a.dx = dx;
  a.dres = dres;
  a.part = part;
  a.N = N;
  a.H = H;
  a.dropout = dropout;
  a.mixed = mixed;
  a.thresh = thresh;
  a.keep_div = keep_div;
  return dispatch_ln(true, dtype, a, blocks, stream);
}

// The backward's block at row width H: shape[0] warps, shape[1] bytes of
// dynamic shared memory, shape[2] chunks a lane with the sums in
// registers (0: in shared memory); vec 1 for the 16-byte path.  For
// reports; returns -1 for an unsupported dtype.
extern "C" int fused_ln_bwd_shape(int dtype, int H, int vec, int* shape) {
  if (H <= 0) return -1;
  LnArgs a{};
  a.H = H;
  switch (dtype) {
    case 0: return run_ln_bwd_t<float>(a, 1, vec != 0, nullptr, shape);
    case 1: return run_ln_bwd_t<__half>(a, 1, vec != 0, nullptr, shape);
    case 2: return run_ln_bwd_t<__nv_bfloat16>(a, 1, vec != 0, nullptr,
                                                shape);
    default: return -1;
  }
}

// pdtype: p, g and po; sdtype: m, v, mo and vo (codes as above).  n
// elements, contiguous; the outputs may alias the inputs.
extern "C" int fused_adamw_flat(int pdtype, int sdtype, void* p,
                                const void* g, void* m, void* v, void* po,
                                void* mo, void* vo, long long n, float lr,
                                float b1, float b2, float eps, float wd,
                                float bc1, float bc2, void* stream) {
  if (n <= 0) return -1;
  AdamArgs a{};
  a.p = p;
  a.g = g;
  a.m = m;
  a.v = v;
  a.po = po;
  a.mo = mo;
  a.vo = vo;
  a.n = n;
  a.lr = lr;
  a.b1 = b1;
  a.b2 = b2;
  a.eps = eps;
  a.wd = wd;
  a.bc1 = bc1;
  a.bc2 = bc2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (pdtype) {
    case 0: return run_adamw_p<float>(sdtype, a, s);
    case 1: return run_adamw_p<__half>(sdtype, a, s);
    case 2: return run_adamw_p<__nv_bfloat16>(sdtype, a, s);
    default: return -1;
  }
}

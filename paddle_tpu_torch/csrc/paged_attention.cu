// Paged decode attention for Hopper (sm_90a).
//
// Replaces paddle_tpu/ops/paged_attention.py:_paged_decode_kernel (the
// Pallas kernel every layer of a bucketed paged decode tick runs).  For
// every slot s and head h, ONE query q[s, h] attends the slot's pool
// positions [pad[s], t[s]], where position p lives in pool block
// table[s, p / bs] at offset p % bs.  Pools are (NB+1, bs, nh, hd) in the
// query's dtype (fp32, fp16, bf16; int8 pairs never come here).  The
// arithmetic is the Pallas kernel's: fp32 q * scale, fp32 scores, fp32
// softmax, fp32 P.V, one cast at the end.
//
// The TPU kernel walks a sequential (slot, table column) grid with VMEM
// accumulators and clamps its index map so columns past the clock cost no
// DMA.  Here the positions [pad, min(t, C * bs - 1)] of a slot are cut
// into tiles of TP consecutive positions (TP from the wrapper: 16, halved
// until a tile's K and V take at most 64 KB), and one block takes one
// (tile, slot) across ALL heads.  Positions outside the range cost
// neither loads nor flops, table[s, j] is never read for j >= C (an
// inactive slot's parked clock may point past the table), and a row with
// no position in range (pad > t, or t < 0) writes zeros, where the
// reference yields a finite average of V that nothing reads.
//
// What bounds it on this card: bytes, and the latency of the dependent
// trips around them.  A slot's K/V is read once at ~4 flops an element,
// far below the ~295 flops a byte the H100 needs before compute matters,
// and at the gpt2-small serve's decode shape (8 slots, clocks 128-639) it
// is 8 MB: 2.4 us at 3.35 TB/s.  What the design does about it:
//   - every tile is its own block: 172 live tiles at that shape, where a
//     block per (slot, head) gave 96 blocks on 132 SMs and the longest
//     slot five rounds of two dependent trips;
//   - since the pool keeps a position's heads together, a tile's
//     positions inside one pool block are ONE contiguous run of
//     positions * nh * hd elements: one bulk copy (cp.async.bulk onto an
//     mbarrier) each for K and V, issued by one lane a run (a tile spans
//     several pool blocks at small bs).  The table entries, clock and pad
//     are loaded in the first trip, the copies are the second;
//   - the tile's scores come from shared memory, a thread a (position,
//     head) with its 16-byte chunks in a rotated order (no bank conflicts,
//     no shuffles), then a thread a (head, 16-byte chunk) takes the tile's
//     max, sum and P.V;
//   - a slot with one live tile writes its output directly; otherwise
//     each tile writes (m, l, acc) a head to a scratch buffer and takes a
//     ticket (one thread's __threadfence after the block's barrier, then
//     atomicAdd): the last tile of each group of 8 merges the group, the
//     last group merges the slot, each merge in tile order with 8
//     partials' loads in flight, so the result does not depend on which
//     block finishes last and one launch does it all.
// Measured at that shape (NVIDIA H100 80GB HBM3, 700.00 W, cold L2):
// 0.0168 ms, where the kernel before the redesign (a block per (slot,
// head), 8 warps taking 16-position chunks) took 0.0194 ms.  Per-block
// clock stamps put the rest in the cold launch and first trip (a launch
// of this grid whose tiles are all skipped takes 0.0069 ms), the bulk
// copies (~3.8 us) and the two merge levels with their tickets (~4.3 us);
// PERF.md §6 has the numbers.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "paged_common.cuh"   // to_float, from_float, load_row
#include "sm90.cuh"           // mbarriers, bulk_load

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;      // partials a merge round; tiles a group

struct Args {
  const void *q, *pk, *pv;
  const int32_t *table, *clock, *pad_lens;
  void* out;
  // (S, tiles, nh, hd) acc, (S, tiles, nh, 2) m, l, then the same two
  // for (S, groups): the partials of tiles and of groups of kBatch tiles
  float* part;
  int32_t* tickets;  // (S, 1 + groups): a slot's, then its groups'; zero
                     // between launches
  int S, nh, bs, C, TP, tiles, groups;
  float sm_scale;
};

// The dynamic shared memory of a block, in order: the mbarrier; q (fp32,
// scaled); the tile's scores (TP, nh); then its K and V (TP, nh, HD) in T.
__host__ __device__ __forceinline__ int up16(int bytes) {
  return (bytes + 15) & ~15;
}

template <typename T, int HD>
__host__ __device__ __forceinline__ int smem_bytes(int nh, int TP) {
  return 16 + up16(nh * HD * 4) + up16(TP * nh * 4) +
         2 * TP * nh * HD * static_cast<int>(sizeof(T));
}

template <typename T, int HD>
struct Smem {
  uint64_t* bar;
  float *q, *sc;
  T *K, *V;
  __device__ Smem(unsigned char* p, int nh, int TP) {
    bar = reinterpret_cast<uint64_t*>(p);
    q = reinterpret_cast<float*>(p + 16);
    sc = reinterpret_cast<float*>(p + 16 + up16(nh * HD * 4));
    K = reinterpret_cast<T*>(p + 16 + up16(nh * HD * 4) + up16(TP * nh * 4));
    V = K + static_cast<size_t>(TP) * nh * HD;
  }
};

// Merges n partials (acc (n, nh, HD) fp32, (m, l) (n, nh, 2)), written by
// other blocks and so read through L2, in order, a thread a (head, 4
// columns): kBatch partials' loads in flight at once, then their weights
// exp(m - max) side by side; a running max carries across batches.
// Writes out (nh, HD) normalised, or the merged partial to (acc_out,
// ml_out).
template <typename T, int HD>
__device__ __forceinline__ void merge_partials(int nh, const float* acc_in,
                                               const float* ml_in, int n,
                                               T* out, float* acc_out,
                                               float* ml_out) {
  for (int u = threadIdx.x; u < nh * (HD / 4); u += kThreads) {
    const int h = u / (HD / 4), c = (u % (HD / 4)) * 4;
    float m_run = -INFINITY, l_run = 0.f, o[4] = {0.f, 0.f, 0.f, 0.f};
    for (int i0 = 0; i0 < n; i0 += kBatch) {
      float2 ml[kBatch];
      float4 acc[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const long long row =
            static_cast<long long>(min(i0 + b, n - 1)) * nh + h;
        ml[b] = __ldcg(reinterpret_cast<const float2*>(ml_in + row * 2));
        acc[b] = __ldcg(reinterpret_cast<const float4*>(acc_in + row * HD +
                                                        c));
      }
      // every partial has a finite m; a clamped repeat gets weight 0
      float m_new = m_run;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) m_new = fmaxf(m_new, ml[b].x);
      const float sa = expf(m_run - m_new);  // 0 on the first batch
      l_run *= sa;
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] *= sa;
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const float w = i0 + b < n ? expf(ml[b].x - m_new) : 0.f;
        l_run += w * ml[b].y;
        o[0] += w * acc[b].x;
        o[1] += w * acc[b].y;
        o[2] += w * acc[b].z;
        o[3] += w * acc[b].w;
      }
      m_run = m_new;
    }
    if (out != nullptr) {
      const float inv = 1.f / l_run;
#pragma unroll
      for (int e = 0; e < 4; ++e)
        out[h * HD + c + e] = from_float<T>(o[e] * inv);
    } else {
      *reinterpret_cast<float4*>(acc_out + static_cast<long long>(h) * HD +
                                 c) = make_float4(o[0], o[1], o[2], o[3]);
      if (c == 0)
        *reinterpret_cast<float2*>(ml_out + static_cast<long long>(h) * 2) =
            make_float2(m_run, l_run);
    }
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
paged_decode_attention_kernel(Args a) {
  constexpr int EPC = 16 / static_cast<int>(sizeof(T));   // elements a chunk
  constexpr int NCH = HD / EPC;                           // chunks a row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int last_flag;
  const int nh = a.nh, TP = a.TP;
  const int row_el = nh * HD;                // a position's elements
  const Smem<T, HD> sm(smem, nh, TP);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int s = blockIdx.y, j = blockIdx.x;
  const int p0 = j * TP;
  const int end_pos = a.C * a.bs - 1;        // the table's last position
  const long long qo = static_cast<long long>(s) * row_el;

  // first trip, every load at once: the tile's table entries (lane k of
  // warp 0: column p0 / bs + k, never past the table), the clock, the pad
  int blk = 0;
  const int col = p0 / a.bs + lane;
  const bool has_col =
      warp == 0 && col * a.bs <= min(p0 + TP - 1, end_pos);
  if (has_col) blk = a.table[static_cast<long long>(s) * a.C + col];
  const int first = a.pad_lens ? max(a.pad_lens[s], 0) : 0;
  const int last = min(a.clock[s], end_pos);
  const int lo = max(p0, first), hi = min(p0 + TP - 1, last);
  if (lo > hi) {                             // nothing of this tile in range
    if (first > last && j == 0) {            // nothing at all: zeros
      for (int e = tid; e < row_el; e += kThreads)
        static_cast<T*>(a.out)[qo + e] = from_float<T>(0.f);
    }
    return;
  }
  const int n_live = last / TP - first / TP + 1;

  if (tid == 0) {
    sm90::mbar_init(sm.bar, 1);
    sm90::mbar_fence_init();
  }
  __syncthreads();
  // second trip: one bulk copy a run of positions inside one pool block
  const uint32_t row_bytes = row_el * sizeof(T);
  if (warp == 0) {
    if (lane == 0)
      sm90::mbar_arrive_tx(sm.bar, 2u * (hi - lo + 1) * row_bytes);
    __syncwarp();
    const int start = max(lo, col * a.bs);
    const int stop = min(hi, col * a.bs + a.bs - 1);
    if (has_col && start <= stop) {
      const long long src =
          (static_cast<long long>(blk) * a.bs + start % a.bs) * row_el;
      const size_t dst = static_cast<size_t>(start - p0) * row_el;
      const uint32_t bytes = (stop - start + 1) * row_bytes;
      sm90::bulk_load(sm.K + dst, static_cast<const T*>(a.pk) + src, bytes,
                      sm.bar);
      sm90::bulk_load(sm.V + dst, static_cast<const T*>(a.pv) + src, bytes,
                      sm.bar);
    }
  }
  const T* q = static_cast<const T*>(a.q) + qo;
  for (int e = tid; e < row_el; e += kThreads)
    sm.q[e] = to_float(q[e]) * a.sm_scale;
  __syncthreads();                           // q
  sm90::mbar_wait(sm.bar, 0);

  // scores: a thread a (position, head), its 16-byte chunks of the row in
  // an order rotated by the pair, so the lanes of a quarter warp read 8
  // different chunks (no bank conflicts, no shuffles)
  const int rlo = lo - p0, rhi = hi - p0, npos = hi - lo + 1;
  for (int pi = tid; pi < npos * nh; pi += kThreads) {
    const int h = pi / npos, r = rlo + pi % npos;
    const T* k = sm.K + static_cast<size_t>(r) * row_el + h * HD;
    const float* qh = sm.q + h * HD;
    float d = 0.f;
#pragma unroll
    for (int i = 0; i < NCH; ++i) {
      const int c = ((i + pi) % NCH) * EPC;
      float kv[EPC];
      load_row<EPC>(k + c, kv);
#pragma unroll
      for (int e = 0; e < EPC; ++e) d += qh[c + e] * kv[e];
    }
    sm.sc[r * nh + h] = d;
  }
  __syncthreads();

  // the tile's softmax and P.V: a thread a (head, 16-byte chunk)
  const long long tiles = static_cast<long long>(a.S) * a.tiles;
  const long long groups = static_cast<long long>(a.S) * a.groups;
  float* tile_ml = a.part + tiles * row_el;
  float* group_acc = tile_ml + tiles * nh * 2;
  float* group_ml = group_acc + groups * row_el;
  for (int u = tid; u < nh * NCH; u += kThreads) {
    const int h = u / NCH, c = (u % NCH) * EPC;
    float m = -INFINITY;
    for (int r = rlo; r <= rhi; ++r) m = fmaxf(m, sm.sc[r * nh + h]);
    float l = 0.f, acc[EPC];
#pragma unroll
    for (int e = 0; e < EPC; ++e) acc[e] = 0.f;
    for (int r = rlo; r <= rhi; ++r) {
      const float pw = expf(sm.sc[r * nh + h] - m);
      float vv[EPC];
      load_row<EPC>(sm.V + static_cast<size_t>(r) * row_el + h * HD + c, vv);
      l += pw;
#pragma unroll
      for (int e = 0; e < EPC; ++e) acc[e] += pw * vv[e];
    }
    if (n_live == 1) {                       // the slot's only tile
      const float inv = 1.f / l;
      T* o = static_cast<T*>(a.out) + qo + h * HD + c;
#pragma unroll
      for (int e = 0; e < EPC; ++e) o[e] = from_float<T>(acc[e] * inv);
    } else {
      const long long row = (static_cast<long long>(s) * a.tiles + j) * nh + h;
      float* pa = a.part + row * HD + c;
#pragma unroll
      for (int e = 0; e < EPC; e += 4)
        *reinterpret_cast<float4*>(pa + e) =
            make_float4(acc[e], acc[e + 1], acc[e + 2], acc[e + 3]);
      if (c == 0)
        *reinterpret_cast<float2*>(tile_ml + row * 2) = make_float2(m, l);
    }
  }
  if (n_live == 1) return;

  // two levels of tickets: the last tile of each group of kBatch
  // consecutive live tiles merges the group, the last group the slot.  One
  // thread's fence after the barrier covers the whole block's writes.
  const int jf = first / TP, g = (j - jf) / kBatch;
  const int n_groups = (n_live + kBatch - 1) / kBatch;
  const int in_group = min(kBatch, n_live - g * kBatch);
  int32_t* tk = a.tickets + static_cast<long long>(s) * (a.groups + 1);
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_flag = atomicAdd(tk + 1 + g, 1) == in_group - 1;
    if (last_flag) __threadfence();
  }
  __syncthreads();
  if (!last_flag) return;
  T* out = static_cast<T*>(a.out) + qo;
  const long long grow = static_cast<long long>(s) * a.groups + g;
  const long long t0 = static_cast<long long>(s) * a.tiles + jf + g * kBatch;
  merge_partials<T, HD>(nh, a.part + t0 * row_el, tile_ml + t0 * nh * 2,
                        in_group, n_groups == 1 ? out : nullptr,
                        group_acc + grow * row_el, group_ml + grow * nh * 2);
  if (tid == 0) tk[1 + g] = 0;               // ready for the next launch
  if (n_groups == 1) return;
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    last_flag = atomicAdd(tk, 1) == n_groups - 1;
    if (last_flag) __threadfence();
  }
  __syncthreads();
  if (!last_flag) return;
  const long long g0 = static_cast<long long>(s) * a.groups;
  merge_partials<T, HD>(nh, group_acc + g0 * row_el, group_ml + g0 * nh * 2,
                        n_groups, out, nullptr, nullptr);
  if (tid == 0) tk[0] = 0;
}

template <typename T, int HD>
int launch(const Args& a, cudaStream_t stream) {
  const int smem = smem_bytes<T, HD>(a.nh, a.TP);
  if (smem > 227 * 1024) return -2;
  static int granted = 48 * 1024;            // set once per instance
  if (smem > granted) {
    const cudaError_t e = cudaFuncSetAttribute(
        paged_decode_attention_kernel<T, HD>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
    granted = smem;
  }
  const dim3 grid(a.tiles, a.S);
  paged_decode_attention_kernel<T, HD><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_hd(const Args& a, int hd, cudaStream_t stream) {
  if (hd == 64) return launch<T, 64>(a, stream);
  if (hd == 128) return launch<T, 128>(a, stream);
  return -1;
}

}  // namespace

// Dynamic shared memory a block takes for (dtype, hd, nh, tile), or -1.
extern "C" int paged_decode_smem_bytes(int dtype, int hd, int nh, int tile) {
  const int el = dtype == 0 ? 4 : 2;
  if (dtype < 0 || dtype > 2 || (hd != 64 && hd != 128)) return -1;
  return el == 4 ? (hd == 64 ? smem_bytes<float, 64>(nh, tile)
                             : smem_bytes<float, 128>(nh, tile))
                 : (hd == 64 ? smem_bytes<__half, 64>(nh, tile)
                             : smem_bytes<__half, 128>(nh, tile));
}

// dtype: 0 float32, 1 float16, 2 bfloat16 (q, the pools and out share it).
// q, out (S, nh, hd); pools (NB+1, bs, nh, hd), 16-byte aligned; table
// (S, C) int32, contiguous; clock, pad_lens (S,) int32; a null pad_lens
// means no left pads.  tile: positions a tile (a power of two <= 32; the
// wrapper's decode_tile_positions).  With tiles = ceil(C * bs / tile) and
// groups = ceil(tiles / 8): part is fp32 scratch of S * (tiles + groups)
// * nh * (hd + 2) floats, 16-byte aligned; tickets S * (1 + groups) int32,
// zero before the first launch (each launch leaves them zero).  Launches
// on the same tickets must be ordered (one stream).  Returns the launch's
// cudaGetLastError(), -1 for an unsupported combination, -2 when a tile
// needs more shared memory than a block has.
extern "C" int paged_decode_attention(
    int dtype, int hd, const void* q, const void* pool_k, const void* pool_v,
    const void* table, const void* clock, const void* pad_lens, void* out,
    void* part, void* tickets, int S, int nh, int bs, int C, int tile,
    float sm_scale, void* stream) {
  if (S <= 0 || nh <= 0 || bs <= 0 || C <= 0 || tile <= 0 || tile > 32 ||
      (tile & (tile - 1)) != 0)
    return -1;
  const long long positions = static_cast<long long>(C) * bs;
  const int tiles = static_cast<int>((positions + tile - 1) / tile);
  const Args a{q, pool_k, pool_v, static_cast<const int32_t*>(table),
               static_cast<const int32_t*>(clock),
               static_cast<const int32_t*>(pad_lens), out,
               static_cast<float*>(part), static_cast<int32_t*>(tickets), S,
               nh, bs, C, tile, tiles, (tiles + kBatch - 1) / kBatch,
               sm_scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: return dispatch_hd<float>(a, hd, s);
    case 1: return dispatch_hd<__half>(a, hd, s);
    case 2: return dispatch_hd<__nv_bfloat16>(a, hd, s);
    default: return -1;
  }
}

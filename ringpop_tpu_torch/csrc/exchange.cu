// Fused push-pull exchange of the scalable engine over the [N, W] uint32
// heard bitmask (W = U/32 words per row).
//
// Replaces the TPU kernel ringpop_tpu/ops/exchange.py:82 `_exchange_kernel`
// (run by `_exchange_pallas`, pallas_call at :192): new = heard | pulled |
// pushed; diff = new ^ heard; per row, the sum mod 2^32 of r_delta[b] over
// the set bits b of diff, and optionally popcount(diff).
//
// Bound on an H100: bytes.  At the 1M-node storm shape (N = 1,000,000,
// W = 16) three 64 MB mask planes are read and one written, plus the [N]
// row delta and the 2 KB table: 260 MB, 0.0776 ms at 3.35 TB/s; a few
// integer operations per word and one add per new bit are far below the
// operation bound.  The first port (one block per 16 rows, one word a
// thread) took 0.1623 ms there, 48% of the bound; this design takes 0.1005
// ms, 77% (3.75 new bits a word; with no new bit 0.1223 -> 0.0913 ms, 85%:
// the memory traffic alone).  Both timed in one run, the kernel alone
// (chip_smoke.py, NVIDIA H100 80GB HBM3, 700 W).  Four causes, and what
// this design does about each:
//
// 1. Every block staged the whole [U] table behind a barrier before its
//    first mask load (62,500 blocks x 2 KB of L2 reads).  The grid is now
//    persistent: about as many blocks as the card holds at once (SM count x
//    BLOCKS_PER_SM, planned by ops/exchange.py `exchange_plan`), each
//    staging the table once and then walking row tiles with a grid stride.
//    Tables up to the 227 KB of opt-in dynamic shared memory are staged;
//    larger ones are read from global memory.
// 2. Too few bytes in flight: a thread issued its loads and then waited
//    on them.  Now each thread keeps the next item's loads in flight (a
//    register double buffer, 48 bytes a thread, 48 KB an SM at 4 blocks)
//    while it ORs, stores and walks the current one.  At 77% of the bound
//    this stays; a ring of bulk copies through shared memory was not tried.
// 3. One-word lanes.  Where 4-word lanes tile a row with no idle lane (W/4
//    a power of two up to 32, or a multiple of 32) and the planes are
//    16-byte aligned, a thread owns 4 consecutive words: one 16-byte load
//    per plane and one 16-byte store.  Otherwise (W in {1, 3, 40}, a view
//    off a 16-byte boundary, or an N whose 4-word tiles leave blocks idle
//    where 4-byte lanes would not) the same kernel runs with 4-byte lanes.
// 4. The __ffs walk over each new bit follows its word's loads; with the
//    next item's loads already issued it no longer leaves the memory idle.
//    It still costs 0.009 ms at 3.75 new bits a word (0.1005 against the
//    0.0913 of no new bit).
//
// `new` is written with streaming stores (the tick reads it back only on
// the next tick) and the planes are read with streaming loads.  A row
// spans `seg` lanes of one warp (seg a power of two <= 32); a lane takes
// ceil(W / (VEC * seg)) items of a row, and the row's partial sums meet by
// xor shuffles (wrapping uint32 adds: any order gives the same sum).
//
// The batch axis: B clusters' masks stacked [B, N, W] run in one launch
// whose grid has a cluster axis (blockIdx.y).  A block offsets its planes,
// outputs and delta table by its cluster and then runs the design above
// inside that cluster: it stages its own cluster's table once and walks
// the cluster's row tiles with a stride of gridDim.x (the persistent grid
// is split between the clusters by ops/exchange.py `exchange_plan`).  A
// table shared by every cluster is passed once, with a cluster stride of 0.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
// Blocks an SM holds at once: the residency __launch_bounds__ promises (at
// most 64 registers a thread).  ops/exchange.py plans with the same number.
constexpr int BLOCKS_PER_SM = 4;
constexpr int DEFAULT_SMEM = 48 * 1024;
// The largest delta table staged in shared memory: an sm_90 block's
// opt-in dynamic shared memory, 227 KB.
constexpr int SMEM_TABLE_MAX = 232448 / 4;  // uint32 entries

enum : int {
  IN_HEARD, IN_PULLED, IN_PUSHED, IN_DELTA,
  OUT_NEW, OUT_ACC, OUT_CNT,
  N_PTRS
};

// One lane's operands for one item: VEC consecutive words of each plane.
template <int VEC>
struct Item {
  uint32_t h[VEC], pl[VEC], ps[VEC];
  size_t off;  // the lane's first word in the [N, W] plane
  int word;    // the same word's index within its row
  bool valid;
};

template <int VEC>
__device__ __forceinline__ void load_words(uint32_t (&d)[VEC], const uint32_t* p) {
  if constexpr (VEC == 4) {
    const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p));
    d[0] = v.x;
    d[1] = v.y;
    d[2] = v.z;
    d[3] = v.w;
  } else {
    d[0] = __ldcs(p);
  }
}

template <int VEC>
__device__ __forceinline__ void store_words(uint32_t* p, const uint32_t (&d)[VEC]) {
  if constexpr (VEC == 4) {
    __stcs(reinterpret_cast<uint4*>(p), make_uint4(d[0], d[1], d[2], d[3]));
  } else {
    __stcs(p, d[0]);
  }
}

// Issue the loads of the item at (row, unit); a row past n or a unit past
// the row's end is an empty item.
template <int VEC>
__device__ __forceinline__ void fetch(Item<VEC>& it, const uint32_t* __restrict__ heard,
                                      const uint32_t* __restrict__ pulled,
                                      const uint32_t* __restrict__ pushed, long long row,
                                      int unit, int n, int w) {
  it.word = unit * VEC;
  it.valid = row < n && it.word < w;
  it.off = static_cast<size_t>(row) * w + it.word;
  if (it.valid) {
    load_words(it.h, heard + it.off);
    load_words(it.pl, pulled + it.off);
    load_words(it.ps, pushed + it.off);
  }
}

template <int VEC, bool SMEM>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
exchange_kernel(const uint32_t* __restrict__ heard,
                const uint32_t* __restrict__ pulled,
                const uint32_t* __restrict__ pushed,
                const uint32_t* __restrict__ r_delta,
                uint32_t* __restrict__ o_new, uint32_t* __restrict__ o_acc,
                int32_t* __restrict__ o_cnt, int n, int w, int seg, int delta_stride) {
  extern __shared__ uint32_t s_delta[];
  {
    const size_t plane = static_cast<size_t>(blockIdx.y) * n * w;
    heard += plane;
    pulled += plane;
    pushed += plane;
    o_new += plane;
    o_acc += static_cast<size_t>(blockIdx.y) * n;
    if (o_cnt) o_cnt += static_cast<size_t>(blockIdx.y) * n;
    r_delta += static_cast<size_t>(blockIdx.y) * delta_stride;
  }
  const uint32_t* tbl = r_delta;
  if (SMEM) {
    const int u = w * 32;
    for (int i = threadIdx.x; i < u; i += THREADS) s_delta[i] = r_delta[i];
    __syncthreads();
    tbl = s_delta;
  }
  const int per_lane = (w / VEC + seg - 1) / seg;  // items a lane takes in a row
  const int rows_per_tile = THREADS / seg;
  const long long tiles = (static_cast<long long>(n) + rows_per_tile - 1) / rows_per_tile;
  const int lane = threadIdx.x % seg;
  const int tile_row = threadIdx.x / seg;

  // The block's items, in order: k = 0 .. per_lane - 1 of tile blockIdx.x,
  // then of tile blockIdx.x + gridDim.x, ...  Block-uniform, so every lane
  // of a warp reaches the row-end shuffles together.
  long long tile = blockIdx.x;
  int k = 0;
  Item<VEC> next;
  if (tile < tiles) fetch(next, heard, pulled, pushed, tile * rows_per_tile + tile_row, lane, n, w);
  uint32_t acc = 0;
  int cnt = 0;
  while (tile < tiles) {
    const Item<VEC> cur = next;
    const long long row = tile * rows_per_tile + tile_row;
    const bool row_end = k == per_lane - 1;
    if (row_end) {
      k = 0;
      tile += gridDim.x;
    } else {
      ++k;
    }
    // the next item's loads go out before this item's work
    if (tile < tiles) {
      fetch(next, heard, pulled, pushed, tile * rows_per_tile + tile_row, k * seg + lane, n, w);
    }
    if (cur.valid) {
      uint32_t nw[VEC];
#pragma unroll
      for (int j = 0; j < VEC; ++j) nw[j] = cur.h[j] | cur.pl[j] | cur.ps[j];
      store_words(o_new + cur.off, nw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        uint32_t diff = nw[j] ^ cur.h[j];
        cnt += __popc(diff);
        const uint32_t* word_tbl = tbl + (cur.word + j) * 32;
        while (diff) {
          acc += word_tbl[__ffs(diff) - 1];
          diff &= diff - 1;
        }
      }
    }
    if (row_end) {
      for (int off = seg / 2; off > 0; off /= 2) {
        acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
        cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
      }
      if (lane == 0 && row < n) {
        o_acc[row] = acc;
        if (o_cnt) o_cnt[row] = cnt;
      }
      acc = 0;
      cnt = 0;
    }
  }
}

struct Args {
  const uint32_t *heard, *pulled, *pushed, *delta;
  uint32_t *o_new, *o_acc;
  int32_t* o_cnt;
};

template <int VEC>
cudaError_t launch(const Args& a, int n, int w, int seg, int blocks, bool smem_table, int b,
                   int delta_stride, cudaStream_t s) {
  const dim3 grid(blocks, b);
  if (smem_table) {
    const size_t bytes = static_cast<size_t>(w) * 32 * sizeof(uint32_t);
    if (bytes > DEFAULT_SMEM) {
      const cudaError_t e = cudaFuncSetAttribute(
          exchange_kernel<VEC, true>, cudaFuncAttributeMaxDynamicSharedMemorySize,
          SMEM_TABLE_MAX * static_cast<int>(sizeof(uint32_t)));
      if (e != cudaSuccess) return e;
    }
    exchange_kernel<VEC, true><<<grid, THREADS, bytes, s>>>(
        a.heard, a.pulled, a.pushed, a.delta, a.o_new, a.o_acc, a.o_cnt, n, w, seg,
        delta_stride);
  } else {
    exchange_kernel<VEC, false><<<grid, THREADS, 0, s>>>(
        a.heard, a.pulled, a.pushed, a.delta, a.o_new, a.o_acc, a.o_cnt, n, w, seg,
        delta_stride);
  }
  return cudaGetLastError();
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// vec, seg and blocks come from ops/exchange.py `exchange_plan`; a plan the
// kernel cannot run is refused with cudaErrorInvalidValue.  b: the clusters
// stacked on the planes' leading axis (1 for one [N, W] mask); delta_stride:
// the words between two clusters' tables (0: one table for all).
RINGPOP_EXPORT int ringpop_exchange(void** p, int n, int w, int vec, int seg, int blocks,
                                    int smem_table, int b, int delta_stride, void* stream) {
  if (n <= 0 || w <= 0 || b <= 0) return 0;
  if (b > 65535 || delta_stride < 0) return static_cast<int>(cudaErrorInvalidValue);
  const Args a{
      static_cast<const uint32_t*>(p[IN_HEARD]), static_cast<const uint32_t*>(p[IN_PULLED]),
      static_cast<const uint32_t*>(p[IN_PUSHED]), static_cast<const uint32_t*>(p[IN_DELTA]),
      static_cast<uint32_t*>(p[OUT_NEW]), static_cast<uint32_t*>(p[OUT_ACC]),
      static_cast<int32_t*>(p[OUT_CNT])};
  const bool seg_ok = seg >= 1 && seg <= 32 && (seg & (seg - 1)) == 0;
  if (!seg_ok || blocks <= 0 || (smem_table && w > SMEM_TABLE_MAX / 32)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (vec == 4) {
    if (w % 4 || !aligned16(a.heard) || !aligned16(a.pulled) || !aligned16(a.pushed) ||
        !aligned16(a.o_new)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return static_cast<int>(launch<4>(a, n, w, seg, blocks, smem_table != 0, b, delta_stride, s));
  }
  if (vec != 1) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(launch<1>(a, n, w, seg, blocks, smem_table != 0, b, delta_stride, s));
}

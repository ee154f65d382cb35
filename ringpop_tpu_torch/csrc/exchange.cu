// Fused push-pull exchange of the scalable engine over the [N, W] uint32
// heard bitmask (W = U/32 words per row).
//
// Replaces the TPU kernel ringpop_tpu/ops/exchange.py `_exchange_kernel`
// (run by `_exchange_pallas`): new = heard | pulled | pushed;
// diff = new ^ heard; per row, the sum mod 2^32 of r_delta[b] over the set
// bits b of diff, and optionally popcount(diff).
//
// Bound on an H100: bytes.  At the 1M-node storm shape (N = 1,000,000,
// W = 16) three 64 MB mask planes are read and one written, plus the [N]
// outputs: 264 MB, about 0.079 ms at 3.35 TB/s; a handful of integer
// operations per word and one add per new bit are far below the operation
// bound.  Design: a segment of S threads per row, S = W when W is a power
// of two <= 32 (each thread owns one word: coalesced 4-byte accesses, a
// row's segment sits inside one warp) and S = 32 otherwise (a warp per row,
// lanes striding over the words).  Each block stages the [U] delta table in
// shared memory once (2 KB at U = 512; tables over 48 KB are read from
// global memory instead).  A thread walks only the set bits of its diff
// word with __ffs, and the segment sums its partials with xor shuffles
// (wrapping uint32 adds, so any order gives the same exact sum).  No
// [8 x 128] tiling and no lane-broadcast delta table, so any W works.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int SMEM_TABLE_MAX = 48 * 1024 / 4;  // uint32 entries

enum : int {
  IN_HEARD, IN_PULLED, IN_PUSHED, IN_DELTA,
  OUT_NEW, OUT_ACC, OUT_CNT,
  N_PTRS
};

template <bool SMEM>
__global__ void __launch_bounds__(THREADS)
exchange_kernel(const uint32_t* __restrict__ heard,
                const uint32_t* __restrict__ pulled,
                const uint32_t* __restrict__ pushed,
                const uint32_t* __restrict__ r_delta,
                uint32_t* __restrict__ o_new, uint32_t* __restrict__ o_acc,
                int32_t* __restrict__ o_cnt, int n, int w, int seg) {
  extern __shared__ uint32_t s_delta[];
  const uint32_t* tbl = r_delta;
  if (SMEM) {
    const int u = w * 32;
    for (int i = threadIdx.x; i < u; i += THREADS) s_delta[i] = r_delta[i];
    __syncthreads();
    tbl = s_delta;
  }
  const int rows_per_block = THREADS / seg;
  const int lane = threadIdx.x % seg;
  const long long row =
      static_cast<long long>(blockIdx.x) * rows_per_block + threadIdx.x / seg;
  uint32_t acc = 0;
  int cnt = 0;
  if (row < n) {
    const size_t base = static_cast<size_t>(row) * w;
    for (int word = lane; word < w; word += seg) {
      const size_t i = base + word;
      const uint32_t h = heard[i];
      const uint32_t nw = h | pulled[i] | pushed[i];
      uint32_t diff = nw ^ h;
      o_new[i] = nw;
      cnt += __popc(diff);
      const uint32_t* row_tbl = tbl + word * 32;
      while (diff) {
        acc += row_tbl[__ffs(diff) - 1];
        diff &= diff - 1;
      }
    }
  }
  // every lane of the warp takes part in the shuffles (seg divides 32)
  for (int off = seg / 2; off > 0; off /= 2) {
    acc += __shfl_xor_sync(0xFFFFFFFFu, acc, off);
    cnt += __shfl_xor_sync(0xFFFFFFFFu, cnt, off);
  }
  if (row < n && lane == 0) {
    o_acc[row] = acc;
    if (o_cnt) o_cnt[row] = cnt;
  }
}

int segment_width(int w) {
  const bool pow2 = (w & (w - 1)) == 0;
  return (pow2 && w <= 32) ? w : 32;
}

}  // namespace

RINGPOP_EXPORT int ringpop_exchange(void** p, int n, int w, void* stream) {
  if (n <= 0 || w <= 0) return 0;
  const int seg = segment_width(w);
  const int rows_per_block = THREADS / seg;
  const long long blocks = (static_cast<long long>(n) + rows_per_block - 1) / rows_per_block;
  const int u = w * 32;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto heard = static_cast<const uint32_t*>(p[IN_HEARD]);
  const auto pulled = static_cast<const uint32_t*>(p[IN_PULLED]);
  const auto pushed = static_cast<const uint32_t*>(p[IN_PUSHED]);
  const auto delta = static_cast<const uint32_t*>(p[IN_DELTA]);
  const auto o_new = static_cast<uint32_t*>(p[OUT_NEW]);
  const auto o_acc = static_cast<uint32_t*>(p[OUT_ACC]);
  const auto o_cnt = static_cast<int32_t*>(p[OUT_CNT]);
  if (u <= SMEM_TABLE_MAX) {
    exchange_kernel<true><<<static_cast<unsigned>(blocks), THREADS,
                            u * sizeof(uint32_t), s>>>(
        heard, pulled, pushed, delta, o_new, o_acc, o_cnt, n, w, seg);
  } else {
    exchange_kernel<false><<<static_cast<unsigned>(blocks), THREADS, 0, s>>>(
        heard, pulled, pushed, delta, o_new, o_acc, o_cnt, n, w, seg);
  }
  return static_cast<int>(cudaGetLastError());
}

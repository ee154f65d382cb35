// One dissemination piggyback-budget site over the change table's
// [N, N] budget planes.
//
// Replaces the TPU kernel ringpop_tpu/ops/fused_piggyback.py
// `_make_kernel` (run through toolkit.stream_row_tiles' gridless
// pallas_call): on active cells of rows with nbump > 0,
// ch_pb += nbump - hits; cells over the row's max_pb retire; the
// surviving bumped cells form the optional content mask; the per-row drop
// count is returned (the wrapper sums it, as the JAX wrapper does).
//
// Bound on an H100: bytes (about 11 MB at n=1024 with hits and content:
// one int32 and one bool plane in, optional int32 hits, one int32 and two
// bool planes out; a few integer operations per cell).  Design: one block
// per row, threads over columns (coalesced), one __syncthreads_count per
// column sweep for the drops.
//
// The batch axis: B clusters' planes stacked [B, N, N] (with [B, N] bump
// counts and bounds) are B * N rows of one [B * N, N] pass — the grid
// runs over the rows, so one launch serves every cluster and the drops
// come back per row of each cluster.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

enum : int {
  IN_ACTIVE, IN_PB, IN_NBUMP, IN_MAX_PB, IN_HITS,
  OUT_PB, OUT_ACTIVE, OUT_CONTENT, OUT_DROPS,
  N_PTRS
};

__global__ void __launch_bounds__(THREADS)
pb_budget_kernel(const uint8_t* active, const int32_t* pb,
                 const int32_t* nbump, const int32_t* max_pb,
                 const int32_t* hits, int32_t* o_pb, uint8_t* o_active,
                 uint8_t* o_content, int32_t* drops, int n) {
  const int row = blockIdx.x;
  const size_t base = static_cast<size_t>(row) * n;
  const int nb = nbump[row];
  const int mp = max_pb[row];
  const bool has = nb > 0;
  int total = 0;
  for (int c0 = 0; c0 < n; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    bool over = false;
    if (c < n) {
      const size_t i = base + c;
      const bool act = active[i] != 0;
      const int eff = (act && has) ? (hits ? nb - hits[i] : nb) : 0;
      const int p2 = pb[i] + eff;
      over = act && (p2 > mp);
      o_pb[i] = p2;
      o_active[i] = act && !over;
      if (o_content) o_content[i] = act && has && !over;
    }
    total += __syncthreads_count(over);
  }
  if (threadIdx.x == 0) drops[row] = total;
}

}  // namespace

// rows: the rows of the pass (n for one cluster, B * n for B clusters).
RINGPOP_EXPORT int ringpop_pb_budget(void** p, int n, int rows, void* stream) {
  if (n <= 0 || rows <= 0) return 0;
  pb_budget_kernel<<<rows, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p[IN_ACTIVE]),
      static_cast<const int32_t*>(p[IN_PB]),
      static_cast<const int32_t*>(p[IN_NBUMP]),
      static_cast<const int32_t*>(p[IN_MAX_PB]),
      static_cast<const int32_t*>(p[IN_HITS]),
      static_cast<int32_t*>(p[OUT_PB]), static_cast<uint8_t*>(p[OUT_ACTIVE]),
      static_cast<uint8_t*>(p[OUT_CONTENT]),
      static_cast<int32_t*>(p[OUT_DROPS]), n);
  return static_cast<int>(cudaGetLastError());
}

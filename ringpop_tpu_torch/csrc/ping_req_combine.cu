// The ping-req combine, leg 2 (ping_req.cuh): for each answering slot
// (i, k), the arrivals of row i combined into its intermediary m's row by
// a 64-bit atomicMax of (key, inverted slot id), the largest key and the
// lowest slot among ties; then a dense pass writes the apply site's
// update planes and the fill values where nothing arrived.
#include "ping_req.cuh"

using namespace ping_req;

namespace {

enum : int {
  C_SEL, C_RESPONDER, C_ACTIVE, C_PB, C_MAX_PB, C_CH_INC, C_CH_STATUS, C_CH_SOURCE,
  C_CH_SOURCE_INC,
  C_OUT_MASK, C_OUT_STATUS, C_OUT_INC, C_OUT_SOURCE, C_OUT_SOURCE_INC, C_OUT_PRRECV, C_WORDS,
  C_N_PTRS
};

// One block a sender row (b, i): for each answering slot, count it at its
// intermediary m and clear m's combine words (two slots on one m clear
// the same zeros; the scatter runs after every clear).
__global__ void __launch_bounds__(THREADS)
    ping_req_combine_clear_kernel(const long long* __restrict__ sel,
                                  const uint8_t* __restrict__ responder,
                                  int32_t* __restrict__ prrecv,
                                  unsigned long long* __restrict__ words, int n, int k) {
  const long long row = blockIdx.x;
  const long long b = row / n;
  for (int s = 0; s < k; ++s) {
    if (!responder[row * k + s]) continue;
    const long long m = b * n + sel[row * k + s];
    if (threadIdx.x == 0) atomicAdd(&prrecv[m], 1);
    unsigned long long* w = words + m * n;
    for (int j = threadIdx.x; j < n; j += THREADS) w[j] = 0ull;
  }
}

// One block a sender row (b, i): each answering slot s's arrivals (active
// cells within the budget after s + 1 bumps) at its intermediary's row,
// as (key, ~slot) words: the largest key wins, then the lowest slot.
// Keys are never negative (stamps stay below 2^21: engine._pack_key).
__global__ void __launch_bounds__(THREADS)
    ping_req_combine_scatter_kernel(const long long* __restrict__ sel,
                                    const uint8_t* __restrict__ responder,
                                    const uint8_t* __restrict__ active,
                                    const int32_t* __restrict__ pb,
                                    const int32_t* __restrict__ max_pb,
                                    const int32_t* __restrict__ ch_inc,
                                    const int32_t* __restrict__ ch_status,
                                    unsigned long long* __restrict__ words, int n, int k) {
  const long long row = blockIdx.x;
  const long long b = row / n;
  const int i = static_cast<int>(row - b * n);
  const int mp = max_pb[row];
  const long long src = row * n;
  for (int s = 0; s < k; ++s) {
    if (!responder[row * k + s]) continue;
    unsigned long long* w = words + (b * n + sel[row * k + s]) * n;
    const unsigned long long low = 0xFFFFFFFFull - static_cast<uint32_t>(i * k + s);
    for (int j = threadIdx.x; j < n; j += THREADS) {
      if (active[src + j] && pb[src + j] + s + 1 <= mp) {
        const uint32_t key =
            static_cast<uint32_t>(ch_inc[src + j]) * 4u + static_cast<uint32_t>(ch_status[src + j]);
        atomicMax(&w[j], (static_cast<unsigned long long>(key) << 32) | low);
      }
    }
  }
}

// One block a row m of the apply site's update planes: the winning key as
// mask, status and incarnation, the winner's source fields; -1 (and
// INT32_MIN sources) where answering slots reached m but nothing arrived
// in the column, INT32_MIN where no answering slot reached m.
__global__ void __launch_bounds__(THREADS)
    ping_req_combine_fill_kernel(const int32_t* __restrict__ prrecv,
                                 const unsigned long long* __restrict__ words,
                                 const int32_t* __restrict__ ch_source,
                                 const int32_t* __restrict__ ch_source_inc,
                                 uint8_t* __restrict__ o_mask, int32_t* __restrict__ o_status,
                                 int32_t* __restrict__ o_inc, int32_t* __restrict__ o_source,
                                 int32_t* __restrict__ o_source_inc, int n, int k) {
  const long long row = blockIdx.x;
  const long long b = row / n;
  const bool reached = prrecv[row] > 0;
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const long long c = row * n + j;
    int key = INT32_MIN, source = INT32_MIN, source_inc = INT32_MIN;
    if (reached) {
      const unsigned long long w = words[c];
      if (w == 0ull) {
        key = -1;
      } else {
        key = static_cast<int>(w >> 32);
        const uint32_t slot = 0xFFFFFFFFu - static_cast<uint32_t>(w);
        const long long at = (b * n + slot / k) * n + j;
        source = ch_source[at];
        source_inc = ch_source_inc[at];
      }
    }
    o_mask[c] = key >= 0;
    o_status[c] = key & 3;
    o_inc[c] = key >> 2;
    o_source[c] = source;
    o_source_inc[c] = source_inc;
  }
}

}  // namespace

// Clears the arrival counts, then three launches on the stream: the
// clear of the reached rows' words, the scatter, the dense fill.
RINGPOP_EXPORT int ringpop_ping_req_combine(void** p, int b, int n, int k, void* stream) {
  if (!shapes_ok(b, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b * n;
  const auto* sel = static_cast<const long long*>(p[C_SEL]);
  const auto* responder = static_cast<const uint8_t*>(p[C_RESPONDER]);
  auto* prrecv = static_cast<int32_t*>(p[C_OUT_PRRECV]);
  auto* words = static_cast<unsigned long long*>(p[C_WORDS]);
  cudaError_t err = cudaMemsetAsync(prrecv, 0, sizeof(int32_t) * rows, st);
  if (err != cudaSuccess) return static_cast<int>(err);
  ping_req_combine_clear_kernel<<<rows, THREADS, 0, st>>>(sel, responder, prrecv, words, n, k);
  ping_req_combine_scatter_kernel<<<rows, THREADS, 0, st>>>(
      sel, responder, static_cast<const uint8_t*>(p[C_ACTIVE]),
      static_cast<const int32_t*>(p[C_PB]), static_cast<const int32_t*>(p[C_MAX_PB]),
      static_cast<const int32_t*>(p[C_CH_INC]), static_cast<const int32_t*>(p[C_CH_STATUS]),
      words, n, k);
  ping_req_combine_fill_kernel<<<rows, THREADS, 0, st>>>(
      prrecv, words, static_cast<const int32_t*>(p[C_CH_SOURCE]),
      static_cast<const int32_t*>(p[C_CH_SOURCE_INC]), static_cast<uint8_t*>(p[C_OUT_MASK]),
      static_cast<int32_t*>(p[C_OUT_STATUS]), static_cast<int32_t*>(p[C_OUT_INC]),
      static_cast<int32_t*>(p[C_OUT_SOURCE]), static_cast<int32_t*>(p[C_OUT_SOURCE_INC]), n, k);
  return static_cast<int>(cudaGetLastError());
}

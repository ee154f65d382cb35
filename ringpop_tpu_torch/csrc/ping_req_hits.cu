// The ping-req hits, leg 3's origin filter (ping_req.cuh): per cell of an
// intermediary's row, the answering slots of the cell's source that
// reached that intermediary, read from the source's K slots.
#include "ping_req.cuh"

using namespace ping_req;

namespace {

enum : int {
  H_SEL, H_RESPONDER, H_ACTIVE, H_CH_SOURCE, H_CH_SOURCE_INC, H_SELF_INC, H_OUT_HITS, H_N_PTRS
};

// One block a row m: an active cell's count is the answering slots of its
// source (the cell's origin, at its own incarnation) whose intermediary is
// m, read from the source's K slots.
__global__ void __launch_bounds__(THREADS)
    ping_req_hits_kernel(const long long* __restrict__ sel, const uint8_t* __restrict__ responder,
                         const uint8_t* __restrict__ active, const int32_t* __restrict__ ch_source,
                         const int32_t* __restrict__ ch_source_inc,
                         const int32_t* __restrict__ self_inc, int32_t* __restrict__ hits, int n,
                         int k) {
  const long long row = blockIdx.x;
  const long long b = row / n;
  const int m = static_cast<int>(row - b * n);
  for (int j = threadIdx.x; j < n; j += THREADS) {
    const long long c = row * n + j;
    int h = 0;
    if (active[c]) {
      const int source = ch_source[c];
      const long long sc = b * n + min(source, n - 1);
      if (source >= 0 && ch_source_inc[c] == self_inc[sc]) {
        for (int s = 0; s < k; ++s) h += responder[sc * k + s] && sel[sc * k + s] == m;
      }
    }
    hits[c] = h;
  }
}

}  // namespace

RINGPOP_EXPORT int ringpop_ping_req_hits(void** p, int b, int n, int k, void* stream) {
  if (!shapes_ok(b, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  ping_req_hits_kernel<<<b * n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const long long*>(p[H_SEL]), static_cast<const uint8_t*>(p[H_RESPONDER]),
      static_cast<const uint8_t*>(p[H_ACTIVE]),
      static_cast<const int32_t*>(p[H_CH_SOURCE]), static_cast<const int32_t*>(p[H_CH_SOURCE_INC]),
      static_cast<const int32_t*>(p[H_SELF_INC]), static_cast<int32_t*>(p[H_OUT_HITS]), n, k);
  return static_cast<int>(cudaGetLastError());
}

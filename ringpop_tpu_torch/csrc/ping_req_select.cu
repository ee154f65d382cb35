// The ping-req select (ping_req.cuh): one warp a row, the salt-29 uniform
// of every pingable column but the target, the K smallest (score, column)
// keys in registers, merged across the warp: argsort(stable)[:, :K].  A
// pass of the row keeps CHUNK keys a lane; K above that takes more
// passes, each keeping the next CHUNK keys above the last one taken.
#include "ping_req.cuh"

using namespace ping_req;

namespace {

constexpr uint32_t SELECT_SALT = 29;
constexpr int CHUNK = 8;

// The engine's counter uniform (`_uniform`, salt 29) of column j of a row
// whose key word is `base`: the uint32 hash rounded to float32 to nearest
// and scaled by 2^-32 (exact).
__device__ __forceinline__ float select_uniform(uint32_t base, uint32_t j) {
  uint32_t x = base + j * 0x01000193u + SELECT_SALT;
  x ^= x >> 15;
  x *= 0x2C1B3C6Du;
  x ^= x >> 12;
  x *= 0x297A2D39u;
  x ^= x >> 15;
  return __uint2float_rn(x) * 0x1p-32f;
}

enum : int { S_PINGABLE, S_TARGET, S_NEED, S_RNG, S_OUT_SEL, S_OUT_VALID, S_N_PTRS };

// A row's key of column j: the score's float bits (scores are >= 0, so
// their bits order as they do) over the column, so the smallest keys are
// the smallest scores, lower column first among ties.
__global__ void __launch_bounds__(THREADS)
    ping_req_select_kernel(const uint8_t* __restrict__ pingable,
                           const int32_t* __restrict__ target, const uint8_t* __restrict__ need,
                           const uint32_t* __restrict__ rng, long long* __restrict__ sel,
                           uint8_t* __restrict__ valid, int rows, int n, int k) {
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(blockIdx.x) * WARPS + (threadIdx.x >> 5);
  if (row >= rows) return;
  long long* out = sel + row * k;
  uint8_t* vout = valid + row * k;
  if (!need[row]) {
    // every score is 2.0: the first K columns, none valid
    for (int r = lane; r < k; r += 32) {
      out[r] = r;
      vout[r] = 0;
    }
    return;
  }
  const uint8_t* p = pingable + row * n;
  const int t = target[row];
  const uint32_t base = rng[2 * row];
  const uint32_t off_bits = __float_as_uint(2.0f);
  const uint32_t valid_below = __float_as_uint(1.5f);
  unsigned long long last = 0ull;  // the largest key taken so far
  for (int done = 0; done < k; done += CHUNK) {
    const int take = min(CHUNK, k - done);
    unsigned long long best[CHUNK];
#pragma unroll
    for (int i = 0; i < CHUNK; ++i) best[i] = ~0ull;
    for (int j = lane; j < n; j += 32) {
      const uint32_t bits =
          (p[j] && j != t) ? __float_as_uint(select_uniform(base, j)) : off_bits;
      unsigned long long key =
          (static_cast<unsigned long long>(bits) << 32) | static_cast<uint32_t>(j);
      if (done > 0 && key <= last) continue;
#pragma unroll
      for (int i = 0; i < CHUNK; ++i) {
        if (i < take && key < best[i]) {
          const unsigned long long tmp = best[i];
          best[i] = key;
          key = tmp;
        }
      }
    }
    // `take` rounds of a warp minimum over the lanes' smallest keys; the
    // lane holding it (keys are distinct: one column each) moves to its
    // next.  Every lane ends with the last key taken.
    for (int r = 0; r < take; ++r) {
      unsigned long long m = best[0];
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        const unsigned long long other = __shfl_xor_sync(0xffffffffu, m, o);
        m = other < m ? other : m;
      }
      if (best[0] == m) {
#pragma unroll
        for (int i = 0; i < CHUNK - 1; ++i) best[i] = best[i + 1];
        best[CHUNK - 1] = ~0ull;
      }
      if (lane == 0) {
        out[done + r] = static_cast<long long>(static_cast<uint32_t>(m));
        vout[done + r] = static_cast<uint32_t>(m >> 32) < valid_below;
      }
      last = m;
    }
  }
}

}  // namespace

// rows: the rows of every cluster (b * n), each of n columns.
RINGPOP_EXPORT int ringpop_ping_req_select(void** p, int rows, int n, int k, void* stream) {
  if (rows <= 0) return 0;
  if (!shapes_ok(1, n, k) || rows > INT32_MAX - WARPS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  ping_req_select_kernel<<<(rows + WARPS - 1) / WARPS, THREADS, 0,
                           static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p[S_PINGABLE]), static_cast<const int32_t*>(p[S_TARGET]),
      static_cast<const uint8_t*>(p[S_NEED]), static_cast<const uint32_t*>(p[S_RNG]),
      static_cast<long long*>(p[S_OUT_SEL]), static_cast<uint8_t*>(p[S_OUT_VALID]), rows, n, k);
  return static_cast<int>(cudaGetLastError());
}

// The cycle walk of the scalable engine's partner permutation: each id of
// [0, n) goes through the keyed 4-round Feistel bijection over [0, 4^hb)
// until the value lands back in [0, n).  The same values as
// prp_walk.prp_walk_plain.
//
// Replaces no Pallas kernel.  It stands in for the JAX engine's
// `while_loop` walk, ringpop_tpu/models/sim/engine_scalable.py `_prp_perm`,
// which the port ran as plain PyTorch ops with one host read a step (does
// any value of any row still lie out of range?): about 25 steps a walk at
// n = 100,000 (n / 4^hb = 0.38), two walks a tick, each step some fifty
// launches.  Here every value walks in its own thread, and the whole walk
// is one launch with no read.
//
// Bound on an H100: latency.  A value reads its id (4 B) and writes its
// result (4 B); a step is about 40 integer instructions, and the longest
// walk of a row sets the launch's time.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ROUNDS = 4;

enum : int { IN_IDS, IN_KEYS, OUT_VALUES, N_PTRS };

// The Feistel round function truncated to the half-width.
__device__ __forceinline__ uint32_t feistel_f(uint32_t r, uint32_t k, uint32_t mask) {
  uint32_t x = r * 0x7FEB352Du + k;
  x ^= x >> 15;
  x *= 0x846CA68Bu;
  x ^= x >> 13;
  return x & mask;
}

// One pass of the bijection over [0, 4^hb); `inverse` runs the rounds
// backwards.
__device__ __forceinline__ uint32_t feistel(uint32_t v, const uint32_t (&k)[ROUNDS], int hb,
                                            uint32_t mask, bool inverse) {
  uint32_t left = v >> hb;
  uint32_t right = v & mask;
  if (!inverse) {
#pragma unroll
    for (int r = 0; r < ROUNDS; ++r) {
      const uint32_t t = left ^ feistel_f(right, k[r], mask);
      left = right;
      right = t;
    }
  } else {
#pragma unroll
    for (int r = ROUNDS - 1; r >= 0; --r) {
      const uint32_t t = right ^ feistel_f(left, k[r], mask);
      right = left;
      left = t;
    }
  }
  return (left << hb) | right;
}

// Row b of `rows` walks the m ids with its own key set keys[b, :].
__global__ void __launch_bounds__(THREADS)
    prp_walk_kernel(const uint32_t* __restrict__ ids, const uint32_t* __restrict__ keys,
                    uint32_t* __restrict__ out, int rows, int m, uint32_t n, int hb,
                    bool inverse) {
  const long long cell = static_cast<long long>(blockIdx.x) * THREADS + threadIdx.x;
  if (cell >= static_cast<long long>(rows) * m) return;
  const int b = static_cast<int>(cell / m);
  const int i = static_cast<int>(cell - static_cast<long long>(b) * m);
  uint32_t k[ROUNDS];
#pragma unroll
  for (int r = 0; r < ROUNDS; ++r) k[r] = keys[b * ROUNDS + r];
  const uint32_t mask = (1u << hb) - 1u;
  uint32_t v = ids[i];
  // an id in [0, n) comes back within one cycle of the bijection, at
  // most 4^hb passes
  do {
    v = feistel(v, k, hb, mask, inverse);
  } while (v >= n);
  out[cell] = v;
}

}  // namespace

// rows: the key sets (one output row each), m: the ids, each in [0, n);
// rows * m below 2^31 - 256; n in [1, 4^hb]; hb in [1, 15].  Anything
// else is refused with cudaErrorInvalidValue.
RINGPOP_EXPORT int ringpop_prp_walk(void** p, int rows, int m, int n, int hb, int inverse,
                                    void* stream) {
  if (rows <= 0 || m <= 0) return 0;
  const long long cells = static_cast<long long>(rows) * m;
  if (cells > INT32_MAX - THREADS || hb < 1 || hb > 15 || n < 1 ||
      static_cast<long long>(n) > (1ll << (2 * hb))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int blocks = static_cast<int>((cells - 1) / THREADS + 1);
  prp_walk_kernel<<<blocks, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p[IN_IDS]), static_cast<const uint32_t*>(p[IN_KEYS]),
      static_cast<uint32_t*>(p[OUT_VALUES]), rows, m, static_cast<uint32_t>(n), hb,
      inverse != 0);
  return static_cast<int>(cudaGetLastError());
}

// Where a farmhashmk block-loop round's time goes on the card: loop shapes
// of the first csrc/block_loop.cu (a thread per row) side by side, each
// thread timing its own loop with clock64().  Built and driven by ringpop_tpu_torch/block_loop_probe.py;
// not part of the kernel library.
//
// MODE 0: register prefetch one stage (8 rounds) ahead, a branch per round;
// MODE 1: the same with the round applied by predicated selects;
// MODE 2: the mixing chain alone (round data in registers, no loads);
// MODE 3 / 4: as MODE 1 with the prefetch 2 / 3 stages ahead (3 / 4
//   register buffers);
// MODE 5 / 6: predicated, each thread's words staged through shared memory
//   by cp.async, 3 / 5 stages ahead.
#include "../common.cuh"

namespace {

using namespace ringpop;

constexpr int THREADS = 32;
constexpr int STAGE = 8;
constexpr int WORDS = 5 * STAGE;

__device__ __forceinline__ void round5(uint32_t a, uint32_t b, uint32_t c, uint32_t d, uint32_t e,
                                       uint32_t& h, uint32_t& g, uint32_t& f) {
  uint32_t nh = h + a, ng = g + b, nf = f + c;
  nh = mur(d, nh) + e;
  ng = mur(c, ng) + a;
  nf = mur(b + e * C1, nf) + d;
  nf = nf + ng;
  ng = ng + nf;
  h = nh;
  g = ng;
  f = nf;
}

__device__ __forceinline__ void fetch(uint32_t (&buf)[WORDS], const uint32_t* row, int s, int n) {
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    const bool live = s + r < n;
    const uint32_t* p = row + 5 * (s + r);
#pragma unroll
    for (int k = 0; k < 5; ++k) buf[5 * r + k] = live ? __ldg(p + k) : 0u;
  }
}

template <bool BRANCH>
__device__ __forceinline__ void mix(const uint32_t (&buf)[WORDS], int s, int n, uint32_t& h,
                                    uint32_t& g, uint32_t& f) {
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    if (BRANCH) {
      if (s + r < n) round5(buf[5 * r], buf[5 * r + 1], buf[5 * r + 2], buf[5 * r + 3], buf[5 * r + 4], h, g, f);
    } else {
      uint32_t h2 = h, g2 = g, f2 = f;
      round5(buf[5 * r], buf[5 * r + 1], buf[5 * r + 2], buf[5 * r + 3], buf[5 * r + 4], h2, g2, f2);
      const bool on = s + r < n;
      h = on ? h2 : h;
      g = on ? g2 : g;
      f = on ? f2 : f;
    }
  }
}

template <int NBUF, bool BRANCH>
__device__ __forceinline__ void reg_loop(const uint32_t* row, int n, uint32_t& h, uint32_t& g,
                                         uint32_t& f) {
  uint32_t buf[NBUF][WORDS];
#pragma unroll
  for (int q = 0; q < NBUF - 1; ++q) fetch(buf[q], row, q * STAGE, n);
  for (int s = 0; s < n; s += NBUF * STAGE) {
#pragma unroll
    for (int q = 0; q < NBUF; ++q) {
      fetch(buf[(q + NBUF - 1) % NBUF], row, s + (q + NBUF - 1) * STAGE, n);
      mix<BRANCH>(buf[q], s + q * STAGE, n, h, g, f);
    }
  }
}

__device__ __forceinline__ void copy4(uint32_t* dst, const uint32_t* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
}

// ring[slot][word][lane]: a thread's words are THREADS apart (conflict-free)
template <int R>
__device__ __forceinline__ void issue(uint32_t* ring, const uint32_t* row, int st, int n, int lane) {
  const int s = st * STAGE;
  uint32_t* dst = ring + (st % R) * WORDS * THREADS + lane;
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    if (s + r < n) {
#pragma unroll
      for (int k = 0; k < 5; ++k) copy4(dst + (5 * r + k) * THREADS, row + 5 * (s + r) + k);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int R>
__device__ __forceinline__ void smem_loop(uint32_t* ring, const uint32_t* row, int n, int lane,
                                          uint32_t& h, uint32_t& g, uint32_t& f) {
#pragma unroll
  for (int q = 0; q < R - 1; ++q) issue<R>(ring, row, q, n, lane);
  for (int st = 0; st * STAGE < n; ++st) {
    issue<R>(ring, row, st + R - 1, n, lane);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(R - 1));
    const uint32_t* src = ring + (st % R) * WORDS * THREADS + lane;
    const int s = st * STAGE;
#pragma unroll
    for (int r = 0; r < STAGE; ++r) {
      uint32_t h2 = h, g2 = g, f2 = f;
      round5(src[(5 * r) * THREADS], src[(5 * r + 1) * THREADS], src[(5 * r + 2) * THREADS],
             src[(5 * r + 3) * THREADS], src[(5 * r + 4) * THREADS], h2, g2, f2);
      const bool on = s + r < n;
      h = on ? h2 : h;
      g = on ? g2 : g;
      f = on ? f2 : f;
    }
  }
}

template <int MODE>
__global__ void __launch_bounds__(THREADS)
rounds_kernel(const uint32_t* h0, const uint32_t* g0, const uint32_t* f0, const uint32_t* blocks,
              const int32_t* iters, uint32_t* oh, uint32_t* og, uint32_t* of, long long* cycles,
              int B, int I, int row_stride) {
  constexpr int R = MODE == 5 ? 4 : 6;
  __shared__ uint32_t ring[(MODE >= 5 ? R : 1) * WORDS * THREADS];
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  uint32_t h = h0[b], g = g0[b], f = f0[b];
  const int it = iters[b];
  const int n = it < 0 ? 0 : (it > I ? I : it);
  const uint32_t* row = blocks + static_cast<size_t>(b) * row_stride;
  const long long t0 = clock64();
  if (MODE == 0) reg_loop<2, true>(row, n, h, g, f);
  if (MODE == 1) reg_loop<2, false>(row, n, h, g, f);
  if (MODE == 2) {
    uint32_t a = h ^ 0x1234u, bb = g ^ 0x5678u, c = f, d = a * 3u, e = bb * 7u;
    for (int i = 0; i < n; ++i) {
      round5(a, bb, c, d, e, h, g, f);
      a += 1u;
    }
  }
  if (MODE == 3) reg_loop<3, false>(row, n, h, g, f);
  if (MODE == 4) reg_loop<4, false>(row, n, h, g, f);
  if (MODE >= 5) smem_loop<R>(ring, row, n, threadIdx.x, h, g, f);
  cycles[b] = clock64() - t0;
  oh[b] = h;
  og[b] = g;
  of[b] = f;
}

template <int MODE>
void launch(void** p, int B, int I, int row_stride, cudaStream_t s) {
  rounds_kernel<MODE><<<(B + THREADS - 1) / THREADS, THREADS, 0, s>>>(
      static_cast<const uint32_t*>(p[0]), static_cast<const uint32_t*>(p[1]),
      static_cast<const uint32_t*>(p[2]), static_cast<const uint32_t*>(p[3]),
      static_cast<const int32_t*>(p[4]), static_cast<uint32_t*>(p[5]),
      static_cast<uint32_t*>(p[6]), static_cast<uint32_t*>(p[7]),
      static_cast<long long*>(p[8]), B, I, row_stride);
}

}  // namespace

// p: h0, g0, f0, blocks, iters, h, g, f, cycles [B] int64
RINGPOP_EXPORT int ringpop_block_loop_rounds(int mode, void** p, int B, int I, int row_stride,
                                             void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case 0: launch<0>(p, B, I, row_stride, s); break;
    case 1: launch<1>(p, B, I, row_stride, s); break;
    case 2: launch<2>(p, B, I, row_stride, s); break;
    case 3: launch<3>(p, B, I, row_stride, s); break;
    case 4: launch<4>(p, B, I, row_stride, s); break;
    case 5: launch<5>(p, B, I, row_stride, s); break;
    case 6: launch<6>(p, B, I, row_stride, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

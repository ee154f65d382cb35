// The farmhashmk long-string block loop: one mixing round per 20-byte
// block, carried through (h, g, f), applied while i < iters[row].
//
// Replaces the TPU kernels ringpop_tpu/ops/pallas_farmhash.py `_kernel`
// (pallas_call in `block_loop`) and `_nogrid_kernel` (pallas_call in
// `block_loop_nogrid`): one kernel for both.  The TPU tiles rows [8 x 128]
// and walks the block axis as a sequential grid dimension (or, gridless,
// as an outer scan of VMEM slabs) with every row masked up to the longest;
// here each thread owns one row and loops to its own trip count.  The same
// arithmetic as block_loop.block_loop_plain, every op mod 2^32.
//
// Bound on an H100: by bytes, the blocks the rows use are read once
// (20 bytes a round: about 35 MB at B = 1024 rows of 1689 rounds, about
// 10 us at 3.35 TB/s).  By latency, a row's rounds are one dependent
// chain: in the SASS the carry path g -> g of a round is 8 dependent
// integer ops (IADD, LOP3, SHF, IMAD, VIADD, IADD3, IMAD, IMAD.IADD), 32
// cycles at 4 each (the chain alone measures 30.6 cycles a round,
// ringpop_tpu_torch/block_loop_probe.py mode 2), so about 1700 rounds take
// about 27 us at 1.98 GHz whatever the card's width.  The chain binds.
// A load issued right before its round would add a device-memory latency
// (hundreds of cycles) to every round, so each thread keeps the next
// STAGE rounds' 5 * STAGE words in flight in registers while it mixes the
// current ones (two register buffers, swapped by unrolling the stage loop
// twice).  A round is applied by predicated selects, not a branch: with a
// branch per round the loop took 259 cycles a round, with selects 131
// (the probe, modes 0 and 1, B = 1024).  What remains above the chain is
// the five loads of a round, which never coalesce (rows are about 36 KB
// apart, so each warp load touches 32 sectors); prefetching further ahead
// does not remove it (probe modes 3-6).  Blocks of 32 threads
// spread the few rows (B = 256 on a gated chunk) over as many SMs as
// possible.
#include "common.cuh"

namespace {

using namespace ringpop;

constexpr int THREADS = 32;
constexpr int STAGE = 8;  // rounds per prefetch stage
constexpr int WORDS = 5 * STAGE;

enum : int {
  IN_H0, IN_G0, IN_F0, IN_BLOCKS, IN_ITERS,
  OUT_H, OUT_G, OUT_F,
  N_PTRS
};

// The words of rounds [s, s + STAGE) that the row runs (n rounds in all).
__device__ __forceinline__ void fetch(uint32_t (&buf)[WORDS], const uint32_t* row,
                                      int s, int n) {
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    const bool live = s + r < n;
    const uint32_t* p = row + 5 * (s + r);
#pragma unroll
    for (int k = 0; k < 5; ++k) buf[5 * r + k] = live ? __ldg(p + k) : 0u;
  }
}

// Mix rounds [s, s + STAGE) of the row, those below n (selected, not
// branched: see above).
__device__ __forceinline__ void mix(const uint32_t (&buf)[WORDS], int s, int n,
                                    uint32_t& h, uint32_t& g, uint32_t& f) {
#pragma unroll
  for (int r = 0; r < STAGE; ++r) {
    const uint32_t a = buf[5 * r], b = buf[5 * r + 1], c = buf[5 * r + 2],
                   d = buf[5 * r + 3], e = buf[5 * r + 4];
    uint32_t nh = h + a;
    uint32_t ng = g + b;
    uint32_t nf = f + c;
    nh = mur(d, nh) + e;
    ng = mur(c, ng) + a;
    nf = mur(b + e * C1, nf) + d;
    nf = nf + ng;
    ng = ng + nf;
    const bool on = s + r < n;
    h = on ? nh : h;
    g = on ? ng : g;
    f = on ? nf : f;
  }
}

__global__ void __launch_bounds__(THREADS)
block_loop_kernel(const uint32_t* h0, const uint32_t* g0, const uint32_t* f0,
                  const uint32_t* blocks, const int32_t* iters, uint32_t* oh,
                  uint32_t* og, uint32_t* of, int B, int I, int row_stride) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= B) return;
  uint32_t h = h0[b], g = g0[b], f = f0[b];
  const int it = iters[b];
  const int n = it < 0 ? 0 : (it > I ? I : it);
  const uint32_t* row = blocks + static_cast<size_t>(b) * row_stride;
  uint32_t buf0[WORDS], buf1[WORDS];
  fetch(buf0, row, 0, n);
  for (int s = 0; s < n; s += 2 * STAGE) {
    fetch(buf1, row, s + STAGE, n);
    mix(buf0, s, n, h, g, f);
    fetch(buf0, row, s + 2 * STAGE, n);
    mix(buf1, s + STAGE, n, h, g, f);
  }
  oh[b] = h;
  og[b] = g;
  of[b] = f;
}

}  // namespace

// p: h0, g0, f0 [B]; blocks [B, I, 5] with rows row_stride words apart;
// iters [B]; outputs h, g, f [B].
RINGPOP_EXPORT int ringpop_block_loop(void** p, int B, int I, int row_stride, void* stream) {
  if (B <= 0) return 0;
  if (I < 0 || (B > 1 && row_stride < 5 * I)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + THREADS - 1) / THREADS;
  block_loop_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p[IN_H0]), static_cast<const uint32_t*>(p[IN_G0]),
      static_cast<const uint32_t*>(p[IN_F0]), static_cast<const uint32_t*>(p[IN_BLOCKS]),
      static_cast<const int32_t*>(p[IN_ITERS]), static_cast<uint32_t*>(p[OUT_H]),
      static_cast<uint32_t*>(p[OUT_G]), static_cast<uint32_t*>(p[OUT_F]), B, I, row_stride);
  return static_cast<int>(cudaGetLastError());
}

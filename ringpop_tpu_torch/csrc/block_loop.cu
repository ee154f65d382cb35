// The farmhashmk long-string block loop: one mixing round per 20-byte
// block, carried through (h, g, f), applied while i < iters[row].
//
// Replaces the TPU kernels ringpop_tpu/ops/pallas_farmhash.py `_kernel`
// (pallas_call in `block_loop`) and `_nogrid_kernel` (pallas_call in
// `block_loop_nogrid`): one kernel for both.  The TPU tiles rows [8 x 128]
// and walks the block axis as a sequential grid dimension (or, gridless,
// as an outer scan of VMEM slabs) with every row masked up to the longest;
// here a half-warp owns a row and loops to its own trip count.  The same
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
// The first kernel gave each thread a row: its five loads a round never
// coalesced (rows are about 36 KB apart, so each warp load touched 32
// sectors) and cost about 100 cycles a round beyond the chain
// (block_loop_probe.py).  Design: a 16-lane half-warp owns a row (2 rows a
// warp, 8 a block), so about one warp sits on each scheduler at B = 1024
// and the ~36 instructions of a round serve both rows.  The half-warp
// walks its row 32 rounds at a time: its lanes load the 160 words of the
// next 32 blocks, coalesced, into registers one chunk ahead (the loads fly
// while the chain runs), store them to the row's shared buffer, and the
// warp mixes the chunk from there (common.cuh mix_blocks: 16-byte shared
// loads four rounds ahead, rounds past a row's count dropped by a
// select).
#include "common.cuh"

namespace {

using namespace ringpop;

constexpr int GROUP = 16;                 // lanes per row
constexpr int WARPS = 4;                  // warps per block
constexpr int ROWS = WARPS * 32 / GROUP;  // rows per block
constexpr int CHUNK = 32;                 // rounds per staged chunk
constexpr int PER_LANE = 5 * CHUNK / GROUP;
constexpr unsigned FULL = 0xffffffffu;

enum : int {
  IN_H0, IN_G0, IN_F0, IN_BLOCKS, IN_ITERS,
  OUT_H, OUT_G, OUT_F,
  N_PTRS
};

// Lane j's words of rounds [s, s + CHUNK) of a row of n rounds: words
// j + 16 * t of the chunk (zero past the row's last round).
__device__ __forceinline__ void fetch(uint32_t (&w)[PER_LANE], const uint32_t* row, int s,
                                      int n, int j) {
  const int count = 5 * max(0, min(CHUNK, n - s));
  const uint32_t* p = row + 5 * static_cast<size_t>(s);
#pragma unroll
  for (int t = 0; t < PER_LANE; ++t) {
    const int k = j + GROUP * t;
    w[t] = k < count ? __ldg(p + k) : 0u;
  }
}

__global__ void __launch_bounds__(WARPS * 32)
block_loop_kernel(const uint32_t* h0, const uint32_t* g0, const uint32_t* f0,
                  const uint32_t* blocks, const int32_t* iters, uint32_t* oh,
                  uint32_t* og, uint32_t* of, int B, int I, int row_stride) {
  // one chunk and the words mix_blocks reads past its last block (a
  // multiple of 4 words: every row's buffer stays 16-byte aligned)
  __shared__ __align__(16) uint32_t sbuf[ROWS][5 * CHUNK + 5 * MIX_STAGE + 16];
  const int j = threadIdx.x & (GROUP - 1);
  const int slot = threadIdx.x / GROUP;
  const int b = blockIdx.x * ROWS + slot;
  uint32_t h = 0u, g = 0u, f = 0u;
  int n = 0;
  if (b < B) {
    h = h0[b];
    g = g0[b];
    f = f0[b];
    const int it = iters[b];
    n = it < 0 ? 0 : (it > I ? I : it);
  }
  // the warp walks to the longer of its two rows
  const int nmax = max(n, __shfl_xor_sync(FULL, n, GROUP));
  const uint32_t* row = blocks + static_cast<size_t>(b < B ? b : 0) * row_stride;
  uint32_t* buf = sbuf[slot];
  uint32_t next[PER_LANE];
  fetch(next, row, 0, n, j);
  for (int s = 0; s < nmax; s += CHUNK) {
#pragma unroll
    for (int t = 0; t < PER_LANE; ++t) buf[j + GROUP * t] = next[t];
    __syncwarp();
    fetch(next, row, s + CHUNK, n, j);
    const int k = max(0, min(CHUNK, n - s));
    mix_blocks(h, g, f, buf, k, min(CHUNK, nmax - s));
    __syncwarp();
  }
  if (b < B && j == 0) {
    oh[b] = h;
    og[b] = g;
    of[b] = f;
  }
}

}  // namespace

// p: h0, g0, f0 [B]; blocks [B, I, 5] with rows row_stride words apart;
// iters [B]; outputs h, g, f [B].
RINGPOP_EXPORT int ringpop_block_loop(void** p, int B, int I, int row_stride, void* stream) {
  if (B <= 0) return 0;
  if (I < 0 || (B > 1 && row_stride < 5 * I)) return static_cast<int>(cudaErrorInvalidValue);
  const int grid = (B + ROWS - 1) / ROWS;
  block_loop_kernel<<<grid, WARPS * 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(p[IN_H0]), static_cast<const uint32_t*>(p[IN_G0]),
      static_cast<const uint32_t*>(p[IN_F0]), static_cast<const uint32_t*>(p[IN_BLOCKS]),
      static_cast<const int32_t*>(p[IN_ITERS]), static_cast<uint32_t*>(p[OUT_H]),
      static_cast<uint32_t*>(p[OUT_G]), static_cast<uint32_t*>(p[OUT_F]), B, I, row_stride);
  return static_cast<int>(cudaGetLastError());
}

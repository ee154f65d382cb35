// The fused FarmHash32 stream: each row's member records walked as one
// 20-byte block stream without assembling the checksum string.
//
// Replaces the TPU kernel ringpop_tpu/ops/pallas_farmhash.py
// `_fused_stream_kernel` (pallas_call in fused_stream_nogrid).  Per row the
// member records, concatenated, form a byte stream; its first
// total_blocks[b] 20-byte blocks go through the farmhashmk mixing round in
// order, and the (h, g, f) carries come back — the same result as
// stream_hash.fused_stream_plain, which appends one record at a time to a
// small residual.
//
// Bound on an H100: the per-row dependency chain.  Every round's carries
// feed the next, so a row of R rounds takes at least R x ~32 cycles (about
// 1689 rounds, 0.027 ms at 1.98 GHz, at n = 1024); by bytes the record
// words are read once (about 38 MB at B = N = 1024, RW = 9, 0.012 ms).
// A round is ~36 warp instructions, so the design keeps about one warp on
// each of the card's 528 schedulers, each warp issuing its own chain:
//   - a 16-lane half-warp owns a row (2 rows a warp, 8 a block: B = 1024
//     rows put one warp on each scheduler), and the chain's instructions
//     serve both rows at once;
//   - the half-warp walks its row 32 members at a time: lane j loads the
//     lengths of members m0 + 2j and m0 + 2j + 1 and a 4-step
//     __shfl_up_sync scan gives each record's byte offset in the window;
//   - the lanes load the window's 32 x RW contiguous record words,
//     coalesced (16 bytes a lane when rows are 16-byte aligned), one
//     window ahead, so the loads fly while the chain runs;
//   - each word is OR-ed into the row's shared byte buffer at
//     carry + offset (a shared atomicOr: neighbouring records share
//     words).  The buffer IS the concatenation, so the residual shifts of
//     the one-record-at-a-time form are gone;
//   - the warp then mixes every complete 20-byte block of each buffer in
//     order (common.cuh mix_blocks: 16-byte shared loads four rounds
//     ahead), and the bytes past the last complete block move to the
//     buffer's head.
// A row stops once total_blocks[b] blocks are mixed: later members cannot
// change the carries.  Record bytes past rec_len are OR-ed in as the plain
// version ORs them (zero for records from the record encoder).  Lengths
// are taken in [0, 4 * RW].
#include "common.cuh"

namespace {

using namespace ringpop;

constexpr int GROUP = 16;                 // lanes per row
constexpr int WARPS = 4;                  // warps per block
constexpr int ROWS = WARPS * 32 / GROUP;  // rows per block
constexpr int WIN = 32;                   // members per window: 2 a lane
constexpr unsigned FULL = 0xffffffffu;

enum : int {
  IN_H0, IN_G0, IN_F0, IN_REC_WORDS, IN_REC_LEN, IN_TOTAL_BLOCKS,
  OUT_H, OUT_G, OUT_F,
  N_PTRS
};

// One window of 32 records in registers: lane j of the row's group holds
// the words 4 * (j + 16 * q) + c of the window (q < QUADS, c < 4) and the
// lengths of records 2j and 2j + 1.
template <int RW>
struct Window {
  static constexpr int QUADS = (8 * RW + GROUP - 1) / GROUP;
  uint32_t w[4 * QUADS];
  int len[2];
};

template <int RW, bool VEC>
__device__ __forceinline__ void load_window(Window<RW>& win, const uint32_t* words,
                                            const int32_t* lens, int m0, int N, int j,
                                            bool act) {
  const int m = m0 + 2 * j;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int l = act && m + r < N ? lens[m + r] : 0;
    win.len[r] = min(max(l, 0), 4 * RW);
  }
  const int count = act ? min(WIN, N - m0) * RW : 0;  // words in this window
  const uint32_t* p = words + static_cast<size_t>(m0) * RW;
#pragma unroll
  for (int q = 0; q < Window<RW>::QUADS; ++q) {
    const int k = 4 * (j + GROUP * q);
    if (VEC) {
      // count is a multiple of 4 on this path, so a quad is whole or absent
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (k < count) v = *reinterpret_cast<const uint4*>(p + k);
      win.w[4 * q] = v.x;
      win.w[4 * q + 1] = v.y;
      win.w[4 * q + 2] = v.z;
      win.w[4 * q + 3] = v.w;
    } else {
#pragma unroll
      for (int c = 0; c < 4; ++c) win.w[4 * q + c] = k + c < count ? p[k + c] : 0u;
    }
  }
}

template <int RW, bool VEC>
__global__ void __launch_bounds__(WARPS * 32)
fused_stream_kernel(const uint32_t* h0, const uint32_t* g0, const uint32_t* f0,
                    const uint32_t* rec_words, const int32_t* rec_len,
                    const int32_t* total_blocks, uint32_t* oh, uint32_t* og,
                    uint32_t* of, int B, int N) {
  // carried bytes (< 20, plus the zero or padding tail of their records)
  // and one window of 32 full-width records: 19 + 128 * RW bytes, at most
  // 5 * avail <= 4 + 32 * RW words of blocks; mix_blocks reads up to 34
  // words past the last block; a multiple of 4 words keeps every row's
  // buffer 16-byte aligned
  constexpr int BUF_W = 40 + 32 * RW;
  __shared__ __align__(16) uint32_t sbuf[ROWS][BUF_W];
  __shared__ int soff[ROWS][WIN];
  const int lane = threadIdx.x & 31;
  const int j = lane & (GROUP - 1);
  const int slot = threadIdx.x / GROUP;
  const int b = blockIdx.x * ROWS + slot;
  const bool valid = b < B;
  uint32_t* buf = sbuf[slot];
  int* offs = soff[slot];
  for (int i = j; i < BUF_W; i += GROUP) buf[i] = 0u;
  uint32_t h = 0u, g = 0u, f = 0u;
  int tb = 0;
  if (valid) {
    h = h0[b];
    g = g0[b];
    f = f0[b];
    tb = total_blocks[b];
  }
  const size_t row = valid ? static_cast<size_t>(b) : 0;
  const uint32_t* words = rec_words + row * N * RW;
  const int32_t* lens = rec_len + row * N;
  int done = 0;   // blocks mixed
  int carry = 0;  // stream bytes at the buffer's head not yet mixed (< 20)
  int ext = 0;    // buffer words that may be non-zero
  bool act = valid && tb > 0;
  Window<RW> next;
  load_window<RW, VEC>(next, words, lens, 0, N, j, act && N > 0);
  __syncwarp();
  for (int m0 = 0; m0 < N; m0 += WIN) {
    act = act && done < tb;
    if (!__any_sync(FULL, act)) break;
    const Window<RW> win = next;
    // each record's byte offset in the window: a scan over the group
    const int pair = win.len[0] + win.len[1];
    int incl = pair;
#pragma unroll
    for (int d = 1; d < GROUP; d <<= 1) {
      const int t = __shfl_up_sync(FULL, incl, d, GROUP);
      if (j >= d) incl += t;
    }
    const int total = __shfl_sync(FULL, incl, GROUP - 1, GROUP);
    offs[2 * j] = incl - pair;
    offs[2 * j + 1] = incl - win.len[1];
    __syncwarp();
    // OR each record word into the byte buffer at carry + offset, without
    // a branch (an idle row's words, and those past the window, are zero
    // and go to word 0)
#pragma unroll
    for (int i = 0; i < 4 * Window<RW>::QUADS; ++i) {
      const uint32_t v = win.w[i];
      const int k = 4 * (j + GROUP * (i >> 2)) + (i & 3);
      const int r = min(k / RW, WIN - 1);
      const int off = k < WIN * RW ? carry + offs[r] + 4 * (k - r * RW) : 0;
      const int wi = off >> 2;
      const uint32_t sh = static_cast<uint32_t>(off & 3) << 3;
      atomicOr(&buf[wi], v << sh);
      atomicOr(&buf[wi + 1], sh != 0u ? v >> (32u - sh) : 0u);
    }
    if (act) ext = max(ext, (carry + offs[WIN - 1] + 4 * RW + 3) >> 2);
    __syncwarp();
    // the next window's loads fly while this window's chain runs
    if (m0 + WIN < N) load_window<RW, VEC>(next, words, lens, m0 + WIN, N, j, act);
    const int avail = (carry + total) / 20;
    const int k = act ? min(avail, tb - done) : 0;
    const int kmax = max(k, __shfl_xor_sync(FULL, k, GROUP));
    mix_blocks(h, g, f, buf, k, kmax);
    done += k;
    // keep the bytes past the last complete block: words [5 * avail, ext),
    // at most ceil((19 + 4 * RW) / 4) <= 2 * GROUP of them
    const bool more = act && done < tb;
    const int keep = more ? ext - 5 * avail : 0;
    const uint32_t head0 = j < keep ? buf[5 * avail + j] : 0u;
    const uint32_t head1 = j + GROUP < keep ? buf[5 * avail + GROUP + j] : 0u;
    __syncwarp();
    if (more) {
      // zero words [0, ext) 16 bytes a lane, then put the kept words back
      uint4* quads = reinterpret_cast<uint4*>(buf);
      for (int i = j; 4 * i < ext; i += GROUP) quads[i] = make_uint4(0u, 0u, 0u, 0u);
    }
    __syncwarp();
    if (more) {
      if (j < keep) buf[j] = head0;
      if (j + GROUP < keep) buf[j + GROUP] = head1;
      ext = keep;
      carry += total - 20 * avail;
    }
    __syncwarp();
  }
  if (valid && j == 0) {
    oh[b] = h;
    og[b] = g;
    of[b] = f;
  }
}

template <int RW>
int launch(void** p, int B, int N, cudaStream_t stream) {
  const int blocks = (B + ROWS - 1) / ROWS;
  const uint32_t* words = static_cast<const uint32_t*>(p[IN_REC_WORDS]);
  // 16-byte lanes when every row and window starts on a 16-byte boundary
  const bool vec = reinterpret_cast<uintptr_t>(words) % 16 == 0 &&
                   (static_cast<size_t>(N) * RW) % 4 == 0;
  auto kernel = vec ? fused_stream_kernel<RW, true> : fused_stream_kernel<RW, false>;
  kernel<<<blocks, WARPS * 32, 0, stream>>>(
      static_cast<const uint32_t*>(p[IN_H0]), static_cast<const uint32_t*>(p[IN_G0]),
      static_cast<const uint32_t*>(p[IN_F0]), words,
      static_cast<const int32_t*>(p[IN_REC_LEN]),
      static_cast<const int32_t*>(p[IN_TOTAL_BLOCKS]),
      static_cast<uint32_t*>(p[OUT_H]), static_cast<uint32_t*>(p[OUT_G]),
      static_cast<uint32_t*>(p[OUT_F]), B, N);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Record widths RW in [4, 16] words (addresses up to 40 bytes at 14
// incarnation digits); any other width is refused with cudaErrorInvalidValue.
RINGPOP_EXPORT int ringpop_fused_stream(void** p, int B, int N, int RW, void* stream) {
  if (B <= 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (RW) {
    case 4: return launch<4>(p, B, N, s);
    case 5: return launch<5>(p, B, N, s);
    case 6: return launch<6>(p, B, N, s);
    case 7: return launch<7>(p, B, N, s);
    case 8: return launch<8>(p, B, N, s);
    case 9: return launch<9>(p, B, N, s);
    case 10: return launch<10>(p, B, N, s);
    case 11: return launch<11>(p, B, N, s);
    case 12: return launch<12>(p, B, N, s);
    case 13: return launch<13>(p, B, N, s);
    case 14: return launch<14>(p, B, N, s);
    case 15: return launch<15>(p, B, N, s);
    case 16: return launch<16>(p, B, N, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

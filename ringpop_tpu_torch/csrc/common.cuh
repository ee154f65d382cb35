// Shared pieces of the port's CUDA kernels (built for sm_90a by
// ringpop_tpu_torch/ops/_build.py).  Every uint32 the Python side keeps as
// an int32 bit pattern arrives here as uint32_t; bool planes arrive as
// uint8_t (PyTorch stores bool as one byte holding 0 or 1).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RINGPOP_EXPORT extern "C" __attribute__((visibility("default")))

namespace ringpop {

// status codes: rank order IS override priority at equal incarnation
constexpr int ALIVE = 0;
constexpr int SUSPECT = 1;
constexpr int FAULTY = 2;
constexpr int LEAVE = 3;

// farmhashmk constants
constexpr uint32_t C1 = 0xCC9E2D51u;
constexpr uint32_t C2 = 0x1B873593u;
constexpr uint32_t MAGIC = 0xE6546B64u;

__device__ __forceinline__ uint32_t rotr32(uint32_t x, int r) {
  return r == 0 ? x : ((x >> r) | (x << (32 - r)));
}

__device__ __forceinline__ uint32_t mur(uint32_t a, uint32_t h) {
  a *= C1;
  a = rotr32(a, 17);
  a *= C2;
  h ^= a;
  h = rotr32(h, 19);
  return h * 5u + MAGIC;
}

// One farmhashmk 20-byte block round: (h, g, f) <- the round of block
// (a, b, c, d, e).
__device__ __forceinline__ void mix_round(uint32_t& h, uint32_t& g, uint32_t& f, uint32_t a,
                                          uint32_t b, uint32_t c, uint32_t d, uint32_t e) {
  uint32_t nh = h + a;
  uint32_t ng = g + b;
  uint32_t nf = f + c;
  nh = mur(d, nh) + e;
  ng = mur(c, ng) + a;
  nf = mur(b + e * C1, nf) + d;
  nf = nf + ng;
  ng = ng + nf;
  h = nh;
  g = ng;
  f = nf;
}

// Rounds of mix_blocks per register stage: four blocks are 20 words, five
// 16-byte shared loads.
constexpr int MIX_STAGE = 4;

__device__ __forceinline__ void load_stage(uint32_t (&w)[5 * MIX_STAGE], const uint32_t* src) {
  const uint4* p = reinterpret_cast<const uint4*>(src);
#pragma unroll
  for (int i = 0; i < 5 * MIX_STAGE / 4; ++i) {
    const uint4 v = p[i];
    w[4 * i] = v.x;
    w[4 * i + 1] = v.y;
    w[4 * i + 2] = v.z;
    w[4 * i + 3] = v.w;
  }
}

// Mix blocks [0, k) of a run of 5-word blocks in shared memory into
// (h, g, f).  Every lane of the warp loops to kmax (the largest k among
// the rows the warp holds), so the loop is warp-uniform; rounds at or past
// the lane's own k are computed and dropped by a select, not a branch.
// The blocks come through registers four at a time, and the next four's
// 16-byte loads are issued before the current four rounds run, so the
// shared-memory latency hides behind the chain even with one warp on a
// scheduler.  blk must be 16-byte aligned and hold
// 5 * (MIX_STAGE * ceil(kmax / MIX_STAGE) + MIX_STAGE) readable words.
__device__ __forceinline__ void mix_blocks(uint32_t& h, uint32_t& g, uint32_t& f,
                                           const uint32_t* blk, int k, int kmax) {
  uint32_t cur[5 * MIX_STAGE];
  load_stage(cur, blk);
#pragma unroll 2
  for (int q = 0; q < kmax; q += MIX_STAGE) {
    uint32_t nxt[5 * MIX_STAGE];
    load_stage(nxt, blk + 5 * (q + MIX_STAGE));
#pragma unroll
    for (int r = 0; r < MIX_STAGE; ++r) {
      uint32_t nh = h, ng = g, nf = f;
      mix_round(nh, ng, nf, cur[5 * r], cur[5 * r + 1], cur[5 * r + 2], cur[5 * r + 3],
                cur[5 * r + 4]);
      const bool on = q + r < k;
      h = on ? nh : h;
      g = on ? ng : g;
      f = on ? nf : f;
    }
#pragma unroll
    for (int i = 0; i < 5 * MIX_STAGE; ++i) cur[i] = nxt[i];
  }
}

// The SWIM precedence table (member.js:171-202).
__device__ __forceinline__ bool overrides(int us, int ui, int cs, int ci) {
  const bool alive_ov = (us == ALIVE) && (ui > ci);
  const bool suspect_ov = (us == SUSPECT) &&
      (((cs == SUSPECT) && (ui > ci)) || ((cs == FAULTY) && (ui > ci)) ||
       ((cs == ALIVE) && (ui >= ci)));
  const bool faulty_ov = (us == FAULTY) &&
      (((cs == SUSPECT) && (ui >= ci)) || ((cs == FAULTY) && (ui > ci)) ||
       ((cs == ALIVE) && (ui >= ci)));
  const bool leave_ov = (us == LEAVE) && (cs != LEAVE) && (ui >= ci);
  return alive_ov || suspect_ov || faulty_ov || leave_ov;
}

}  // namespace ringpop

// One SWIM membership-update application site over [N, N] planes.
//
// Replaces the TPU kernel ringpop_tpu/ops/fused_apply.py `_make_kernel`
// (run through toolkit.stream_row_tiles' gridless pallas_call): per cell
// the precedence gate, refute on the diagonal, the change-table write and
// suspicion start/stop with the deadline stamp; per row the applied OR, an
// optional applied count and the refute diagonal; an optional packed
// [N, ceil(N/32)] applied-union word OR-accumulated; an optional dense
// applied mask.
//
// Bound on an H100: bytes.  It reads 15 planes and writes 10 (about 86 MB
// at n=1024 with the dense mask) and does a handful of integer compares
// per cell, far below the card's operation rate.  Design: one block per
// row, threads over columns, so each warp reads 32 consecutive cells of
// every plane (coalesced) and its __ballot_sync of the gate IS the packed
// union word of those 32 columns; __syncthreads_count per column sweep
// gives the per-row count and OR without a second pass.  Columns past n
// (a partial last word) take part in the ballot with gate = 0.
//
// The batch axis: B clusters' planes stacked [B, N, N] run in one launch
// of B x N blocks.  Block x is row x % N of cluster x / N: its planes'
// row is the x-th of the flattened [B * N, N] view, so only the diagonal
// test (the local row) and the stamps (cluster b's now and deadline, one
// each) read the cluster index; the per-row outputs are [B * N].
#include "common.cuh"

namespace {

using namespace ringpop;

constexpr int THREADS = 256;  // a multiple of 32: warps align to union words

enum : int {
  IN_KNOWN, IN_STATUS, IN_INC, IN_CH_ACTIVE, IN_CH_STATUS, IN_CH_INC,
  IN_CH_SOURCE, IN_CH_SOURCE_INC, IN_CH_PB, IN_SUSP,
  IN_RECV, IN_U_STATUS, IN_U_INC, IN_U_SOURCE, IN_U_SOURCE_INC,
  IN_UNION, IN_NOW, IN_DEADLINE,
  OUT_KNOWN, OUT_STATUS, OUT_INC, OUT_CH_ACTIVE, OUT_CH_STATUS, OUT_CH_INC,
  OUT_CH_SOURCE, OUT_CH_SOURCE_INC, OUT_CH_PB, OUT_SUSP,
  OUT_UNION, OUT_APPLIED, OUT_ROWS, OUT_COUNT, OUT_REFUTE,
  N_PTRS
};

struct ApplyArgs {
  const uint8_t* known; const int32_t* status; const int32_t* inc;
  const uint8_t* ch_active; const int32_t* ch_status; const int32_t* ch_inc;
  const int32_t* ch_source; const int32_t* ch_source_inc; const int32_t* ch_pb;
  const int32_t* susp;
  const uint8_t* recv; const int32_t* u_status; const int32_t* u_inc;
  const int32_t* u_source; const int32_t* u_source_inc;
  const uint32_t* union_in;
  const int32_t* now; const int32_t* deadline;
  uint8_t* o_known; int32_t* o_status; int32_t* o_inc;
  uint8_t* o_ch_active; int32_t* o_ch_status; int32_t* o_ch_inc;
  int32_t* o_ch_source; int32_t* o_ch_source_inc; int32_t* o_ch_pb;
  int32_t* o_susp;
  uint32_t* union_out; uint8_t* applied; uint8_t* rows; int32_t* count;
  uint8_t* refute;
};

__global__ void __launch_bounds__(THREADS)
apply_updates_kernel(ApplyArgs a, int n, int words) {
  const int flat = blockIdx.x;  // row of the flattened [B * N, N] planes
  const int cluster = flat / n;
  const int row = flat - cluster * n;
  const int now = a.now[cluster];
  const int deadline = a.deadline[cluster];
  const size_t base = static_cast<size_t>(flat) * n;
  int total = 0;
  for (int c0 = 0; c0 < n; c0 += THREADS) {
    const int c = c0 + threadIdx.x;
    bool gate = false;
    if (c < n) {
      const size_t i = base + c;
      const bool is_self = c == row;
      const bool rv = a.recv[i] != 0;
      const int us = a.u_status[i];
      const int ui = a.u_inc[i];
      const bool refute = rv && is_self && (us == SUSPECT || us == FAULTY);
      const int es = refute ? ALIVE : us;
      const int ei = refute ? now : ui;
      const bool kn = a.known[i] != 0;
      const int cs = a.status[i];
      const int ci = a.inc[i];
      const bool new_member = rv && !kn;
      gate = rv && (refute || new_member || overrides(es, ei, cs, ci));
      const int st = gate ? es : cs;
      const int in = gate ? ei : ci;
      a.o_known[i] = kn || new_member;
      a.o_status[i] = st;
      a.o_inc[i] = in;
      a.o_ch_active[i] = (a.ch_active[i] != 0) || gate;
      a.o_ch_status[i] = gate ? st : a.ch_status[i];
      a.o_ch_inc[i] = gate ? in : a.ch_inc[i];
      a.o_ch_source[i] = gate ? a.u_source[i] : a.ch_source[i];
      a.o_ch_source_inc[i] = gate ? a.u_source_inc[i] : a.ch_source_inc[i];
      a.o_ch_pb[i] = gate ? 0 : a.ch_pb[i];
      // starts and stops are disjoint (status == SUSPECT vs !=)
      const bool start = gate && st == SUSPECT && !is_self;
      const bool stop = gate && st != SUSPECT;
      a.o_susp[i] = start ? deadline : (stop ? -1 : a.susp[i]);
      if (a.applied) a.applied[i] = gate;
      if (a.refute && is_self) a.refute[flat] = refute;
    }
    if (a.union_out) {
      const unsigned bits = __ballot_sync(0xffffffffu, gate);
      const int word = c >> 5;
      if ((threadIdx.x & 31) == 0 && word < words) {
        const size_t w = static_cast<size_t>(flat) * words + word;
        a.union_out[w] = a.union_in[w] | bits;
      }
    }
    total += __syncthreads_count(gate);
  }
  if (threadIdx.x == 0) {
    a.rows[flat] = total > 0;
    if (a.count) a.count[flat] = total;
  }
}

}  // namespace

// b: the clusters stacked on the planes' leading axis (1 for one [N, N]
// cluster), with b stamps each for now and deadline.
RINGPOP_EXPORT int ringpop_apply_updates(void** p, int n, int words, int b, void* stream) {
  ApplyArgs a;
  a.known = static_cast<const uint8_t*>(p[IN_KNOWN]);
  a.status = static_cast<const int32_t*>(p[IN_STATUS]);
  a.inc = static_cast<const int32_t*>(p[IN_INC]);
  a.ch_active = static_cast<const uint8_t*>(p[IN_CH_ACTIVE]);
  a.ch_status = static_cast<const int32_t*>(p[IN_CH_STATUS]);
  a.ch_inc = static_cast<const int32_t*>(p[IN_CH_INC]);
  a.ch_source = static_cast<const int32_t*>(p[IN_CH_SOURCE]);
  a.ch_source_inc = static_cast<const int32_t*>(p[IN_CH_SOURCE_INC]);
  a.ch_pb = static_cast<const int32_t*>(p[IN_CH_PB]);
  a.susp = static_cast<const int32_t*>(p[IN_SUSP]);
  a.recv = static_cast<const uint8_t*>(p[IN_RECV]);
  a.u_status = static_cast<const int32_t*>(p[IN_U_STATUS]);
  a.u_inc = static_cast<const int32_t*>(p[IN_U_INC]);
  a.u_source = static_cast<const int32_t*>(p[IN_U_SOURCE]);
  a.u_source_inc = static_cast<const int32_t*>(p[IN_U_SOURCE_INC]);
  a.union_in = static_cast<const uint32_t*>(p[IN_UNION]);
  a.now = static_cast<const int32_t*>(p[IN_NOW]);
  a.deadline = static_cast<const int32_t*>(p[IN_DEADLINE]);
  a.o_known = static_cast<uint8_t*>(p[OUT_KNOWN]);
  a.o_status = static_cast<int32_t*>(p[OUT_STATUS]);
  a.o_inc = static_cast<int32_t*>(p[OUT_INC]);
  a.o_ch_active = static_cast<uint8_t*>(p[OUT_CH_ACTIVE]);
  a.o_ch_status = static_cast<int32_t*>(p[OUT_CH_STATUS]);
  a.o_ch_inc = static_cast<int32_t*>(p[OUT_CH_INC]);
  a.o_ch_source = static_cast<int32_t*>(p[OUT_CH_SOURCE]);
  a.o_ch_source_inc = static_cast<int32_t*>(p[OUT_CH_SOURCE_INC]);
  a.o_ch_pb = static_cast<int32_t*>(p[OUT_CH_PB]);
  a.o_susp = static_cast<int32_t*>(p[OUT_SUSP]);
  a.union_out = static_cast<uint32_t*>(p[OUT_UNION]);
  a.applied = static_cast<uint8_t*>(p[OUT_APPLIED]);
  a.rows = static_cast<uint8_t*>(p[OUT_ROWS]);
  a.count = static_cast<int32_t*>(p[OUT_COUNT]);
  a.refute = static_cast<uint8_t*>(p[OUT_REFUTE]);
  if (n <= 0 || b <= 0) return 0;
  apply_updates_kernel<<<b * n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      a, n, words);
  return static_cast<int>(cudaGetLastError());
}

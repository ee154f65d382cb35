// The ping-req respond, leg 3 (ping_req.cuh): one block a sender row, the
// K intermediaries' rows read in place, the full-sync rule and the
// strict-greater combine in slot order.
#include "ping_req.cuh"

using namespace ping_req;

namespace {

enum : int {
  R_SEL, R_RESPONDER, R_RESPONDABLE, R_CH_SOURCE, R_CH_SOURCE_INC, R_KNOWN, R_STATUS, R_INC,
  R_CH_STATUS, R_CH_INC, R_PR_SELF_INC, R_MID,
  R_OUT_MASK, R_OUT_STATUS, R_OUT_INC, R_OUT_SOURCE, R_OUT_SOURCE_INC, R_OUT_FS, R_OUT_FS_REC,
  R_N_PTRS
};

struct RespondArgs {
  const long long* sel;
  const uint8_t* responder;
  const uint8_t* respondable;
  const int32_t* ch_source;
  const int32_t* ch_source_inc;
  const uint8_t* known;
  const int32_t* status;
  const int32_t* inc;
  const int32_t* ch_status;
  const int32_t* ch_inc;
  const int32_t* pr_self_inc;
  const int32_t* mid;
  uint8_t* o_mask;
  int32_t* o_status;
  int32_t* o_inc;
  int32_t* o_source;
  int32_t* o_source_inc;
  uint8_t* o_fs;
  int32_t* o_fs_rec;
};

// The sum of every thread's `v` (each thread of the block calls it).
__device__ __forceinline__ int block_sum(int v) {
  __shared__ int part[WARPS];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  if ((threadIdx.x & 31) == 0) part[threadIdx.x >> 5] = v;
  __syncthreads();
  int total = 0;
#pragma unroll
  for (int w = 0; w < WARPS; ++w) total += part[w];
  __syncthreads();  // before the next call writes `part`
  return total;
}

// One block a sender row (b, i).  A row none of whose slots answered
// gets the no-update fill.  Otherwise, per answering slot: whether the
// intermediary m has any change to tell i (its respondable cells, less
// those i itself originated at the incarnation it sent), and if not and
// the checksums differ, a full sync of m's known members (written to the
// row's full-sync outputs, which the combine then reads); then each
// column keeps the strictly greatest key in slot order.
__global__ void __launch_bounds__(THREADS) ping_req_respond_kernel(RespondArgs a, int n, int k) {
  const long long row = blockIdx.x;
  const long long b = row / n;
  const int i = static_cast<int>(row - b * n);
  const uint8_t* resp = a.responder + row * k;
  uint8_t* fs_out = a.o_fs + row * k;
  bool any_slot = false;
  for (int s = 0; s < k; ++s) any_slot = any_slot || resp[s];
  if (!any_slot) {
    for (int j = threadIdx.x; j < n; j += THREADS) {
      const long long c = row * n + j;
      a.o_mask[c] = 0;
      a.o_status[c] = 3;  // -1 % 4
      a.o_inc[c] = -1;    // -1 // 4
      a.o_source[c] = -1;
      a.o_source_inc[c] = 0;
    }
    for (int s = threadIdx.x; s < k; s += THREADS) {
      fs_out[s] = 0;
      a.o_fs_rec[row * k + s] = 0;
    }
    return;
  }
  const int own_inc = a.pr_self_inc[row];
  const int own_mid = a.mid[row];
  for (int s = 0; s < k; ++s) {
    bool fs = false;
    int records = 0;
    if (resp[s]) {  // the same for every thread of the block
      const long long mrow = b * n + a.sel[row * k + s];
      bool tells = false;
      for (int j = threadIdx.x; j < n; j += THREADS) {
        const long long c = mrow * n + j;
        tells = tells || (a.respondable[c] &&
                          !(a.ch_source[c] == i && a.ch_source_inc[c] == own_inc));
      }
      fs = !__syncthreads_or(tells) && a.mid[mrow] != own_mid;
      if (fs) {  // the same for every thread of the block
        int known = 0;
        for (int j = threadIdx.x; j < n; j += THREADS) known += a.known[mrow * n + j];
        records = block_sum(known);
      }
    }
    if (threadIdx.x == 0) {
      fs_out[s] = fs;
      a.o_fs_rec[row * k + s] = records;
    }
  }
  __syncthreads();  // the full syncs, written above, read below
  for (int j = threadIdx.x; j < n; j += THREADS) {
    int best_key = -1, best_source = -1, best_source_inc = 0;
    for (int s = 0; s < k; ++s) {
      if (!resp[s]) continue;
      const int m = static_cast<int>(a.sel[row * k + s]);
      const long long mrow = b * n + m;
      const long long c = mrow * n + j;
      const bool tells =
          a.respondable[c] && !(a.ch_source[c] == i && a.ch_source_inc[c] == own_inc);
      const bool sync = fs_out[s] && a.known[c];
      if (!(tells || sync)) continue;  // key -1: never above the best
      const int st = sync ? a.status[c] : a.ch_status[c];
      const int in = sync ? a.inc[c] : a.ch_inc[c];
      const int key =
          static_cast<int>(static_cast<uint32_t>(in) * 4u + static_cast<uint32_t>(st));
      if (key > best_key) {
        best_key = key;
        best_source = sync ? m : a.ch_source[c];
        best_source_inc = sync ? a.inc[mrow * n + m] : a.ch_source_inc[c];
      }
    }
    const long long c = row * n + j;
    a.o_mask[c] = best_key >= 0;
    a.o_status[c] = best_key & 3;
    a.o_inc[c] = best_key >> 2;
    a.o_source[c] = best_source;
    a.o_source_inc[c] = best_source_inc;
  }
}

}  // namespace

RINGPOP_EXPORT int ringpop_ping_req_respond(void** p, int b, int n, int k, void* stream) {
  if (!shapes_ok(b, n, k)) return static_cast<int>(cudaErrorInvalidValue);
  RespondArgs a{
      static_cast<const long long*>(p[R_SEL]),
      static_cast<const uint8_t*>(p[R_RESPONDER]),
      static_cast<const uint8_t*>(p[R_RESPONDABLE]),
      static_cast<const int32_t*>(p[R_CH_SOURCE]),
      static_cast<const int32_t*>(p[R_CH_SOURCE_INC]),
      static_cast<const uint8_t*>(p[R_KNOWN]),
      static_cast<const int32_t*>(p[R_STATUS]),
      static_cast<const int32_t*>(p[R_INC]),
      static_cast<const int32_t*>(p[R_CH_STATUS]),
      static_cast<const int32_t*>(p[R_CH_INC]),
      static_cast<const int32_t*>(p[R_PR_SELF_INC]),
      static_cast<const int32_t*>(p[R_MID]),
      static_cast<uint8_t*>(p[R_OUT_MASK]),
      static_cast<int32_t*>(p[R_OUT_STATUS]),
      static_cast<int32_t*>(p[R_OUT_INC]),
      static_cast<int32_t*>(p[R_OUT_SOURCE]),
      static_cast<int32_t*>(p[R_OUT_SOURCE_INC]),
      static_cast<uint8_t*>(p[R_OUT_FS]),
      static_cast<int32_t*>(p[R_OUT_FS_REC]),
  };
  ping_req_respond_kernel<<<b * n, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(a, n, k);
  return static_cast<int>(cudaGetLastError());
}

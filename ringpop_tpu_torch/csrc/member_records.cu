// The member record encode: each (known, status, incarnation) cell of a
// membership view becomes its checksum record
// `addr + status + digits(inc_ms) + ';'`, zero-padded to the record width
// R, and the record's byte length (0 and all-zero bytes for an absent
// cell).  The same bytes as fused_checksum.member_records_plain.
//
// Replaces no Pallas kernel.  It stands in for XLA's elementwise encode,
// ringpop_tpu/ops/fused_checksum.py:113 `member_records` (and the sparse
// `member_records_at`), which the port first ran as about sixty plain
// PyTorch ops over int32 and int64 intermediates of [..., R] a cell: the
// "full" checksum recompute encodes every cell of [B, N, N] twice a tick.
//
// Bound on an H100: bytes.  A cell reads known (1 B), status (4 B) and
// inc_ms (8 B) and writes R record bytes and a 4-byte length: at
// [32, 1024, 1024] with R = 36, 1.78 GB, 0.53 ms at 3.35 TB/s.  A record
// takes about 200 integer instructions, under half of that time at full
// issue, so the design keeps the arithmetic cheap and every access to
// device memory coalesced:
//   - one thread per cell; its record is built in shared memory: first
//     the member's address row (the universe's [N, RW] word table, zero
//     past each address; 36 KB at n = 1024, held in L1 and L2), then the
//     status, the digits and ';' as byte stores at their offsets;
//   - the cell's known, status, inc_ms and address length are loaded
//     before any is used, so one memory round trip serves them all (on
//     an H100 80GB HBM3 at 700 W, [32, 1024, 1024]: 0.70 ms, against
//     0.76 ms with the loads after the known test; a block-wide 16-byte
//     copy of the dense form's contiguous address rows into shared
//     memory was slower, 0.77-0.80 ms);
//   - the status string is a 64-bit literal picked by a select, not a
//     table read whose address differs across the warp;
//   - the digits come from one 64-bit split into three 32-bit parts
//     (inc / 10^14, inc / 10^7 % 10^7, inc % 10^7): two 64-bit divisions
//     by constants a cell, then a multiply-high division by 10 a digit;
//   - a block's 256 records are 256 x R contiguous bytes of the output,
//     so they leave shared memory as 16-byte vector stores, contiguous
//     across the block (where R % 4 == 0; byte stores otherwise);
//   - known, status, inc_ms and the lengths move one element a lane.
// Dense form (no subject pointer): the cell's member is its index along
// the last axis, cell % n.  Sparse form: the member is subject[cell],
// clamped to [0, n).  Status codes are taken mod 4 (0..3 are the codes;
// the plain version's table lookup wraps -4..-1 the same way).
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int MAX_RW = 32;  // records up to 128 bytes: 32 KB of shared memory a block
constexpr int STATUS_W = 7;
constexpr int MAX_DIGITS = 19;  // int64 decimal digits
constexpr uint64_t E7 = 10000000ull;

enum : int {
  IN_PRESENT, IN_STATUS, IN_INC, IN_SUBJECT, IN_ADDR_WORDS, IN_ADDR_LEN,
  OUT_BYTES, OUT_LEN,
  N_PTRS
};

// decimal digits of v < 10^7 (0 has one)
__device__ __forceinline__ int ndigits7(uint32_t v) {
  return 1 + (v >= 10u) + (v >= 100u) + (v >= 1000u) + (v >= 10000u) + (v >= 100000u) +
         (v >= 1000000u);
}

// Build one record at rec (RW words of shared memory that already hold
// the member's address row) and return its length.  width: R; maxd: the
// record's digit capacity.
__device__ __forceinline__ int encode(uint32_t* rec, int al, int st, int64_t x, int width,
                                      int maxd) {
  uint8_t* rb = reinterpret_cast<uint8_t*>(rec);

  // "alive", "suspect", "faulty", "leave" (checksum_encode.STATUS_STRINGS),
  // first byte lowest
  const uint64_t sv = st == 0 ? 0x6576696c61ull
                    : st == 1 ? 0x74636570737573ull
                    : st == 2 ? 0x79746c756166ull
                              : 0x657661656cull;
  const int sl = st == 1 ? 7 : st == 2 ? 6 : 5;
#pragma unroll
  for (int j = 0; j < STATUS_W; ++j) {
    if (j < sl) rb[al + j] = static_cast<uint8_t>(sv >> (8 * j));
  }

  // a negative value prints as one digit, its floored remainder mod 10
  // (the plain version's floor division and modulo)
  const uint64_t u = x >= 0 ? static_cast<uint64_t>(x)
                            : static_cast<uint64_t>(((x % 10) + 10) % 10);
  const uint64_t q7 = u / E7;
  const uint64_t q14 = q7 / E7;
  const uint32_t lo = static_cast<uint32_t>(u - q7 * E7);
  const uint32_t mid = static_cast<uint32_t>(q7 - q14 * E7);
  const uint32_t hi = static_cast<uint32_t>(q14);  // < 10^5
  const int dl = hi ? 14 + ndigits7(hi) : mid ? 7 + ndigits7(mid) : ndigits7(lo);

  // digit j (of 10^j) sits at k = dl - 1 - j past the status; only the
  // first maxd positions hold their own digit
  const int start = al + sl;
  uint32_t v = lo;
  for (int j = 0; j < dl; ++j) {
    if (j == 7) v = mid;
    if (j == 14) v = hi;
    const uint32_t q = v / 10u;
    const uint32_t d = v - 10u * q;
    v = q;
    const int k = dl - 1 - j;
    if (k < maxd && start + k < width) rb[start + k] = static_cast<uint8_t>('0' + d);
  }
  if (dl > maxd) {
    // wider than the capacity: positions maxd.. repeat the digit at
    // maxd - 1, as the plain version's clamped gather does
    const int p0 = start + maxd - 1;
    if (p0 < width) {
      const uint8_t c = rb[p0];
      for (int p = p0 + 1; p < min(start + dl, width); ++p) rb[p] = c;
    }
  }
  if (start + dl < width) rb[start + dl] = ';';
  return start + dl + 1;
}

__global__ void __launch_bounds__(THREADS)
member_records_kernel(const uint8_t* present, const int32_t* status, const int64_t* inc,
                      const int64_t* subject, const uint32_t* addr_words,
                      const int32_t* addr_len, uint8_t* out_bytes, int32_t* out_len, int cells,
                      int n, int width, int rw, int maxd, bool vec) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int t = threadIdx.x;
  const int cell0 = blockIdx.x * THREADS;
  const int cell = cell0 + t;
  uint32_t* rec = smem + t * rw;
  if (cell < cells) {
    // every operand's load is issued before any is used, so that their
    // latencies overlap (present is a byte, 0 or 1)
    const bool pres = present[cell] != 0;
    const int st = status[cell] & 3;
    const int64_t x = inc[cell];
    int m;
    if (subject) {
      const int64_t s = subject[cell];
      m = static_cast<int>(s < 0 ? 0 : s >= n ? n - 1 : s);
    } else {
      m = cell % n;
    }
    const int al = __ldg(addr_len + m);
    int len = 0;
    if (pres) {
      const uint32_t* row = addr_words + static_cast<size_t>(m) * rw;
      for (int k = 0; k < rw; ++k) rec[k] = __ldg(row + k);
      len = encode(rec, al, st, x, width, maxd);
    } else {
      for (int k = 0; k < rw; ++k) rec[k] = 0u;
    }
    out_len[cell] = len;
  }
  __syncthreads();

  // the block's records are cnt x width contiguous bytes of the output
  const int cnt = min(THREADS, cells - cell0);
  uint8_t* dst = out_bytes + static_cast<size_t>(cell0) * width;
  if (vec) {
    // width == 4 * rw: shared memory holds the same bytes in the same order
    const int words = cnt * rw;
    const int quads = words >> 2;
    const uint4* src4 = reinterpret_cast<const uint4*>(smem);
    uint4* dst4 = reinterpret_cast<uint4*>(dst);
    for (int i = t; i < quads; i += THREADS) dst4[i] = src4[i];
    uint32_t* dst1 = reinterpret_cast<uint32_t*>(dst);
    for (int i = 4 * quads + t; i < words; i += THREADS) dst1[i] = smem[i];
  } else {
    const uint8_t* sb = reinterpret_cast<const uint8_t*>(smem);
    for (int b = t; b < cnt * width; b += THREADS) {
      const int r = b / width;
      dst[b] = sb[4 * rw * r + (b - r * width)];
    }
  }
}

}  // namespace

// cells: the count of cells (present, status, inc_ms and, in the sparse
// form, subject each hold one element a cell), below 2^31 - 256; n: the
// universe's size; width: the record width R in bytes, at most
// 4 * MAX_RW; max_digits in [1, 19].  Anything else is refused with
// cudaErrorInvalidValue.
RINGPOP_EXPORT int ringpop_member_records(void** p, int cells, int n, int width, int max_digits,
                                          void* stream) {
  if (cells <= 0) return 0;
  const int rw = (width + 3) / 4;
  if (cells > INT32_MAX - THREADS || n <= 0 || width <= 0 || rw > MAX_RW || max_digits < 1 ||
      max_digits > MAX_DIGITS) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const bool vec = width % 4 == 0 && reinterpret_cast<uintptr_t>(p[OUT_BYTES]) % 16 == 0;
  const int blocks = (cells - 1) / THREADS + 1;
  const size_t shared = static_cast<size_t>(THREADS) * rw * sizeof(uint32_t);
  member_records_kernel<<<blocks, THREADS, shared, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(p[IN_PRESENT]), static_cast<const int32_t*>(p[IN_STATUS]),
      static_cast<const int64_t*>(p[IN_INC]), static_cast<const int64_t*>(p[IN_SUBJECT]),
      static_cast<const uint32_t*>(p[IN_ADDR_WORDS]), static_cast<const int32_t*>(p[IN_ADDR_LEN]),
      static_cast<uint8_t*>(p[OUT_BYTES]), static_cast<int32_t*>(p[OUT_LEN]), cells, n, width, rw,
      max_digits, vec);
  return static_cast<int>(cudaGetLastError());
}

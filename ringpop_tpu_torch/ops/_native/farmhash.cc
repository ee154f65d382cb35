// Native FarmHash32 oracle for ringpop_tpu_torch (a copy of the JAX
// package's ops/_native/farmhash.cc; the port builds its own).
//
// Implements farmhashmk::Hash32 — the variant behind the npm `farmhash`
// addon's hash32() that the reference uses for every ring/membership hash
// (ringpop-node lib/ring/index.js:21, lib/membership/index.js:24).  Both
// farmhash::Hash32 (portable, non-SSE build) and farmhash::Fingerprint32
// dispatch here, so this is the bit pattern the Node reference produces.
//
// Exposed as a plain C ABI consumed from Python via ctypes (no pybind11 in
// the image).  Batch entry points operate on a padded row-major byte matrix
// so large membership/ring checksum workloads stay in native code.

#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

constexpr uint32_t c1 = 0xcc9e2d51;
constexpr uint32_t c2 = 0x1b873593;

inline uint32_t Fetch32(const uint8_t* p) {
  uint32_t v;
  std::memcpy(&v, p, sizeof(v));  // little-endian hosts only (x86/ARM LE)
  return v;
}

inline uint32_t Rotate32(uint32_t val, int shift) {
  return shift == 0 ? val : ((val >> shift) | (val << (32 - shift)));
}

inline uint32_t fmix(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85ebca6b;
  h ^= h >> 13;
  h *= 0xc2b2ae35;
  h ^= h >> 16;
  return h;
}

inline uint32_t Mur(uint32_t a, uint32_t h) {
  a *= c1;
  a = Rotate32(a, 17);
  a *= c2;
  h ^= a;
  h = Rotate32(h, 19);
  return h * 5 + 0xe6546b64;
}

uint32_t Hash32Len0to4(const uint8_t* s, size_t len, uint32_t seed = 0) {
  uint32_t b = seed;
  uint32_t c = 9;
  for (size_t i = 0; i < len; i++) {
    signed char v = static_cast<signed char>(s[i]);
    b = b * c1 + static_cast<uint32_t>(v);
    c ^= b;
  }
  return fmix(Mur(b, Mur(static_cast<uint32_t>(len), c)));
}

uint32_t Hash32Len5to12(const uint8_t* s, size_t len, uint32_t seed = 0) {
  uint32_t a = static_cast<uint32_t>(len), b = a * 5, c = 9, d = b + seed;
  a += Fetch32(s);
  b += Fetch32(s + len - 4);
  c += Fetch32(s + ((len >> 1) & 4));
  return fmix(seed ^ Mur(c, Mur(b, Mur(a, d))));
}

uint32_t Hash32Len13to24(const uint8_t* s, size_t len, uint32_t seed = 0) {
  uint32_t a = Fetch32(s - 4 + (len >> 1));
  uint32_t b = Fetch32(s + 4);
  uint32_t c = Fetch32(s + len - 8);
  uint32_t d = Fetch32(s + (len >> 1));
  uint32_t e = Fetch32(s);
  uint32_t f = Fetch32(s + len - 4);
  uint32_t h = d * c1 + static_cast<uint32_t>(len) + seed;
  a = Rotate32(a, 12) + f;
  h = Mur(c, h) + a;
  a = Rotate32(a, 3) + c;
  h = Mur(e, h) + a;
  a = Rotate32(a + f, 12) + d;
  h = Mur(b ^ seed, h) + a;
  return fmix(h);
}

uint32_t Hash32(const uint8_t* s, size_t len) {
  if (len <= 24) {
    return len <= 12
               ? (len <= 4 ? Hash32Len0to4(s, len) : Hash32Len5to12(s, len))
               : Hash32Len13to24(s, len);
  }

  // len > 24
  uint32_t h = static_cast<uint32_t>(len), g = c1 * h, f = g;
  uint32_t a0 = Rotate32(Fetch32(s + len - 4) * c1, 17) * c2;
  uint32_t a1 = Rotate32(Fetch32(s + len - 8) * c1, 17) * c2;
  uint32_t a2 = Rotate32(Fetch32(s + len - 16) * c1, 17) * c2;
  uint32_t a3 = Rotate32(Fetch32(s + len - 12) * c1, 17) * c2;
  uint32_t a4 = Rotate32(Fetch32(s + len - 20) * c1, 17) * c2;
  h ^= a0;
  h = Rotate32(h, 19);
  h = h * 5 + 0xe6546b64;
  h ^= a2;
  h = Rotate32(h, 19);
  h = h * 5 + 0xe6546b64;
  g ^= a1;
  g = Rotate32(g, 19);
  g = g * 5 + 0xe6546b64;
  g ^= a3;
  g = Rotate32(g, 19);
  g = g * 5 + 0xe6546b64;
  f += a4;
  f = Rotate32(f, 19) + 113;
  size_t iters = (len - 1) / 20;
  do {
    uint32_t a = Fetch32(s);
    uint32_t b = Fetch32(s + 4);
    uint32_t c = Fetch32(s + 8);
    uint32_t d = Fetch32(s + 12);
    uint32_t e = Fetch32(s + 16);
    h += a;
    g += b;
    f += c;
    h = Mur(d, h) + e;
    g = Mur(c, g) + a;
    f = Mur(b + e * c1, f) + d;
    f += g;
    g += f;
    s += 20;
  } while (--iters != 0);
  g = Rotate32(g, 11) * c1;
  g = Rotate32(g, 17) * c1;
  f = Rotate32(f, 11) * c1;
  f = Rotate32(f, 17) * c1;
  h = Rotate32(h + g, 19);
  h = h * 5 + 0xe6546b64;
  h = Rotate32(h, 17) * c1;
  h = Rotate32(h + f, 19);
  h = h * 5 + 0xe6546b64;
  h = Rotate32(h, 17) * c1;
  return h;
}

}  // namespace

extern "C" {

uint32_t rp_farmhash32(const uint8_t* data, uint64_t len) {
  return Hash32(data, static_cast<size_t>(len));
}

// Hash each row of a padded row-major [n, stride] byte matrix.
void rp_farmhash32_batch(const uint8_t* data, uint64_t stride,
                         const uint64_t* lens, uint64_t n, uint32_t* out) {
  for (uint64_t i = 0; i < n; i++) {
    out[i] = Hash32(data + i * stride, static_cast<size_t>(lens[i]));
  }
}

// Hash `reps` replica-point strings "<name><i>" for i in [0, reps) — the
// ring's replica expansion (lib/ring/index.js:54-57) without Python overhead.
void rp_replica_hashes(const uint8_t* name, uint64_t name_len, uint64_t reps,
                       uint32_t* out) {
  uint8_t buf[512];
  if (name_len > 480) return;  // caller guards; addresses are short
  std::memcpy(buf, name, name_len);
  for (uint64_t i = 0; i < reps; i++) {
    char digits[24];
    int nd = 0;
    uint64_t v = i;
    do {
      digits[nd++] = static_cast<char>('0' + (v % 10));
      v /= 10;
    } while (v != 0);
    for (int d = 0; d < nd; d++) {
      buf[name_len + d] = static_cast<uint8_t>(digits[nd - 1 - d]);
    }
    out[i] = Hash32(buf, name_len + nd);
  }
}

}  // extern "C"

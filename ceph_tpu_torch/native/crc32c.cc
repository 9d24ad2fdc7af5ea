// crc32c host kernel (Castagnoli, reflected poly 0x82F63B78) and the
// host region XOR.
//
// Behavioral twin of the reference's ceph_crc32c family
// (reference src/common/sctp_crc32.c:update_crc32 — plain reflected
// table update, caller passes the seed, no init/final inversion).
// Slice-by-8 for throughput.  A null data pointer means len zero bytes
// (reference crc32c.cc:39, ceph_crc32c_zeros): advancing the register
// through n zero bytes multiplies it by x^(8n) modulo the polynomial, so
// the zeros path takes O(log n) steps instead of n table lookups.
#include <cstddef>
#include <cstdint>
#include <cstring>

namespace {

struct Tables {
  uint32_t t[8][256];
  Tables() {
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = i;
      for (int k = 0; k < 8; k++) c = (c & 1) ? 0x82F63B78u ^ (c >> 1) : c >> 1;
      t[0][i] = c;
    }
    for (uint32_t i = 0; i < 256; i++) {
      uint32_t c = t[0][i];
      for (int s = 1; s < 8; s++) {
        c = t[0][c & 0xff] ^ (c >> 8);
        t[s][i] = c;
      }
    }
  }
};
const Tables kT;

constexpr uint32_t kPoly = 0x82F63B78u;

// a * b modulo the polynomial, reflected (bit 31 is x^0)
uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
  for (uint32_t m = 1u << 31; m; m >>= 1) {
    if (a & m) p ^= b;
    b = (b & 1) ? (b >> 1) ^ kPoly : b >> 1;
  }
  return p;
}

// x2n[i] = x^(2^i) modulo the polynomial
struct PowerTable {
  uint32_t x2n[67];  // i up to 3 + 63
  PowerTable() {
    uint32_t p = 1u << 30;  // x^1
    for (int i = 0; i < 67; i++) {
      x2n[i] = p;
      p = multmodp(p, p);
    }
  }
};
const PowerTable kX;

// x^(8n) modulo the polynomial: the advance through n zero bytes
uint32_t zeros_op(uint64_t n) {
  uint32_t p = 1u << 31;  // x^0
  for (int i = 3; n; n >>= 1, i++)
    if (n & 1) p = multmodp(kX.x2n[i], p);
  return p;
}

}  // namespace

extern "C" {

// Matches ceph_crc32c(seed, data, len); data may be null (= len zeros).
uint32_t ceph_tpu_torch_crc32c(uint32_t crc, const uint8_t* data, size_t len) {
  if (data == nullptr) return len ? multmodp(zeros_op(len), crc) : crc;
  while (len && (reinterpret_cast<uintptr_t>(data) & 7)) {
    crc = kT.t[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
    len--;
  }
  while (len >= 8) {
    uint64_t v;
    std::memcpy(&v, data, 8);
    v ^= crc;
    crc = kT.t[7][v & 0xff] ^ kT.t[6][(v >> 8) & 0xff] ^
          kT.t[5][(v >> 16) & 0xff] ^ kT.t[4][(v >> 24) & 0xff] ^
          kT.t[3][(v >> 32) & 0xff] ^ kT.t[2][(v >> 40) & 0xff] ^
          kT.t[1][(v >> 48) & 0xff] ^ kT.t[0][(v >> 56) & 0xff];
    data += 8;
    len -= 8;
  }
  while (len--) crc = kT.t[0][(crc ^ *data++) & 0xff] ^ (crc >> 8);
  return crc;
}

// dst ^= src over len bytes (region parity; reference
// src/erasure-code/isa/xor_op.cc semantics), eight bytes a step.
void ceph_tpu_torch_xor_region(uint8_t* dst, const uint8_t* src, size_t len) {
  size_t i = 0;
  for (; i + 8 <= len; i += 8) {
    uint64_t a, b;
    std::memcpy(&a, dst + i, 8);
    std::memcpy(&b, src + i, 8);
    a ^= b;
    std::memcpy(dst + i, &a, 8);
  }
  for (; i < len; i++) dst[i] ^= src[i];
}

}  // extern "C"

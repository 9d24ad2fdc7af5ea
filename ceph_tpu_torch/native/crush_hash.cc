// Scalar CRUSH placement hot loop, native.
//
// The Python scalar mapper (ceph_tpu_torch/crush/mapper.py) is the
// correctness oracle of the batched CUDA engine and the whole-cluster
// remap; in pure Python one straw2 draw costs ~25us, too slow to check
// every PG of a 1024-OSD map each epoch.  This file moves the
// per-item draw loop — Jenkins hash, fixed-point crush_ln LUT lookup,
// weighted division, argmax — into C++ with one ctypes call per
// bucket level.  Semantics mirror mapper.py exactly (which is itself
// pinned bit-identical to the reference's src/crush/mapper.c by
// golden vectors); the crush_ln LUTs are injected at load time from
// ceph_tpu_torch/crush/_ln_tables.py so there is a single table of truth.

#include <cstdint>
#include <cstring>

extern "C" {

static uint32_t SEED = 1315423911u;
static const uint32_t XPAD = 231232u;
static const uint32_t YPAD = 1232u;

#define MIX(a, b, c)     \
  do {                   \
    a = a - b; a = a - c; a = a ^ (c >> 13); \
    b = b - c; b = b - a; b = b ^ (a << 8);  \
    c = c - a; c = c - b; c = c ^ (b >> 13); \
    a = a - b; a = a - c; a = a ^ (c >> 12); \
    b = b - c; b = b - a; b = b ^ (a << 16); \
    c = c - a; c = c - b; c = c ^ (b >> 5);  \
    a = a - b; a = a - c; a = a ^ (c >> 3);  \
    b = b - c; b = b - a; b = b ^ (a << 10); \
    c = c - a; c = c - b; c = c ^ (b >> 15); \
  } while (0)

uint32_t ceph_tpu_torch_hash32(uint32_t a) {
  uint32_t h = SEED ^ a, b = a, x = XPAD, y = YPAD;
  MIX(b, x, h);
  MIX(y, a, h);
  return h;
}

uint32_t ceph_tpu_torch_hash32_2(uint32_t a, uint32_t b) {
  uint32_t h = SEED ^ a ^ b, x = XPAD, y = YPAD;
  MIX(a, b, h);
  MIX(x, a, h);
  MIX(b, y, h);
  return h;
}

uint32_t ceph_tpu_torch_hash32_3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = SEED ^ a ^ b ^ c, x = XPAD, y = YPAD;
  MIX(a, b, h);
  MIX(c, x, h);
  MIX(y, a, h);
  MIX(b, x, h);
  MIX(y, c, h);
  return h;
}

uint32_t ceph_tpu_torch_hash32_4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  uint32_t h = SEED ^ a ^ b ^ c ^ d, x = XPAD, y = YPAD;
  MIX(a, b, h);
  MIX(c, d, h);
  MIX(a, x, h);
  MIX(y, b, h);
  MIX(c, x, h);
  MIX(y, d, h);
  return h;
}

uint32_t ceph_tpu_torch_hash32_5(uint32_t a, uint32_t b, uint32_t c, uint32_t d,
                           uint32_t e) {
  uint32_t h = SEED ^ a ^ b ^ c ^ d ^ e, x = XPAD, y = YPAD;
  MIX(a, b, h);
  MIX(c, d, h);
  MIX(e, x, h);
  MIX(y, a, h);
  MIX(b, x, h);
  MIX(y, c, h);
  MIX(d, x, h);
  MIX(y, e, h);
  return h;
}

// crush_ln fixed-point LUTs, injected once from Python (the generated
// tables in ceph_tpu_torch/crush/_ln_tables.py).  RH_LH has 258 entries
// (index1 in [256, 512] step 2 maps to [0, 257] after the -256 bias),
// LL has 256.
static int64_t RH_LH[258];
static int64_t LL[256];
static int tables_ready = 0;

void ceph_tpu_torch_set_ln_tables(const int64_t* rh_lh, const int64_t* ll) {
  memcpy(RH_LH, rh_lh, sizeof(RH_LH));
  memcpy(LL, ll, sizeof(LL));
  tables_ready = 1;
}

int ceph_tpu_torch_ln_tables_ready(void) { return tables_ready; }

// 2^44 * log2(xin + 1) — twin of mapper.py crush_ln
static int64_t crush_ln_fp(uint32_t xin) {
  uint32_t x = (xin + 1u);
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    int bits = 0;
    uint32_t v = x & 0x1FFFFu;
    // 16 - bit_length(v); v >= 1 because of the +1 above
    while (v < 0x8000u) { v <<= 1; ++bits; }
    x <<= bits;
    iexpon = 15 - bits;
  }
  uint32_t index1 = (x >> 8) << 1;
  int64_t rh = RH_LH[index1 - 256];
  int64_t lh = RH_LH[index1 + 1 - 256];
  uint64_t xl64 = ((uint64_t)x * (uint64_t)rh) >> 48;
  int64_t result = (int64_t)iexpon << 44;
  int64_t llv = LL[xl64 & 0xFF];
  lh += llv;
  lh >>= (48 - 12 - 32);
  return result + lh;
}

// One straw2 draw: generate_exponential_distribution semantics
// (mapper.py straw2_draw).  C's int64 division truncates toward zero,
// matching the Python _div64 helper.
static int64_t straw2_draw_c(uint32_t x, int32_t item, uint32_t r,
                             uint32_t weight) {
  uint32_t u = ceph_tpu_torch_hash32_3(x, (uint32_t)item, r) & 0xFFFFu;
  int64_t ln = crush_ln_fp(u) - 0x1000000000000LL;
  return ln / (int64_t)weight;  // ln <= 0, weight > 0
}

// Whole straw2 bucket choose: returns the ARG INDEX (not item id) of
// the winner — first index wins ties, draw == S64_MIN for zero
// weights — mirroring bucket_straw2_choose in mapper.py.
int32_t ceph_tpu_torch_straw2_choose(uint32_t x, uint32_t r, const int32_t* ids,
                               const uint32_t* weights, int32_t n) {
  int32_t high = 0;
  int64_t high_draw = 0;
  for (int32_t i = 0; i < n; ++i) {
    int64_t draw;
    if (weights[i]) {
      draw = straw2_draw_c(x, ids[i], r, weights[i]);
    } else {
      draw = INT64_MIN;
    }
    if (i == 0 || draw > high_draw) {
      high = i;
      high_draw = draw;
    }
  }
  return high;
}

}  // extern "C"

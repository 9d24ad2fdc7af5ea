// GF(2) bit-matrix product over chunk bytes, for Hopper (sm_90a).
//
// Computes, for an (8m, 8k) 0/1 matrix B and (k, S) uint8 data,
//
//   out[u, s] bit c  =  XOR over (i, b) of  B[8u+c, 8i+b] & bit b of data[i, s]
//
// i.e. the (m, k) GF(2^8) matrix whose bit expansion is B, applied to the
// bytes of every column s (erasure encode with the generator, decode with
// a per-erasure-signature matrix).  Optionally batched over a leading
// axis, and in one of two modes (the template's MODE, besides the stage
// cuts below): store out = f(data), or "acc" out = out ^ f(data ^ seed).
// A kernel of its own (gf_encode_compare_kernel, below) compares instead:
// flags[b, u] = 1 where f(data[b]) differs from the stored parity[b]
// anywhere in row u, else 0.
//
// Replaces the three Pallas TPU kernels of the JAX package's
// ceph_tpu/ops/rs_kernels.py: gf_bitmatmul_pallas (_bitmatmul_kernel),
// gf_bitmatmul_pallas_grouped (_grouped_kernel) and
// gf_bitmatmul_pallas_acc (its inner `kern`), plus the batched XLA paths
// gf_bitmatmul and gf_encode_compare (deep scrub's re-encode-compare,
// whose expected parity never reaches memory here).  On the TPU the
// product runs on the MXU as an int8 matmul over unpacked bits; here no
// bit tensor is formed at all.  The
// grouped TPU kernel packs column groups into blockdiag(C, ..., C) to
// fill the MXU; the function, and so every output byte, is the same as
// the ungrouped kernel's, so on the card a grouped call is an ungrouped
// launch.
//
// Arithmetic.  Row r = 8u + c of B, restricted to input row i, is a byte
// mask; the host builds it once per bit-matrix, copied into all four
// bytes of a 32-bit word (mask * 0x01010101), so that the inner loop
// needs no byte shuffle.  A thread holds W words (4W adjacent columns) of
// each input row.  Bit row r of output byte u is the word
// a_r = XOR_i (x_i & mask[r][i]) (one LOP3 per input word), whose byte
// parities are the output bits.  The eight a_r of a byte are folded as a
// tree: rows (c, c+4) with nibble folds and one select (fold_pair), then
// (c, c+2) with 2-bit folds, then (c, c+1) with 1-bit folds (2 shifts, 2
// XORs and one select a pair).  That is 35 operations for the eight rows,
// against about 72 for a parity fold per row, and it leaves bit c of each
// byte at its place.  RS(8,3) costs 8m.k + 35m = 297 integer operations
// per 4 columns.  Rows (c, c+4) are formed together and merged at once,
// so that few words stay live.  Codes with k > 8 take 8-row chunks;
// parity is linear, so the chunks' a_r simply XOR together.
//
// Masks.  The host keeps them on the device per bit-matrix: replicated
// ([u][chunk][c][i], at most kReplicatedBytes), or for wide codes (k + m
// up to 256) packed four input rows to a word and spread with
// __byte_perm.  Each block copies them to shared memory with one
// coalesced load per thread, issued after its first item's data loads so
// that the two are in flight together; the inner loop reads four masks
// with one broadcast 16-byte load.  (Masks in the launch's
// __grid_constant__ parameter block are slower: indexed by loop
// counters, each becomes an LDC per use.)
//
// What bounds it (H100 SXM: 132 SMs, 64 int32 lanes each, about 16.7 T
// int32 op/s at 1.98 GHz; 3.35 TB/s).  An RS(8,3) encode moves (k + m) S
// bytes: 1.72 us at S = 512 Ki and 0.88 ms at S = 256 Mi (the acc form
// also reads the carry: 1.12 ms).  At 297 / 4 operations a column the
// integer ALUs need about 2.4 us and 1.2 ms for the same shapes: the
// encode is ALU-bound at every size (the acc loop runs at about two
// thirds of that rate).  A 1-erasure decode (m = 1) needs 99 / 4
// operations a column and is held by its bytes.  Every instruction of the
// inner loop is an ALU one, so a full 8-row chunk (k = 8) runs without
// per-row checks.  At object sizes a launch's fixed latency (about
// 3.5 us) is as large as its work; there the host's launch plan gives a
// thread 8 columns (W = 2), one thread per item, and 16 (W = 4) only at
// large S, where the grid is capped at 8 blocks per SM and each thread
// strides over items (4 columns a thread were slower at every shape
// measured).  The batch axis is folded into the flat item index, so a
// batch of short rows spreads like one long row.
//
// Tensor cores are not used.  The int8 mma/wgmma form needs each data bit
// expanded to a byte (about 48 integer operations a column) and 24
// parities packed back (about 36): more ALU work than the whole tree
// fold, so the cheap product buys nothing.  Hopper has no binary (.b1)
// tensor-core type at full rate.  Nor is cp.async or TMA used: each byte
// is loaded once, into registers, and the loads of the object-sized
// launches are all issued at the start.
//
// The compare (deep scrub's re-encode-compare) is one launch that writes
// the (batch, m) bool mask itself: no memset, no atomic, no cast after
// it.  Its work is split into units, one (item of 8 columns, stored row)
// pair each, so a thread forms one output row's product (the store's
// pair / fold_stage2 / fold_stage3), not m of them: RS(8,3) scrub's
// (8, 8, 65536) is 196,608 units, about two a thread on 264 blocks of
// 384.
// A warp takes one row of 32 items (the masks' loads broadcast; they are
// read through L1, with no copy into shared memory, so no round trip
// comes before the first load), and the rows of those 32 items are
// neighbouring warps, which share the data's lines.  A unit issues the
// loads of its data words and of its stored row's words together: no
// DRAM round trip waits at a unit's tail.  Each batch entry is `parts`
// blocks; each block ORs its units' differences (one bit a row), parts
// 1.. post theirs to a slot (8 bytes, bit 32 set), and part 0 takes
// them, clears each slot for the next launch and writes every flag of
// its entry once.  Part 0 waits on its partners, so the launch is
// cooperative: every block resident at once, or the launch is refused.
// The host's plan (rs_kernels.compare_plan) takes a block an SM where
// that gives each thread one unit, else two blocks an SM.
// The stage cuts (modes 3-5) replace the ablation probe of the JAX
// package's tools/perf_lab2.py (make_ablate, its pallas_call at :76),
// which cuts the TPU encode after load, bit extraction or the MXU
// product.  Each runs this kernel's own loop, launch plan and mask copy
// up to its stage and writes the probe's output: data[0:m] (load),
// data[0:m] & 1 (extract), f(data) & 1 (product); "full" is kStore.
// This kernel has no extraction stage of its own (its byte masks select
// the bits inside the product's LOP3), so the extract cut forms the 8k
// bit planes (x >> b) & 0x01010101 that the TPU kernel unpacks: its cost
// over the load cut is what unpacking would cost here.  The product cut
// forms all 8m bit rows but skips the tree fold.  Every value a cut
// would not need is passed to an empty asm volatile (keep_live), so
// nvcc keeps all k input rows' loads and the work up to the stage.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.  It makes no query
// call: the host computes the plan from the SM count it has cached.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kReplicatedBytes = 48 * 1024;  // replicated masks up to this size
constexpr int kMaxSmemBytes = 232448;        // a block's shared memory on sm_90

// What the kernel does with each output word (2 is not a mode of this
// kernel: the compare has its own, gf_encode_compare_kernel).
enum Mode : int {
  kStore = 0,    // out = f(data)
  kAcc = 1,      // out ^= f(data ^ seed), in place
  // The stage cuts (the measurement probe's ablation): the loop runs up
  // to its stage over every input row, then writes an (m, S) uint8 out.
  kCutLoad = 3,     // out = data[0:m]
  kCutExtract = 4,  // out = data[0:m] & 1
  kCutProduct = 5,  // out = f(data) & 1
};

// Keeps x live: the compiler must compute it into a register here, so a
// stage cut cannot drop the work before its stage (no instruction is
// emitted for the statement itself).
__device__ __forceinline__ void keep_live(uint32_t x) {
  asm volatile("" ::"r"(x));
}

// Blocks of kThreads each SM must hold at once (the register budget: 64
// registers a thread for 8 columns, 80 for 16).
template <int W>
constexpr int kBlocksPerSm = W == 4 ? 3 : 4;

struct Params {
  const uint8_t* data;
  uint8_t* out;            // the compare: the (batch, m) bool flags
  const uint8_t* parity;   // the compare: the stored (batch, m, s) parity
  const uint32_t* masks;   // device: [u][chunk][c][i] replicated, or packed
  long long s;
  unsigned items_per_row;  // ceil(s / 4W)
  unsigned items;          // batch * items_per_row (the compare: unused)
  int k, m, nch;           // nch: 8-row chunks of the input
  uint32_t seed_rep;       // acc seed in all four bytes
  int vec;                 // rows aligned for W-word vector access
  int packed;              // masks four input rows to a word
};

// The 4W bytes at q, of which the first rem lie inside S (the rest read
// as zero and are not written): the ragged or unaligned path.
template <int W>
__device__ __forceinline__ void load_bytes(uint32_t (&w)[W], const uint8_t* q,
                                           long long rem) {
#pragma unroll
  for (int j = 0; j < W; ++j) w[j] = 0u;
#pragma unroll
  for (int b = 0; b < 4 * W; ++b)
    if (b < rem) w[b >> 2] |= uint32_t(q[b]) << (8 * (b & 3));
}

template <int W>
__device__ __forceinline__ void store_bytes(uint8_t* q, long long rem,
                                            const uint32_t (&w)[W]) {
#pragma unroll
  for (int b = 0; b < 4 * W; ++b)
    if (b < rem) q[b] = uint8_t(w[b >> 2] >> (8 * (b & 3)));
}

// W aligned words at q.  NC: through the read-only cache (not for the
// carry, which this kernel writes).
template <int W, bool NC>
__device__ __forceinline__ void load_vec(uint32_t (&w)[W], const uint8_t* q) {
  if constexpr (W == 4) {
    const auto* v4 = reinterpret_cast<const uint4*>(q);
    const uint4 v = NC ? __ldg(v4) : *v4;
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
    static_assert(W == 2, "8 or 16 columns a thread");
    const auto* v2 = reinterpret_cast<const uint2*>(q);
    const uint2 v = NC ? __ldg(v2) : *v2;
    w[0] = v.x; w[1] = v.y;
  }
}

template <int W>
__device__ __forceinline__ void store_vec(uint8_t* q, const uint32_t (&w)[W]) {
  if constexpr (W == 4)
    *reinterpret_cast<uint4*>(q) = make_uint4(w[0], w[1], w[2], w[3]);
  else
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[1]);
}

// bits of a where keep is set, bits of b elsewhere (one LOP3)
__device__ __forceinline__ uint32_t pick(uint32_t keep, uint32_t a, uint32_t b) {
  return (a & keep) | (b & ~keep);
}

// Stage 1 of the tree fold: bit rows c (lo) and c + 4 (hi) merged, the
// nibble fold of row c in the low nibble of each byte, of row c + 4 in
// the high nibble.
__device__ __forceinline__ uint32_t fold_pair(uint32_t lo, uint32_t hi) {
  return pick(0x0F0F0F0Fu, lo ^ (lo >> 4), hi ^ (hi << 4));
}

// Stage 2: the merged pairs of rows (c, c + 4) and (c + 2, c + 6), folded
// to two bits per row: bits 0-1 of each byte row c, 2-3 row c + 2, 4-5
// row c + 4, 6-7 row c + 6.
__device__ __forceinline__ uint32_t fold_stage2(uint32_t b0, uint32_t b2) {
  return pick(0x33333333u, b0 ^ (b0 >> 2), b2 ^ (b2 << 2));
}

// Stage 3: the stage-2 words of c = 0 and c = 1, folded to the parity of
// bit row c at bit c of each byte.
__device__ __forceinline__ uint32_t fold_stage3(uint32_t d0, uint32_t d1) {
  return pick(0x55555555u, d0 ^ (d0 >> 1), d1 ^ (d1 << 1));
}

// Masks of output row 8u + c against input rows 8 * chunk + 4q .. + 3,
// base = u * nch + chunk, from the block's shared copy: one broadcast
// 16-byte load (replicated), or one word spread by __byte_perm (packed:
// byte t of word q is input row 4q + t).
template <bool PACKED>
__device__ __forceinline__ void mask_quad(const uint32_t* sm, int base, int c,
                                          int q, uint32_t (&mk)[4]) {
  if constexpr (PACKED) {
    const uint32_t w = sm[(base * 8 + c) * 2 + q];
#pragma unroll
    for (int t = 0; t < 4; ++t) mk[t] = __byte_perm(w, 0u, 0x1111u * t);
  } else {
    const uint4 v = reinterpret_cast<const uint4*>(sm)[(base * 8 + c) * 2 + q];
    mk[0] = v.x; mk[1] = v.y; mk[2] = v.z; mk[3] = v.w;
  }
}

// One item: 4W columns of one batch row.  d and o point at its first
// column in input row 0 and output row 0 (the compare: o is the stored
// parity's); rem = S - that column; fast: the item lies inside S and the
// rows are aligned for W-word vectors.
struct Item {
  const uint8_t* d;
  uint8_t* o;
  long long rem;
  bool fast;
};

// Item j of batch row bi.
template <int W>
__device__ __forceinline__ Item item_at(const Params& p, uint8_t* out, unsigned bi,
                                        unsigned j) {
  const long long col = (long long)j * (4 * W);
  Item it;
  it.d = p.data + (long long)bi * p.k * p.s + col;
  it.o = out + (long long)bi * p.m * p.s + col;
  it.rem = p.s - col;
  it.fast = p.vec && it.rem >= 4 * W;
  return it;
}

template <int W>
__device__ __forceinline__ Item locate(const Params& p, unsigned t) {
  const unsigned bi = t / p.items_per_row;
  return item_at<W>(p, p.out, bi, t - bi * p.items_per_row);
}

// Input rows 8 * ch .. 8 * ch + 7 of the item (rows past k are not read).
template <int MODE, int W>
__device__ __forceinline__ void load_chunk(const Params& p, const Item& it,
                                           int ch, uint32_t (&x)[8][W]) {
  const int nrow = min(8, p.k - 8 * ch);
  const uint8_t* q = it.d + (long long)(8 * ch) * p.s;
  if (it.fast) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nrow) load_vec<W, true>(x[i], q + i * p.s);
  } else {
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i < nrow) load_bytes<W>(x[i], q + i * p.s, it.rem);
  }
  if (MODE == kAcc) {
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < W; ++j) x[i][j] ^= p.seed_rep;
  }
}

// lo ^= x_i & ml_i and hi ^= x_i & mh_i over input rows i = 4q .. 4q + 3
// below nrow (FULL: all of them).
template <int W, bool FULL>
__device__ __forceinline__ void and_xor(const uint32_t (&x)[8][W], int q,
                                        int nrow, const uint32_t (&ml)[4],
                                        const uint32_t (&mh)[4],
                                        uint32_t (&lo)[W], uint32_t (&hi)[W]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (FULL || 4 * q + i < nrow) {
#pragma unroll
      for (int j = 0; j < W; ++j) {
        lo[j] ^= x[4 * q + i][j] & ml[i];
        hi[j] ^= x[4 * q + i][j] & mh[i];
      }
    }
  }
}

// Bit rows c (lo) and c + 4 (hi) of output byte u over the item (XOR
// over input rows i of x_i & mask), formed together.  x holds input
// chunk 0 when loaded (k <= 8: it is never reloaded); other chunks are
// loaded here.  Masks come four at a time.
template <int MODE, int W, bool PACKED>
__device__ __forceinline__ void products(const Params& p, const uint32_t* sm,
                                         const Item& it, uint32_t (&x)[8][W],
                                         bool loaded, int u, int c,
                                         uint32_t (&lo)[W], uint32_t (&hi)[W]) {
#pragma unroll
  for (int j = 0; j < W; ++j) lo[j] = hi[j] = 0u;
  for (int ch = 0; ch < p.nch; ++ch) {
    if (!loaded || p.nch > 1) load_chunk<MODE, W>(p, it, ch, x);
    const int nrow = min(8, p.k - 8 * ch);
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      uint32_t ml[4], mh[4];
      mask_quad<PACKED>(sm, u * p.nch + ch, c, q, ml);
      mask_quad<PACKED>(sm, u * p.nch + ch, c + 4, q, mh);
      // a full chunk (k = 8, the common case) runs with no row checks
      if (nrow == 8)
        and_xor<W, true>(x, q, 8, ml, mh, lo, hi);
      else
        and_xor<W, false>(x, q, nrow, ml, mh, lo, hi);
    }
  }
}

// Bit rows c and c + 4 of output byte u, merged by fold_pair into out.
template <int MODE, int W, bool PACKED>
__device__ __forceinline__ void pair(const Params& p, const uint32_t* sm,
                                     const Item& it, uint32_t (&x)[8][W],
                                     bool loaded, int u, int c,
                                     uint32_t (&out)[W]) {
  uint32_t lo[W], hi[W];
  products<MODE, W, PACKED>(p, sm, it, x, loaded, u, c, lo, hi);
#pragma unroll
  for (int j = 0; j < W; ++j) out[j] = fold_pair(lo[j], hi[j]);
}

template <int W>
__device__ __forceinline__ void store_row(const Item& it, uint8_t* orow,
                                          const uint32_t (&res)[W]) {
  if (it.fast)
    store_vec<W>(orow, res);
  else
    store_bytes<W>(orow, it.rem, res);
}

// kCutLoad and kCutExtract: every input row of the item is loaded (and,
// for kCutExtract, cut into its eight bit planes (x >> b) & 0x01010101,
// the TPU kernel's unpacking), each value kept live; then output row u
// is input row u (kCutLoad) or its bit plane 0 (kCutExtract).  Needs
// m <= k (the host checks).
template <int MODE, int W>
__device__ __forceinline__ void cut_early(const Params& p, const Item& it,
                                          uint32_t (&x)[8][W], bool loaded) {
  for (int ch = 0; ch < p.nch; ++ch) {
    if (!loaded || ch > 0) load_chunk<MODE, W>(p, it, ch, x);
    const int nrow = min(8, p.k - 8 * ch);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      if (i >= nrow) continue;
#pragma unroll
      for (int j = 0; j < W; ++j) {
        if (MODE == kCutLoad) {
          keep_live(x[i][j]);
        } else {
#pragma unroll
          for (int b = 0; b < 8; ++b) keep_live((x[i][j] >> b) & 0x01010101u);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int row = 8 * ch + i;
      if (i >= nrow || row >= p.m) continue;
      uint32_t res[W];
#pragma unroll
      for (int j = 0; j < W; ++j)
        res[j] = MODE == kCutLoad ? x[i][j] : x[i][j] & 0x01010101u;
      store_row<W>(it, it.o + (long long)row * p.s, res);
    }
  }
}

// kCutProduct: all 8m bit rows of the product are formed (the kernel's
// own AND-XOR loop, each row kept live), but not folded: output byte u is
// the byte parity of bit row 0 alone, i.e. bit 0 of f(data) row u.
template <int MODE, int W, bool PACKED>
__device__ __forceinline__ void cut_product(const Params& p, const uint32_t* sm,
                                            const Item& it, uint32_t (&x)[8][W],
                                            bool loaded) {
  for (int u = 0; u < p.m; ++u) {
    uint32_t row0[W];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      uint32_t lo[W], hi[W];
      products<MODE, W, PACKED>(p, sm, it, x, loaded || u + c > 0, u, c, lo, hi);
#pragma unroll
      for (int j = 0; j < W; ++j) {
        keep_live(lo[j]);
        keep_live(hi[j]);
        if (c == 0) row0[j] = lo[j];
      }
    }
    uint32_t res[W];
#pragma unroll
    for (int j = 0; j < W; ++j) {
      uint32_t t = row0[j] ^ (row0[j] >> 4);
      t ^= t >> 2;
      t ^= t >> 1;
      res[j] = t & 0x01010101u;
    }
    store_row<W>(it, it.o + (long long)u * p.s, res);
  }
}

// Every output byte of one item.  The bit rows of output byte u are
// taken in pairs (c, c + 4) and merged as soon as they are formed: pairs
// 0 and 2 by fold_pair and stage 2 into d[0], then pairs 1 and 3 into
// d[1], so that few words per column word are live at once.  Then the
// mode's epilogue: store, XOR into the carry, or compare.
template <int MODE, int W, bool PACKED>
__device__ __forceinline__ void item(const Params& p, const uint32_t* sm,
                                     const Item& it, uint32_t (&x)[8][W],
                                     bool loaded) {
  if constexpr (MODE == kCutLoad || MODE == kCutExtract) {
    cut_early<MODE, W>(p, it, x, loaded);
    return;
  }
  if constexpr (MODE == kCutProduct) {
    cut_product<MODE, W, PACKED>(p, sm, it, x, loaded);
    return;
  }
  for (int u = 0; u < p.m; ++u) {
    uint32_t d[2][W];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      uint32_t b0[W], b2[W];
      pair<MODE, W, PACKED>(p, sm, it, x, loaded || u + h > 0, u, h, b0);
      pair<MODE, W, PACKED>(p, sm, it, x, true, u, h + 2, b2);
#pragma unroll
      for (int j = 0; j < W; ++j) d[h][j] = fold_stage2(b0[j], b2[j]);
    }
    uint32_t res[W];
#pragma unroll
    for (int j = 0; j < W; ++j) res[j] = fold_stage3(d[0][j], d[1][j]);
    uint8_t* orow = it.o + (long long)u * p.s;
    if (MODE == kAcc) {
      uint32_t prev[W];
      if (it.fast)
        load_vec<W, false>(prev, orow);
      else
        load_bytes<W>(prev, orow, it.rem);
#pragma unroll
      for (int j = 0; j < W; ++j) res[j] ^= prev[j];
    }
    store_row<W>(it, orow, res);
  }
}

template <int MODE, int W, bool PACKED>
__device__ __forceinline__ void run(const Params& p, uint32_t* sm) {
  const unsigned t0 = blockIdx.x * kThreads + threadIdx.x;
  const unsigned stride = gridDim.x * kThreads;
  // the first item's rows are in flight while the masks are copied
  uint32_t x[8][W];
  const bool pre = p.nch == 1 && t0 < p.items;
  if (pre) load_chunk<MODE, W>(p, locate<W>(p, t0), 0, x);
  const int n = p.m * p.nch * (PACKED ? 16 : 64);
  for (int j = threadIdx.x; j < n; j += kThreads) sm[j] = __ldg(p.masks + j);
  __syncthreads();
  for (unsigned t = t0; t < p.items; t += stride)
    item<MODE, W, PACKED>(p, sm, locate<W>(p, t), x, pre && t == t0);
}

template <int MODE, int W>
__global__ void __launch_bounds__(kThreads, kBlocksPerSm<W>)
gf_bitmatmul_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(16) uint32_t smem[];
  if (p.packed)
    run<MODE, W, true>(p, smem);
  else
    run<MODE, W, false>(p, smem);
}

size_t smem_bytes(int m, int nch, bool packed) {
  return size_t(m) * nch * (packed ? 16 : 64) * sizeof(uint32_t);
}

template <int MODE, int W>
int launch(const Params& p, int blocks, cudaStream_t stream) {
  const size_t smem = smem_bytes(p.m, p.nch, p.packed != 0);
  if (smem > 48 * 1024) {  // wide codes only: opt in above the default
    const cudaError_t err = cudaFuncSetAttribute(
        gf_bitmatmul_kernel<MODE, W>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
  }
  gf_bitmatmul_kernel<MODE, W><<<blocks, kThreads, smem, stream>>>(p);
  return int(cudaGetLastError());
}

template <int MODE>
int launch_w(const Params& p, int words, int blocks, cudaStream_t stream) {
  switch (words) {
    case 2: return launch<MODE, 2>(p, blocks, stream);
    case 4: return launch<MODE, 4>(p, blocks, stream);
    default: return int(cudaErrorInvalidValue);
  }
}

// -- the compare ------------------------------------------------------

// The compare's block: at most kCompareMaxThreads threads, two of them an
// SM at 64 registers a thread, so 2 x SMs blocks are resident at once.
constexpr int kCompareMaxThreads = 512;
// Words a unit (4 kCompareWords columns of one stored row).
constexpr int kCompareWords = 2;
// The flags that one pass over an entry's data reduces, a bit each.
constexpr int kGroupRows = 32;
// Polls of a slot before the launch traps rather than hangs.
constexpr unsigned kMaxPolls = 1u << 24;

struct CompareParams {
  Params p;
  int parts;                  // blocks a batch entry
  unsigned long long* slots;  // [batch][row group][part]; zero between launches
};

// One unit: stored row u of one item (ok: the item lies inside the row).
struct Unit {
  Item it;
  int u;
  bool ok;
};

// Unit w of the row group of rows u0 .. u0 + rows - 1: chunk c = w / 32
// of 32 units is stored row u0 + c % rows of items (c / rows) * 32 +
// lane, so a warp shares its row (the masks' loads broadcast) and the
// rows of 32 items are neighbouring warps.
__device__ __forceinline__ Unit unit_at(const Params& p, uint8_t* parity, unsigned b,
                                        unsigned w, int u0, unsigned rows) {
  const unsigned c = w >> 5;
  const unsigned ci = c / rows;
  const unsigned g = ci * 32u + (w & 31u);
  Unit un;
  un.ok = g < p.items_per_row;
  un.u = u0 + int(c - ci * rows);
  un.it = item_at<kCompareWords>(p, parity, b, un.ok ? g : 0u);
  return un;
}

// A unit's loads, issued together: input chunk 0 (k <= 8; wider codes
// load each chunk in the product) and the stored row's words.
__device__ __forceinline__ void unit_loads(const Params& p, const Unit& un,
                                           uint32_t (&x)[8][kCompareWords],
                                           uint32_t (&y)[kCompareWords]) {
  if (p.nch == 1) load_chunk<kStore, kCompareWords>(p, un.it, 0, x);
  const uint8_t* q = un.it.o + (long long)un.u * p.s;
  if (un.it.fast)
    load_vec<kCompareWords, true>(y, q);
  else
    load_bytes<kCompareWords>(y, q, un.it.rem);
}

// Output row u of the item XOR the stored row: nonzero where they differ.
// The product and fold are the store's (pair, fold_stage2, fold_stage3).
template <bool PACKED>
__device__ __forceinline__ uint32_t compare_row(const Params& p, const uint32_t* masks,
                                                const Item& it,
                                                uint32_t (&x)[8][kCompareWords], int u,
                                                const uint32_t (&stored)[kCompareWords]) {
  constexpr int W = kCompareWords;
  uint32_t d[2][W];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    uint32_t b0[W], b2[W];
    pair<kStore, W, PACKED>(p, masks, it, x, true, u, h, b0);
    pair<kStore, W, PACKED>(p, masks, it, x, true, u, h + 2, b2);
#pragma unroll
    for (int j = 0; j < W; ++j) d[h][j] = fold_stage2(b0[j], b2[j]);
  }
  uint32_t diff = 0u;
#pragma unroll
  for (int j = 0; j < W; ++j) diff |= fold_stage3(d[0][j], d[1][j]) ^ stored[j];
  return diff;
}

// The OR of v over the block, to every thread (red: a word a warp).
__device__ __forceinline__ uint32_t block_or(uint32_t v, uint32_t* red) {
  v = __reduce_or_sync(0xffffffffu, v);
  if ((threadIdx.x & 31u) == 0u) red[threadIdx.x >> 5] = v;
  __syncthreads();
  uint32_t all = 0u;
  for (unsigned w = 0; w < blockDim.x >> 5; ++w) all |= red[w];
  __syncthreads();
  return all;
}

__device__ __forceinline__ unsigned long long slot_load(const unsigned long long* q) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(v) : "l"(q) : "memory");
  return v;
}

__device__ __forceinline__ void slot_store(unsigned long long* q, unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(q), "l"(v) : "memory");
}

// A partner block's word, once its slot holds it (bit 32 set); the slot
// is cleared again for the next launch.
__device__ __forceinline__ uint32_t take(unsigned long long* q) {
  unsigned long long v;
  unsigned polls = 0;
  while (((v = slot_load(q)) >> 32) == 0ull)
    if (++polls == kMaxPolls) __trap();
  slot_store(q, 0ull);
  return uint32_t(v);
}

// Block i takes part i % parts of batch entry b = i / parts: its thread t
// units part * T + t, + parts * T, ... of each row group (kGroupRows
// stored rows: one group for m <= 32).  A unit loads its item's data and
// its stored row together, forms that row's product (the masks read
// through L1, no copy first) and compares.  The block ORs its units'
// bits; with parts > 1 the other parts post theirs to their slots and
// part 0 takes them, then writes each flag once.
template <bool PACKED>
__device__ __forceinline__ void compare_run(const CompareParams& cp) {
  __shared__ uint32_t red[kCompareMaxThreads / 32];
  const Params& p = cp.p;
  const unsigned parts = unsigned(cp.parts);
  const unsigned b = blockIdx.x / parts;
  const unsigned part = blockIdx.x - b * parts;
  const unsigned g0 = part * blockDim.x + threadIdx.x;
  const unsigned stride = parts * blockDim.x;
  const unsigned chunks = (p.items_per_row + 31u) / 32u;
  uint8_t* parity = const_cast<uint8_t*>(p.parity);
  const int groups = (p.m + kGroupRows - 1) / kGroupRows;
  for (int grp = 0; grp < groups; ++grp) {
    const int u0 = grp * kGroupRows;
    const unsigned rows = unsigned(min(kGroupRows, p.m - u0));
    uint32_t bad = 0u;  // bit r: stored row u0 + r differs
    for (unsigned w = g0; w < chunks * rows * 32u; w += stride) {
      const Unit un = unit_at(p, parity, b, w, u0, rows);
      if (!un.ok) continue;
      uint32_t x[8][kCompareWords], y[kCompareWords];
      unit_loads(p, un, x, y);
      if (compare_row<PACKED>(p, p.masks, un.it, x, un.u, y) != 0u) bad |= 1u << (un.u - u0);
    }
    uint32_t all = block_or(bad, red);
    if (parts > 1) {
      unsigned long long* slot = cp.slots + ((long long)b * groups + grp) * parts;
      if (part != 0) {
        if (threadIdx.x == 0) slot_store(slot + part, (1ull << 32) | all);
        continue;
      }
      uint32_t theirs = 0u;
      for (unsigned q = threadIdx.x + 1; q < parts; q += blockDim.x) theirs |= take(slot + q);
      all |= block_or(theirs, red);
    }
    if (threadIdx.x < rows)
      p.out[(long long)b * p.m + u0 + threadIdx.x] = uint8_t((all >> threadIdx.x) & 1u);
  }
}

__global__ void __launch_bounds__(kCompareMaxThreads, 2)
gf_encode_compare_kernel(const __grid_constant__ CompareParams cp) {
  if (cp.p.packed)
    compare_run<true>(cp);
  else
    compare_run<false>(cp);
}

}  // namespace

extern "C" {

// For b < batch: mode 0, out[b] = f(data[b]); mode 1, out[b] ^=
// f(data[b] ^ seed); the stage cuts, mode 3 out[b] = data[b][0:m], mode 4
// data[b][0:m] & 1 (both need m <= k), mode 5 f(data[b]) & 1.
// data: (batch, k, s), out: (batch, m, s), contiguous.  masks: device
// array of m * nch * 64 replicated words, or with packed != 0 of
// m * nch * 16 packed words (nch = ceil(k / 8)).  words (2 or 4) and
// blocks are the host's launch plan.  Returns a cudaError_t value (0 on
// success).
int ceph_gf_bitmatmul(const void* data, void* out, const void* masks, int packed, int k,
                      int m, long long s, int batch, int mode, int seed, int words,
                      int blocks, void* stream) {
  if (k < 1 || m < 1 || k + m > 256 || s < 0 || batch < 0 || blocks < 1 ||
      (words != 2 && words != 4) || mode < kStore || mode > kCutProduct ||
      mode == 2 || ((mode == kCutLoad || mode == kCutExtract) && m > k))
    return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  if (s == 0 || batch == 0) return 0;
  const int nch = (k + 7) / 8;
  const long long per_row = (s + 4 * words - 1) / (4 * words);
  const long long items = per_row * batch;
  if (items >= (1ll << 31)) return int(cudaErrorInvalidValue);
  if (smem_bytes(m, nch, packed != 0) >
      size_t(packed ? kMaxSmemBytes : kReplicatedBytes))
    return int(cudaErrorInvalidValue);
  const auto aligned = [words](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & uintptr_t(4 * words - 1)) == 0;
  };
  Params p;
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint8_t*>(out);
  p.parity = nullptr;
  p.masks = static_cast<const uint32_t*>(masks);
  p.s = s;
  p.items_per_row = unsigned(per_row);
  p.items = unsigned(items);
  p.k = k;
  p.m = m;
  p.nch = nch;
  p.seed_rep = mode == kAcc ? (uint32_t(seed) & 0xFFu) * 0x01010101u : 0u;
  // every row starts aligned when s is a multiple of the vector width
  p.vec = s % (4 * words) == 0 && aligned(data) && aligned(out);
  p.packed = packed != 0;
  switch (mode) {
    case kAcc: return launch_w<kAcc>(p, words, blocks, st);
    case kCutLoad: return launch_w<kCutLoad>(p, words, blocks, st);
    case kCutExtract: return launch_w<kCutExtract>(p, words, blocks, st);
    case kCutProduct: return launch_w<kCutProduct>(p, words, blocks, st);
    default: return launch_w<kStore>(p, words, blocks, st);
  }
}

// flags[b, u] = 1 where f(data[b]) row u differs from parity[b] row u,
// else 0, for b < batch: one launch, each flag written once.  data:
// (batch, k, s) and parity: (batch, m, s) contiguous; flags: batch * m
// bytes (torch.bool).  masks as for ceph_gf_bitmatmul.  parts (blocks a
// batch entry) and threads (a multiple of 32 up to 512) are the host's
// launch plan; with parts > 1 the launch is cooperative (refused unless
// every block is resident at once: batch * parts <= 2 x the SMs) and
// slots are n_slots >= batch * ceil(m / 32) * parts zeroed 8-byte words
// on the device, which the launch leaves zero, for one stream at a time.
// Returns a cudaError_t value (0 on success).
int ceph_gf_encode_compare(const void* data, const void* parity, void* flags,
                           const void* masks, void* slots, long long n_slots, int packed,
                           int k, int m, long long s, int batch, int parts, int threads,
                           void* stream) {
  if (k < 1 || m < 1 || k + m > 256 || s < 0 || batch < 0 || parts < 1 ||
      (parity == nullptr && s > 0) || threads < 32 || threads > kCompareMaxThreads ||
      threads % 32 != 0)
    return int(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  constexpr int W = kCompareWords;
  const long long groups = (m + kGroupRows - 1) / kGroupRows;
  const long long per_row = (s + 4 * W - 1) / (4 * W);
  if ((per_row + 31) / 32 * 32 * min(m, kGroupRows) >= (1ll << 31) ||
      (long long)batch * parts >= (1ll << 31) || (long long)parts * threads >= (1ll << 31) ||
      (parts > 1 && (slots == nullptr || n_slots < batch * groups * parts)))
    return int(cudaErrorInvalidValue);
  const auto aligned = [](const void* ptr) {
    return (reinterpret_cast<uintptr_t>(ptr) & uintptr_t(4 * W - 1)) == 0;
  };
  CompareParams cp;
  Params& p = cp.p;
  p.data = static_cast<const uint8_t*>(data);
  p.out = static_cast<uint8_t*>(flags);
  p.parity = static_cast<const uint8_t*>(parity);
  p.masks = static_cast<const uint32_t*>(masks);
  p.s = s;
  p.items_per_row = unsigned(per_row);
  p.items = 0u;
  p.k = k;
  p.m = m;
  p.nch = (k + 7) / 8;
  p.seed_rep = 0u;
  p.vec = s % (4 * W) == 0 && aligned(data) && aligned(parity);
  p.packed = packed != 0;
  cp.parts = parts;
  cp.slots = static_cast<unsigned long long*>(slots);
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeCooperative;
  attr.val.cooperative = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch) * unsigned(parts));
  cfg.blockDim = dim3(unsigned(threads));
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = parts > 1 ? 1 : 0;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, gf_encode_compare_kernel, cp);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"

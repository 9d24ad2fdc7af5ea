// Single-launch CLAY repair of one lost chunk, for Hopper (sm_90a).
//
// Computes, for the staged helper sub-chunks H of a CLAY(k, m, d = k+m-1)
// code (n_helpers rows, P repair planes, sc bytes a cell; shortened nodes
// as zero rows), the lost chunk as sub_chunk_no cells of sc bytes:
//
//   A  U[j]  = ca * H[a_h, p] ^ cb * H[b_h, b_p]     (j < K = k + nu)
//   B  V[e]  = sum_j D[e][j] * U[j]                  (e < Q = q)
//   C  out[z_e] = ch * H[e_h, p] ^ cu * V[e]
//
// for every repair plane p: stage A fills the uncoupled values of the K
// survivor nodes (a copy of one helper sub-chunk, or a 2-term pair solve
// over the node's and its partner's coupled values), stage B is the inner
// MDS decode of the lost node's q-row, stage C the lost chunk's coupled
// values (a copy of the lost node's U, or a 2-term solve over a q-row
// helper's C and its U).  All products are in GF(2^8) over 0x11d.
//
// Replaces the JAX package's jitted ClayRepairProgram._run
// (ceph_tpu/ec/plugins/clay_jit.py:69), one XLA program of gathers,
// three groups of GF(2) bit-matmuls and scatters.
//
// Design.  The three stages are linear and column-wise, so the host
// composes them (clay_cuda.RepairSchedule.table): in plane p each output
// e is one GF(2^8) combination out[z_e] = sum_i c[i][e] * x_i of the
// plane's S shared inputs (every a- and b-operand of stage A, through
// stage B) and one private input (H[e_h, p], through stage C; absent
// where its coefficient is 0).  For CLAY(8,4,11) that is S = 14 and
// 59 products a word, against the three stages' 12 + 32 + 8 products
// each behind an xtime ladder.  A block takes one plane (blockIdx.y),
// copies its slice of the table to shared memory and turns the inputs'
// sub-chunk numbers into byte offsets once; a thread takes W words (4W
// columns), kThreads words apart: two where the cells are aligned, one
// where they are not (byte loads).  It issues the loads of all its
// inputs (up to kChunk shared ones, and the private ones) before any
// arithmetic, so its 2K + Q round trips are in flight together.
//
// The multiply.  A byte x splits into fields x[0:3], x[3:6] and x[6:8];
// c * x is the XOR of c * (each field at its place), and each of those
// is one PRMT on a table of 8 (or 4) product bytes held in two words
// (one): T0[v] = c v, T1[v] = c (v << 3), T2[v] = c (v << 6).  PRMT
// picks output byte t by nibble t of its selector, so a word's three
// selectors put byte t's field at nibble t; x + (x >> 12) of the masked
// field does it in one LEA, with the word's bytes 1 and 2 swapped
// (nibble 1 holds byte 2's field).  The swap is the same for every
// product, so the sums keep it and one PRMT a stored word undoes it.
// The selectors depend on x alone and serve every output: 8 integer
// instructions an input word (2 SHF, 3 LOP3, 3 LEA), then 3 PRMT and
// 2 LOP3 a product, against an xtime ladder's 5 a bit of the constant.
// The host builds the 5-word tables once per schedule; a product reads
// them with one broadcast 16-byte and one 4-byte shared load.
//
// What bounds it (H100 SXM: 3.35 TB/s; 132 SMs x 64 INT32 lanes at
// 1.98 GHz).  The function's bound is its bytes: CLAY(8,4,11) with
// 32 MiB chunks moves (11 x 16 + 64) x 512 KiB = 120 MiB, 0.0376 ms; its
// GF(2^8) products, as 8x8 bit-matrix products at the int8 tensor-core
// rate, take less.  The SASS of clay_repair_kernel<4, 2, true>
// (chip_smoke.py's sass_clay_ops line) holds 1330 integer instructions
// for its two words, kChunk = 16 shared inputs unrolled: about 665 a
// word (PRMT 208, LOP3 197, LEA 67, IMAD 59, IADD3 48, SHF 46.5, ISETP
// 34.5, SEL 5), about 600 of them run at S = 14.  That is 0.075 ms of
// integer issue over the card at the 32 MiB chunk, where the launch runs
// at about 44% of its byte bound (PERF.md); the xtime ladders of the
// first design issued about 1.1-1.3 k a word.  At the 4 MiB object (2048
// words a plane, 128 blocks) the launch is latency-bound: one round of
// loads, about 14% of its byte bound.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxQ = 8;
constexpr int kChunk = 16;  // shared inputs whose loads are issued together
constexpr int kMaxSmemBytes = 48 * 1024;  // a block's slice and offsets

// The three PRMT selectors of a word: nibble t of each holds the field
// of byte t (bytes 1 and 2 swapped), with bit 3 of every nibble clear.
struct Sel {
  uint32_t s0, s1, s2;
};

__device__ __forceinline__ Sel selectors(uint32_t x) {
  const uint32_t v0 = x & 0x07070707u;
  const uint32_t v1 = (x >> 3) & 0x07070707u;
  const uint32_t v2 = (x >> 6) & 0x03030303u;
  return {v0 + (v0 >> 12), v1 + (v1 >> 12), v2 + (v2 >> 12)};
}

// PRMT in its default mode: byte t of the result is byte s[4t, 4t+3) of
// (b:a), bit 3 of the nibble asking for its sign.  The selectors keep
// bit 3 clear, so this is __byte_perm without the mask that the
// intrinsic puts on its selector.
__device__ __forceinline__ uint32_t prmt(uint32_t a, uint32_t b, uint32_t s) {
#ifdef __CUDA_ARCH__
  uint32_t r;
  asm("prmt.b32 %0, %1, %2, %3;" : "=r"(r) : "r"(a), "r"(b), "r"(s));
  return r;
#else
  return __byte_perm(a, b, s);  // host builds of the device code
#endif
}

// The three lookups of c * x for the four bytes of the word whose
// selectors are s (bytes 1 and 2 swapped); t01 = (T0 low, T0 high, T1
// low, T1 high), t2 = T2.  Their XOR is the product.
__device__ __forceinline__ uint4 lookups(const uint4& t01, uint32_t t2, const Sel& s) {
  return {prmt(t01.x, t01.y, s.s0), prmt(t01.z, t01.w, s.s1), prmt(t2, 0u, s.s2), 0u};
}

// The 4 bytes at q, of which rem lie inside the cell (zeros past it;
// kAligned: sc % 4 == 0, so rem > 0 means all four).
template <bool kAligned>
__device__ __forceinline__ uint32_t load4(const uint8_t* q, long long rem) {
  if (rem <= 0) return 0u;
  if constexpr (kAligned) {
    return __ldg(reinterpret_cast<const uint32_t*>(q));
  } else {
    uint32_t v = 0;
    for (int i = 0; i < 4; ++i)
      if (i < rem) v |= uint32_t(q[i]) << (8 * i);
    return v;
  }
}

template <bool kAligned>
__device__ __forceinline__ void store4(uint8_t* cell, long long col, long long sc, uint32_t v) {
  if (col >= sc) return;
  if constexpr (kAligned) {
    *reinterpret_cast<uint32_t*>(cell + col) = v;
  } else {
    for (int i = 0; i < 4; ++i)
      if (col + i < sc) cell[col + i] = uint8_t(v >> (8 * i));
  }
}

// One plane's slice of the table (clay_cuda.RepairSchedule.table): the
// product tables of input i and output e at i * Q + e, the shared
// inputs i < S then the private row i = S; t01 as (S + 1) Q uint4, t2
// as (S + 1) Q words; then the S + Q inputs' sub-chunk indices (row * P
// + plane, -1: absent) and the Q outputs' sub-chunks.
__host__ __device__ constexpr int slice_words(int S, int Q) { return 5 * Q * (S + 1) + S + 2 * Q; }

// A block's shared memory: the slice, padded to 8 bytes, then the S + Q
// inputs' byte offsets in H.
__host__ __device__ constexpr int offsets_at(int S, int Q) { return (slice_words(S, Q) + 1) & ~1; }
__host__ __device__ constexpr size_t smem_bytes(int S, int Q) {
  return size_t(offsets_at(S, Q)) * 4 + size_t(S + Q) * 8;
}

// Words w0 + j * kThreads (j < W) of one plane: hc = H + 4 * w0,
// cols[j] = 4 * that word.  off: the inputs' byte offsets in H (-1:
// absent), the block's.
template <int Q, int W, bool kAligned>
__device__ __forceinline__ void repair_words(const uint8_t* __restrict__ hc,
                                             uint8_t* __restrict__ out,
                                             const int32_t* slice, const long long* off,
                                             int S, long long sc,
                                             const long long (&cols)[W]) {
  const int nprod = Q * (S + 1);
  const uint4* t01 = reinterpret_cast<const uint4*>(slice);
  const uint32_t* t2 = reinterpret_cast<const uint32_t*>(slice + 4 * nprod);
  const int32_t* oz = slice + 5 * nprod + S + Q;
  // word j: rem[j] bytes of the cell left at its column, at hc + rel[j]
  long long rem[W], rel[W];
#pragma unroll
  for (int j = 0; j < W; ++j) {
    rem[j] = sc - cols[j];
    rel[j] = cols[j] - cols[0];
  }
  // the private inputs' loads go out with the first chunk's
  uint32_t xp[Q][W];
#pragma unroll
  for (int e = 0; e < Q; ++e) {
    const long long o = off[S + e];
#pragma unroll
    for (int j = 0; j < W; ++j)
      xp[e][j] = o >= 0 ? load4<kAligned>(hc + o + rel[j], rem[j]) : 0u;
  }
  uint32_t acc[Q][W];
#pragma unroll
  for (int e = 0; e < Q; ++e)
#pragma unroll
    for (int j = 0; j < W; ++j) acc[e][j] = 0u;
  for (int base = 0; base < S; base += kChunk) {
    // past S the chunk reloads its last input (no branch); those loads
    // are not used
    uint32_t x[kChunk][W];
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      const uint8_t* cell = hc + off[min(base + i, S - 1)];
#pragma unroll
      for (int j = 0; j < W; ++j) x[i][j] = load4<kAligned>(cell + rel[j], rem[j]);
    }
#pragma unroll
    for (int i = 0; i < kChunk; ++i) {
      if (base + i >= S) break;
      Sel s[W];
#pragma unroll
      for (int j = 0; j < W; ++j) s[j] = selectors(x[i][j]);
#pragma unroll
      for (int e = 0; e < Q; ++e) {
        const uint4 t = t01[(base + i) * Q + e];
        const uint32_t u = t2[(base + i) * Q + e];
#pragma unroll
        for (int j = 0; j < W; ++j) {
          const uint4 l = lookups(t, u, s[j]);
          acc[e][j] ^= l.x ^ l.y ^ l.z;
        }
      }
    }
  }
#pragma unroll
  for (int e = 0; e < Q; ++e) {
    if (off[S + e] >= 0) {
      const uint4 t = t01[S * Q + e];
      const uint32_t u = t2[S * Q + e];
#pragma unroll
      for (int j = 0; j < W; ++j) {
        const uint4 l = lookups(t, u, selectors(xp[e][j]));
        acc[e][j] ^= l.x ^ l.y ^ l.z;
      }
    }
    uint8_t* cell = out + (long long)oz[e] * sc;
#pragma unroll
    for (int j = 0; j < W; ++j)
      store4<kAligned>(cell, cols[j], sc, prmt(acc[e][j], 0u, 0x3120u));
  }
}

// -- kernel and launch --------------------------------------------------

template <int Q, int W, bool kAligned>
__global__ void __launch_bounds__(kThreads, 4)
clay_repair_kernel(const uint8_t* __restrict__ H, uint8_t* __restrict__ out,
                   const int32_t* __restrict__ table, int S, long long sc) {
  extern __shared__ __align__(16) int32_t slice[];
  long long* off = reinterpret_cast<long long*>(slice + offsets_at(S, Q));
  const int n = slice_words(S, Q);
  const int in0 = 5 * Q * (S + 1);  // the inputs' words in the slice
  const int32_t* src = table + (long long)blockIdx.y * n;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int32_t v = __ldg(src + i);
    slice[i] = v;
    // the inputs' byte offsets in H, once a block
    if (i >= in0 && i < in0 + S + Q) off[i - in0] = v >= 0 ? (long long)v * sc : -1ll;
  }
  __syncthreads();
  long long cols[W];
#pragma unroll
  for (int j = 0; j < W; ++j)
    cols[j] = 4ll * ((long long)blockIdx.x * kThreads * W + j * kThreads + threadIdx.x);
  if (cols[0] < sc) repair_words<Q, W, kAligned>(H + cols[0], out, slice, off, S, sc, cols);
}

// Two words a thread where aligned, one where not.
template <int Q>
cudaError_t launch(const uint8_t* H, uint8_t* out, const int32_t* table, int P, int S,
                   long long sc, bool aligned, cudaStream_t st) {
  const long long per_block = (long long)kThreads * (aligned ? 2 : 1);
  const dim3 grid(unsigned(((sc + 3) / 4 + per_block - 1) / per_block), unsigned(P));
  const size_t smem = smem_bytes(S, Q);
  if (aligned)
    clay_repair_kernel<Q, 2, true><<<grid, kThreads, smem, st>>>(H, out, table, S, sc);
  else
    clay_repair_kernel<Q, 1, false><<<grid, kThreads, smem, st>>>(H, out, table, S, sc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (sub_chunk_no, sc) <- the repair of H (n_helpers, P, sc), both
// contiguous on one device; table: P slices of 5Q(S + 1) + S + 2Q int32
// on that device (clay_cuda.RepairSchedule.table).  aligned: sc % 4 == 0
// and H, out 4-byte aligned (two words a thread, else one).  Refused
// where a block's slice and offsets pass kMaxSmemBytes.  Returns a
// cudaError_t value (0 on success).
int ceph_clay_repair(const void* H, void* out, const void* table, int P, int S, int Q,
                     long long sc, int aligned, void* stream) {
  if (P < 1 || P > 65535 || S < 1 || Q < 1 || Q > kMaxQ || sc < 1 ||
      (sc + 3) / 4 > (long long)kThreads * 0x7fffffffll ||
      smem_bytes(S, Q) > size_t(kMaxSmemBytes))
    return int(cudaErrorInvalidValue);
  auto h = static_cast<const uint8_t*>(H);
  auto o = static_cast<uint8_t*>(out);
  auto t = static_cast<const int32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  switch (Q) {
    case 1: return int(launch<1>(h, o, t, P, S, sc, al, st));
    case 2: return int(launch<2>(h, o, t, P, S, sc, al, st));
    case 3: return int(launch<3>(h, o, t, P, S, sc, al, st));
    case 4: return int(launch<4>(h, o, t, P, S, sc, al, st));
    case 5: return int(launch<5>(h, o, t, P, S, sc, al, st));
    case 6: return int(launch<6>(h, o, t, P, S, sc, al, st));
    case 7: return int(launch<7>(h, o, t, P, S, sc, al, st));
    default: return int(launch<8>(h, o, t, P, S, sc, al, st));
  }
}

}  // extern "C"

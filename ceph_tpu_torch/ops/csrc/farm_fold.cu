// The encode farm's parity fold, for Hopper (sm_90a): the XOR of n packed
// GF(2) partials.
//
//   out[i] = p[0][i] ^ p[1][i] ^ ... ^ p[n - 1][i],  i < N = m S
//
// for n (m, S) uint8 partials contiguous as (n, m, S), at any address.
//
// Replaces the combine of the chunk-sharded encode in the JAX package's
// ceph_tpu/parallel/encode_farm.py (sharded_encode_tp._encode, :113-122):
// there each shard's int32 accumulators (8m, S) are psum-ed over the mesh,
// reduced mod 2 and packed.  (sum a_i) mod 2 = XOR (a_i mod 2), so each
// rank's store kernel packs its own partial mod 2 and this kernel XORs the
// packed bytes: 1/32 of the int32 partials' bytes.
//
// What bounds it: bytes, (n + 1) N over the card's 3.35 TB/s (1.41 us at
// (n, m, S) = (2, 3, 524288), 2.35 us at n = 4).  It does one XOR a byte.
// At these sizes the whole input fits the loads a wave of threads has in
// flight, so the time is the launch, one DRAM round trip and the bytes.
//
// Design.  One kernel for every S and alignment.  The output (16-byte
// aligned: the wrapper allocates it) is cut into 16-byte chunks, one a
// thread (grid-stride past the grid's cap): it starts the loads of up to
// four partials before their XORs.  Many small threads beat fewer with
// more chunks each: at these sizes the whole input fits the loads of one
// wave, so what counts is how soon every load is under way.  (Asking L2 for
// whole 256-byte lines, and 1-D bulk copies into shared memory, were no
// faster.)  Partial r starts at p + r N, so where p or N is
// not a multiple of 16 its bytes lie at a phase of their own: then (a
// branch taken once, by every thread alike) the thread loads, for each
// partial, the two aligned 16-byte words that hold its chunk (the second
// only where the phase is not 0, so it never touches a word with no byte
// of the partial) and funnel-shifts them into place.  The N mod 16 tail
// bytes: a byte a thread of block 0.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kGroup = 4;  // partials whose loads are all under way before their XORs

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// The 16 bytes at byte `phase` (0 .. 15) of the 32 bytes lo:hi.
__device__ __forceinline__ uint4 realign(uint4 lo, uint4 hi, int phase) {
  const uint32_t w[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
  const int q = phase >> 2, s = (phase & 3) * 8;
  uint32_t x[5];
#pragma unroll
  for (int j = 0; j < 5; ++j)
    x[j] = q == 0 ? w[j] : q == 1 ? w[j + 1] : q == 2 ? w[j + 2] : w[j + 3];
  return make_uint4(__funnelshift_r(x[0], x[1], s), __funnelshift_r(x[1], x[2], s),
                    __funnelshift_r(x[2], x[3], s), __funnelshift_r(x[3], x[4], s));
}

// Chunk c of the XOR of n partials of N bytes at p, where some partial is
// not 16-byte aligned: up to four partials' loads before their XORs.
__device__ __forceinline__ uint4 fold_shifted(const uint8_t* p, long long N, int n, long long c) {
  uint4 acc = make_uint4(0u, 0u, 0u, 0u);
  for (int r0 = 0; r0 < n; r0 += kGroup) {
    uint4 v[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      if (r0 + g >= n) continue;
      const uintptr_t a = reinterpret_cast<uintptr_t>(p) + uintptr_t(r0 + g) * uintptr_t(N);
      const int phase = int(a & 15u);
      const uint4* q = reinterpret_cast<const uint4*>(a - phase) + c;
      v[g] = __ldg(q);
      if (phase) v[g] = realign(v[g], __ldg(q + 1), phase);
    }
#pragma unroll
    for (int g = 0; g < kGroup; ++g)
      if (r0 + g < n) acc = xor4(acc, v[g]);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
farm_fold_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out, long long N, int n) {
  const long long nvec = N >> 4;
  const long long stride = (long long)gridDim.x * kThreads;
  uint4* o = reinterpret_cast<uint4*>(out);
  if (((reinterpret_cast<uintptr_t>(p) | uintptr_t(N)) & 15u) == 0) {
    const uint4* q = reinterpret_cast<const uint4*>(p);
    for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < nvec; c += stride) {
      uint4 acc = make_uint4(0u, 0u, 0u, 0u);
      for (int r0 = 0; r0 < n; r0 += kGroup) {
        uint4 v[kGroup];
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (r0 + g < n) v[g] = __ldg(q + (r0 + g) * nvec + c);
#pragma unroll
        for (int g = 0; g < kGroup; ++g)
          if (r0 + g < n) acc = xor4(acc, v[g]);
      }
      o[c] = acc;
    }
  } else {
    for (long long c = (long long)blockIdx.x * kThreads + threadIdx.x; c < nvec; c += stride)
      o[c] = fold_shifted(p, N, n, c);
  }
  const int tail = int(N & 15);
  if (blockIdx.x == 0 && threadIdx.x < tail) {
    const long long i = (nvec << 4) + threadIdx.x;
    uint8_t acc = 0;
    for (int r = 0; r < n; ++r) acc ^= __ldg(p + r * N + i);
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// out[0:nbytes] = XOR over r < n of partials[r * nbytes : (r + 1) * nbytes]
// (any address; out 16-byte aligned), on `blocks` blocks of 256 threads,
// a 16-byte chunk a thread a step.  Returns a cudaError_t value (0 on
// success).
int ceph_farm_fold(const void* partials, void* out, long long nbytes, int n, int blocks,
                   void* stream) {
  if (nbytes < 0 || n < 1 || blocks < 1 || (reinterpret_cast<uintptr_t>(out) & 15u) != 0)
    return int(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  farm_fold_kernel<<<blocks, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(partials), static_cast<uint8_t*>(out), nbytes, n);
  return int(cudaGetLastError());
}

}  // extern "C"

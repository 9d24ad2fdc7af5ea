// The encode farm's parity fold, for Hopper (sm_90a): the XOR of n packed
// GF(2) partials.
//
//   out[i] = p[0][i] ^ p[1][i] ^ ... ^ p[n - 1][i],  i < N = m S
//
// for n (m, S) uint8 partials contiguous as (n, m, S).
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
//
// Design.  A thread takes 16 bytes of the output a step and loads the n
// partials' 16 bytes at that offset (four loads in flight, issued before
// the XORs), grid-stride over the output.  Where the partials or N are
// not 16-byte aligned (a ragged S), a byte a thread: only a direct call of
// sharded_encode_tp with such an S reaches that kernel: the encode
// service pads S to a power of two, at least 32768 / k bytes at its
// default min_bytes.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kInFlight = 4;  // partials' loads issued before the XORs

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

__global__ void __launch_bounds__(kThreads)
farm_fold_kernel(const uint4* __restrict__ p, uint4* __restrict__ out, long long nvec, int n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nvec; i += stride) {
    uint4 acc = make_uint4(0u, 0u, 0u, 0u);
    for (int r0 = 0; r0 < n; r0 += kInFlight) {
      uint4 v[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (r0 + u < n) v[u] = __ldg(p + (long long)(r0 + u) * nvec + i);
#pragma unroll
      for (int u = 0; u < kInFlight; ++u)
        if (r0 + u < n) acc = xor4(acc, v[u]);
    }
    out[i] = acc;
  }
}

__global__ void __launch_bounds__(kThreads)
farm_fold_bytes_kernel(const uint8_t* __restrict__ p, uint8_t* __restrict__ out, long long nbytes,
                       int n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < nbytes; i += stride) {
    uint8_t acc = 0;
    for (int r = 0; r < n; ++r) acc ^= __ldg(p + (long long)r * nbytes + i);
    out[i] = acc;
  }
}

}  // namespace

extern "C" {

// out[0:nbytes] = XOR over r < n of partials[r * nbytes : (r + 1) * nbytes],
// on `blocks` blocks of 256 threads.  Returns a cudaError_t value (0 on
// success).
int ceph_farm_fold(const void* partials, void* out, long long nbytes, int n, int blocks,
                   void* stream) {
  if (nbytes < 0 || n < 1 || blocks < 1) return int(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto a = reinterpret_cast<uintptr_t>(partials), o = reinterpret_cast<uintptr_t>(out);
  if (((a | o) & 15u) == 0 && nbytes % 16 == 0) {
    farm_fold_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const uint4*>(partials),
                                                  static_cast<uint4*>(out), nbytes / 16, n);
  } else {
    farm_fold_bytes_kernel<<<blocks, kThreads, 0, st>>>(static_cast<const uint8_t*>(partials),
                                                        static_cast<uint8_t*>(out), nbytes, n);
  }
  return int(cudaGetLastError());
}

}  // extern "C"

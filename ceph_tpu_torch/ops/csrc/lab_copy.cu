// Row copy for Hopper (sm_90a): out = src[0:rows] of a contiguous (R, N)
// uint8 array.
//
// Replaces the two copy probes of the JAX package's tools/perf_lab.py:
// copy_fn (its pallas_call at :61, rows 0:3 of an (8, S) array, (8, tile)
// blocks loaded) and main.fat_copy (:101, rows 0:384 of a (1024, N)
// array).  The TPU kernels copy block by block through VMEM; the first
// `rows` rows of a row-major array are one contiguous run of rows * N
// bytes, so here the copy is one flat run.
//
// What bounds it: bytes.  It reads rows * N bytes once and writes them
// once, 2 rows N bytes over the card's 3.35 TB/s: 0.120 ms for either
// probe's 192 MiB.  It does no arithmetic.
//
// Design.  Each block copies one contiguous chunk of the run (the host
// sizes the grid: up to 64 blocks an SM, so at the probes' 192 MiB a
// block's chunk is one pass of 32 KiB and the SMs finish together), 16
// bytes a thread a load, eight loads in flight a thread, neighbouring
// threads on neighbouring addresses.  Loads are
// ld.global.nc.L1::no_allocate and stores st.global.cs (streaming: the
// bytes are touched once).  It was chosen on the card against the first
// version's grid-stride loop, other vector counts and grids, no hints,
// L2 prefetch and evict-first hints, and TMA bulk-copy rings; PERF.md
// has every time.  The last nbytes % 16 bytes go a byte a thread of the
// first block; a run whose ends are not 16-byte aligned (a view that
// does not start on a row of an aligned allocation) is copied a byte a
// thread.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 8;  // 16-byte loads in flight a thread

__device__ __forceinline__ uint4 ld_stream(const uint4* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(uint4* p, uint4 v) {
  asm volatile("st.global.cs.v4.u32 [%0], {%1, %2, %3, %4};" ::"l"(p), "r"(v.x), "r"(v.y),
               "r"(v.z), "r"(v.w)
               : "memory");
}

// vectors [b * per_block, (b + 1) * per_block) to block b; per_block is a
// multiple of kThreads * kUnroll
__global__ void __launch_bounds__(kThreads)
lab_row_copy_kernel(const uint4* __restrict__ src, uint4* __restrict__ dst, long long nvec,
                    long long per_block, const uint8_t* __restrict__ src_tail,
                    uint8_t* __restrict__ dst_tail, int ntail) {
  const long long begin = (long long)blockIdx.x * per_block;
  const long long end = begin + per_block < nvec ? begin + per_block : nvec;
  for (long long i = begin + threadIdx.x; i < end; i += (long long)kThreads * kUnroll) {
    uint4 v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < end) v[u] = ld_stream(src + j);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long j = i + (long long)u * kThreads;
      if (j < end) st_stream(dst + j, v[u]);
    }
  }
  // the last nbytes % 16 bytes, one a thread of the first block
  if (blockIdx.x == 0 && threadIdx.x < ntail) dst_tail[threadIdx.x] = src_tail[threadIdx.x];
}

__global__ void __launch_bounds__(kThreads)
lab_row_copy_bytes_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                          long long n) {
  const long long stride = (long long)gridDim.x * kThreads;
  for (long long i = (long long)blockIdx.x * kThreads + threadIdx.x; i < n; i += stride)
    dst[i] = src[i];
}

}  // namespace

extern "C" {

// dst[0:nbytes] = src[0:nbytes] (the first rows * N bytes of a
// contiguous (R, N) array), on `blocks` blocks of 256 threads.  Returns a
// cudaError_t value (0 on success).
int ceph_lab_row_copy(const void* src, void* dst, long long nbytes, int blocks,
                      void* stream) {
  if (nbytes < 0 || blocks < 1) return int(cudaErrorInvalidValue);
  if (nbytes == 0) return 0;
  auto st = static_cast<cudaStream_t>(stream);
  const auto s = reinterpret_cast<uintptr_t>(src), d = reinterpret_cast<uintptr_t>(dst);
  if ((s | d) & 15u) {
    lab_row_copy_bytes_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), nbytes);
  } else {
    const long long nvec = nbytes / 16;
    const int ntail = int(nbytes % 16);
    const long long step = (long long)kThreads * kUnroll;
    const long long per_block = ((nvec + blocks - 1) / blocks + step - 1) / step * step;
    lab_row_copy_kernel<<<blocks, kThreads, 0, st>>>(
        static_cast<const uint4*>(src), static_cast<uint4*>(dst), nvec, per_block,
        static_cast<const uint8_t*>(src) + 16 * nvec,
        static_cast<uint8_t*>(dst) + 16 * nvec, ntail);
  }
  return int(cudaGetLastError());
}

}  // extern "C"

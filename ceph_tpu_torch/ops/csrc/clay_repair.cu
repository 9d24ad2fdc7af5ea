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
// helper's C and its U).  All products are in GF(2^8) over 0x11d.  The
// table (clay_cuda.RepairSchedule.table) gives, per plane, the
// source rows, planes and coefficients; every output cell is written by
// exactly one (plane, e).
//
// Replaces the JAX package's jitted ClayRepairProgram._run
// (ceph_tpu/ec/plugins/clay_jit.py:69), one XLA program of gathers,
// three groups of GF(2) bit-matmuls and scatters.
//
// Design.  Every stage is column-wise: byte c of every cell depends only
// on byte c of the inputs, and a plane's three stages read only that
// plane's survivors and their partners.  So a thread takes one 32-bit
// word (four columns) of one plane (blockIdx.y) and runs all three stages
// for it in registers: U is never stored, stage B accumulates the q
// values of V as each U[j] is formed.  A packed word times a constant is
// the xtime ladder x*2 = ((x & 0x7f7f7f7f) << 1) ^ (((x >> 7) & 0x01010101)
// * 0x1d), XOR-ing in x*2^b for each set bit b of the constant: the same
// bytes as the reference's 8x8 bit-matrix product for that constant.
// Stage B shares one ladder of U[j] across the q accumulators.  The
// block copies its plane's slice of the table to shared memory.  A ragged
// sc (not a multiple of 4) is handled here by byte loads and stores.
//
// What bounds it (H100 SXM: 3.35 TB/s).  The function's bound is its
// bytes: CLAY(8,4,11) with 32 MiB chunks moves (11 x 16 + 64) x 512 KiB =
// 120 MiB, 0.0376 ms; its GF(2^8) products, as 8x8 bit-matrix products at
// the int8 tensor-core rate, take less.  This design spends its time in
// the ladder instead: about 1.1-1.3 k INT32 instructions a word of a plane
// (8 survivors, 6 of them 2-term solves, the 8-step ladder into 4
// accumulators, 3 solves out), about 0.13-0.16 ms of issue over 132 SMs x
// 64 lanes at 1.98 GHz.  A cheaper multiply is the lever.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxQ = 8;

__device__ __forceinline__ uint32_t xtime4(uint32_t x) {
  return ((x & 0x7f7f7f7fu) << 1) ^ (((x >> 7) & 0x01010101u) * 0x1du);
}

// the four bytes of x, each times c in GF(2^8); c is the same for every
// thread of the launch, so the loop does not diverge
__device__ __forceinline__ uint32_t gf_mul4(uint32_t x, uint32_t c) {
  if (c == 1u) return x;
  uint32_t r = 0;
  while (c) {
    if (c & 1u) r ^= x;
    x = xtime4(x);
    c >>= 1;
  }
  return r;
}

template <bool kAligned>
__device__ __forceinline__ uint32_t load4(const uint8_t* cell, long long col, long long sc) {
  if (kAligned) return *reinterpret_cast<const uint32_t*>(cell + col);
  uint32_t v = 0;
  for (int i = 0; i < 4; ++i)
    if (col + i < sc) v |= uint32_t(cell[col + i]) << (8 * i);
  return v;
}

template <bool kAligned>
__device__ __forceinline__ void store4(uint8_t* cell, long long col, long long sc, uint32_t v) {
  if (kAligned) {
    *reinterpret_cast<uint32_t*>(cell + col) = v;
    return;
  }
  for (int i = 0; i < 4; ++i)
    if (col + i < sc) cell[col + i] = uint8_t(v >> (8 * i));
}

// Columns [col, col + 4) of plane p.  s: the plane's table slice,
// [4K) stage A (a_h, b_h, b_p, ca | cb << 8), [Q*K) stage B D[e][j],
// [3Q) stage C (out plane, e_h, ch | cu << 8).
template <int Q, bool kAligned>
__device__ __forceinline__ void repair_column(const uint8_t* __restrict__ H,
                                              uint8_t* __restrict__ out,
                                              const int32_t* s, int P, int K,
                                              long long sc, int p, long long col) {
  uint32_t acc[Q];
#pragma unroll
  for (int e = 0; e < Q; ++e) acc[e] = 0u;
  const int32_t* d = s + 4 * K;
  for (int j = 0; j < K; ++j) {
    const int32_t* a = s + 4 * j;
    const uint32_t cf = uint32_t(a[3]);
    uint32_t u = gf_mul4(load4<kAligned>(H + ((long long)a[0] * P + p) * sc, col, sc),
                         cf & 0xffu);
    if (cf >> 8)
      u ^= gf_mul4(load4<kAligned>(H + ((long long)a[1] * P + a[2]) * sc, col, sc), cf >> 8);
    uint32_t coef[Q];
#pragma unroll
    for (int e = 0; e < Q; ++e) coef[e] = uint32_t(d[e * K + j]);
#pragma unroll
    for (int b = 0; b < 8; ++b) {
#pragma unroll
      for (int e = 0; e < Q; ++e)
        if ((coef[e] >> b) & 1u) acc[e] ^= u;
      u = xtime4(u);
    }
  }
  const int32_t* c = d + Q * K;
#pragma unroll
  for (int e = 0; e < Q; ++e) {
    const uint32_t cf = uint32_t(c[3 * e + 2]);
    uint32_t v = gf_mul4(acc[e], cf >> 8);
    if (cf & 0xffu)
      v ^= gf_mul4(load4<kAligned>(H + ((long long)c[3 * e + 1] * P + p) * sc, col, sc),
                   cf & 0xffu);
    store4<kAligned>(out + (long long)c[3 * e] * sc, col, sc, v);
  }
}

// -- kernel and launch --------------------------------------------------

template <int Q, bool kAligned>
__global__ void __launch_bounds__(kThreads)
clay_repair_kernel(const uint8_t* __restrict__ H, uint8_t* __restrict__ out,
                   const int32_t* __restrict__ table, int P, int K, long long sc) {
  extern __shared__ int32_t slice[];
  const int p = blockIdx.y;
  const int n = 4 * K + Q * K + 3 * Q;
  const int32_t* src = table + (long long)p * n;
  for (int i = threadIdx.x; i < n; i += kThreads) slice[i] = src[i];
  __syncthreads();
  const long long col = 4ll * ((long long)blockIdx.x * kThreads + threadIdx.x);
  if (col < sc) repair_column<Q, kAligned>(H, out, slice, P, K, sc, p, col);
}

template <int Q>
cudaError_t launch(const uint8_t* H, uint8_t* out, const int32_t* table, int P, int K,
                   long long sc, bool aligned, cudaStream_t st) {
  const long long words = (sc + 3) / 4;
  const dim3 grid(unsigned((words + kThreads - 1) / kThreads), unsigned(P));
  const size_t smem = size_t(4 * K + Q * K + 3 * Q) * sizeof(int32_t);
  if (aligned)
    clay_repair_kernel<Q, true><<<grid, kThreads, smem, st>>>(H, out, table, P, K, sc);
  else
    clay_repair_kernel<Q, false><<<grid, kThreads, smem, st>>>(H, out, table, P, K, sc);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// out (sub_chunk_no, sc) <- the repair of H (n_helpers, P, sc), both
// contiguous on one device; table: P slices of 4K + QK + 3Q int32 on that
// device (clay_cuda.RepairSchedule.table).  aligned: sc % 4 == 0 and H,
// out 4-byte aligned.  Returns a cudaError_t value (0 on success).
int ceph_clay_repair(const void* H, void* out, const void* table, int P, int K, int Q,
                     long long sc, int aligned, void* stream) {
  if (P < 1 || P > 65535 || K < 1 || Q < 1 || Q > kMaxQ || sc < 1 ||
      (sc + 3) / 4 > (long long)kThreads * 0x7fffffffll ||
      size_t(4 * K + Q * K + 3 * Q) * sizeof(int32_t) > 48 * 1024)
    return int(cudaErrorInvalidValue);
  auto h = static_cast<const uint8_t*>(H);
  auto o = static_cast<uint8_t*>(out);
  auto t = static_cast<const int32_t*>(table);
  auto st = static_cast<cudaStream_t>(stream);
  const bool al = aligned != 0;
  switch (Q) {
    case 1: return int(launch<1>(h, o, t, P, K, sc, al, st));
    case 2: return int(launch<2>(h, o, t, P, K, sc, al, st));
    case 3: return int(launch<3>(h, o, t, P, K, sc, al, st));
    case 4: return int(launch<4>(h, o, t, P, K, sc, al, st));
    case 5: return int(launch<5>(h, o, t, P, K, sc, al, st));
    case 6: return int(launch<6>(h, o, t, P, K, sc, al, st));
    case 7: return int(launch<7>(h, o, t, P, K, sc, al, st));
    default: return int(launch<8>(h, o, t, P, K, sc, al, st));
  }
}

}  // extern "C"

// GF(2) bit-matrix product over chunk bytes, for Hopper (sm_90a).
//
// Computes, for an (8m, 8k) 0/1 matrix B and (k, S) uint8 data,
//
//   out[u, s] bit c  =  XOR over (i, b) of  B[8u+c, 8i+b] & bit b of data[i, s]
//
// i.e. the (m, k) GF(2^8) matrix whose bit expansion is B, applied to the
// bytes of every column s (erasure encode with the generator, decode with
// a per-erasure-signature matrix).  Optionally batched over a leading
// axis, and optionally in the "acc" form  out = out ^ f(data ^ seed).
//
// Replaces the three Pallas TPU kernels of the JAX package's
// ceph_tpu/ops/rs_kernels.py: gf_bitmatmul_pallas (_bitmatmul_kernel),
// gf_bitmatmul_pallas_grouped (_grouped_kernel) and
// gf_bitmatmul_pallas_acc (its inner `kern`), plus the batched XLA path
// gf_bitmatmul.  On the TPU the product runs on the MXU as an int8
// matmul over unpacked bits; here no bit tensor is formed at all.
//
// Design.  Each block turns B into byte masks M[r][i] = the bits b with
// B[r, 8i+b] = 1 and keeps them in shared memory (8m x k bytes, at most
// 131 KB for k + m <= 256), packed four input rows to a 32-bit word.
// Each thread owns 16 adjacent columns (one uint4 per input row, loaded
// coalesced), holds up to 8 input rows of them in registers, and for each
// output bit row r XORs
// (word_i & M[r][i] * 0x01010101) over i, folds each byte's parity
// (x ^= x>>4; x ^= x>>2; x ^= x>>1; & 0x01010101) and places it as bit c
// of output byte u.  Codes with k > 8 take several 8-row chunks; parity is
// linear, so the chunks' results XOR together.  Columns past S (a ragged
// tail) are read as zero and never written.
//
// What bounds it.  An RS(8,3) encode moves (k + m) S bytes: 0.88 ms at
// S = 256 MiB over 3.35 TB/s; the acc form also reads the carry,
// (k + 2m) S bytes.  This mask-and-parity form spends about 100 int32
// operations per column for RS(8,3) (an AND and an XOR per input word and
// output bit row, plus the parity folds), so it is likely held by the
// integer ALUs rather than by bytes.  Reaching the byte bound (int8
// mma/wgmma on bit planes, or a wider SWAR fold, with cp.async/TMA
// staging) is later work.
//
// Column groups.  The grouped TPU kernel packs g column groups into
// blockdiag(C, ..., C) to fill the MXU; the function, and so every output
// byte, is the same as the ungrouped kernel's.  On the card a grouped call
// is an ungrouped launch.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns cudaGetLastError() after it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 8;         // input rows held in registers per chunk
constexpr int kBlocksPerSm = 8;  // grid-stride loop: at most this many blocks per SM

__device__ __forceinline__ uint32_t byte_parity(uint32_t x) {
  x ^= x >> 4;
  x ^= x >> 2;
  x ^= x >> 1;
  return x & 0x01010101u;
}

// 16 bytes of one row from column col; bytes at or past s read as zero.
__device__ __forceinline__ uint4 load16(const uint8_t* row, long long col,
                                        long long s, bool vec) {
  if (vec && col + 16 <= s) return *reinterpret_cast<const uint4*>(row + col);
  uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < s) w[b >> 2] |= uint32_t(row[col + b]) << (8 * (b & 3));
  return make_uint4(w[0], w[1], w[2], w[3]);
}

__device__ __forceinline__ void store16(uint8_t* row, long long col,
                                        long long s, bool vec, uint4 v) {
  if (vec && col + 16 <= s) {
    *reinterpret_cast<uint4*>(row + col) = v;
    return;
  }
  const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int b = 0; b < 16; ++b)
    if (col + b < s) row[col + b] = uint8_t(w[b >> 2] >> (8 * (b & 3)));
}

__device__ __forceinline__ uint4 xor4(uint4 a, uint4 b) {
  return make_uint4(a.x ^ b.x, a.y ^ b.y, a.z ^ b.z, a.w ^ b.w);
}

// ACC: out = out ^ f(data ^ seed) in place (out is the carry).
template <bool ACC>
__global__ void __launch_bounds__(kThreads)
gf_bitmatmul_kernel(const uint8_t* __restrict__ bitmat,
                    const uint8_t* __restrict__ data, uint8_t* out, int k,
                    int m, long long s, int batch, long long data_bstride,
                    long long out_bstride, uint32_t seed_rep, bool vec) {
  extern __shared__ uint32_t masks[];  // [8m][kq]; byte t of word q: row 4q+t
  const int kq = (k + 3) >> 2;
  const int nr = 8 * m;
  for (int idx = threadIdx.x; idx < nr * kq; idx += blockDim.x) {
    const int r = idx / kq, q = idx - r * kq;
    uint32_t word = 0;
    for (int t = 0; t < 4; ++t) {
      const int i = 4 * q + t;
      if (i < k) {
        const uint8_t* src = bitmat + (long long)r * 8 * k + 8 * i;
        uint32_t mb = 0;
        for (int b = 0; b < 8; ++b) mb |= uint32_t(src[b] & 1u) << b;
        word |= mb << (8 * t);
      }
    }
    masks[idx] = word;
  }
  __syncthreads();

  const long long items = (s + 15) >> 4;
  const long long stride = (long long)gridDim.x * blockDim.x;
  const uint4 seed4 = make_uint4(seed_rep, seed_rep, seed_rep, seed_rep);
  for (int bi = blockIdx.y; bi < batch; bi += gridDim.y) {
    const uint8_t* d = data + bi * data_bstride;
    uint8_t* o = out + bi * out_bstride;
    for (long long it = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         it < items; it += stride) {
      const long long col = it << 4;
      uint4 x[kRows];
      for (int u = 0; u < m; ++u) {
        uint4 res = make_uint4(0u, 0u, 0u, 0u);
        for (int i0 = 0; i0 < k; i0 += kRows) {
          const int nrow = min(kRows, k - i0);
          // k <= 8: the rows stay in registers across all output rows
          if (u == 0 || k > kRows) {
#pragma unroll
            for (int i = 0; i < kRows; ++i) {
              if (i < nrow) {
                x[i] = load16(d + (long long)(i0 + i) * s, col, s, vec);
                if (ACC) x[i] = xor4(x[i], seed4);
              } else {
                x[i] = make_uint4(0u, 0u, 0u, 0u);
              }
            }
          }
#pragma unroll
          for (int c = 0; c < 8; ++c) {
            const uint32_t* mrow = masks + (8 * u + c) * kq + (i0 >> 2);
            uint4 acc = make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
            for (int qq = 0; qq < kRows / 4; ++qq) {
              if (4 * qq < nrow) {
                const uint32_t mq = mrow[qq];
#pragma unroll
                for (int t = 0; t < 4; ++t) {
                  // byte t of mq copied into all four bytes
                  const uint32_t mm = __byte_perm(mq, 0u, 0x1111u * t);
                  const uint4 v = x[4 * qq + t];
                  acc.x ^= v.x & mm;
                  acc.y ^= v.y & mm;
                  acc.z ^= v.z & mm;
                  acc.w ^= v.w & mm;
                }
              }
            }
            res.x ^= byte_parity(acc.x) << c;
            res.y ^= byte_parity(acc.y) << c;
            res.z ^= byte_parity(acc.z) << c;
            res.w ^= byte_parity(acc.w) << c;
          }
        }
        uint8_t* orow = o + (long long)u * s;
        if (ACC) res = xor4(res, load16(orow, col, s, vec));
        store16(orow, col, s, vec, res);
      }
    }
  }
}

template <bool ACC>
int launch(const uint8_t* bitmat, const uint8_t* data, uint8_t* out, int k,
           int m, long long s, int batch, long long data_bstride,
           long long out_bstride, uint32_t seed_rep, bool vec,
           cudaStream_t stream) {
  const size_t smem = size_t(8) * m * ((k + 3) / 4) * sizeof(uint32_t);
  cudaError_t err = cudaFuncSetAttribute(
      gf_bitmatmul_kernel<ACC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      int(smem));
  if (err != cudaSuccess) return int(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return int(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return int(err);
  const long long items = (s + 15) >> 4;
  long long blocks = (items + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * kBlocksPerSm;
  if (blocks > cap) blocks = cap;
  dim3 grid(unsigned(blocks), unsigned(batch < 65535 ? batch : 65535));
  gf_bitmatmul_kernel<ACC><<<grid, kThreads, smem, stream>>>(
      bitmat, data, out, k, m, s, batch, data_bstride, out_bstride, seed_rep,
      vec);
  return int(cudaGetLastError());
}

}  // namespace

extern "C" {

// out[b] = f(data[b]) for b < batch, or out[b] ^= f(data[b] ^ seed) when
// acc != 0.  bitmat: (8m, 8k) uint8 0/1, row-major.  data: (k, s) per
// batch entry, out: (m, s).  Returns a cudaError_t value (0 on success).
int ceph_gf_bitmatmul(const void* bitmat, const void* data, void* out, int k,
                      int m, long long s, int batch, long long data_bstride,
                      long long out_bstride, int acc, int seed, void* stream) {
  if (k < 1 || m < 1 || k + m > 256 || s < 0 || batch < 0)
    return int(cudaErrorInvalidValue);
  if (s == 0 || batch == 0) return 0;
  const auto aligned = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
  };
  // 16-byte vector access needs every row start aligned
  const bool vec = s % 16 == 0 && aligned(data) && aligned(out) &&
                   data_bstride % 16 == 0 && out_bstride % 16 == 0;
  const uint32_t seed_rep = (uint32_t(seed) & 0xFFu) * 0x01010101u;
  const auto* bm = static_cast<const uint8_t*>(bitmat);
  const auto* d = static_cast<const uint8_t*>(data);
  auto* o = static_cast<uint8_t*>(out);
  auto st = static_cast<cudaStream_t>(stream);
  if (acc)
    return launch<true>(bm, d, o, k, m, s, batch, data_bstride, out_bstride,
                        seed_rep, vec, st);
  return launch<false>(bm, d, o, k, m, s, batch, data_bstride, out_bstride,
                       0u, vec, st);
}

}  // extern "C"

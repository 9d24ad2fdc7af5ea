// Batched crc32c of equal-width lanes, for Hopper (sm_90a).
//
// Computes, for (B, W) uint8 lanes,
//
//   out[b] = ceph_crc32c(0, lane_b, W)
//
// the reflected Castagnoli register update (polynomial 0x82F63B78) from
// seed 0 with no inversion, as native/crc32c.cc does on the host.  That
// is bit for bit M_W @ bits(lane_b) of ops/hashing.py (byte i, bit j at
// column 8i+j, output bit p at weight 2^p).  Deep scrub folds the seed
// and the lane padding in on the host.
//
// Replaces the jitted XLA kernel of the JAX package's
// ceph_tpu/ops/hashing.py (_crc_kernel_jit.kern, entry
// batched_crc32c_device), which unpacked every lane to bits and ran the
// (32, 8W) GF(2) product as an int8 matmul on the MXU.  Here no bit
// tensor is formed: crc32c's linearity splits a lane into segments.
//
// Arithmetic.  Thread t of a block takes a 16-byte segment (one 16-byte
// load) and computes its seed-0 crc with two slice-by-8 steps (tables in
// shared memory).  Advancing a register through n zero bytes is
// multiplying it by x^(8n) modulo the polynomial (the operator S_n of
// hashing.py as one word, its column 31), so each thread multiplies its
// segment's crc by the advance from its segment's end to its block's end
// (a word per thread), the block XOR-reduces by warp shuffles and then
// across its eight warps, and thread 0 multiplies the block's crc by the
// advance from the block's end to the lane's end (a word per block of
// the lane) and atomicXors it into out[b], which the entry zeroes first.
// XOR is order-free, so the blocks of one lane need no order.  A lane
// narrower than a block (4096 B) reads as left-padded with zeros, which
// leaves a seed-0 crc unchanged.  The advance words and the tables are
// built on the host per width (hashing.kernel_operators) and kept on the
// device.
//
// What bounds it (H100 SXM: 3.35 TB/s; about 33 T thread-instructions/s
// at 1.98 GHz).  A (32, 65536) launch reads 2 MiB: 0.63 us.  Each thread
// spends about 16 shared-table lookups and 32 shift-and-XOR steps of the
// multiply (about 230 instructions) on 16 bytes: about 0.9 us for that
// launch.  At the scrub path's shapes a launch's fixed latency (several
// us) is larger than both.
//
// Plain C interface (ctypes); the memset and the launch go on the
// caller's stream and the function returns cudaGetLastError() after
// them.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSeg = 16;                      // lane bytes a thread
constexpr int kBlockBytes = kThreads * kSeg;  // lane bytes a block
constexpr int kTableWords = 8 * 256;          // slice-by-8 tables
constexpr uint32_t kPoly = 0x82F63B78u;

// a * b modulo the polynomial, reflected (bit 31 is x^0): no branches
__device__ __forceinline__ uint32_t multmodp(uint32_t a, uint32_t b) {
  uint32_t p = 0;
#pragma unroll
  for (int i = 31; i >= 0; --i) {
    p ^= b & (0u - ((a >> i) & 1u));
    b = (b >> 1) ^ (kPoly & (0u - (b & 1u)));
  }
  return p;
}

// One slice-by-8 step: the register after the 8 bytes lo, hi (lo first,
// the running register already XORed into lo), from register 0.
__device__ __forceinline__ uint32_t slice8(const uint32_t* t, uint32_t lo,
                                           uint32_t hi) {
  return t[7 * 256 + (lo & 0xff)] ^ t[6 * 256 + ((lo >> 8) & 0xff)] ^
         t[5 * 256 + ((lo >> 16) & 0xff)] ^ t[4 * 256 + (lo >> 24)] ^
         t[3 * 256 + (hi & 0xff)] ^ t[2 * 256 + ((hi >> 8) & 0xff)] ^
         t[1 * 256 + ((hi >> 16) & 0xff)] ^ t[0 * 256 + (hi >> 24)];
}

// ops: [kTableWords tables][kThreads thread advances][nblk block advances]
__global__ void __launch_bounds__(kThreads)
crc32c_lanes_kernel(const uint8_t* __restrict__ data, uint32_t* out,
                    const uint32_t* __restrict__ ops, long long width,
                    int nblk, int vec) {
  __shared__ __align__(16) uint32_t tab[kTableWords];
  __shared__ uint32_t part[kThreads / 32];
  const int t = threadIdx.x;
  const long long lane = blockIdx.x / nblk;
  const int j = int(blockIdx.x - lane * nblk);
  // the lane reads as left-padded to a whole block
  const long long pad = (long long)nblk * kBlockBytes - width;
  const long long off = (long long)j * kBlockBytes + t * kSeg - pad;
  const uint8_t* lp = data + lane * width;

  // the segment's load is in flight while the tables are copied
  uint32_t w[4];
  if (vec && off >= 0 && off + kSeg <= width) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(lp + off));
    w[0] = v.x; w[1] = v.y; w[2] = v.z; w[3] = v.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) w[q] = 0u;
#pragma unroll
    for (int b = 0; b < kSeg; ++b) {
      const long long i = off + b;
      if (i >= 0 && i < width) w[b >> 2] |= uint32_t(lp[i]) << (8 * (b & 3));
    }
  }
  const uint32_t to_block_end = __ldg(ops + kTableWords + t);
  for (int i = t; i < kTableWords / 4; i += kThreads)
    reinterpret_cast<uint4*>(tab)[i] = __ldg(reinterpret_cast<const uint4*>(ops) + i);
  __syncthreads();

  uint32_t c = slice8(tab, w[0], w[1]);
  c = slice8(tab, w[2] ^ c, w[3]);
  c = multmodp(to_block_end, c);
#pragma unroll
  for (int o = 16; o; o >>= 1) c ^= __shfl_xor_sync(0xffffffffu, c, o);
  if ((t & 31) == 0) part[t >> 5] = c;
  __syncthreads();
  if (t < 32) {
    c = t < kThreads / 32 ? part[t] : 0u;
#pragma unroll
    for (int o = kThreads / 64; o; o >>= 1) c ^= __shfl_xor_sync(0xffffffffu, c, o);
    if (t == 0) {
      c = multmodp(__ldg(ops + kTableWords + kThreads + j), c);
      if (c) atomicXor(out + lane, c);
    }
  }
}

}  // namespace

extern "C" {

// out[b] = crc32c(0, data[b], width) for b < batch.  data: (batch, width)
// contiguous; out: batch words, zeroed here; ops: device array of
// kTableWords + kThreads + ceil(width / kBlockBytes) words
// (hashing.kernel_operators(width)).  Returns a cudaError_t value (0 on
// success).
int ceph_crc32c_lanes(const void* data, void* out, const void* ops,
                      long long width, int batch, void* stream) {
  if (width < 1 || batch < 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const long long nblk = (width + kBlockBytes - 1) / kBlockBytes;
  if (nblk * batch >= (1ll << 31)) return int(cudaErrorInvalidValue);
  auto st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaMemsetAsync(out, 0, size_t(batch) * sizeof(uint32_t), st);
  if (err != cudaSuccess) return int(err);
  const int vec = (reinterpret_cast<uintptr_t>(data) & 15) == 0 && width % kSeg == 0;
  crc32c_lanes_kernel<<<unsigned(nblk * batch), kThreads, 0, st>>>(
      static_cast<const uint8_t*>(data), static_cast<uint32_t*>(out),
      static_cast<const uint32_t*>(ops), width, int(nblk), vec);
  return int(cudaGetLastError());
}

}  // extern "C"

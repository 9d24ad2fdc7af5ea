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
// Geometry.  A lane is one thread-block cluster of C = 1, 2, 4 or 8
// blocks of 128 threads (C = 1 launches without a cluster).  A thread
// walks VEC 16-byte loads a pass: VEC = 2 when the lane fits one block
// at 32 bytes a thread (W <= 4096), else 4.  C is the lane's blocks at
// that rate rounded up to a power of two, at most 8.  The lane reads as
// left-padded with zeros to C * 128 * L bytes (leading zeros leave a
// seed-0 crc unchanged); thread t of block rank r owns the contiguous
// segment (128 r + t) of L = 16 VEC passes bytes, the next pass's loads
// issued before this one's arithmetic, the register carried along.
//
// The 8-byte step.  The register after 8 bytes (the running register
// XORed into the first four) is the XOR of 16 table entries, one for each
// nibble of the 8 bytes: 16 tables of 16 words in shared memory.  A
// table spans 16 consecutive words, so the 32 lanes of one lookup touch
// at most 16 words in 16 distinct banks: one wavefront, where byte
// tables cost one lookup a byte but about 3.5 wavefronts at random banks.
//
// Combine.  Advancing a register through n zero bytes is multiplying it
// by x^(8n) modulo the polynomial, which for a fixed n is linear in the
// register: eight lookups, one a nibble, into an 8 x 16-word table.  The
// segments are joined by a binary tree: at level s each run of 2^s
// segments is advanced past the run after it (2^s L bytes) and the two
// are XORed.  Levels 0-4 are shuffles over a warp's lanes, 5-6 over the
// block's warps (through shared memory), 7-9 over the cluster's blocks:
// each block's word goes into rank 0's shared memory (distributed shared
// memory) between the two phases of one split cluster barrier (the first
// arrival is made at the kernel's start, so its wait costs nothing), and
// rank 0 finishes the tree; one thread writes out[b]: one device
// operation a call, no memset, no atomic.  The host builds the step
// tables and the ten levels' tables per width (hashing.kernel_operators).
//
// Why 128-thread blocks.  The cluster scheduler places a cluster's
// blocks inside one GPC, and with clusters of 4 or 8 only 120 of the 132
// SMs take them, so at (32, 65536) some SMs run two blocks while others
// sit idle; the slowest SM ends the launch.  Smaller blocks shrink that
// imbalance (chip_smoke.py's crc_sweep and PERF.md record the shapes).
//
// What bounds it (H100 SXM: 3.35 TB/s).  A (32, 65536) launch reads
// 2 MiB: 0.63 us.  Every lane byte costs two conflict-free lookups, 4.2 M
// for 2 MiB, 1024 wavefronts on each of 128 SMs (0.52 us at 1.98 GHz);
// at 16 MiB about 4 us beside the bytes' 5 us.  At the scrub path's
// shapes the launch's fixed latency, the blocks' placement and the
// combine's dependent steps are larger than both.
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kStepWords = 16 * 16;  // nibble tables of the 8-byte step
constexpr int kAdvWords = 8 * 16;    // nibble tables of one advance
// the combine's levels: 5 over a warp's lanes, 2 over the block's warps,
// 3 over the cluster's blocks
constexpr int kWarpLevels = 5;
constexpr int kBlockLevels = 2;
constexpr int kLevels = 10;
static_assert(1 << kBlockLevels == kWarps && 1 << kLevels == kThreads * kMaxCluster, "levels");

// The register after the 8 bytes lo, hi (lo first, the running register
// already XORed into lo), from register 0: s[16 j + v] is the register
// after the 8 bytes whose nibble j is v and every other nibble 0.
__device__ __forceinline__ uint32_t step8(const uint32_t* s, uint32_t lo, uint32_t hi) {
  uint32_t c = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) c ^= s[16 * j + ((lo >> (4 * j)) & 15)];
#pragma unroll
  for (int j = 0; j < 8; ++j) c ^= s[16 * (8 + j) + ((hi >> (4 * j)) & 15)];
  return c;
}

// The register c after the 16 bytes v (little-endian words).
__device__ __forceinline__ uint32_t step16(const uint32_t* s, uint32_t c, uint4 v) {
  c = step8(s, v.x ^ c, v.y);
  return step8(s, v.z ^ c, v.w);
}

// c times one fixed advance x^(8n) mod P: a[16 k + v] is the advance of
// the register v << 4k.
__device__ __forceinline__ uint32_t advance(const uint32_t* a, uint32_t c) {
  return a[0 * 16 + (c & 15)] ^ a[1 * 16 + ((c >> 4) & 15)] ^ a[2 * 16 + ((c >> 8) & 15)] ^
         a[3 * 16 + ((c >> 12) & 15)] ^ a[4 * 16 + ((c >> 16) & 15)] ^
         a[5 * 16 + ((c >> 20) & 15)] ^ a[6 * 16 + ((c >> 24) & 15)] ^ a[7 * 16 + (c >> 28)];
}

// Levels [first, first + n) of the tree over a warp's lanes: after them
// lane 0 holds its 2^n words joined, the first advanced past the rest.
__device__ __forceinline__ uint32_t join_lanes(const uint32_t* adv, uint32_t c, int first, int n) {
  for (int s = 0; s < n; ++s)
    c = advance(adv + (first + s) * kAdvWords, c) ^ __shfl_down_sync(0xffffffffu, c, 1 << s);
  return c;
}

// Lane bytes [off, off + 16 VEC) as VEC words, zeros outside [0, width):
// 16-byte loads where `aligned` (16-byte aligned lanes, width % 16 == 0)
// and the piece is whole, else a byte at a time.
template <int VEC>
__device__ __forceinline__ void load_pass(uint4 (&v)[VEC], const uint8_t* lp, long long off,
                                          long long width, bool aligned) {
#pragma unroll
  for (int u = 0; u < VEC; ++u) {
    const long long o = off + 16 * u;
    if (aligned && o >= 0 && o + 16 <= width) {
      v[u] = __ldg(reinterpret_cast<const uint4*>(lp + o));
    } else {
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      for (int b = 0; b < 16; ++b)
        if (o + b >= 0 && o + b < width) w[b >> 2] |= uint32_t(lp[o + b]) << (8 * (b & 3));
      v[u] = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// ops: [kStepWords step tables][kLevels advance tables of kAdvWords],
// table s advancing by 2^s L bytes, L = passes * 16 VEC the bytes a
// thread owns.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
crc32c_lanes_kernel(const uint8_t* __restrict__ data, uint32_t* __restrict__ out,
                    const uint32_t* __restrict__ ops, long long width, int passes, int aligned) {
  constexpr int kPassBytes = 16 * VEC;
  constexpr int kTableVecs = (kStepWords + kLevels * kAdvWords) / 4;
  constexpr int kCopies = (kTableVecs + kThreads - 1) / kThreads;
  __shared__ __align__(16) uint32_t tab[4 * kTableVecs];
  __shared__ uint32_t part[kWarps];
  __shared__ uint32_t slot[kMaxCluster];
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned csize = unsigned(cluster.num_blocks());
  const unsigned rank = unsigned(cluster.block_rank());
  // phase 0 of the cluster barrier: this block has started
  if (csize > 1) asm volatile("barrier.cluster.arrive.relaxed;" ::: "memory");
  const long long lane = blockIdx.x / csize;
  const int t = threadIdx.x;
  const int li = t & 31;
  const long long seg = (long long)passes * kPassBytes;
  const long long pad = seg * kThreads * csize - width;
  long long off = ((long long)rank * kThreads + t) * seg - pad;
  const uint8_t* lp = data + lane * width;

  // the first pass's loads and the table loads in flight together
  uint4 v[VEC];
  load_pass<VEC>(v, lp, off, width, aligned);
  uint4 w[kCopies];
#pragma unroll
  for (int q = 0; q < kCopies; ++q)
    if (q * kThreads + t < kTableVecs)
      w[q] = __ldg(reinterpret_cast<const uint4*>(ops) + q * kThreads + t);
#pragma unroll
  for (int q = 0; q < kCopies; ++q)
    if (q * kThreads + t < kTableVecs) reinterpret_cast<uint4*>(tab)[q * kThreads + t] = w[q];
  __syncthreads();

  uint32_t c = 0;
  for (int p = 0; p < passes; ++p) {
    uint4 next[VEC];
    if (p + 1 < passes) load_pass<VEC>(next, lp, off + kPassBytes, width, aligned);
#pragma unroll
    for (int u = 0; u < VEC; ++u) c = step16(tab, c, v[u]);
    off += kPassBytes;
#pragma unroll
    for (int u = 0; u < VEC; ++u) v[u] = next[u];
  }

  const uint32_t* adv = tab + kStepWords;
  c = join_lanes(adv, c, 0, kWarpLevels);  // lane 0: the warp's 32 segments
  if (li == 0) part[t >> 5] = c;
  __syncthreads();
  // warps past the first leave: a cluster barrier waits only for the
  // threads that have not exited
  if (t >= 32) return;
  c = join_lanes(adv, part[li & (kWarps - 1)], kWarpLevels, kBlockLevels);
  if (csize == 1) {
    if (li == 0) out[lane] = c;
    return;
  }
  // the cluster: each block's word into rank 0's shared memory once every
  // block has started (phase 0), then released to rank 0 (phase 1), which
  // joins the words
  asm volatile("barrier.cluster.wait;" ::: "memory");
  if (li == 0) *cluster.map_shared_rank(slot + rank, 0) = c;
  asm volatile("barrier.cluster.arrive;" ::: "memory");
  if (rank != 0) return;
  asm volatile("barrier.cluster.wait;" ::: "memory");
  c = join_lanes(adv, slot[li & (csize - 1)], kWarpLevels + kBlockLevels,
                 31 - __clz(int(csize)));
  if (li == 0) out[lane] = c;
}

}  // namespace

extern "C" {

// The launch's geometry for lanes of `width` bytes: 16-byte loads a
// thread a pass, blocks a lane (the cluster size) and passes a thread.
void ceph_crc32c_geometry(long long width, int* vec, int* cluster, long long* passes) {
  const int v = width <= 32ll * kThreads ? 2 : 4;
  const long long block_pass = 16ll * v * kThreads;
  const long long blocks = (width + block_pass - 1) / block_pass;
  int c = 1;
  while (c < kMaxCluster && c < blocks) c *= 2;
  *vec = v;
  *cluster = c;
  *passes = (width + c * block_pass - 1) / (c * block_pass);
}

// out[b] = crc32c(0, data[b], width) for b < batch.  data: (batch, width)
// contiguous; out: batch words, each written once; ops: device array of
// kStepWords + kLevels * kAdvWords words (hashing.kernel_operators(width)).  Returns a cudaError_t value (0 on
// success).
int ceph_crc32c_lanes(const void* data, void* out, const void* ops, long long width, int batch,
                      void* stream) {
  if (width < 1 || batch < 0) return int(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  int vec, cluster;
  long long passes;
  ceph_crc32c_geometry(width, &vec, &cluster, &passes);
  if ((long long)batch * cluster >= (1ll << 31) || passes >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  const int aligned = (reinterpret_cast<uintptr_t>(data) & 15) == 0 && width % 16 == 0;

  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(batch * cluster));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  const auto d = static_cast<const uint8_t*>(data);
  const auto o = static_cast<uint32_t*>(out);
  const auto w = static_cast<const uint32_t*>(ops);
  const cudaError_t err =
      vec == 2 ? cudaLaunchKernelEx(&cfg, crc32c_lanes_kernel<2>, d, o, w, width, int(passes), aligned)
               : cudaLaunchKernelEx(&cfg, crc32c_lanes_kernel<4>, d, o, w, width, int(passes), aligned);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"

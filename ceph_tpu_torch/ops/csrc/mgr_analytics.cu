// The mgr's cluster analytics in one launch, for Hopper (sm_90a).
//
// Computes, bit for bit, what analyze_numpy of mgr/analytics.py computes
// over the time-series store: int64 values (D, M, W), bool valid
// (D, M, W) and int64 cursor (D,), cursor[d] the oldest column of
// daemon d's ring.  Per metric m:
//
//   percentiles (M, 3)  nearest-rank p50 / p95 / p99 over every valid
//                       sample of m (all daemons, the whole window): the
//                       sample of rank pos = (p n + 99) // 100 - 1 in
//                       ascending order, 0 where n = 0
//   n_samples (M,)      n
//   ewma_scaled (D, M)  e = x << 8 at the first valid sample, then
//                       e += ((x << 8) - e) >> 2, oldest first
//   mean_scaled (D, M)  (sum << 8) // count, 0 where count = 0
//   count (D, M)        valid samples of the series
//   outlier (D, M)      count > 0, mean > 2 med and med > 0, med the
//                       lower median of the means of the daemons with
//                       samples (0 where none has)
//
// Replaces the jitted XLA program of the JAX package's
// ceph_tpu/mgr/analytics.py (AnalyticsEngine._build_jit.run, :205-213):
// a gather into time order, two full sorts (the samples of each metric,
// the daemons' means) and a lax.scan over the window.
//
// Arithmetic.  Every step is numpy's int64 semantics: x << 8, xs - e,
// e + d, the sums and 2 med wrap in two's complement, so they are done
// in uint64 (signed overflow is undefined in C++); >> is arithmetic; //
// and the ring's % floor (C's / and % truncate toward zero); the ring
// index (cursor + t) % W is taken of the wrapped sum when cursor + t
// overflows.  Order statistics are read from the sign-flipped key
// uint64(x) ^ 2^63, whose unsigned order is x's signed order.
//
// Design.  A cluster of C blocks (C = 1 .. 8, chosen on the host so a
// block holds at most 128 daemons) per metric, grid (C, M).  At 128
// daemons of 32 samples a block takes under half an SM's shared memory
// and 64 registers a thread, so two blocks share an SM and all sixteen
// clusters of a (1024, 16, 32) store are resident at once (with one
// block an SM, 15 clusters of 8 fit the card).  Block r takes daemons
// [r nd, (r + 1) nd):
// 1. it stages their rows of metric m (values and valid) into shared
//    memory (or, where a block's share does not fit there, into its own
//    slice of a global scratch buffer: the staged instantiation, the
//    same code over global pointers), a warp per row of up to 32
//    columns, eight rows' loads in flight a warp, the cursors' with
//    them; rows padded to an odd stride of 8-byte words, so the walk's
//    32 lanes read 32 different banks; and each daemon's ring start and
//    first wrapped step;
// 2. at once, in two groups of warps: the first ceil(nd / 32) warps (at
//    most half, the walkers) walk a daemon's ring a thread, oldest first
//    (EWMA, sum, count, branch-free) and keep its ewma, mean and count in
//    shared memory; the others (the key warps) put each valid sample's
//    key, in ring order (where a cursor's sum wraps, the reference's
//    gather repeats a column and skips one, and its percentiles count
//    them so), into a segment of the key list of their own, four jobs'
//    loads in flight.  The blocks meet at a cluster barrier and read each
//    other's counts and key ranges;
// 3. four order statistics are selected at once (p50, p95 and p99 of
//    the samples by the key warps, the lower median of the means by the
//    walkers) in rounds, each select in one of two modes:
//    - a histogram pass: the bits above `top` are decided; the next
//      digit is the 11 bits below it in a select's first pass (2048
//      bins), 10 in later ones (1024; fewer at the end), the first
//      starting at the highest bit where the cluster's smallest and
//      largest keys differ.  Each block counts its candidates into a
//      shared histogram (percentile selects that seek among the same
//      candidates, as all three do in the first round, share one), sums
//      each 32 bins into a super-bin, and meets the cluster at one
//      barrier; then one warp a select, in every block, reads the C
//      blocks' super-bins over distributed shared memory, finds the
//      super-bin where its rank falls, reads those 32 bins of the C
//      blocks, and picks the digit;
//    - an early end: once at most 64 candidates are left in the cluster
//      (or from the start), each block appends its candidates to a list
//      of its own for the select; after the round's barrier one warp
//      reads every block's list over distributed shared memory, two
//      candidates a lane, and finds the key of the rank a bit at a time
//      (two ballots count the candidates whose bit is 0).
//    From the second round on, each key warp first compacts its segment
//    in place to the keys that are still some running percentile
//    select's candidates, then scans that, one tight loop a select.
//    Two histogram buffers alternate, so one cluster barrier a round
//    suffices: a buffer is cleared only after every block has read it.
//    Clamp-range stores end in two rounds, latency stores in two or
//    three (the median of many daemons' close means may take a second
//    pass);
// 4. each block writes its daemons' ewma, mean and count and flags their
//    outliers (no global store is pending at a cluster barrier, whose
//    release fence would wait for it); rank 0 writes the metric's
//    percentiles and n.
// One launch, no memset, no global atomic, no library call.  Every block
// of a cluster holds the selects' state and computes it from the same
// sums, so all take the same rounds.
//
// What bounds it (H100 SXM: 3.35 TB/s).  Bytes: each sample's 8 + 1
// bytes and the cursors read once, 4M + 3DM words and DM flags written:
// 0.024 us at (16, 16, 32), 1.53 us at (1024, 16, 32).  Both shapes are
// latency-bound: a launch, the staging loads, the walk's W dependent
// steps, then per round a scan, the cluster barrier (its release fence is
// a GPU-scope membar) and the picks, each a chain of dependent
// instructions; so the design takes as few rounds as the keys allow.  (Plain shared atomics: combining a
// warp's equal bins with __match_any_sync first was slower.)
//
// Plain C interface (ctypes); the launch goes on the caller's stream and
// the function returns its error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <climits>
#include <cstdint>

namespace cg = cooperative_groups;

namespace {

using i64 = long long;
using u64 = unsigned long long;

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCluster = 8;
constexpr int kSelects = 4;  // p50, p95, p99, the median of the means
constexpr int kMedian = 3;
constexpr int kFirstBits = 11;  // the digit of a select's first pass
constexpr int kLaterBits = 10;  // the digits of its later passes
constexpr int kBufWords = 4096;  // a histogram buffer: 2 x 2048 bins, or 4 x 1024
constexpr int kHistBytes = 2 * kBufWords * 4;
constexpr int kBufSupers = kBufWords / 32;  // super-bins of 32 bins
constexpr int kGather = 64;  // candidates an early end takes
constexpr int kScaleShift = 8;
constexpr int kAlphaShift = 2;
constexpr u64 kSign = 1ull << 63;
constexpr unsigned kFull = 0xffffffffu;

enum Mode { kDone = 0, kHistogram = 1, kGatherMode = 2 };

static_assert(kBufWords == 8 * kThreads, "a thread sums eight bins of a buffer");
static_assert(2 << kFirstBits == kBufWords && 4 << kLaterBits == kBufWords, "buffer layouts");

__device__ __forceinline__ u64 key_of(i64 x) { return u64(x) ^ kSign; }
__device__ __forceinline__ i64 value_of(u64 k) { return i64(k ^ kSign); }

// numpy's a // b for b >= 1
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;  // one (emulated) 64-bit division
  return (a != q * b && a < 0) ? q - 1 : q;
}

// numpy's a % b for b >= 1
__device__ __forceinline__ int floor_mod(i64 a, int b) {
  const i64 r = a % b;
  return int(r < 0 ? r + b : r);
}

// Step t's column of a ring: (cursor + t) mod W of the wrapped int64 sum,
// from c = cursor mod W; from step tw on, where cursor + t has passed
// INT64_MAX, the column drops by r64 = 2^64 mod W.  (Then the columns
// are no permutation: one repeats and one is skipped, in the gather of
// the reference as here.)
__device__ __forceinline__ int ring_index(int c, int tw, int r64, int W, int t) {
  int j = c + t;
  if (j >= W) j -= W;
  if (t >= tw) j = j >= r64 ? j - r64 : j + W - r64;
  return j;
}

// The selects' state: identical in every block of a cluster, since every
// block computes it from the same sums.  A select's candidates are the
// keys whose bits from `top` up equal `prefix`'s.
struct Selects {
  u64 prefix[kSelects];
  unsigned rank[kSelects];   // the rank sought among the candidates
  unsigned count[kSelects];  // the cluster's candidates
  int top[kSelects];
  int mode[kSelects];
  unsigned n;   // valid samples of the metric (the cluster's)
  unsigned nm;  // daemons with samples
};

// A block's counts and key ranges, read by its peers.
struct BlockStats {
  u64 kmin, kmax, mmin, mmax;
  unsigned nk, nm;
};

__device__ __forceinline__ void cluster_barrier(cg::cluster_group& cluster, int csize) {
  if (csize > 1)
    cluster.sync();
  else
    __syncthreads();
}

// Block r's copy of `p` (a shared-memory address of this block).
template <typename T>
__device__ __forceinline__ T* peer(cg::cluster_group& cluster, int csize, T* p, int r) {
  return csize == 1 ? p : cluster.map_shared_rank(p, r);
}

// A histogram pass's digit width in round `round`, and its histogram's
// first bin in the round's buffer for select s.
__device__ __forceinline__ int digit_bits(int round) { return round ? kLaterBits : kFirstBits; }
__device__ __forceinline__ int slot(int round, int s) {
  return round ? s << kLaterBits : s == kMedian ? 1 << kFirstBits : 0;
}

// What a scan tests of a select, in as few instructions a key as it
// takes: a key is a candidate where (key ^ prefix) <= below (the bits
// under `top`); its digit is (key >> shift) & dmask, one funnel shift.
struct Scan {
  u64 prefix, below;
  int shift;
  unsigned dmask;
};

__device__ __forceinline__ Scan scan_of(const Selects& st, int s, int bits) {
  const int top = st.top[s], w = min(bits, top);
  return {st.prefix[s], top >= 64 ? ~0ull : (1ull << top) - 1ull, top - w, (1u << w) - 1u};
}

__device__ __forceinline__ bool candidate(u64 key, const Scan& c) {
  return (key ^ c.prefix) <= c.below;
}

__device__ __forceinline__ unsigned digit(u64 key, const Scan& c) {
  const unsigned lo = unsigned(key), hi = unsigned(key >> 32);
  return (c.shift >= 32 ? hi >> (c.shift - 32) : __funnelshift_r(lo, hi, c.shift)) & c.dmask;
}

__device__ __forceinline__ void start_select(Selects& st, int s, unsigned total, unsigned rank,
                                             u64 kmin, u64 kmax) {
  st.rank[s] = rank;
  st.count[s] = total;
  st.top[s] = 64;
  st.prefix[s] = 0;
  if (total == 0) {
    st.mode[s] = kDone;
    return;
  }
  const u64 x = kmin ^ kmax;
  if (x == 0) {  // one distinct key
    st.prefix[s] = kmin;
    st.mode[s] = kDone;
    return;
  }
  const int top = 64 - __clzll(i64(x));  // the bits above are every key's
  st.top[s] = top;
  st.prefix[s] = top >= 64 ? 0ull : kmin >> top << top;
  st.mode[s] = total <= unsigned(kGather) ? kGatherMode : kHistogram;
}

// Whether percentile selects a and b (histogram passes both) seek among
// the same candidates: then they share one histogram.
__device__ __forceinline__ bool same_candidates(const Selects& st, int a, int b) {
  return st.mode[a] == kHistogram && st.mode[b] == kHistogram && st.top[a] == st.top[b] &&
         st.prefix[a] == st.prefix[b];
}

// A warp's smallest and largest 64-bit value, two REDUX a 32-bit half.
__device__ __forceinline__ u64 warp_min(u64 v) {
  const unsigned hi = __reduce_min_sync(kFull, unsigned(v >> 32));
  const unsigned lo = __reduce_min_sync(kFull, unsigned(v >> 32) == hi ? unsigned(v) : ~0u);
  return u64(hi) << 32 | lo;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
  const unsigned hi = __reduce_max_sync(kFull, unsigned(v >> 32));
  const unsigned lo = __reduce_max_sync(kFull, unsigned(v >> 32) == hi ? unsigned(v) : 0u);
  return u64(hi) << 32 | lo;
}

__device__ __forceinline__ unsigned warp_inclusive_sum(unsigned v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const unsigned up = __shfl_up_sync(kFull, v, o);
    if (lane >= o) v += up;
  }
  return v;
}

// Append `key` (where `has`) to list[count..]: one shared atomic a warp.
// All 32 lanes call it together.
__device__ __forceinline__ void append(u64* list, unsigned* count, bool has, u64 key, int lane) {
  const unsigned bal = __ballot_sync(kFull, has);
  if (!bal) return;
  const int leader = __ffs(bal) - 1;
  unsigned base = 0;
  if (lane == leader) base = atomicAdd(count, unsigned(__popc(bal)));
  base = __shfl_sync(kFull, base, leader);
  if (has) list[base + __popc(bal & ((1u << lane) - 1u))] = key;
}

// One warp: a histogram pass's pick for select s from the C blocks'
// histograms in buffer h (super-bins sup) at `first`: the super-bin where
// the rank falls, then its 32 bins.  Lane 0 updates the state.
__device__ __forceinline__ void pick_digit(cg::cluster_group& cluster, int csize, Selects& st,
                                           int s, int first, int bits, unsigned* h,
                                           unsigned* sup, int lane) {
  const unsigned want = st.rank[s];
  const bool two = bits == kFirstBits;  // 64 super-bins: two a lane
  const int at0 = (first >> 5) + (two ? 2 * lane : lane);
  unsigned va[kMaxCluster], vb[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < csize) {
      const unsigned* p = peer(cluster, csize, sup, r) + at0;
      va[r] = p[0];
      vb[r] = two ? p[1] : 0u;
    }
  unsigned a = 0, b = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < csize) {
      a += va[r];
      b += vb[r];
    }
  unsigned incl = warp_inclusive_sum(a + b, lane);
  int at = __ffs(__ballot_sync(kFull, incl > want)) - 1;
  unsigned below = __shfl_sync(kFull, incl - a - b, at);
  const unsigned a_at = __shfl_sync(kFull, a, at);
  int super = two ? 2 * at : at;
  if (two && below + a_at <= want) {
    below += a_at;
    ++super;
  }
  unsigned f[kMaxCluster];
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < csize) f[r] = peer(cluster, csize, h, r)[first + super * 32 + lane];
  unsigned c = 0;
#pragma unroll
  for (int r = 0; r < kMaxCluster; ++r)
    if (r < csize) c += f[r];
  incl = warp_inclusive_sum(c, lane);
  at = __ffs(__ballot_sync(kFull, below + incl > want)) - 1;
  below += __shfl_sync(kFull, incl - c, at);
  const unsigned cnt = __shfl_sync(kFull, c, at);
  if (lane == 0) {
    const int top = st.top[s];
    const int shift = top - min(bits, top);
    st.rank[s] = want - below;
    st.prefix[s] |= u64(super * 32 + at) << shift;
    st.top[s] = shift;
    st.count[s] = cnt;
    st.mode[s] = shift == 0 ? kDone : cnt <= unsigned(kGather) ? kGatherMode : kHistogram;
  }
}

// One warp: an early end's pick for select s from the C blocks' lists
// (at most kGather keys together, two a lane): the key of rank
// st.rank[s] among them, a bit at a time from the highest undecided one:
// two ballots count the candidates whose bit is 0, the rank falls among
// those or the others, and the loop ends once one candidate is left.
__device__ __forceinline__ void pick_gathered(cg::cluster_group& cluster, int csize, Selects& st,
                                              int s, u64* list, unsigned* count, int lane) {
  const unsigned total = st.count[s];
  unsigned want = st.rank[s];
  // lane holds the candidates lane and lane + 32 of the blocks' lists
  u64 x[2] = {0ull, 0ull};
  if (csize == 1) {
    x[0] = list[lane];
    x[1] = list[lane + 32];
  } else {
    const unsigned mine = lane < csize ? *cluster.map_shared_rank(count, lane) : 0u;
    const unsigned base = warp_inclusive_sum(mine, lane) - mine;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const unsigned e = unsigned(lane + 32 * h);
      for (int r = 0; r < csize; ++r) {
        const unsigned b = __shfl_sync(kFull, base, r), c = __shfl_sync(kFull, mine, r);
        if (e < total && e >= b && e < b + c) x[h] = cluster.map_shared_rank(list, r)[e - b];
      }
    }
  }
  bool in0 = unsigned(lane) < total, in1 = unsigned(lane + 32) < total;
  unsigned left = total;
  for (int b = st.top[s] - 1; b >= 0 && left > 1; --b) {
    const int w = b >> 5, o = b & 31;
    const bool one0 = (unsigned(w ? x[0] >> 32 : x[0]) >> o) & 1u;
    const bool one1 = (unsigned(w ? x[1] >> 32 : x[1]) >> o) & 1u;
    const unsigned zeros =
        __popc(__ballot_sync(kFull, in0 && !one0)) + __popc(__ballot_sync(kFull, in1 && !one1));
    const bool low = want < zeros;
    want -= low ? 0u : zeros;
    left = low ? zeros : left - zeros;
    in0 = in0 && one0 != low;
    in1 = in1 && one1 != low;
  }
  const unsigned b0 = __ballot_sync(kFull, in0), b1 = __ballot_sync(kFull, in1);
  const u64 key = b0 ? __shfl_sync(kFull, x[0], __ffs(b0) - 1) : __shfl_sync(kFull, x[1], __ffs(b1) - 1);
  if (lane == 0) {
    st.prefix[s] = key;
    st.top[s] = 0;
    st.mode[s] = kDone;
  }
}

// Dynamic shared memory: the two histogram buffers, then (unless
// kGlobal) the block's staging area, in order: staged values (nd x S
// words), sample keys (nd W), ewmas (nd), means (nd), counts (nd ints),
// ring starts and first wrapped steps (nd ints each), staged valid bytes
// (nd x S).  The walk's results stay there until the last step writes
// them out, so no store is pending at a cluster barrier.  kGlobal: block (r, m)'s
// staging area is `stride` bytes at stage + (m C + r) stride.
//
// The key list is cut into one segment a key warp: warp q takes the
// contiguous jobs [q J / Q, (q + 1) J / Q) of the J = rows x chunks, and
// its segment holds exactly their columns.  A warp writes, scans and
// compacts its own segment in place (a key is read before any write
// reaches its slot), so the list needs no shared counter.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads, 2)
mgr_analytics_kernel(const i64* __restrict__ values, const uint8_t* __restrict__ valid,
                     const i64* __restrict__ cursor, i64* __restrict__ out, int D, int M, int W,
                     int r64, int nd, unsigned char* __restrict__ stage, long long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned* hist = reinterpret_cast<unsigned*>(smem);
  unsigned char* base =
      kGlobal ? stage + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * size_t(stride)
              : smem + kHistBytes;
  const int S = W | 1;  // odd row stride: conflict-free walk
  i64* sv = reinterpret_cast<i64*>(base);
  u64* skey = reinterpret_cast<u64*>(sv + size_t(nd) * S);
  i64* sewma = reinterpret_cast<i64*>(skey + size_t(nd) * W);
  i64* smean = sewma + nd;
  int* scnt = reinterpret_cast<int*>(smean + nd);
  int* sc0 = scnt + nd;
  int* swrap = sc0 + nd;
  uint8_t* sb = reinterpret_cast<uint8_t*>(swrap + nd);

  __shared__ __align__(16) unsigned sbins[2][kBufSupers];
  __shared__ u64 gathered[kSelects][kGather];
  __shared__ unsigned ngathered[kSelects];
  __shared__ Selects st;
  __shared__ BlockStats bs;
  __shared__ u64 wred[4][kWarps];
  __shared__ unsigned wcnt[kWarps];

  cg::cluster_group cluster = cg::this_cluster();
  const int csize = int(cluster.num_blocks());
  const int rank = int(cluster.block_rank());
  const int m = blockIdx.y;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int d0 = rank * nd;
  const int nloc = max(0, min(nd, D - d0));
  const size_t DM = size_t(D) * M;
  i64* out_pct = out;
  i64* out_n = out + 3 * size_t(M);
  i64* out_ewma = out + 4 * size_t(M);
  i64* out_mean = out_ewma + DM;
  i64* out_count = out_mean + DM;
  uint8_t* out_flag = reinterpret_cast<uint8_t*>(out_count + DM);

  for (int i = tid; i < kHistBytes / 16; i += kThreads)
    reinterpret_cast<uint4*>(hist)[i] = make_uint4(0u, 0u, 0u, 0u);
  if (tid < kSelects) ngathered[tid] = 0;

  // 1. stage the block's rows of metric m, the cursors' loads in flight
  // with the rows'
  const i64 cur0 = tid < nloc ? __ldg(cursor + d0 + tid) : 0;
  const int chunks = (W + 31) >> 5;
  const int jobs = nloc * chunks;
  for (int j0 = warp; j0 < jobs; j0 += 8 * kWarps) {
    i64 x[8];
    uint8_t b[8];
    int at[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int j = j0 + u * kWarps;
      const int row = chunks == 1 ? j : j / chunks;
      const int t = (j - row * chunks) * 32 + lane;
      at[u] = (j < jobs && t < W) ? row * S + t : -1;
      if (at[u] >= 0) {
        const size_t g = (size_t(d0 + row) * M + m) * W + t;
        x[u] = __ldg(values + g);
        b[u] = __ldg(valid + g);
      }
    }
#pragma unroll
    for (int u = 0; u < 8; ++u)
      if (at[u] >= 0) {
        sv[at[u]] = x[u];
        sb[at[u]] = b[u];
      }
  }
  // each daemon's ring: its start, and its first step whose cursor + t
  // wraps (W where none does within the window)
  for (int i = tid; i < nloc; i += kThreads) {
    const i64 c = i == tid ? cur0 : __ldg(cursor + d0 + i);
    const u64 t0 = u64(LLONG_MAX) - u64(c) + 1;
    sc0[i] = floor_mod(c, W);
    swrap[i] = t0 < u64(W) ? int(t0) : W;
  }
  __syncthreads();

  // 2. the walkers walk their daemons' rings oldest first; the key warps
  // list the block's samples in ring order, step t of a row the sample at
  // its ring_index, as the reference gathers them
  const int walkers = min(kWarps / 2, max(1, (nloc + 31) >> 5));
  const bool walker = warp < walkers;
  const int q = warp - walkers, Q = kWarps - walkers;
  // (q J < 2^32: J < 2^28 for every store check_shape admits)
  const int jb = walker ? 0 : int(unsigned(q) * unsigned(jobs) / unsigned(Q));
  const int je = walker ? 0 : int(unsigned(q + 1) * unsigned(jobs) / unsigned(Q));
  int jrow = jb / chunks, jchunk = jb - jrow * chunks;
  u64* seg = skey + size_t(jrow) * W + size_t(jchunk) * 32;
  unsigned nseg = 0;  // the keys in the warp's segment
  u64 kmin = ~0ull, kmax = 0, mmin = ~0ull, mmax = 0;
  if (walker) {
    for (int i = tid; i < nloc; i += walkers * 32) {
      const int tw = swrap[i];
      int idx = sc0[i];
      const i64* row = sv + size_t(i) * S;
      const uint8_t* rowb = sb + size_t(i) * S;
      i64 e = 0, cnt = 0;
      u64 sum = 0;
      bool seen = false;
#pragma unroll 4
      for (int t = 0; t < W; ++t) {  // branch-free
        if (t == tw) idx = idx >= r64 ? idx - r64 : idx + W - r64;
        const bool v = rowb[idx] != 0;
        const i64 x = row[idx];
        const i64 xs = i64(u64(x) << kScaleShift);
        const i64 step = i64(u64(xs) - u64(e)) >> kAlphaShift;
        const i64 upd = seen ? i64(u64(e) + u64(step)) : xs;
        e = v ? upd : e;
        seen |= v;
        sum += v ? u64(x) : 0ull;
        cnt += v;
        idx = idx + 1 == W ? 0 : idx + 1;
      }
      const i64 mean = cnt > 0 ? floor_div(i64(sum << kScaleShift), cnt) : 0;
      sewma[i] = e;
      smean[i] = mean;
      scnt[i] = int(cnt);
      if (cnt > 0) {
        mmin = min(mmin, key_of(mean));
        mmax = max(mmax, key_of(mean));
      }
    }
  } else {
    for (int j0 = jb; j0 < je; j0 += 4) {  // warp-uniform; four jobs' loads in flight
      bool v[4];
      u64 k[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        // every load at a valid address, so none waits on a branch
        const int t = jchunk * 32 + lane, r = min(jrow, nloc - 1);
        const int c = ring_index(sc0[r], swrap[r], r64, W, min(t, W - 1));
        v[u] = j0 + u < je && t < W && sb[r * S + c] != 0;
        k[u] = key_of(sv[r * S + c]);
        if (++jchunk == chunks) {
          jchunk = 0;
          ++jrow;
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const unsigned bal = __ballot_sync(kFull, v[u]);
        if (v[u]) {
          seg[nseg + __popc(bal & ((1u << lane) - 1u))] = k[u];
          kmin = min(kmin, k[u]);
          kmax = max(kmax, k[u]);
        }
        nseg += __popc(bal);
      }
    }
  }

  // the block's counts and key ranges, for its peers
  kmin = warp_min(kmin);
  kmax = warp_max(kmax);
  mmin = warp_min(mmin);
  mmax = warp_max(mmax);
  if (lane == 0) {
    wred[0][warp] = kmin;
    wred[1][warp] = kmax;
    wred[2][warp] = mmin;
    wred[3][warp] = mmax;
    wcnt[warp] = nseg;
  }
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < kWarps;
    kmin = warp_min(w ? wred[0][lane] : ~0ull);
    kmax = warp_max(w ? wred[1][lane] : 0ull);
    mmin = warp_min(w ? wred[2][lane] : ~0ull);
    mmax = warp_max(w ? wred[3][lane] : 0ull);
    const unsigned nk = __reduce_add_sync(kFull, w ? wcnt[lane] : 0u);
    unsigned nm = 0;
    for (int i = lane; i < nloc; i += 32) nm += scnt[i] > 0;
    nm = __reduce_add_sync(kFull, nm);
    if (lane == 0) {
      bs.kmin = kmin;
      bs.kmax = kmax;
      bs.mmin = mmin;
      bs.mmax = mmax;
      bs.nk = nk;
      bs.nm = nm;
    }
  }
  cluster_barrier(cluster, csize);

  // 3. the selects: the cluster's counts and ranges, then the ranks; lane
  // s of warp 0 starts select s
  if (warp == 0) {
    unsigned n = 0, nmeans = 0;
    u64 a = ~0ull, z = 0, ma = ~0ull, mz = 0;
    if (lane < csize) {  // lane r reads block r's counts and ranges
      const BlockStats* p = peer(cluster, csize, &bs, lane);
      n = p->nk;
      nmeans = p->nm;
      a = p->kmin;
      z = p->kmax;
      ma = p->mmin;
      mz = p->mmax;
    }
    n = __reduce_add_sync(kFull, n);
    nmeans = __reduce_add_sync(kFull, nmeans);
    a = warp_min(a);
    z = warp_max(z);
    ma = warp_min(ma);
    mz = warp_max(mz);
    // the ranks: (p n + 99) // 100 - 1 (at most n - 1 <= D W - 1), at
    // least 0; the median's (nm - 1) // 2 (at most D - 1)
    const unsigned pct = lane == 0 ? 50u : lane == 1 ? 95u : 99u;
    const unsigned pos = unsigned((u64(pct) * n + 99) / 100);
    const bool med = lane == kMedian;
    if (lane < kSelects)
      start_select(st, lane, med ? nmeans : n,
                   med ? (nmeans > 0 ? (nmeans - 1) / 2 : 0u) : pos > 0 ? pos - 1 : 0u,
                   med ? ma : a, med ? mz : z);
    if (lane == 0) {
      st.n = n;
      st.nm = nmeans;
    }
  }
  __syncthreads();

  for (int round = 0;; ++round) {
    bool more = false;
#pragma unroll
    for (int s = 0; s < kSelects; ++s) more |= st.mode[s] != kDone;
    if (!more) break;  // the same in every block
    const int bits = digit_bits(round);
    unsigned* h = hist + (round & 1) * kBufWords;
    unsigned* sup = sbins[round & 1];
    // percentile selects among the same candidates share a histogram (all
    // three do in the first round); `from` is the select that builds it
    const int from1 = same_candidates(st, 0, 1) ? 0 : 1;
    const int from2 = same_candidates(st, 0, 2) ? 0 : same_candidates(st, 1, 2) ? 1 : 2;
    if (!walker) {
      // the key warps: the percentile selects over their segments,
      // compacted in place from the second round on
      Scan c[3];
      int mode[3];
      bool run[3];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        c[s] = scan_of(st, s, bits);
        mode[s] = st.mode[s];
        // whether s scans: a select that shares a histogram does not
        run[s] = mode[s] == kGatherMode ||
                 (mode[s] == kHistogram && (s == 0 || (s == 1 ? from1 : from2) == s));
      }
      if (round > 0 && (mode[0] != kDone || mode[1] != kDone || mode[2] != kDone)) {
        // keep only the keys that are still some running select's candidates
        unsigned kept = 0;
        for (unsigned i0 = 0; i0 < nseg; i0 += 32) {  // warp-uniform
          const unsigned i = i0 + lane;
          const u64 k = seg[min(i, nseg - 1)];
          const bool keep = i < nseg && ((mode[0] != kDone && candidate(k, c[0])) ||
                                         (mode[1] != kDone && candidate(k, c[1])) ||
                                         (mode[2] != kDone && candidate(k, c[2])));
          const unsigned bal = __ballot_sync(kFull, keep);
          if (keep) seg[kept + __popc(bal & ((1u << lane) - 1u))] = k;
          kept += __popc(bal);
        }
        nseg = kept;
        __syncwarp();
      }
#pragma unroll 1
      for (int s = 0; s < 3; ++s) {
        if (!run[s]) continue;
        const Scan cs = s == 0 ? c[0] : s == 1 ? c[1] : c[2];
        const bool gather = (s == 0 ? mode[0] : s == 1 ? mode[1] : mode[2]) == kGatherMode;
        unsigned* hs = h + slot(round, s);
        for (unsigned i0 = 0; i0 < nseg; i0 += 32) {  // warp-uniform
          const unsigned i = i0 + lane;
          const u64 k = seg[min(i, nseg - 1)];
          const bool hit = i < nseg && candidate(k, cs);
          if (gather)
            append(gathered[s], &ngathered[s], hit, k, lane);
          else if (hit)
            atomicAdd(hs + digit(k, cs), 1u);
        }
      }
    } else if (st.mode[kMedian] != kDone) {
      // the walkers: the median over their daemons' mean keys
      const Scan c = scan_of(st, kMedian, bits);
      const bool gather = st.mode[kMedian] == kGatherMode;
      for (int i0 = warp * 32; i0 < nloc; i0 += walkers * 32) {  // warp-uniform
        const int i = i0 + lane;
        const u64 k = key_of(smean[min(i, nloc - 1)]);
        const bool hit = i < nloc && scnt[i] > 0 && candidate(k, c);
        if (gather)
          append(gathered[kMedian], &ngathered[kMedian], hit, k, lane);
        else if (hit)
          atomicAdd(h + slot(round, kMedian) + digit(k, c), 1u);
      }
    }
    __syncthreads();
    // the buffer's super-bins: a thread sums four bins twice, eight
    // threads a super-bin (zero where no histogram was built)
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int i = tid + u * kThreads;
      const uint4 v = reinterpret_cast<const uint4*>(h)[i];
      unsigned x = v.x + v.y + v.z + v.w;
      x += __shfl_down_sync(kFull, x, 4, 8);
      x += __shfl_down_sync(kFull, x, 2, 8);
      x += __shfl_down_sync(kFull, x, 1, 8);
      if ((lane & 7) == 0) sup[i >> 3] = x;
    }
    cluster_barrier(cluster, csize);
    // warp s picks select s's digit, or ends it
    if (warp < kSelects && st.mode[warp] != kDone) {
      const int s = warp;
      if (st.mode[s] == kGatherMode)
        pick_gathered(cluster, csize, st, s, gathered[s], &ngathered[s], lane);
      else
        pick_digit(cluster, csize, st, s, slot(round, s == 1 ? from1 : s == 2 ? from2 : s),
                   bits, h, sup, lane);
    }
    // every peer has read the other buffer (it reached this round's barrier)
    unsigned* other = hist + ((round + 1) & 1) * kBufWords;
    for (int i = tid; i < kBufWords / 4; i += kThreads)
      reinterpret_cast<uint4*>(other)[i] = make_uint4(0u, 0u, 0u, 0u);
    __syncthreads();
  }
  // no block leaves while a peer may still read its shared memory: arrive
  // now, wait before leaving
  if (csize > 1) asm volatile("barrier.cluster.arrive;" ::: "memory");

  // 4. outliers of the block's daemons; the metric's percentiles and n
  const i64 med = st.nm > 0 ? value_of(st.prefix[kMedian]) : 0;
  const i64 twice = i64(u64(med) * 2ull);
  for (int i = tid; i < nloc; i += kThreads) {
    const size_t o = size_t(d0 + i) * M + m;
    out_ewma[o] = sewma[i];
    out_mean[o] = smean[i];
    out_count[o] = scnt[i];
    out_flag[o] = scnt[i] > 0 && smean[i] > twice && med > 0;
  }
  if (rank == 0 && tid < 3) out_pct[size_t(m) * 3 + tid] = st.n > 0 ? value_of(st.prefix[tid]) : 0;
  if (rank == 0 && tid == 3) out_n[m] = i64(st.n);
  if (csize > 1) asm volatile("barrier.cluster.wait;" ::: "memory");
}

int g_smem_set[2] = {0, 0};
int g_static_smem = -1;

// Bytes of shared memory the kernel takes besides a staging area: its two
// histogram buffers and its static arrays (-1 where they cannot be read).
long long fixed_smem() {
  if (g_static_smem < 0) {
    cudaFuncAttributes fa;
    if (cudaFuncGetAttributes(&fa, mgr_analytics_kernel<false>) != cudaSuccess) return -1;
    g_static_smem = int(fa.sharedSizeBytes);
  }
  return kHistBytes + g_static_smem;
}

}  // namespace

extern "C" {

// Bytes of the staging area of a block holding `nd` daemons' rows of W
// samples (the kernel's layout above): its dynamic shared memory after
// the histograms, or its slice of the scratch buffer rounded up to 16.
long long ceph_mgr_analytics_smem(int nd, int W) {
  const long long S = W | 1;
  return (long long)nd * (S * 8 + (long long)W * 8 + 8 + 8 + 4 + 8 + S);
}

// The six outputs of the store (values, valid, cursor) into `out`:
// [percentiles M x 3][n_samples M][ewma D x M][mean D x M][count D x M]
// as int64, then D x M outlier bytes.  values: (D, M, W) int64, valid:
// (D, M, W) bytes, cursor: D int64, all contiguous; `cluster` blocks a
// metric, each of `nd` daemons (cluster * nd >= D).  `stage` null: the
// rows are staged in shared memory; else in `stage`, a scratch buffer
// of cluster x M slices of ceph_mgr_analytics_smem(nd, W) bytes rounded
// up to 16 (not read before the kernel writes it).  Returns a
// cudaError_t value (0 on success).
int ceph_mgr_analytics(const void* values, const void* valid, const void* cursor, void* out, int D,
                       int M, int W, int cluster, int nd, void* stage, void* stream) {
  if (D < 1 || M < 1 || W < 1 || M > 65535 || cluster < 1 || cluster > kMaxCluster || nd < 1 ||
      (long long)cluster * nd < D || (long long)D * W >= (1ll << 31))
    return int(cudaErrorInvalidValue);
  const long long bytes = ceph_mgr_analytics_smem(nd, W);
  const bool global = stage != nullptr;
  const long long fixed = fixed_smem();
  if (fixed < 0) return int(cudaGetLastError());
  const long long smem = kHistBytes + (global ? 0 : bytes);
  if (smem - kHistBytes + fixed > 232448) return int(cudaErrorInvalidValue);
  auto kernel = global ? mgr_analytics_kernel<true> : mgr_analytics_kernel<false>;
  cudaError_t err;
  if (smem > g_smem_set[global]) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    g_smem_set[global] = int(smem);
  }
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = unsigned(cluster);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(unsigned(cluster), unsigned(M));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = size_t(smem);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = cluster > 1 ? 1 : 0;
  err = cudaLaunchKernelEx(&cfg, kernel, static_cast<const i64*>(values),
                           static_cast<const uint8_t*>(valid), static_cast<const i64*>(cursor),
                           static_cast<i64*>(out), D, M, W, int((~0ull % unsigned(W) + 1) % unsigned(W)),
                           nd, static_cast<unsigned char*>(stage), (bytes + 15) / 16 * 16);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"

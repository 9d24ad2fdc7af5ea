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
// block holds at most 128 daemons) per metric, grid (C, M).  Block r
// takes daemons [r nd, (r + 1) nd):
// 1. it stages their rows of metric m (values and valid) into shared
//    memory (or, where a block's share does not fit there, into its own
//    slice of a global scratch buffer: the staged instantiation, the
//    same code over global pointers), a warp per row of up to 32
//    columns, four rows' loads in
//    flight a warp; rows padded to an odd stride of 8-byte words, so the
//    walk's 32 lanes read 32 different banks; and each daemon's ring
//    start and first wrapped step;
// 2. each valid sample's key, in ring order (where a cursor's sum wraps,
//    the reference's gather repeats a column and skips one, and its
//    percentiles count them so), goes into a dense list in shared memory
//    (a warp counts its rows' samples and reserves their room with one
//    shared atomic);
// 3. a thread walks a daemon's ring oldest first (EWMA, sum, count),
//    branch-free, and writes its ewma, mean and count; each reporting
//    daemon's mean key goes into a second list;
// 4. four order statistics are selected at once (p50, p95 and p99 of
//    the samples, the lower median of the means) by a most-significant-
//    digit-first radix select over 8-bit digits: the leading bytes that
//    all keys share (from the cluster's minimum and maximum key) are
//    skipped; each pass every block histograms its own candidates into
//    shared memory (percentile selects that seek among the same
//    candidates, as all three do in the first pass, share one
//    histogram), the blocks meet at a cluster barrier, every block adds
//    the C histograms over distributed shared memory and picks the same
//    digit.  Nothing is sorted and no block reads another's keys.
//    Two histogram buffers alternate, so one barrier a pass suffices: a
//    buffer is cleared only after every block has read it;
// 5. each block flags its daemons' outliers; rank 0 writes the metric's
//    percentiles and n.
// One launch, no memset, no global atomic, no library call.
//
// What bounds it (H100 SXM: 3.35 TB/s).  Bytes: each sample's 8 + 1
// bytes and the cursors read once, 4M + 3DM words and DM flags written:
// 0.024 us at (16, 16, 32), 1.53 us at (1024, 16, 32).  The first shape
// is pure latency (a launch, the walk's W dependent steps, a pass or
// more of the select with its cluster barrier); at the second the
// passes' shared-memory histograms and barriers dominate.  (A first
// version combined a warp's equal bins with __match_any_sync before each
// atomic; those calls took most of the kernel's time.)
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
constexpr int kBins = 256;
constexpr int kScaleShift = 8;
constexpr int kAlphaShift = 2;
constexpr u64 kSign = 1ull << 63;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ u64 key_of(i64 x) { return u64(x) ^ kSign; }
__device__ __forceinline__ i64 value_of(u64 k) { return i64(k ^ kSign); }

// numpy's a // b for b >= 1
__device__ __forceinline__ i64 floor_div(i64 a, i64 b) {
  const i64 q = a / b;
  return (a % b != 0 && a < 0) ? q - 1 : q;
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
// block computes it from the same sums.
struct Selects {
  u64 prefix[kSelects];  // the key's digits chosen so far
  unsigned rank[kSelects];  // the rank sought among the candidates left
  int shift[kSelects];   // the digit of the next pass; < 0: done
  unsigned n;            // valid samples of the metric (the cluster's)
  unsigned nm;           // daemons with samples
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

// Count key into h's bin of its digit at `shift`, where its digits above
// match `prefix`.
__device__ __forceinline__ void bin_add(unsigned* h, u64 key, u64 prefix, int shift) {
  const u64 above = shift >= 56 ? 0ull : ~0ull << (shift + 8);
  if (((key ^ prefix) & above) == 0) atomicAdd(h + (unsigned(key >> shift) & 255u), 1u);
}

// Whether percentile selects a and b (both running) seek among the same
// candidates: then they share one histogram.
__device__ __forceinline__ bool same_candidates(const Selects& st, int a, int b) {
  return st.shift[a] >= 0 && st.shift[a] == st.shift[b] && st.prefix[a] == st.prefix[b];
}

__device__ __forceinline__ void start_select(Selects& st, int s, unsigned total, unsigned rank,
                                             u64 kmin, u64 kmax) {
  st.rank[s] = rank;
  if (total == 0) {
    st.prefix[s] = 0;
    st.shift[s] = -1;
    return;
  }
  const u64 x = kmin ^ kmax;
  if (x == 0) {  // one distinct key
    st.prefix[s] = kmin;
    st.shift[s] = -1;
    return;
  }
  const int common = __clzll(i64(x)) / 8;  // leading bytes every key shares
  st.prefix[s] = common ? kmin & (~0ull << (64 - 8 * common)) : 0ull;
  st.shift[s] = 56 - 8 * common;
}

__device__ __forceinline__ u64 warp_min(u64 v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = min(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

__device__ __forceinline__ u64 warp_max(u64 v) {
#pragma unroll
  for (int o = 16; o; o >>= 1) v = max(v, __shfl_xor_sync(kFull, v, o));
  return v;
}

// The block's staging area, in order: staged values (nd x S words),
// sample keys (nd W), mean keys (nd), means (nd), counts (nd ints), ring
// starts and first wrapped steps (nd ints each), staged valid bytes
// (nd x S).  kGlobal: block (r, m)'s slice `stride` bytes at
// stage + (m C + r) stride; else dynamic shared memory.
template <bool kGlobal>
__global__ void __launch_bounds__(kThreads)
mgr_analytics_kernel(const i64* __restrict__ values, const uint8_t* __restrict__ valid,
                     const i64* __restrict__ cursor, i64* __restrict__ out, int D, int M, int W,
                     int nd, unsigned char* __restrict__ stage, long long stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* base =
      kGlobal ? stage + (size_t(blockIdx.y) * gridDim.x + blockIdx.x) * size_t(stride) : smem;
  const int S = W | 1;  // odd row stride: conflict-free walk
  i64* sv = reinterpret_cast<i64*>(base);
  u64* skey = reinterpret_cast<u64*>(sv + size_t(nd) * S);
  u64* mkey = skey + size_t(nd) * W;
  i64* smean = reinterpret_cast<i64*>(mkey + nd);
  int* scnt = reinterpret_cast<int*>(smean + nd);
  int* sc0 = scnt + nd;
  int* swrap = sc0 + nd;
  uint8_t* sb = reinterpret_cast<uint8_t*>(swrap + nd);

  __shared__ unsigned hist[2][kSelects * kBins];
  __shared__ unsigned tot[kSelects * kBins];
  __shared__ Selects st;
  __shared__ BlockStats bs;
  __shared__ unsigned nk, nm;
  __shared__ u64 wred[4][kWarps];

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

  for (int i = tid; i < 2 * kSelects * kBins; i += kThreads) (&hist[0][0])[i] = 0;
  if (tid == 0) nk = nm = 0;

  // 1. stage the block's rows of metric m
  const int chunks = (W + 31) >> 5;
  const int jobs = nloc * chunks;
  for (int j0 = warp; j0 < jobs; j0 += 4 * kWarps) {
    i64 x[4];
    uint8_t b[4];
    int at[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = j0 + u * kWarps;
      const int row = j / chunks;
      const int t = (j - row * chunks) * 32 + lane;
      at[u] = (j < jobs && t < W) ? row * S + t : -1;
      if (at[u] >= 0) {
        const size_t g = (size_t(d0 + row) * M + m) * W + t;
        x[u] = __ldg(values + g);
        b[u] = __ldg(valid + g);
      }
    }
#pragma unroll
    for (int u = 0; u < 4; ++u)
      if (at[u] >= 0) {
        sv[at[u]] = x[u];
        sb[at[u]] = b[u];
      }
  }
  // each daemon's ring: its start, and its first step whose cursor + t
  // wraps (W where none does within the window)
  for (int i = tid; i < nloc; i += kThreads) {
    const i64 cur = __ldg(cursor + d0 + i);
    const u64 t0 = u64(LLONG_MAX) - u64(cur) + 1;
    sc0[i] = floor_mod(cur, W);
    swrap[i] = t0 < u64(W) ? int(t0) : W;
  }
  const int r64 = int((~0ull % unsigned(W) + 1) % unsigned(W));  // 2^64 mod W
  __syncthreads();

  // 2. the block's samples in ring order, step t of a row the sample at
  // its ring_index, as the reference gathers them, as a dense list of the
  // valid ones' keys: each warp counts its rows' samples, reserves their
  // room with one atomic, then writes
  u64 kmin = ~0ull, kmax = 0, mmin = ~0ull, mmax = 0;
  unsigned mine = 0;
  for (int j = warp; j < jobs; j += kWarps) {  // warp-uniform
    const int row = j / chunks;
    const int t = (j - row * chunks) * 32 + lane;
    const int c = t < W ? ring_index(sc0[row], swrap[row], r64, W, t) : 0;
    mine += __popc(__ballot_sync(kFull, t < W && sb[row * S + c] != 0));
  }
  unsigned at = 0;
  if (lane == 0 && mine) at = atomicAdd(&nk, mine);
  at = __shfl_sync(kFull, at, 0);
  for (int j = warp; j < jobs; j += kWarps) {
    const int row = j / chunks;
    const int t = (j - row * chunks) * 32 + lane;
    const int c = t < W ? ring_index(sc0[row], swrap[row], r64, W, t) : 0;
    const bool v = t < W && sb[row * S + c] != 0;
    const unsigned bal = __ballot_sync(kFull, v);
    if (v) {
      const u64 k = key_of(sv[row * S + c]);
      skey[at + __popc(bal & ((1u << lane) - 1u))] = k;
      kmin = min(kmin, k);
      kmax = max(kmax, k);
    }
    at += __popc(bal);
  }

  // 3. a thread a daemon: walk its ring oldest first
  for (int i = tid; i < nloc; i += kThreads) {
    const int tw = swrap[i];
    int idx = sc0[i];
    const i64* row = sv + size_t(i) * S;
    const uint8_t* rowb = sb + size_t(i) * S;
    i64 e = 0, cnt = 0;
    u64 sum = 0;
    bool seen = false;
#pragma unroll 4
    for (int t = 0; t < W; ++t) {
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
    const size_t o = size_t(d0 + i) * M + m;
    out_ewma[o] = e;
    out_mean[o] = mean;
    out_count[o] = cnt;
    smean[i] = mean;
    scnt[i] = int(cnt);
  }
  __syncthreads();
  // the reporting daemons' mean keys, dense
  for (int i0 = warp * 32; i0 < nloc; i0 += kThreads) {  // warp-uniform
    const int i = i0 + lane;
    const bool has = i < nloc && scnt[i] > 0;
    const u64 k = key_of(has ? smean[i] : 0);
    append(mkey, &nm, has, k, lane);
    if (has) {
      mmin = min(mmin, k);
      mmax = max(mmax, k);
    }
  }

  // the block's key ranges, for its peers
  kmin = warp_min(kmin);
  kmax = warp_max(kmax);
  mmin = warp_min(mmin);
  mmax = warp_max(mmax);
  if (lane == 0) {
    wred[0][warp] = kmin;
    wred[1][warp] = kmax;
    wred[2][warp] = mmin;
    wred[3][warp] = mmax;
  }
  __syncthreads();
  if (warp == 0) {
    const bool w = lane < kWarps;
    kmin = warp_min(w ? wred[0][lane] : ~0ull);
    kmax = warp_max(w ? wred[1][lane] : 0ull);
    mmin = warp_min(w ? wred[2][lane] : ~0ull);
    mmax = warp_max(w ? wred[3][lane] : 0ull);
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

  // 4. the selects: the cluster's counts and ranges, then the ranks
  unsigned n = 0, nmeans = 0;
  u64 a = ~0ull, z = 0, ma = ~0ull, mz = 0;
  if (warp == 0) {
    if (lane < csize) {  // lane r reads block r's counts and ranges
      const BlockStats* p = cluster.map_shared_rank(&bs, lane);
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
  }
  if (tid == 0) {
    st.n = n;
    st.nm = nmeans;
    const i64 last = i64(D) * W - 1;
    const int pcts[3] = {50, 95, 99};
    for (int s = 0; s < 3; ++s) {
      i64 pos = (i64(pcts[s]) * n + 99) / 100 - 1;
      pos = pos < 0 ? 0 : pos > last ? last : pos;
      start_select(st, s, n, unsigned(pos), a, z);
    }
    i64 mpos = nmeans > 0 ? (i64(nmeans) - 1) / 2 : 0;
    mpos = mpos > D - 1 ? D - 1 : mpos;
    start_select(st, kMedian, nmeans, unsigned(mpos), ma, mz);
  }
  __syncthreads();

  const unsigned nkl = nk, nml = nm;
  for (int pass = 0;; ++pass) {
    bool more = false;
#pragma unroll
    for (int s = 0; s < kSelects; ++s) more |= st.shift[s] >= 0;
    if (!more) break;  // the same in every block
    // percentile selects among the same candidates share a histogram (all
    // three do in the first pass); `from` is the select that builds it
    const int from1 = same_candidates(st, 0, 1) ? 0 : 1;
    const int from2 = same_candidates(st, 0, 2) ? 0 : same_candidates(st, 1, 2) ? 1 : 2;
    const int own = int(st.shift[0] >= 0) | int(st.shift[1] >= 0 && from1 == 1) << 1 |
                    int(st.shift[2] >= 0 && from2 == 2) << 2;  // bit s: s builds its own
    unsigned* h = hist[pass & 1];
    for (unsigned i = tid; i < nkl; i += kThreads) {
      const u64 k = skey[i];
#pragma unroll
      for (int s = 0; s < 3; ++s)
        if (own >> s & 1) bin_add(h + s * kBins, k, st.prefix[s], st.shift[s]);
    }
    if (st.shift[kMedian] >= 0)
      for (unsigned i = tid; i < nml; i += kThreads)
        bin_add(h + kMedian * kBins, mkey[i], st.prefix[kMedian], st.shift[kMedian]);
    cluster_barrier(cluster, csize);
    // every block adds the cluster's histograms: all C loads of an entry
    // in flight together
    for (int i = tid; i < kSelects * kBins; i += kThreads) {
      const int s = i / kBins;
      if (s < 3 ? !(own >> s & 1) : st.shift[kMedian] < 0) continue;
      unsigned c[kMaxCluster];
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r)
        c[r] = r >= csize ? 0u : csize == 1 ? h[i] : cluster.map_shared_rank(h, r)[i];
      unsigned sum = 0;
#pragma unroll
      for (int r = 0; r < kMaxCluster; ++r) sum += c[r];
      tot[i] = sum;
    }
    __syncthreads();
    // warp s picks select s's digit: the bin where its rank falls
    if (warp < kSelects && st.shift[warp] >= 0) {
      const int s = warp;
      const unsigned* t = tot + (s == 1 ? from1 : s == 2 ? from2 : s) * kBins;
      unsigned c8[8], part = 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        c8[j] = t[lane * 8 + j];
        part += c8[j];
      }
      unsigned incl = part;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const unsigned up = __shfl_up_sync(kFull, incl, o);
        if (lane >= o) incl += up;
      }
      const unsigned want = st.rank[s];
      const unsigned past = __ballot_sync(kFull, incl > want);
      if (lane == __ffs(past) - 1) {
        unsigned below = incl - part;
        int bin = 7;
        for (int j = 0; j < 8; ++j) {
          if (below + c8[j] > want) {
            bin = j;
            break;
          }
          below += c8[j];
        }
        st.rank[s] = want - below;
        st.prefix[s] |= u64(lane * 8 + bin) << st.shift[s];
        st.shift[s] -= 8;
      }
    }
    // every peer has read the other buffer (it reached this pass's barrier)
    for (int i = tid; i < kSelects * kBins; i += kThreads) hist[(pass + 1) & 1][i] = 0;
    __syncthreads();
  }
  // no block leaves while a peer may still read its shared memory
  cluster_barrier(cluster, csize);

  // 5. outliers of the block's daemons; the metric's percentiles and n
  const i64 med = st.nm > 0 ? value_of(st.prefix[kMedian]) : 0;
  const i64 twice = i64(u64(med) * 2ull);
  for (int i = tid; i < nloc; i += kThreads)
    out_flag[size_t(d0 + i) * M + m] = scnt[i] > 0 && smean[i] > twice && med > 0;
  if (rank == 0 && tid < 3) out_pct[size_t(m) * 3 + tid] = st.n > 0 ? value_of(st.prefix[tid]) : 0;
  if (rank == 0 && tid == 3) out_n[m] = i64(st.n);
}

int g_smem_set = 0;
int g_static_smem = -1;

}  // namespace

extern "C" {

// Bytes of the staging area of a block holding `nd` daemons' rows of W
// samples (the kernel's layout above): its dynamic shared memory, or its
// slice of the scratch buffer rounded up to 16.
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
  const long long smem = global ? 0 : bytes;
  cudaError_t err;
  if (g_static_smem < 0) {
    cudaFuncAttributes fa;
    err = cudaFuncGetAttributes(&fa, mgr_analytics_kernel<false>);
    if (err != cudaSuccess) return int(err);
    g_static_smem = int(fa.sharedSizeBytes);
  }
  if (smem + g_static_smem > 232448) return int(cudaErrorInvalidValue);
  if (smem > g_smem_set) {
    err = cudaFuncSetAttribute(mgr_analytics_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, int(smem));
    if (err != cudaSuccess) return int(err);
    g_smem_set = int(smem);
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
  err = cudaLaunchKernelEx(&cfg, global ? mgr_analytics_kernel<true> : mgr_analytics_kernel<false>,
                           static_cast<const i64*>(values), static_cast<const uint8_t*>(valid),
                           static_cast<const i64*>(cursor), static_cast<i64*>(out), D, M, W, nd,
                           static_cast<unsigned char*>(stage), (bytes + 15) / 16 * 16);
  if (err != cudaSuccess) return int(err);
  return int(cudaGetLastError());
}

}  // extern "C"

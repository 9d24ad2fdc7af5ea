// Batched CRUSH placement: one warp per placement seed, a lane per bucket
// item (sm_90a).
//
// Replaces the jitted XLA program of ceph_tpu/crush/jaxmapper.py
// (BatchedRuleMapper._build, :997-1015: jit(vmap(lane)) over whole rule
// programs, with the crush_hash32_3 / _2 twins of ops/hashing.py:208-260
// inside).  Each warp maps one seed x through the rule exactly as the
// scalar interpreter does (ceph_tpu_torch/crush/mapper.py, a twin of
// src/crush/mapper.c): crush_do_rule's step loop, crush_choose_firstn
// with its retry_descent / retry_bucket loops and chooseleaf recursion,
// crush_choose_indep's breadth-first rounds, and crush_msr_do_rule with
// its stride tree, collision retries and whole-descent retries.  The
// JAX program had to express that control flow as masked while-loops
// over every lane; a warp runs the C loops as they are.
//
// The work is in straw2: every choose draws each item of a bucket (a
// root of 128 hosts is 128 draws a descent).  Lane l of the warp draws
// items l, l + 32, ... and keeps its best (draw, index); a five-step
// xor butterfly of shuffles then gives every lane the winner, the
// larger draw and on equal draws the lower index (mapper.c's first on
// ties, jaxmapper.py:237-254's jnp.argmax).  Every lane thus ends each
// straw2 with the same item, and the rest of the interpreter runs
// warp-uniform: all 32 lanes hold the same scratch and take the same
// branches, so their local-memory accesses coalesce and every shuffle
// sees the whole warp.  The lanes write the seed's results together.
//
// Inputs: the rule as a small program of (op, arg1, arg2) steps plus the
// tunables, in the kernel's argument block (every thread reads the same
// step, so the constant bank broadcasts it); the compiled map's dense
// arrays (items, child, ids, per-position weights, sizes, types) and the
// reweights in device memory, an item's weight and id read by its lane
// (the 32 lanes read neighbouring words); the crush_ln tables (258 + 256
// int64), copied by each block into shared memory, since constant memory
// would serialise the divergent table indices of a warp.
//
// Per-seed scratch (the working vector, the output windows, the MSR
// used-vectors) is fixed-size local memory, capped at kMaxResult
// results, kMaxSteps steps and kMaxMsrLevels CHOOSE_MSR steps per
// segment; the wrapper (crush/cudamapper.py) raises above the caps.
// The MSR levels recurse through a template on the level, so the stack
// frame is static.
//
// Bound: integer operations.  A straw2 draw is one crush_hash32_3 (5
// Jenkins mixes of 27 fused ops), a crush_ln (a clz, a shift, three table
// loads, a 64-bit product), one 64-bit division and a compare: about 175
// INT32 instructions at the least, the division being an FP64 reciprocal
// product (on the FP64 pipe) and one integer correction (div_weight).
// A warp per seed
// gives 2048-8192 warps for a pool's PGs, enough to fill the 132 SMs;
// a lane per item turns a 128-item bucket's 128 dependent draws into 4
// per lane.  What stays serial is the descent itself (root, then host,
// then the retries), the butterfly after each bucket, and the lanes a
// small bucket leaves idle (a host of 8 OSDs draws on 8 of 32 lanes).
//
// CRUSH_LANES (default 32, the warp) is the lane count; a host build of
// this source sets it to 1 and stubs the shuffle, and then runs one
// lane over every item, one seed after another.

#include <climits>
#include <cstdint>

#include <cuda_runtime.h>

#ifndef CRUSH_LANES
#define CRUSH_LANES 32
#endif

// the caps of the per-seed scratch (cudamapper.MAX_STEPS, MAX_RESULT,
// MAX_MSR_LEVELS)
constexpr int kMaxSteps = 32;

struct Args {
  const int32_t* xs;       // [batch] seeds (uint32 bits)
  const int32_t* rew;      // [max(max_devices, 1)] reweights, class-masked
  int32_t* vals;           // [batch, result_max]
  int32_t* counts;         // [batch]
  const int32_t* items;    // [nb, m]
  const int32_t* child;    // [nb, m] dense index of a child bucket, or -1
  const int32_t* argids;   // [nb, m] ids hashed by the draw
  const int64_t* weights;  // [nb, npos_all, m]
  const int32_t* npos;     // [nb]
  const int32_t* size;     // [nb]
  const int32_t* btype;    // [nb]
  const int32_t* idx_of;   // [n_idx] (-1 - bucket id) -> dense index, or -1
  const int64_t* ln;       // RH_LH (258) then LL (256)
  int32_t batch, result_max, nb, m, npos_all, n_idx, max_devices, nsteps;
  int32_t choose_total_tries, choose_local_tries, chooseleaf_descend_once;
  int32_t chooseleaf_vary_r, chooseleaf_stable, msr_descents;
  int32_t msr_collision_tries, msr_firstn;
  int32_t steps[kMaxSteps * 3];
};

namespace {

constexpr int kLanes = CRUSH_LANES;  // lanes per seed
constexpr int kWarps = 4;            // seeds (warps) per block
constexpr int kMaxResult = 32;
constexpr int kMaxMsrLevels = 6;
constexpr int kLnEntries = 258 + 256;

constexpr int kNone = 0x7FFFFFFF;   // CRUSH_ITEM_NONE
constexpr int kUndef = 0x7FFFFFFE;  // CRUSH_ITEM_UNDEF

enum Mode { kFirstn = 0, kIndep = 1, kMsr = 2 };

// crush.h CRUSH_RULE_* step opcodes (crush/types.py RuleOp)
enum Op {
  kNoop = 0, kTake = 1, kChooseFirstn = 2, kChooseIndep = 3, kEmit = 4,
  kChooseleafFirstn = 6, kChooseleafIndep = 7, kSetChooseTries = 8,
  kSetChooseleafTries = 9, kSetChooseLocalTries = 10,
  kSetChooseLocalFallbackTries = 11, kSetChooseleafVaryR = 12,
  kSetChooseleafStable = 13, kSetMsrDescents = 14,
  kSetMsrCollisionTries = 15, kChooseMsr = 16,
};

// ---------------------------------------------------------------------------
// Hashes, crush_ln, straw2
// ---------------------------------------------------------------------------

__device__ __forceinline__ void mix(uint32_t& a, uint32_t& b, uint32_t& c) {
  a = a - b; a = a - c; a = a ^ (c >> 13);
  b = b - c; b = b - a; b = b ^ (a << 8);
  c = c - a; c = c - b; c = c ^ (b >> 13);
  a = a - b; a = a - c; a = a ^ (c >> 12);
  b = b - c; b = b - a; b = b ^ (a << 16);
  c = c - a; c = c - b; c = c ^ (b >> 5);
  a = a - b; a = a - c; a = a ^ (c >> 3);
  b = b - c; b = b - a; b = b ^ (a << 10);
  c = c - a; c = c - b; c = c ^ (b >> 15);
}

constexpr uint32_t kSeed = 1315423911u;

__device__ __forceinline__ uint32_t hash3(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t h = kSeed ^ a ^ b ^ c, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(c, x, h);
  mix(y, a, h);
  mix(b, x, h);
  mix(y, c, h);
  return h;
}

__device__ __forceinline__ uint32_t hash2(uint32_t a, uint32_t b) {
  uint32_t h = kSeed ^ a ^ b, x = 231232u, y = 1232u;
  mix(a, b, h);
  mix(x, a, h);
  mix(b, y, h);
  return h;
}

// 2^44 * log2(u + 1), u in [0, 0xffff] (mapper.c:229-271).  The uint64
// product wraps as the C code's does; only its bits 48-55 are used.
__device__ __forceinline__ int64_t crush_ln(const int64_t* __restrict__ ln, uint32_t u) {
  uint32_t x = u + 1;
  int iexpon = 15;
  if (!(x & 0x18000u)) {
    const int bits = __clz(x) - 16;  // 16 - bit_length(x)
    x <<= bits;
    iexpon = 15 - bits;
  }
  const uint32_t index1 = (x >> 8) << 1;
  const int64_t rh = ln[index1 - 256];
  const int64_t lh = ln[index1 + 1 - 256];
  const uint64_t xl64 = ((uint64_t)x * (uint64_t)rh) >> 48;
  const int64_t ll = ln[258 + (xl64 & 0xFF)];
  return ((int64_t)iexpon << 44) + ((lh + ll) >> 4);
}

struct Ctx {
  const Args& a;
  const int64_t* __restrict__ ln;  // shared memory
  uint32_t x;
};

// num / w, truncated, for 0 <= num <= 2^48 and w >= 1 (any int64).  The
// FP64 product of num and the correctly rounded 1/w has a relative error
// under 3 * 2^-53, so it lies within num * 3 * 2^-53 / w < 1 / w of the
// quotient: never past the next integer (num / w is at least 1 / w below
// it), at most just under an exact quotient, whose truncation one integer
// remainder then corrects.  This replaces nvcc's emulated 64-bit
// division, a long dependent chain on every draw.
__device__ __forceinline__ uint64_t div_weight(uint64_t num, int64_t w) {
  const uint64_t q = (uint64_t)__dmul_rn((double)num, __drcp_rn((double)w));
  return num - q * (uint64_t)w >= (uint64_t)w ? q + 1 : q;
}

// A straw2 candidate: its draw and its index in the bucket.  An empty
// lane holds (INT64_MIN, INT_MAX), which loses every comparison to a
// real item, a zero-weight item (whose draw is INT64_MIN) included.
struct Best {
  int64_t draw;
  int idx;
};

// The larger draw, the lower index on equal draws: a total order, so any
// order of combining gives the first maximum.
__device__ __forceinline__ Best best_of(Best a, Best b) {
  return (b.draw > a.draw || (b.draw == a.draw && b.idx < a.idx)) ? b : a;
}

// One lane's part of bucket_straw2_choose (mapper.c:342-365): items
// lane, lane + lanes, ... of bucket bidx; a zero weight draws S64_MIN.
__device__ __forceinline__ Best straw2_lane(const Ctx& c, int bidx, uint32_t r, int pos,
                                            int lane, int lanes) {
  const Args& a = c.a;
  const int n = a.size[bidx];
  const int p = min(max(pos, 0), a.npos[bidx] - 1);
  const int base = bidx * a.m;
  const int64_t* w = a.weights + ((int64_t)bidx * a.npos_all + p) * a.m;
  Best b{INT64_MIN, INT_MAX};
  for (int i = lane; i < n; i += lanes) {
    const int64_t wi = __ldg(w + i);
    int64_t draw = INT64_MIN;
    if (wi > 0) {
      const uint32_t u = hash3(c.x, (uint32_t)__ldg(a.argids + base + i), r) & 0xFFFFu;
      // -(2^48 - ln) / w, truncated; the numerator is >= 0
      const uint64_t num = 0x1000000000000ULL - (uint64_t)crush_ln(c.ln, u);
      draw = -(int64_t)div_weight(num, wi);
    }
    b = best_of(b, Best{draw, i});
  }
  return b;
}

// The warp's winner in every lane: a butterfly of kLanes / 2, ..., 1.
__device__ __forceinline__ Best warp_best(Best b) {
  for (int off = kLanes / 2; off > 0; off >>= 1) {
    // The full mask is valid: the 32 lanes of a warp run one seed, hold
    // the same state and take the same branches, so all of them reach
    // every straw2 call, and this shuffle, together.
    const Best o{(int64_t)__shfl_xor_sync(0xFFFFFFFFu, (long long)b.draw, off),
                 __shfl_xor_sync(0xFFFFFFFFu, b.idx, off)};
    b = best_of(b, o);
  }
  return b;
}

__device__ __forceinline__ int lane_id() { return (int)(threadIdx.x % kLanes); }

// bucket_straw2_choose over the warp: the item of the largest draw, the
// first one on ties.  Sets *cidx to the item's dense child index (-1 for
// a device or an unknown bucket).  The bucket is not empty (every caller
// checks), so lane 0's item 0 makes the winner a real item.
__device__ int straw2(const Ctx& c, int bidx, uint32_t r, int pos, int* cidx) {
  const Args& a = c.a;
  const Best b = warp_best(straw2_lane(c, bidx, r, pos, lane_id(), kLanes));
  const int base = bidx * a.m;
  *cidx = __ldg(a.child + base + b.idx);
  return __ldg(a.items + base + b.idx);
}

// is_out (mapper.c:405-419) on the reweight vector
__device__ bool is_out(const Ctx& c, const int32_t* __restrict__ rew, int item) {
  const Args& a = c.a;
  const int it = min(max(item, 0), max(a.max_devices - 1, 0));
  const int w = a.max_devices ? __ldg(rew + it) : 0;
  if (w >= 0x10000) return false;
  if (w == 0) return true;
  return (int)(hash2(c.x, (uint32_t)item) & 0xFFFFu) >= w;
}

// dense index of a bucket id, or -1 (a device or an unknown id)
__device__ __forceinline__ int bucket_index(const Args& a, int id) {
  if (id >= 0) return -1;
  const int k = -1 - id;
  return k < a.n_idx ? a.idx_of[k] : -1;
}

__device__ __forceinline__ int item_type(const Args& a, bool is_dev, bool known, int cidx) {
  return (is_dev || !known) ? 0 : a.btype[cidx];
}

// ---------------------------------------------------------------------------
// crush_choose_firstn (mapper.c:441-629); RECURSE is chooseleaf
// ---------------------------------------------------------------------------

template <bool RECURSE>
__device__ int choose_firstn(const Ctx& c, const int32_t* __restrict__ rew, int root,
                             int numrep, int type, int* out, int outpos, int out_size,
                             int tries, int recurse_tries, int local_retries,
                             int vary_r, int stable, int* out2, int parent_r) {
  const Args& a = c.a;
  int count = out_size;
  for (int rep = stable ? 0 : outpos; rep < numrep && count > 0; ++rep) {
    int ftotal = 0;
    bool skip = false;
    int item = 0;
    bool retry_descent;
    do {
      retry_descent = false;
      int in = root;
      int flocal = 0;
      bool retry_bucket;
      do {
        retry_bucket = false;
        const int r = rep + parent_r + ftotal;
        bool reject, collide;
        if (a.size[in] == 0) {
          reject = true;
          collide = false;
          item = 0;
        } else {
          int cidx;
          item = straw2(c, in, (uint32_t)r, outpos, &cidx);
          if (item >= a.max_devices) {
            skip = true;
            break;
          }
          const bool is_dev = item >= 0;
          const bool known = is_dev || cidx >= 0;
          const int itemtype = item_type(a, is_dev, known, cidx);
          if (!known || itemtype != type) {
            if (is_dev || !known) {
              skip = true;
              break;
            }
            in = cidx;
            retry_bucket = true;
            continue;
          }
          collide = false;
          for (int i = 0; i < outpos; ++i) collide |= out[i] == item;
          reject = false;
          if (RECURSE && !collide) {
            if (!is_dev) {
              const int sub_r = vary_r ? r >> (vary_r - 1) : 0;
              if (choose_firstn<false>(c, rew, cidx, stable ? 1 : outpos + 1, 0, out2,
                                       outpos, count, recurse_tries, 0, local_retries,
                                       vary_r, stable, nullptr, sub_r) <= outpos)
                reject = true;
            } else {
              out2[outpos] = item;
            }
          }
          if (!reject && !collide && type == 0 && is_dev) reject = is_out(c, rew, item);
        }
        if (reject || collide) {
          ++ftotal;
          ++flocal;
          if (collide && flocal <= local_retries)
            retry_bucket = true;
          else if (ftotal < tries)
            retry_descent = true;
          else
            skip = true;
        }
      } while (retry_bucket);
    } while (retry_descent);
    if (!skip) {
      out[outpos++] = item;
      --count;
    }
  }
  return outpos;
}

// ---------------------------------------------------------------------------
// crush_choose_indep (mapper.c:636-824); RECURSE is chooseleaf
// ---------------------------------------------------------------------------

template <bool RECURSE>
__device__ void choose_indep(const Ctx& c, const int32_t* __restrict__ rew, int root,
                             int left, int numrep, int type, int* out, int outpos,
                             int tries, int recurse_tries, int* out2, int parent_r) {
  const Args& a = c.a;
  const int endpos = outpos + left;
  for (int rep = outpos; rep < endpos; ++rep) {
    out[rep] = kUndef;
    if (out2) out2[rep] = kUndef;
  }
  for (int ftotal = 0; left > 0 && ftotal < tries; ++ftotal) {
    for (int rep = outpos; rep < endpos; ++rep) {
      if (out[rep] != kUndef) continue;
      int in = root;
      for (;;) {
        const int r = rep + parent_r + numrep * ftotal;
        if (a.size[in] == 0) break;
        int cidx;
        const int item = straw2(c, in, (uint32_t)r, outpos, &cidx);
        if (item >= a.max_devices) {
          out[rep] = kNone;
          if (out2) out2[rep] = kNone;
          --left;
          break;
        }
        const bool is_dev = item >= 0;
        const bool known = is_dev || cidx >= 0;
        const int itemtype = item_type(a, is_dev, known, cidx);
        if (!known || itemtype != type) {
          if (is_dev || !known) {
            out[rep] = kNone;
            if (out2) out2[rep] = kNone;
            --left;
            break;
          }
          in = cidx;
          continue;
        }
        bool collide = false;
        for (int i = outpos; i < endpos; ++i) collide |= out[i] == item;
        if (collide) break;
        if (RECURSE) {
          if (!is_dev) {
            choose_indep<false>(c, rew, cidx, 1, numrep, 0, out2, rep, recurse_tries, 0,
                                nullptr, r);
            if (out2[rep] == kNone) break;
          } else {
            out2[rep] = item;
          }
        }
        if (type == 0 && is_dev && is_out(c, rew, item)) break;
        out[rep] = item;
        --left;
        break;
      }
    }
  }
  for (int rep = outpos; rep < endpos; ++rep) {
    if (out[rep] == kUndef) out[rep] = kNone;
    if (out2 && out2[rep] == kUndef) out2[rep] = kNone;
  }
}

// ---------------------------------------------------------------------------
// crush_do_rule for classic rules (mapper.c:826-1032)
// ---------------------------------------------------------------------------

template <int MODE>
__device__ int classic_rule(const Ctx& c, const int32_t* __restrict__ rew, int* res) {
  const Args& a = c.a;
  const int rm = a.result_max;
  int w[kMaxResult], o[kMaxResult], o2[kMaxResult];
  int nw = 0, nres = 0;
  int choose_tries = a.choose_total_tries + 1;
  int choose_leaf_tries = 0;
  int local_retries = a.choose_local_tries;
  int vary_r = a.chooseleaf_vary_r;
  int stable = a.chooseleaf_stable;
  for (int s = 0; s < a.nsteps; ++s) {
    const int op = a.steps[3 * s], arg1 = a.steps[3 * s + 1], arg2 = a.steps[3 * s + 2];
    switch (op) {
      case kTake:
        if ((arg1 >= 0 && arg1 < a.max_devices) || bucket_index(a, arg1) >= 0) {
          w[0] = arg1;
          nw = 1;
        } else {
          nw = 0;
        }
        break;
      case kSetChooseTries:
        if (arg1 > 0) choose_tries = arg1;
        break;
      case kSetChooseleafTries:
        if (arg1 > 0) choose_leaf_tries = arg1;
        break;
      case kSetChooseLocalTries:
        if (arg1 >= 0) local_retries = arg1;
        break;
      case kSetChooseleafVaryR:
        if (arg1 >= 0) vary_r = arg1;
        break;
      case kSetChooseleafStable:
        if (arg1 >= 0) stable = arg1;
        break;
      case kChooseFirstn:
      case kChooseleafFirstn:
      case kChooseIndep:
      case kChooseleafIndep: {
        if (nw == 0) break;
        const bool firstn = op == kChooseFirstn || op == kChooseleafFirstn;
        const bool leafy = op == kChooseleafFirstn || op == kChooseleafIndep;
        int on = 0;
        for (int j = 0; j < nw; ++j) {
          int numrep = arg1;
          if (numrep <= 0) {
            numrep += rm;
            if (numrep <= 0) continue;
          }
          const int bidx = bucket_index(a, w[j]);
          if (bidx < 0) continue;
          const int avail = rm - on;
          if (firstn) {
            const int recurse_tries = choose_leaf_tries ? choose_leaf_tries
                                      : a.chooseleaf_descend_once ? 1 : choose_tries;
            on += leafy ? choose_firstn<true>(c, rew, bidx, numrep, arg2, o + on, 0, avail,
                                              choose_tries, recurse_tries, local_retries,
                                              vary_r, stable, o2 + on, 0)
                        : choose_firstn<false>(c, rew, bidx, numrep, arg2, o + on, 0, avail,
                                               choose_tries, recurse_tries, local_retries,
                                               vary_r, stable, o2 + on, 0);
          } else if (MODE == kIndep) {
            const int n = min(numrep, avail);
            const int recurse_tries = choose_leaf_tries ? choose_leaf_tries : 1;
            if (leafy)
              choose_indep<true>(c, rew, bidx, n, numrep, arg2, o + on, 0, choose_tries,
                                 recurse_tries, o2 + on, 0);
            else
              choose_indep<false>(c, rew, bidx, n, numrep, arg2, o + on, 0, choose_tries,
                                  recurse_tries, o2 + on, 0);
            on += n;
          }
        }
        const int* src = leafy ? o2 : o;
        for (int j = 0; j < on; ++j) w[j] = src[j];
        nw = on;
        break;
      }
      case kEmit:
        for (int j = 0; j < nw && nres < rm; ++j) res[nres++] = w[j];
        nw = 0;
        break;
      default:
        break;
    }
  }
  return nres;
}

// ---------------------------------------------------------------------------
// crush_msr_do_rule (mapper.c:1723-1930)
// ---------------------------------------------------------------------------

struct Msr {
  int out[kMaxResult + 1];
  int returned;
  int vecs[kMaxMsrLevels][kMaxResult];
  int rm, collision_tries;
  bool firstn;
};

__device__ __forceinline__ void msr_emit(Msr& st, int cand, int position) {
  const int pos = st.firstn ? st.returned : position;
  if (pos >= 0 && pos < st.rm) st.out[pos] = cand;
  ++st.returned;
}

// crush_msr_descend (mapper.c:1274): draw at each level until a device or
// a bucket of `type`.  Returns kNone on a map-integrity reject (empty
// bucket, dangling child, oversized device id); sets *ci to the dense
// index of a bucket it returns.
__device__ int msr_descend(const Ctx& c, int bidx, int type, uint32_t r, int pos, int* ci) {
  const Args& a = c.a;
  *ci = -1;
  for (int depth = 0; depth < a.nb + 2; ++depth) {
    if (a.size[bidx] == 0) return kNone;
    int cidx;
    const int item = straw2(c, bidx, r, pos, &cidx);
    if (item >= 0) return item < a.max_devices ? item : kNone;
    if (cidx < 0) return kNone;
    if (a.btype[cidx] == type) {
      *ci = cidx;
      return item;
    }
    bidx = cidx;
  }
  return kNone;
}

// crush_msr_valid_candidate: a candidate used in [lo, hi) is invalid
// unless every such use is inside the stride [s_lo, s_hi)
__device__ __forceinline__ bool msr_valid(const int* vec, int lo, int hi, int s_lo,
                                          int s_hi, int cand) {
  for (int i = lo; i < hi; ++i)
    if (vec[i] == cand && (i < s_lo || i >= s_hi)) return false;
  return true;
}

// crush_msr_push_used: the first UNDEF slot of the stride takes the
// candidate, unless it is already there
__device__ __forceinline__ bool msr_push(int* vec, int s_lo, int s_hi, int cand) {
  int slot = -1;
  for (int i = s_lo; i < s_hi; ++i) {
    if (vec[i] == cand) return false;
    if (slot < 0 && vec[i] == kUndef) slot = i;
  }
  if (slot < 0) return false;
  vec[slot] = cand;
  return true;
}

// crush_msr_pop_used: clear the last slot of the stride holding cand
__device__ __forceinline__ void msr_pop(int* vec, int s_lo, int s_hi, int cand) {
  for (int i = s_hi - 1; i >= s_lo; --i)
    if (vec[i] == cand) {
      vec[i] = kUndef;
      return;
    }
}

// crush_msr_choose (mapper.c:1507): one CHOOSE_MSR step over its strides;
// LEVEL is the step's place in the segment.
template <int LEVEL>
__device__ int msr_choose(const Ctx& c, const int32_t* __restrict__ rew, Msr& st, int bidx,
                          int tryno, int lo, int hi, int total, int seg_start,
                          int emit_stepno) {
  if constexpr (LEVEL >= kMaxMsrLevels) {
    return 0;  // the wrapper rejects deeper rules
  } else {
    const Args& a = c.a;
    const int stepno = seg_start + LEVEL;
    const int arg1 = a.steps[3 * stepno + 1], arg2 = a.steps[3 * stepno + 2];
    const int rm = st.rm;
    const int num_strides = arg1 ? arg1 : rm;
    if (num_strides <= 0 || total % num_strides != 0) return 0;  // malformed
    const int length = total / num_strides;
    if (length <= 0) return 0;
    const int leaf_level = emit_stepno - seg_start - 1;
    int* vec = st.vecs[LEVEL];
    const int* leaf_vec = st.vecs[leaf_level];
    int undo[kMaxResult];
    int mapped = 0;
    int sidx = 0;
    for (int s_lo = lo; s_lo < hi; s_lo += length, ++sidx) {
      const int s_hi = min(s_lo + length, hi);
      undo[sidx] = kUndef;
      bool filled = true;
      for (int i = s_lo; i < s_hi; ++i) filled &= leaf_vec[i] != kUndef;
      if (filled) continue;
      int cand = kNone, cand_ci = -1;
      bool found = false;
      for (int lt = 0; lt < st.collision_tries; ++lt) {
        const uint32_t r = ((uint32_t)(tryno * rm + sidx) << 16) + (uint32_t)lt;
        int ci;
        const int cd = msr_descend(c, bidx, arg2, r, sidx, &ci);
        if (cd == kNone) continue;
        if (msr_valid(vec, lo, hi, s_lo, s_hi, cd)) {
          cand = cd;
          cand_ci = ci;
          found = true;
          break;
        }
      }
      if (!found) continue;
      if (arg2 == 0) {  // leaf step
        if (length != 1 || stepno + 1 != emit_stepno) continue;  // malformed
        if (is_out(c, rew, cand)) continue;  // a later descent retries
        msr_push(vec, s_lo, s_hi, cand);
        msr_emit(st, cand, s_lo);
        ++mapped;
      } else {
        if (stepno + 1 >= emit_stepno || cand >= 0) continue;
        const int child_mapped = msr_choose<LEVEL + 1>(c, rew, st, cand_ci, tryno, s_lo, s_hi,
                                                       length, seg_start, emit_stepno);
        const bool pushed = msr_push(vec, s_lo, s_hi, cand);
        // popped only after every stride of this level ran: a failed
        // candidate stays visible to the later strides' validity checks
        if (pushed && child_mapped == 0)
          undo[sidx] = cand;
        else
          mapped += child_mapped;
      }
    }
    sidx = 0;
    for (int s_lo = lo; s_lo < hi; s_lo += length, ++sidx)
      if (undo[sidx] != kUndef) msr_pop(vec, s_lo, min(s_lo + length, hi), undo[sidx]);
    return mapped;
  }
}

// Returns the count; writes result_max values (NONE-padded) into res.
__device__ int msr_rule(const Ctx& c, const int32_t* __restrict__ rew, int* res) {
  const Args& a = c.a;
  const int rm = a.result_max;
  const int nsteps = a.nsteps;
  Msr st;
  st.rm = rm;
  st.firstn = a.msr_firstn != 0;
  st.returned = 0;
  for (int i = 0; i <= rm; ++i) st.out[i] = kNone;
  // _msr_scan_config_steps (mapper.c:1088): a leading run of set steps
  int descents = a.msr_descents, collision_tries = a.msr_collision_tries, stepno = 0;
  for (; stepno < nsteps; ++stepno) {
    const int op = a.steps[3 * stepno];
    if (op == kSetMsrDescents)
      descents = a.steps[3 * stepno + 1];
    else if (op == kSetMsrCollisionTries)
      collision_tries = a.steps[3 * stepno + 1];
    else
      break;
  }
  st.collision_tries = collision_tries;

  int start_index = 0;
  while (stepno < nsteps) {
    // _msr_scan_next (mapper.c:1139)
    if (stepno + 1 >= nsteps || a.steps[3 * stepno] != kTake) return -1;
    int total = 1, emit_stepno = stepno + 1;
    for (; emit_stepno < nsteps; ++emit_stepno) {
      const int op = a.steps[3 * emit_stepno];
      if (op == kEmit) break;
      if (op != kChooseMsr) return -1;
      const int arg1 = a.steps[3 * emit_stepno + 1];
      total *= arg1 ? arg1 : rm;
    }
    if (emit_stepno >= nsteps) return -1;
    const int take = a.steps[3 * stepno + 1];
    if (take >= 0) {
      if (stepno + 1 != emit_stepno) return -1;
      msr_emit(st, take, start_index);  // start_index does not advance
    } else {
      const int root = bucket_index(a, take);
      if (root >= 0) {
        const int seg_start = stepno + 1;
        const int end_index = min(start_index + total, rm);
        for (int l = 0; l < emit_stepno - seg_start; ++l)
          for (int i = 0; i < rm; ++i) st.vecs[l][i] = kUndef;
        const int return_limit = st.returned + (end_index - start_index);
        for (int tryno = 0; tryno < descents && st.returned < return_limit; ++tryno)
          msr_choose<0>(c, rew, st, root, tryno, start_index, end_index, total, seg_start,
                        emit_stepno);
        start_index = end_index;
      }
    }
    stepno = emit_stepno + 1;
  }
  for (int i = 0; i < rm; ++i) res[i] = st.out[i];
  return st.firstn ? st.returned : rm;
}

// ---------------------------------------------------------------------------
// The kernels: one seed per warp
// ---------------------------------------------------------------------------

template <int MODE>
__device__ __forceinline__ void rule_body(const Args& a) {
  __shared__ int64_t s_ln[kLnEntries];
  for (int i = threadIdx.x; i < kLnEntries; i += blockDim.x) s_ln[i] = a.ln[i];
  __syncthreads();
  // warp-uniform, so a warp past the batch exits whole
  const int seed = blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  if (seed >= a.batch) return;
  const Ctx c{a, s_ln, (uint32_t)a.xs[seed]};
  int res[kMaxResult];
  int n;
  if constexpr (MODE == kMsr) {
    n = max(msr_rule(c, a.rew, res), 0);  // an invalid rule maps nothing
  } else {
    n = classic_rule<MODE>(c, a.rew, res);
  }
  // every lane holds the whole result: lane i writes value i
  int32_t* out = a.vals + (int64_t)seed * a.result_max;
  for (int i = lane_id(); i < a.result_max; i += kLanes) out[i] = i < n ? res[i] : kNone;
  if (lane_id() == 0) a.counts[seed] = n;
}

constexpr int kThreads = kWarps * kLanes;

__global__ void __launch_bounds__(kThreads) crush_rule_firstn_kernel(const __grid_constant__ Args a) {
  rule_body<kFirstn>(a);
}

__global__ void __launch_bounds__(kThreads) crush_rule_indep_kernel(const __grid_constant__ Args a) {
  rule_body<kIndep>(a);
}

__global__ void __launch_bounds__(kThreads) crush_rule_msr_kernel(const __grid_constant__ Args a) {
  rule_body<kMsr>(a);
}

}  // namespace

// The launch geometry of a batch: warps (seeds) per block and blocks.
// ceph_crush_rule launches with it.
extern "C" void ceph_crush_rule_geometry(int batch, int* warps_per_block, int* blocks) {
  *warps_per_block = kWarps;
  *blocks = batch > 0 ? (batch + kWarps - 1) / kWarps : 0;
}

// One launch of the mode's kernel on `stream`: a warp per seed, kWarps
// warps a block.  Returns the launch's cudaError_t (0 on success).
extern "C" int ceph_crush_rule(int mode, const Args* args, void* stream) {
  int warps, blocks;
  ceph_crush_rule_geometry(args->batch, &warps, &blocks);
  if (blocks == 0) return 0;
  const dim3 grid(blocks), block(warps * kLanes);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mode) {
    case kFirstn: crush_rule_firstn_kernel<<<grid, block, 0, s>>>(*args); break;
    case kIndep: crush_rule_indep_kernel<<<grid, block, 0, s>>>(*args); break;
    case kMsr: crush_rule_msr_kernel<<<grid, block, 0, s>>>(*args); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

"""CRUSH in the port against ceph_tpu: hashes, crush_ln, the scalar
interpreter, and the batched mapper's plain version (the CPU path of
``crush/cudamapper.py``) and kernel source.

Every comparison is exact (tolerance 0: placements are integers).  The
oracles are the golden vectors compiled from the reference's C
(``tests/golden/crush_vectors.json``) and the JAX package's scalar
``crush_do_rule``; the JAX batched engine, which compiles for seconds
per rule on one CPU core, sits beside the port in each of the kernel's
three modes here and in one case of ``test_torch_remap.py``.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from ceph_tpu.crush import builder as rb
from ceph_tpu.crush import mapper as rmapper
from ceph_tpu.crush.jaxmapper import BatchedRuleMapper as JaxRuleMapper
from ceph_tpu.crush.jaxmapper import compile_map as jax_compile_map
from ceph_tpu.crush.types import BucketAlg as RBucketAlg
from ceph_tpu.crush.types import ChooseArg as RChooseArg
from ceph_tpu.crush.types import CrushMap as RCrushMap
from ceph_tpu.crush.types import Tunables as RTunables
from ceph_tpu.ops import hashing as rhash
from ceph_tpu_torch.crush import builder as pb
from ceph_tpu_torch.crush import cudamapper as cm
from ceph_tpu_torch.crush import mapper as pmapper
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import (
    RULE_TYPE_MSR_FIRSTN,
    RULE_TYPE_MSR_INDEP,
    BucketAlg,
    ChooseArg,
    CrushMap,
    Rule,
    RuleOp,
    RuleStep,
    Tunables,
)
from ceph_tpu_torch.ops import hashing as phash
from tests.xla_private import _private_xla_compiles  # noqa: F401

ROOT = Path(__file__).resolve().parent.parent
GOLDEN = ROOT / "tests" / "golden" / "crush_vectors.json"
NONE = 0x7FFFFFFF


@pytest.fixture(scope="module")
def vectors():
    return json.loads(GOLDEN.read_text())


# ---------------------------------------------------------------------------
# Hashes and crush_ln
# ---------------------------------------------------------------------------

def test_hash_golden_vectors(vectors):
    for i, want in enumerate(vectors["hash32_3"]):
        a, b, c = i * 2654435761 % 2**32, i ^ 0x55AA, i
        assert int(phash.crush_hash32_3(np.uint32(a), np.uint32(b), np.uint32(c))) == want
        assert phash.crush_hash32_3(a, b, c) == want
    for i, want in enumerate(vectors["hash32_2"]):
        assert int(phash.crush_hash32_2(np.uint32(i * 40503), np.uint32(i + 7))) == want
        assert phash.crush_hash32_2(i * 40503, i + 7) == want


@pytest.mark.parametrize("arity", [1, 2, 3, 4, 5])
def test_hash_matches_reference(arity):
    rng = np.random.default_rng(100 + arity)
    args = [rng.integers(0, 2**32, 256, dtype=np.uint32) for _ in range(arity)]
    name = "crush_hash32" if arity == 1 else f"crush_hash32_{arity}"
    want = getattr(rhash, name)(*args)
    assert np.array_equal(getattr(phash, name)(*args), want)
    # the plain-int fast path
    ints = [[int(v) for v in a[:16]] for a in args]
    for j in range(16):
        assert getattr(phash, name)(*(a[j] for a in ints)) == int(want[j])


def test_torch_hash_twins_with_high_bits():
    rng = np.random.default_rng(7)
    a, b, c = (rng.integers(0, 2**32, 4096, dtype=np.uint32) | np.uint32(1 << 31)
               for _ in range(3))

    def t(v):
        return torch.from_numpy(v.view(np.int32).copy())

    got3 = phash.crush_hash32_3_torch(t(a), t(b), t(c)).numpy().view(np.uint32)
    got2 = phash.crush_hash32_2_torch(t(a), t(b)).numpy().view(np.uint32)
    assert np.array_equal(got3, rhash.crush_hash32_3(a, b, c))
    assert np.array_equal(got2, rhash.crush_hash32_2(a, b))
    # a plain int operand broadcasts, as the mapper passes r
    got = phash.crush_hash32_3_torch(t(a), t(b), 0xFFFFFFF0).numpy().view(np.uint32)
    assert np.array_equal(got, rhash.crush_hash32_3(a, b, np.uint32(0xFFFFFFF0)))


def test_crush_ln_every_input():
    u = np.arange(0x10000)
    want = np.array([rmapper.crush_ln(int(v)) for v in u], dtype=np.int64)
    got = np.array([pmapper.crush_ln(int(v)) for v in u], dtype=np.int64)
    assert np.array_equal(got, want)
    m = CrushMap()
    pb.build_hierarchy(m, osds_per_host=2, n_hosts=2)
    dm = cm.device_map(cm.compile_map(m), "cpu")
    plain = cm.crush_ln_plain(dm, torch.from_numpy(u.astype(np.int32)))
    assert plain.dtype == torch.int64
    assert np.array_equal(plain.numpy(), want)


def test_straw2_draw_matches_reference():
    rng = np.random.default_rng(3)
    for x, item, r, w in zip(rng.integers(0, 2**32, 200), rng.integers(-50, 1000, 200),
                             rng.integers(0, 100, 200), rng.integers(1, 0x50000, 200)):
        args = (0, int(x), int(item), int(r), int(w))
        assert pmapper.straw2_draw(*args) == rmapper.straw2_draw(*args)


# ---------------------------------------------------------------------------
# The scalar interpreter: the cases of test_crush_golden.py
# ---------------------------------------------------------------------------

ALGS = {"straw2": BucketAlg.STRAW2, "uniform": BucketAlg.UNIFORM,
        "list": BucketAlg.LIST, "tree": BucketAlg.TREE}


def _golden_map(alg: str):
    m = CrushMap()
    root = pb.build_hierarchy(m, osds_per_host=4, n_hosts=5, alg=ALGS[alg])
    return m, root.id


def _weights(zero=(), half=(), quarter=()):
    w = [0x10000] * 20
    for i in zero:
        w[i] = 0
    for i in half:
        w[i] = 0x8000
    for i in quarter:
        w[i] = 0x4000
    return w


def _golden_rule(case: str, m: CrushMap, root: int) -> tuple[int, int]:
    """(rule id, result_max) of a golden case on the port's builder."""
    if case in ("chooseleaf_firstn_host", "firstn_host_degraded"):
        return pb.add_simple_rule(m, root, failure_domain_type=1, mode="firstn"), 3
    if case == "chooseleaf_indep_host":
        return pb.add_simple_rule(m, root, failure_domain_type=1, mode="indep"), 4
    if case in ("choose_indep_osd", "indep_osd_degraded"):
        return pb.add_simple_rule(m, root, failure_domain_type=0, mode="indep"), 6
    if case.startswith("two_level"):
        rid = pb.add_two_level_indep_rule(m, root, failure_domain_type=1, num_per_domain=2)
        m.rules[rid].steps[2].arg1 = 3  # the oracle's choose indep 3
        return rid, 6
    if case.startswith("msr_indep"):
        return pb.add_osd_multi_per_domain_rule(
            m, root, failure_domain_type=1, num_per_domain=2, num_domains=4), 8
    rid = max(m.rules, default=-1) + 1
    m.rules[rid] = Rule(rule_type=RULE_TYPE_MSR_FIRSTN, steps=[
        RuleStep(RuleOp.SET_MSR_DESCENTS, 8, 0),
        RuleStep(RuleOp.SET_MSR_COLLISION_TRIES, 16, 0),
        RuleStep(RuleOp.TAKE, root, 0),
        RuleStep(RuleOp.CHOOSE_MSR, 0, 1),
        RuleStep(RuleOp.CHOOSE_MSR, 1, 0),
        RuleStep(RuleOp.EMIT, 0, 0),
    ])
    return rid, 3


GOLDEN_WEIGHTS = {
    "chooseleaf_firstn_host": _weights(),
    "chooseleaf_indep_host": _weights(),
    "choose_indep_osd": _weights(),
    "indep_osd_degraded": _weights(zero=(3,), half=(7,), quarter=(12,)),
    "firstn_host_degraded": _weights(zero=(3,), half=(7,), quarter=(12,)),
    "two_level": _weights(),
    "two_level_degraded": _weights(zero=(3,), half=(7,)),
    "msr_indep": _weights(),
    "msr_indep_degraded": _weights(zero=(3, 12), half=(7,)),
    "msr_firstn": _weights(),
    "msr_firstn_degraded": _weights(zero=(0, 4, 8, 9)),
}


@pytest.mark.parametrize("case", sorted(GOLDEN_WEIGHTS))
@pytest.mark.parametrize("alg", sorted(ALGS))
def test_scalar_mapper_golden(vectors, alg, case):
    m, root = _golden_map(alg)
    rid, rm = _golden_rule(case, m, root)
    if case.startswith("msr"):
        want_type = RULE_TYPE_MSR_FIRSTN if "firstn" in case else RULE_TYPE_MSR_INDEP
        assert m.rules[rid].rule_type == want_type
    want = vectors[f"{alg}_{case}"]
    w = GOLDEN_WEIGHTS[case]
    for x in range(64):
        assert pmapper.crush_do_rule(m, rid, x, rm, w) == want[x], (alg, case, x)
    if alg == "straw2":
        # the batched mapper's plain version on the same vectors
        bm = cm.BatchedRuleMapper(cm.compile_map(m), rid, rm, device="cpu")
        vals, cnt = bm(np.arange(64, dtype=np.uint32), w)
        assert [[int(v) for v in vals[x, :cnt[x]]] for x in range(64)] == want


def test_scalar_dangling_and_empty_buckets_never_raise():
    m, root = _golden_map("straw2")
    indep = pb.add_simple_rule(m, root, failure_domain_type=1, mode="indep")
    msr = pb.add_osd_multi_per_domain_rule(m, root, failure_domain_type=1,
                                           num_per_domain=2, num_domains=4)
    m.buckets[root].items.append(-99)
    m.buckets[root].item_weights.append(0x10000)
    host = next(b for b in m.buckets.values() if b.type == 1)
    host.items.clear()
    host.item_weights.clear()
    rm_ = RCrushMap()
    rroot = rb.build_hierarchy(rm_, osds_per_host=4, n_hosts=5)
    rb.add_simple_rule(rm_, rroot.id, failure_domain_type=1, mode="indep")
    rb.add_osd_multi_per_domain_rule(rm_, rroot.id, failure_domain_type=1,
                                     num_per_domain=2, num_domains=4)
    rm_.buckets[rroot.id].items.append(-99)
    rm_.buckets[rroot.id].item_weights.append(0x10000)
    rhost = rm_.buckets[host.id]
    rhost.items.clear()
    rhost.item_weights.clear()
    for rid, n in ((indep, 4), (msr, 8)):
        bm = cm.BatchedRuleMapper(cm.compile_map(m), rid, n, device="cpu")
        vals, cnt = bm(np.arange(32, dtype=np.uint32))
        for x in range(32):
            out = pmapper.crush_do_rule(m, rid, x, n, _weights())
            assert len(out) == n
            assert out == rmapper.crush_do_rule(rm_, rid, x, n, _weights())
            assert [int(v) for v in vals[x, :cnt[x]]] == out


# ---------------------------------------------------------------------------
# The batched mapper's plain version against the reference scalar mapper
# ---------------------------------------------------------------------------

def _three_level(builder, crush_map_cls, alg, seed: int):
    """root -> 4 racks -> 4 hosts -> 3 osds with random weights, built
    with one package's builder (tests/test_jaxmapper.py:three_level_map)."""
    rng = np.random.default_rng(seed)
    m = crush_map_cls()
    m.types = {0: "osd", 1: "host", 3: "rack", 10: "root"}
    rack_ids, rack_w, osd = [], [], 0
    for _ in range(4):
        host_ids, host_w = [], []
        for _h in range(4):
            devs = list(range(osd, osd + 3))
            osd += 3
            w = [int(rng.integers(0x8000, 0x30000)) for _ in devs]
            hb = builder.make_bucket(m, alg, 1, devs, w)
            host_ids.append(hb.id)
            host_w.append(hb.weight)
        rbk = builder.make_bucket(m, alg, 3, host_ids, host_w)
        rack_ids.append(rbk.id)
        rack_w.append(rbk.weight)
    root = builder.make_bucket(m, alg, 10, rack_ids, rack_w)
    m.bucket_names["default"] = root.id
    return m, root


XS = np.random.default_rng(11).integers(0, 2**32, 120, dtype=np.uint32)


def _rules(builder, m, root):
    """Every rule of the cases below, by case name: (rule id, result_max)."""
    out = {
        "replicated firstn 3": (builder.add_simple_rule(m, root.id, 1, mode="firstn"), 3),
        "ec indep": (builder.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3), 6),
        "rack domain": (builder.add_simple_rule(m, root.id, 3, mode="indep", rule_type=3), 4),
        "two-step lrc": (builder.add_two_level_indep_rule(
            m, root.id, 3, num_per_domain=2, num_domains=4), 8),
        "msr indep": (builder.add_osd_multi_per_domain_rule(
            m, root.id, 3, num_per_domain=2, num_domains=4), 8),
        "msr firstn reweighted": (builder.add_osd_multi_per_domain_rule(
            m, root.id, 3, num_per_domain=3, num_domains=3,
            rule_type=RULE_TYPE_MSR_FIRSTN), 9),
        "osd direct": (builder.add_simple_rule(m, root.id, 0, mode="firstn"), 3),
    }
    out["replicated firstn 5"] = (out["replicated firstn 3"][0], 5)
    out["msr indep truncated"] = (out["msr indep"][0], 6)
    return out


@pytest.fixture(scope="module")
def maps():
    """Equal maps from the two builders, with every rule of the cases."""
    m, root = _three_level(pb, CrushMap, BucketAlg.STRAW2, 20260730)
    r, rroot = _three_level(rb, RCrushMap, RBucketAlg.STRAW2, 20260730)
    rules = _rules(pb, m, root)
    assert _rules(rb, r, rroot) == rules
    return m, r, root, rules


def test_builders_make_equal_maps(maps):
    m, r, _, _ = maps
    assert sorted(m.buckets) == sorted(r.buckets)
    for bid, b in m.buckets.items():
        rbk = r.buckets[bid]
        assert (b.id, b.type, int(b.alg), b.hash, b.items, b.item_weights) == (
            rbk.id, rbk.type, int(rbk.alg), rbk.hash, rbk.items, rbk.item_weights)
    assert sorted(m.rules) == sorted(r.rules)
    for rid, rule in m.rules.items():
        rr = r.rules[rid]
        assert rule.rule_type == rr.rule_type and rule.device_class == rr.device_class
        assert [(int(s.op), s.arg1, s.arg2) for s in rule.steps] == [
            (int(s.op), s.arg1, s.arg2) for s in rr.steps]
    assert m.max_devices == r.max_devices == 48


def _reweights(seed: int, n: int, k: int) -> list[int]:
    rng = np.random.default_rng(seed)
    w = np.full(n, 0x10000, np.int64)
    w[rng.integers(0, n, k)] = 0
    w[rng.integers(0, n, k)] = rng.integers(1, 0x10000, k)
    return [int(v) for v in w]


def _assert_plain_matches(m, r, rid, rm, xs, weights=None, ca=None, rca=None,
                          tunables=None):
    saved = m.tunables, r.tunables
    if tunables is not None:
        m.tunables, r.tunables = Tunables(**tunables), RTunables(**tunables)
    try:
        bm = cm.BatchedRuleMapper(cm.compile_map(m, choose_args=ca), rid, rm, device="cpu")
        vals, cnt = bm(xs, weights)
        assert vals.shape == (len(xs), rm) and vals.dtype == np.int32
        # NONE pads every row past its count
        assert (vals[np.arange(rm)[None, :] >= cnt[:, None]] == NONE).all()
        for i, x in enumerate(xs):
            want = rmapper.crush_do_rule(r, rid, int(x), rm, weights, rca)
            assert [int(v) for v in vals[i, :cnt[i]]] == want, (rid, int(x))
    finally:
        m.tunables, r.tunables = saved


CASES = ["replicated firstn 3", "replicated firstn 5", "ec indep", "rack domain",
         "two-step lrc", "msr indep", "msr indep truncated", "osd direct"]


@pytest.mark.parametrize("case", CASES)
def test_plain_batched_matches_reference(maps, case):
    m, r, _, rules = maps
    rid, rm = rules[case]
    xs = XS[:60] if case.startswith("msr") else XS
    _assert_plain_matches(m, r, rid, rm, xs)


@pytest.mark.parametrize("case", ["msr firstn reweighted", "replicated firstn 3", "ec indep"])
def test_plain_batched_zero_and_partial_reweights(maps, case):
    m, r, _, rules = maps
    rid, rm = rules[case]
    weights = _reweights(5, m.max_devices, 10 if case.startswith("msr") else 8)
    _assert_plain_matches(m, r, rid, rm, XS[:60], weights)


def test_plain_batched_device_class(maps):
    m, r, root, _ = maps
    m, r = m.copy(), r.copy()
    for o in range(m.max_devices):
        cls = "ssd" if o % 3 == 0 else "hdd"
        pb.set_device_class(m, o, cls)
        rb.set_device_class(r, o, cls)
    rid = pb.add_simple_rule(m, root.id, 1, mode="firstn")
    assert rb.add_simple_rule(r, root.id, 1, mode="firstn") == rid
    m.rules[rid].device_class = r.rules[rid].device_class = "hdd"
    _assert_plain_matches(m, r, rid, 3, XS)


@pytest.mark.parametrize("case", ["replicated firstn 3", "ec indep"])
def test_plain_batched_legacy_tunables(maps, case):
    m, r, _, rules = maps
    rid, rm = rules[case]
    _assert_plain_matches(m, r, rid, rm, XS, tunables=dict(
        choose_local_tries=2, choose_local_fallback_tries=0, choose_total_tries=19,
        chooseleaf_descend_once=0, chooseleaf_vary_r=0, chooseleaf_stable=0))


def test_plain_batched_choose_args_weight_sets(maps):
    m, r, root, rules = maps
    rng = np.random.default_rng(21)
    sets = [[int(v) for v in rng.integers(0x8000, 0x30000, root.size)] for _ in range(2)]
    ca = {root.id: ChooseArg(root.id, weight_set=sets)}
    rca = {root.id: RChooseArg(root.id, weight_set=sets)}
    _assert_plain_matches(m, r, rules["replicated firstn 3"][0], 3, XS, ca=ca, rca=rca)


def test_unsupported_map_for_a_list_bucket():
    m = CrushMap()
    b = pb.make_bucket(m, BucketAlg.LIST, 1, [0, 1, 2], [0x10000] * 3)
    m.bucket_names["default"] = b.id
    with pytest.raises(cm.UnsupportedMap):
        cm.compile_map(m)
    m2, root = _golden_map("straw2")
    rid = pb.add_simple_rule(m2, root, 1, mode="firstn")
    m2.tunables.choose_local_fallback_tries = 5
    with pytest.raises(cm.UnsupportedMap):
        cm.BatchedRuleMapper(cm.compile_map(m2), rid, 3, device="cpu")


@pytest.mark.parametrize("case", ["replicated firstn 3", "ec indep", "msr indep"])
def test_plain_batched_beside_the_jax_engine(maps, case):
    """The same seeds through ceph_tpu's jit/vmap engine and the port's
    plain version, in each of the kernel's three modes: equal (vals,
    counts), NONE padding included."""
    m, r, _, rules = maps
    rid, rm = rules[case]
    weights = _reweights(9, m.max_devices, 6)
    want_vals, want_cnt = JaxRuleMapper(jax_compile_map(r), rid, rm)(XS, weights)
    vals, cnt = cm.BatchedRuleMapper(cm.compile_map(m), rid, rm, device="cpu")(XS, weights)
    assert np.array_equal(vals, np.asarray(want_vals))
    assert np.array_equal(cnt, np.asarray(want_cnt))


def test_kernel_entry_points_and_caps(maps):
    m, _, _, rules = maps
    cc = cm.compile_map(m)
    kinds = {case: cm.BatchedRuleMapper(cc, *rules[case], device="cpu").kind
             for case in ("replicated firstn 3", "ec indep", "two-step lrc", "msr indep")}
    assert kinds == {"replicated firstn 3": "firstn", "ec indep": "indep",
                     "two-step lrc": "indep", "msr indep": "msr"}
    cm.reset_launch_counts()
    mapper = cm.BatchedRuleMapper(cc, *rules["ec indep"], device="cpu")
    vals, cnt = mapper.map_tensors(torch.from_numpy(XS[:4].astype(np.int32)),
                                   torch.from_numpy(mapper.reweights()))
    assert vals.shape == (4, 6) and cnt.tolist() == [6] * 4
    # the CPU path is the plain version: nothing launched
    assert cm.launch_counts() == {"crush_rule_firstn": 0, "crush_rule_indep": 0,
                                  "crush_rule_msr": 0}
    cm.check_caps(mapper)
    with pytest.raises(ValueError, match="result_max"):
        cm.check_caps(cm.BatchedRuleMapper(cc, rules["ec indep"][0], cm.MAX_RESULT + 1,
                                           device="cpu"))


# ---------------------------------------------------------------------------
# The kernel source, built as host C++ (the card is not here)
# ---------------------------------------------------------------------------

_HOST_PRELUDE = r"""
#include <algorithm>
#include <cstdint>
using std::max;
using std::min;
#define CRUSH_LANES 1
template <class T> inline T __shfl_xor_sync(unsigned, T v, int) { return v; }
inline double __drcp_rn(double x) { return 1.0 / x; }
inline double __dmul_rn(double a, double b) { return a * b; }
#define __device__
#define __forceinline__ inline
#define __global__
#define __launch_bounds__(x)
#define __grid_constant__
#define __shared__ static
#define __restrict__
template <class T> inline T __ldg(const T* p) { return *p; }
inline int __clz(unsigned x) { return x ? __builtin_clz(x) : 32; }
struct Dim { unsigned x; };
static Dim threadIdx{0}, blockIdx{0}, blockDim{1};
inline void __syncthreads() {}
"""
_HOST_LOOP = r"""
extern "C" void host_rule(int mode, const Args* a) {
  for (int s = 0; s < a->batch; ++s) {
    blockIdx.x = s;
    if (mode == 0) rule_body<kFirstn>(*a);
    else if (mode == 1) rule_body<kIndep>(*a);
    else rule_body<kMsr>(*a);
  }
}

// Bucket bidx's straw2 winner for seed x as `lanes` lanes find it: the
// kernel's straw2_lane on each lane, then warp_best's butterfly (lane l
// takes best_of(its own, lane l ^ off's) for off = lanes / 2, ..., 1),
// run in lockstep.  Returns the index, or -1 if the lanes disagree.
extern "C" int host_straw2(const Args* a, int bidx, unsigned x, unsigned r, int pos,
                           int lanes, long long* draw) {
  const Ctx c{*a, a->ln, x};
  Best v[32], nv[32];
  for (int l = 0; l < lanes; ++l) v[l] = straw2_lane(c, bidx, r, pos, l, lanes);
  for (int off = lanes / 2; off > 0; off >>= 1) {
    for (int l = 0; l < lanes; ++l) nv[l] = best_of(v[l], v[l ^ off]);
    for (int l = 0; l < lanes; ++l) v[l] = nv[l];
  }
  for (int l = 1; l < lanes; ++l)
    if (v[l].draw != v[0].draw || v[l].idx != v[0].idx) return -1;
  *draw = v[0].draw;
  return v[0].idx;
}

extern "C" unsigned long long host_div_weight(unsigned long long num, long long w) {
  return div_weight(num, w);
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``crush_rule.cu``'s device code compiled with g++ as host code, one
    seed after another: its control flow and arithmetic, not its speed."""
    src = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "crush_rule.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src[: src.index('extern "C" int ceph_crush_rule')]
    d = tmp_path_factory.mktemp("crush_host")
    cpp, so = d / "crush_host.cpp", d / "libcrush_host.so"
    cpp.write_text(_HOST_PRELUDE + src + _HOST_LOOP)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_rule.argtypes = [ctypes.c_int, ctypes.c_void_p]
    lib.host_straw2.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_uint,
                                ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)]
    lib.host_div_weight.argtypes = [ctypes.c_ulonglong, ctypes.c_longlong]
    lib.host_div_weight.restype = ctypes.c_ulonglong
    return lib


def _host_map(lib, mapper, xs, weights=None):
    """cudamapper's argument block for these seeds, run by the host build."""
    x = torch.from_numpy(np.asarray(xs, np.uint32).astype(np.int32))
    rew = mapper.class_masked(torch.from_numpy(mapper.reweights(weights))).contiguous()
    vals = torch.empty((len(xs), mapper.result_max), dtype=torch.int32)
    counts = torch.empty((len(xs),), dtype=torch.int32)
    args = cm.kernel_args(mapper, x, rew, vals, counts)
    lib.host_rule(cm.MODES[mapper.kind], ctypes.byref(args))
    return vals.numpy(), counts.numpy()


@pytest.mark.parametrize("case", CASES + ["msr firstn reweighted"])
def test_kernel_source_as_host_code(maps, host_kernel, case):
    m, _, _, rules = maps
    rid, rm = rules[case]
    weights = _reweights(5, m.max_devices, 10) if "reweighted" in case else None
    mapper = cm.BatchedRuleMapper(cm.compile_map(m), rid, rm, device="cpu")
    want_vals, want_cnt = mapper(XS, weights)
    vals, cnt = _host_map(host_kernel, mapper, XS, weights)
    assert np.array_equal(vals, want_vals) and np.array_equal(cnt, want_cnt)


def test_kernel_source_as_host_code_tunables_classes_and_weight_sets(maps, host_kernel):
    m, _, root, rules = maps
    m = m.copy()
    for o in range(m.max_devices):
        pb.set_device_class(m, o, "ssd" if o % 3 == 0 else "hdd")
    rid = pb.add_simple_rule(m, root.id, 1, mode="firstn")
    m.rules[rid].device_class = "hdd"
    rng = np.random.default_rng(21)
    ca = {root.id: ChooseArg(root.id, weight_set=[
        [int(v) for v in rng.integers(0x8000, 0x30000, root.size)] for _ in range(2)])}
    weights = _reweights(6, m.max_devices, 8)
    for cc, ruleno, rm in ((cm.compile_map(m), rid, 3),
                           (cm.compile_map(m, choose_args=ca), rules["ec indep"][0], 6)):
        mapper = cm.BatchedRuleMapper(cc, ruleno, rm, device="cpu")
        want = mapper(XS, weights)
        got = _host_map(host_kernel, mapper, XS, weights)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))
    m.tunables = Tunables(choose_local_tries=2, choose_total_tries=19,
                          chooseleaf_descend_once=0, chooseleaf_vary_r=0, chooseleaf_stable=0)
    for case in ("replicated firstn 3", "ec indep"):
        mapper = cm.BatchedRuleMapper(cm.compile_map(m), *rules[case], device="cpu")
        want = mapper(XS, weights)
        got = _host_map(host_kernel, mapper, XS, weights)
        assert all(np.array_equal(a, b) for a, b in zip(got, want))


def test_kernel_division_as_host_code(host_kernel):
    """div_weight, the draw's num // w by an FP64 reciprocal and one
    integer correction, against Python's // over its edges: numerators 0
    to 2^48, weights 1 to 2^63 - 1, exact multiples and their neighbours."""
    rng = np.random.default_rng(48)
    top = 1 << 48
    weights = [1, 2, 3, 7, 0xFFFF, 0x10000, 0x10001, 0x30000, (1 << 32) - 1, 1 << 32,
               (1 << 32) + 1, (1 << 40) + 7, top - 1, top, top + 1, (1 << 53) + 1,
               (1 << 62) + 3, (1 << 63) - 1]
    weights += [int(v) for v in rng.integers(1, 1 << 20, 40)]
    weights += [int(v) for v in rng.integers(1 << 32, 1 << 62, 40)]
    for w in weights:
        nums = {0, 1, top - 1, top, w - 1, w, w + 1, top // w * w, top // w * w - 1}
        for k in rng.integers(0, top // w + 1, 12):
            nums |= {int(k) * w - 1, int(k) * w, int(k) * w + 1}
        nums |= {int(v) for v in rng.integers(0, top + 1, 12)}
        for num in sorted(n for n in nums if 0 <= n <= top):
            assert host_kernel.host_div_weight(num, w) == num // w, (num, w)


def _straw2_want(cc, bidx, x, r, pos):
    """(index, draw) of bucket_straw2_choose in Python ints: the first
    maximum of -((2^48 - crush_ln(u)) // w), S64_MIN for a zero weight."""
    n = int(cc.size[bidx])
    p = min(max(pos, 0), int(cc.npos[bidx]) - 1)
    best = None
    for i in range(n):
        w = int(cc.weights[bidx, p, i])
        draw = -(2 ** 63)
        if w > 0:
            u = int(phash.crush_hash32_3(x, int(cc.argids[bidx, i]) & 0xFFFFFFFF, r)) & 0xFFFF
            draw = -(((1 << 48) - pmapper.crush_ln(u)) // w)
        if best is None or draw > best[1]:
            best = (i, draw)
    return best


def _weighted(kind: str, n: int, rng) -> list[int]:
    """Weights of one bucket's n items for each lane-split case."""
    if kind == "random":
        return [int(v) for v in rng.integers(1, 0x50000, n)]
    if kind == "all zero":
        return [0] * n
    if kind == "zero first":
        return [0] + [int(v) for v in rng.integers(0x8000, 0x30000, n - 1)]
    if kind == "equal draws":
        # weights past 2^48 draw 0, weight 1 draws -(2^48 - ln) < 0: the
        # huge-weight items tie, 65 on a lane below the lowest index's
        w = [1] * n
        for i in (40, 65, 69, 7, 4, 2) + ((1,) if n <= 3 else ()):
            if i < n:
                w[i] = 1 << 50
        return w
    # past 2^32, beside small ones
    return [int(v) if i % 3 else int(v) >> 24
            for i, v in enumerate(rng.integers(1 << 32, 1 << 56, n))]


@pytest.mark.parametrize("kind", ["random", "all zero", "zero first", "equal draws",
                                  "past 2^32"])
@pytest.mark.parametrize("hosts", [70, 32, 33, 5])
def test_kernel_straw2_lane_split_as_host_code(host_kernel, hosts, kind):
    """straw2 over 32 lanes and the xor butterfly, in C++: every lane ends
    with the one-lane winner (the lower index on equal draws), which is
    the first maximum of bucket_straw2_choose."""
    rng = np.random.default_rng(hosts)
    m = CrushMap()
    root = pb.build_hierarchy(m, osds_per_host=3, n_hosts=hosts)
    rid = pb.add_simple_rule(m, root.id, 1, mode="firstn")
    cc = cm.compile_map(m)
    root_idx = cc.idx_of[root.id]
    host_idx = cc.idx_of[m.buckets[root.id].items[0]]
    cc.weights[root_idx, 0, :hosts] = _weighted(kind, hosts, rng)
    cc.weights[host_idx, 0, :3] = _weighted(kind, 3, rng)
    mapper = cm.BatchedRuleMapper(cc, rid, 3, device="cpu")
    x = torch.zeros(1, dtype=torch.int32)
    vals, counts = torch.empty((1, 3), dtype=torch.int32), torch.empty(1, dtype=torch.int32)
    args = cm.kernel_args(mapper, x, torch.full((m.max_devices,), 0x10000, dtype=torch.int32),
                          vals, counts)
    draw = ctypes.c_longlong()
    for seed in rng.integers(0, 2 ** 32, 24, dtype=np.uint32):
        for bidx in (root_idx, host_idx):
            for r in (0, 1, 0x20003):
                want = _straw2_want(cc, bidx, int(seed), r, 0)
                for lanes in (1, 2, 8, 32):
                    got = host_kernel.host_straw2(ctypes.byref(args), bidx, int(seed), r, 0,
                                                  lanes, ctypes.byref(draw))
                    assert (got, draw.value) == want, (kind, hosts, bidx, int(seed), r, lanes)
    if kind == "all zero":
        assert want[0] == 0
    if kind == "equal draws" and hosts == 70:
        assert _straw2_want(cc, root_idx, 0, 0, 0)[0] == 2


# ---------------------------------------------------------------------------
# crushtool --test
# ---------------------------------------------------------------------------

def test_tester_counts_match_crush_do_rule(maps):
    m, _, _, rules = maps
    for case in ("replicated firstn 3", "ec indep"):
        rid, rm = rules[case]
        res = CrushTester(m, device="cpu").test(rid, rm, 0, 255, keep_mappings=True)
        counts: dict[int, int] = {}
        bad = []
        for x in range(256):
            row = pmapper.crush_do_rule(m, rid, x, rm)
            assert res.mappings[x] == row
            devs = [o for o in row if o != NONE]
            bad += [x] if len(devs) < rm else []
            for o in devs:
                counts[o] = counts.get(o, 0) + 1
        assert res.device_counts == counts and res.bad_mappings == bad
    # a legacy map goes to the scalar interpreter
    lm, lroot = _golden_map("list")
    rid = pb.add_simple_rule(lm, lroot, 1, mode="firstn")
    res = CrushTester(lm, device="cpu").test(rid, 3, 0, 31, keep_mappings=True)
    assert res.mappings == {x: pmapper.crush_do_rule(lm, rid, x, 3) for x in range(32)}

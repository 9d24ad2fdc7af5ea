"""The mgr's analytics engine and time-series store against ceph_tpu.

The port's engine (its kernel wrapper's plain version on the CPU) and
its numpy host path are held bit-identical (tolerance 0) to the
reference's ``analyze_numpy`` and to its jitted ``AnalyticsEngine`` on
seeded random stores, with the traps where C and numpy part ways:
negative and full-range int64 samples (floor division, wrapping shifts,
sums and products), cursors past the window, negative and next to
INT64_MAX (floor modulo of a wrapped sum), empty and single-sample
series, ties, D from 1 to 64.  A model of ``mgr_analytics.cu``'s
algorithm (the cluster's split of the daemons, the walk, the dense key
lists, the radix select with its shared leading bytes skipped and the
histograms summed over the blocks) is held to the same answers.  The
store and the digest summary are held to the reference's on the same
report sequences.
"""

import types

import numpy as np
import pytest
import torch

from ceph_tpu.mgr.analytics import AnalyticsEngine as RefEngine
from ceph_tpu.mgr.analytics import analyze_numpy as ref_analyze_numpy
from ceph_tpu.mgr.daemon import MgrDaemon as RefMgrDaemon
from ceph_tpu.mgr.daemon import TimeSeriesStore as RefStore
from ceph_tpu_torch.mgr import analytics as an
from ceph_tpu_torch.mgr import daemon as md
from ceph_tpu_torch.ops import analytics_kernels as ak
from tests.xla_private import _private_xla_compiles  # noqa: F401

I64 = np.iinfo(np.int64)


def _random_store(rng, D=5, M=4, W=12):
    vals = rng.integers(0, 1 << 28, size=(D, M, W)).astype(np.int64)
    valid = rng.random((D, M, W)) < rng.uniform(0.2, 0.9)
    cursor = rng.integers(0, W, size=D).astype(np.int64)
    return vals, valid, cursor


def _trap_store(rng, D, M, W, kind):
    """A store with one of the traps: full-range values, small values
    with many ties and negatives, or sparse series (empty and single
    samples); cursors past the window, negative, and next to INT64_MAX."""
    if kind == "full":
        vals = rng.integers(I64.min, I64.max, size=(D, M, W), dtype=np.int64, endpoint=True)
        valid = rng.random((D, M, W)) < 0.7
    elif kind == "ties":
        vals = rng.integers(-3, 4, size=(D, M, W)).astype(np.int64)
        valid = rng.random((D, M, W)) < 0.8
    else:  # sparse: most series empty or one sample; one metric all invalid
        vals = rng.integers(-(1 << 40), 1 << 40, size=(D, M, W)).astype(np.int64)
        valid = rng.random((D, M, W)) < 1.5 / W
        valid[:, 0, :] = False
    cursor = rng.integers(-3 * W, 3 * W, size=D).astype(np.int64)
    cursor[: min(D, 3)] = [I64.max, I64.max - 1, I64.min][: min(D, 3)]
    return vals, valid, cursor


def _assert_same(got, want):
    assert set(got) == set(want)
    for key in want:
        g = np.asarray(got[key])
        assert g.dtype == want[key].dtype and g.shape == want[key].shape, key
        assert np.array_equal(g, want[key]), key


# ---------------------------------------------------------------------------
# Twins of tests/test_mgr.py TestAnalytics
# ---------------------------------------------------------------------------

def test_engine_bit_identical_to_numpy():
    """The engine's device path (the kernel's plain version here) and the
    numpy host path return bit-identical arrays; prewarm covers the one
    shape, so no pass is a cold launch."""
    rng = np.random.default_rng(42)
    eng = an.AnalyticsEngine(5, 4, 12, device="cpu")
    assert eng.prewarm() == 1
    assert eng.prewarm() == 0
    for _ in range(3):
        vals, valid, cursor = _random_store(rng)
        _assert_same(eng.analyze(vals, valid, cursor), an.analyze_numpy(vals, valid, cursor))
    assert eng.stats == {"prewarmed_shapes": 1, "passes": 3, "launches": 3}
    assert "fallbacks" not in eng.stats


def test_numpy_backend_same_results():
    rng = np.random.default_rng(7)
    vals, valid, cursor = _random_store(rng)
    eng = an.AnalyticsEngine(5, 4, 12, backend="numpy")
    assert eng.prewarm() == 0 and eng.device is None
    _assert_same(eng.analyze(vals, valid, cursor), an.analyze_numpy(vals, valid, cursor))
    assert eng.stats == {"passes": 1}


def test_percentile_semantics():
    """Nearest rank on a known series: p50 of 1..100 is 50."""
    D, M, W = 1, 1, 100
    vals = np.arange(1, 101, dtype=np.int64).reshape(D, M, W)
    valid = np.ones((D, M, W), bool)
    eng = an.AnalyticsEngine(D, M, W, device="cpu")
    out = eng.analyze(vals, valid, np.zeros(D, np.int64))
    assert list(out["percentiles"][0]) == [50, 95, 99]
    assert out["n_samples"][0] == 100


def test_outlier_detection():
    """One daemon 10x slower than five others is flagged."""
    D, M, W = 6, 1, 8
    vals = np.full((D, M, W), 100, np.int64)
    vals[3] = 1000
    valid = np.ones((D, M, W), bool)
    out = an.AnalyticsEngine(D, M, W, device="cpu").analyze(vals, valid, np.zeros(D, np.int64))
    assert out["outlier"][3, 0] and out["outlier"].sum() == 1


def test_ewma_tracks_trend():
    """EWMA (alpha 1/4) of a step 0 -> 1000 converges toward 1000 and
    exceeds the plain mean of the window."""
    D, M, W = 1, 1, 16
    vals = np.zeros((D, M, W), np.int64)
    vals[0, 0, 8:] = 1000
    valid = np.ones((D, M, W), bool)
    out = an.AnalyticsEngine(D, M, W, device="cpu").analyze(vals, valid, np.zeros(D, np.int64))
    ewma = out["ewma_scaled"][0, 0] / (1 << an.SCALE_SHIFT)
    mean = out["mean_scaled"][0, 0] / (1 << an.SCALE_SHIFT)
    assert 800 < ewma <= 1000 and ewma > mean


# ---------------------------------------------------------------------------
# Against the reference: its numpy path and its jitted engine
# ---------------------------------------------------------------------------

SHAPES = [(1, 1, 1), (1, 3, 4), (2, 2, 7), (7, 3, 5), (16, 16, 32), (64, 4, 8)]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_matches_reference(shape):
    D, M, W = shape
    rng = np.random.default_rng(sum(shape) * 101)
    port = an.AnalyticsEngine(D, M, W, device="cpu")
    ref = RefEngine(D, M, W, backend="jax")
    assert port.prewarm() == ref.prewarm() == 1
    stores = [_random_store(rng, D, M, W)] + [
        _trap_store(rng, D, M, W, kind) for kind in ("full", "ties", "sparse")]
    for vals, valid, cursor in stores:
        want = ref_analyze_numpy(vals, valid, cursor)
        _assert_same(port.analyze(vals, valid, cursor), want)
        _assert_same(an.analyze_numpy(vals, valid, cursor), want)
        _assert_same(ref.analyze(vals, valid, cursor), want)
        t = [torch.from_numpy(x) for x in (vals, valid, cursor)]
        _assert_same({k: v.numpy() for k, v in ak.analyze(*t).items()}, want)
        _assert_same({k: v.numpy() for k, v in ak.unpack(ak.analyze_packed(*t), D, M).items()},
                     want)
    assert ref.stats["fallbacks"] == 0 and ref.stats["cold_launches"] == 0
    assert port.stats["cold_launches"] == 0 and port.stats["launches"] == len(stores)


def test_store_of_another_shape_raises():
    eng = an.AnalyticsEngine(5, 4, 12, device="cpu")
    with pytest.raises(ValueError, match="shape"):
        eng.analyze(*_random_store(np.random.default_rng(0), 4, 4, 12))


def test_cold_launch_counted_without_prewarm():
    rng = np.random.default_rng(5)
    eng = an.AnalyticsEngine(5, 4, 12, device="cpu")
    eng.analyze(*_random_store(rng))
    eng.analyze(*_random_store(rng))
    assert eng.stats["cold_launches"] == 1 and eng.prewarm() == 0


# ---------------------------------------------------------------------------
# A model of mgr_analytics.cu's algorithm
# ---------------------------------------------------------------------------

M64 = (1 << 64) - 1


def _s64(x: int) -> int:
    """Two's-complement int64 of x mod 2^64."""
    x &= M64
    return x - (1 << 64) if x >> 63 else x


def _key(x: int) -> int:
    return (x & M64) ^ (1 << 63)


def _start(total, rank, kmin, kmax):
    """A select's state before its first round (``start_select``): the
    bits from ``top`` up are every candidate's; at most ``GATHER_MAX``
    candidates end it at once by a rank count."""
    st = {"rank": rank, "count": total, "top": 64, "prefix": 0, "passes": 0, "gathered": False}
    if total == 0:
        st["mode"] = "done"
    elif kmin == kmax:
        st.update(prefix=kmin, mode="done")
    else:
        top = (kmin ^ kmax).bit_length()
        st.update(top=top, prefix=kmin >> top << top,
                  mode="gather" if total <= ak.GATHER_MAX else "hist")
    return st


def _matches(k, st):
    return (k ^ st["prefix"]) >> st["top"] == 0


def _digit_bits(rnd):
    """A histogram pass's digit width: 11 bits in a select's first round,
    10 in later ones."""
    return ak.FIRST_DIGIT_BITS if rnd == 0 else ak.LATER_DIGIT_BITS


def _pick_digit(st, hists, bits):
    """A histogram pass's pick from the blocks' histograms of the digit
    below ``top``: their super-bins of 32 bins summed, the super-bin where
    the rank falls, then its 32 bins (``pick_digit``)."""
    w = min(bits, st["top"])
    shift = st["top"] - w
    tot = [sum(h[b] for h in hists) for b in range(1 << bits)]
    width = 32
    supers = [sum(tot[i * width:(i + 1) * width]) for i in range((1 << bits) // width)]
    want, below, sup = st["rank"], 0, 0
    while below + supers[sup] <= want:
        below += supers[sup]
        sup += 1
    b = sup * width
    while below + tot[b] <= want:
        below += tot[b]
        b += 1
    st.update(rank=want - below, prefix=st["prefix"] | b << shift, top=shift, count=tot[b],
              passes=st["passes"] + 1)
    st["mode"] = ("done" if shift == 0 else "gather" if tot[b] <= ak.GATHER_MAX else "hist")


def _pick_gathered(st, lists):
    """An early end: the blocks' lists of the candidates (at most
    ``GATHER_MAX`` together); the key of the rank by counting, for each,
    the candidates below it and those not above it."""
    cands = [k for lst in lists for k in lst]
    assert len(cands) == st["count"] <= ak.GATHER_MAX
    want = st["rank"]
    hit = [k for k in cands if sum(y < k for y in cands) <= want < sum(y <= k for y in cands)]
    st.update(prefix=hit[0], top=0, mode="done", gathered=True)


def _selects(blocks, mblocks, ranks, mrank):
    """The kernel's four selects on the blocks' sample key lists and mean
    key lists, round by round (an 11-bit digit in the first, 10 bits
    later): the percentile selects that seek among the same candidates
    share a histogram; from the second round each block first keeps only
    the keys that match a running percentile select, and the round's
    selects scan those.  Returns the four states (key in
    ``prefix``, ``passes``, ``gathered``) and the rounds."""
    flat = [k for b in blocks for k in b]
    mflat = [k for b in mblocks for k in b]
    n, nm = len(flat), len(mflat)
    sts = [_start(n, r, min(flat or [0]), max(flat or [0])) for r in ranks]
    sts.append(_start(nm, mrank, min(mflat or [0]), max(mflat or [0])))
    lists = [list(b) for b in blocks]
    rounds = 0
    while any(st["mode"] != "done" for st in sts):
        if rounds > 0:
            running = [st for st in sts[:3] if st["mode"] != "done"]
            lists = [[k for k in b if any(_matches(k, st) for st in running)] for b in lists]
        for i, st in enumerate(sts):
            if st["mode"] == "done":
                continue
            src = mblocks if i == 3 else lists
            # the compacted lists hold every candidate of a running select
            assert [[k for k in b if _matches(k, st)] for b in src] == \
                [[k for k in b if _matches(k, st)] for b in (mblocks if i == 3 else blocks)]
            if st["mode"] == "gather":
                _pick_gathered(st, [[k for k in b if _matches(k, st)] for b in src])
            else:
                bits = _digit_bits(rounds)
                w = min(bits, st["top"])
                hists = []
                for b in src:
                    h = [0] * (1 << bits)
                    for k in b:
                        if _matches(k, st):
                            h[(k >> (st["top"] - w)) & ((1 << w) - 1)] += 1
                    hists.append(h)
                _pick_digit(st, hists, bits)
        rounds += 1
    return sts, rounds


def kernel_model(values, valid, cursor):
    """``mgr_analytics.cu`` step by step on Python ints: returns the six
    outputs and, a metric, its four selects' (histogram passes, ended by a
    rank count) and its rounds."""
    D, M, W = values.shape
    cluster, nd, _ = ak.geometry(D, W)
    out = {"percentiles": np.zeros((M, 3), np.int64), "n_samples": np.zeros(M, np.int64),
           "ewma_scaled": np.zeros((D, M), np.int64), "mean_scaled": np.zeros((D, M), np.int64),
           "count": np.zeros((D, M), np.int64), "outlier": np.zeros((D, M), bool)}
    plans = []
    for m in range(M):
        skeys, mkeys, means = [], [], {}
        for r in range(cluster):
            d0 = r * nd
            keys, mk = [], []
            for d in range(d0, min(D, d0 + nd)):
                cur = int(cursor[d])
                e, seen, s, cnt = 0, False, 0, 0
                for t in range(W):
                    j = _s64(cur + t) % W          # Python's % floors
                    if valid[d, m, j]:
                        x = int(values[d, m, j])
                        xs = _s64(x << 8)
                        e = _s64(e + (_s64(xs - e) >> 2)) if seen else xs
                        seen = True
                        s = _s64(s + x)
                        cnt += 1
                        keys.append(_key(x))
                mean = _s64(s << 8) // cnt if cnt else 0
                out["ewma_scaled"][d, m], out["mean_scaled"][d, m] = e, mean
                out["count"][d, m] = cnt
                means[d] = (mean, cnt)
                if cnt:
                    mk.append(_key(mean))
            skeys.append(keys)
            mkeys.append(mk)
        n = sum(map(len, skeys))
        nm = sum(map(len, mkeys))
        ranks = [min(max((p * n + 99) // 100 - 1, 0), D * W - 1) for p in an.PCTS]
        sts, rounds = _selects(skeys, mkeys, ranks, min((nm - 1) // 2 if nm else 0, D - 1))
        for i in range(3):
            out["percentiles"][m, i] = _s64(sts[i]["prefix"] ^ (1 << 63)) if n else 0
        med = _s64(sts[3]["prefix"] ^ (1 << 63)) if nm else 0
        for d, (mean, cnt) in means.items():
            out["outlier"][d, m] = cnt > 0 and mean > _s64(2 * med) and med > 0
        out["n_samples"][m] = n
        plans.append({"selects": [(st["passes"], st["gathered"]) for st in sts],
                      "rounds": rounds})
    return out, plans


def _ring_index(c: int, tw: int, r64: int, W: int, t: int) -> int:
    """``ring_index`` of mgr_analytics.cu: step t's column from the ring's
    start c, dropping by r64 = 2^64 mod W from step tw on."""
    j = c + t
    if j >= W:
        j -= W
    if t >= tw:
        j = j - r64 if j >= r64 else j + W - r64
    return j


@pytest.mark.parametrize("W", [1, 2, 5, 7, 8, 12, 32, 40, 100])
def test_ring_index_matches_the_gather(W):
    """The kernel's ring columns, from its per-daemon start and first
    wrapped step, equal the reference's gather ``(cursor + t) % W`` of the
    wrapped int64 sum: for cursors next to INT64_MAX that gather repeats
    a column and skips one unless W divides 2^64."""
    cursors = [I64.max - d for d in range(W + 2)] + [I64.min, -1, 0, 3, 5 * W + 1, -7 * W - 2]
    want = ((np.array(cursors, np.int64)[:, None] + np.arange(W, dtype=np.int64)[None, :])
            % W)
    r64 = (1 << 64) % W
    for cur, row in zip(cursors, want):
        t0 = I64.max - cur + 1              # the first t whose sum wraps
        tw = t0 if t0 < W else W
        assert [_ring_index(cur % W, tw, r64, W, t) for t in range(W)] == row.tolist()
    if r64:
        assert len(set(want[0])) < W       # INT64_MAX's ring repeats a column


@pytest.mark.parametrize("shape", [(1, 1, 1), (3, 2, 5), (16, 2, 32), (130, 2, 4), (300, 1, 3)],
                         ids=lambda s: "x".join(map(str, s)))
def test_kernel_model_matches_numpy(shape):
    """The kernel's algorithm, at cluster sizes 1, 2 and 3 (130 and 300
    daemons), on every kind of store."""
    D, M, W = shape
    rng = np.random.default_rng(D * 7 + W)
    stores = [_random_store(rng, D, M, W)] + [
        _trap_store(rng, D, M, W, kind) for kind in ("full", "ties", "sparse")]
    for vals, valid, cursor in stores:
        got, _ = kernel_model(vals, valid, cursor)
        _assert_same(got, an.analyze_numpy(vals, valid, cursor))


def test_kernel_model_skips_shared_bytes():
    """Samples of the store's clamp range share their leading bits: the
    first digit starts at the highest bit where they differ, one 11-bit
    pass leaves at most 64 candidates and a rank count among them ends
    the select; 16 means end by a rank count at once."""
    rng = np.random.default_rng(11)
    vals = rng.integers(0, 1 << 20, size=(16, 2, 32)).astype(np.int64)
    valid = np.ones(vals.shape, bool)
    valid[:, 1] = False
    vals[:, 1] = 5
    got, plans = kernel_model(vals, valid, np.zeros(16, np.int64))
    _assert_same(got, an.analyze_numpy(vals, valid, np.zeros(16, np.int64)))
    assert plans[0] == {"selects": [(1, True)] * 3 + [(0, True)], "rounds": 2}
    assert plans[1] == {"selects": [(0, False)] * 4, "rounds": 0}   # no samples: no round


@pytest.mark.parametrize("kind", ["latency", "clamp"])
def test_kernel_model_two_rounds(kind):
    """Seeded stores like the mgr path's end in two rounds: op latencies
    (150-2050 µs, a slow daemon, 1 in 8 left out) and samples over the
    store's whole clamp range, at one block and at a cluster of three."""
    for D in (16, 300):
        rng = np.random.default_rng(D)
        shape = (D, 2, 32)
        if kind == "latency":
            vals = rng.integers(150, 2051, size=shape).astype(np.int64)
            vals[3] += 20000
        else:
            vals = rng.integers(0, (1 << 40) + 1, size=shape).astype(np.int64)
        valid = rng.random(shape) >= 0.125
        cursor = rng.integers(0, 32, size=D).astype(np.int64)
        got, plans = kernel_model(vals, valid, cursor)
        _assert_same(got, an.analyze_numpy(vals, valid, cursor))
        assert [p["rounds"] for p in plans] == [2, 2], (D, plans)


@pytest.mark.parametrize("case", ["gather_edge", "over_edge", "ties", "one_key_apart", "wide"])
def test_select_model_every_rank(case):
    """The select alone, over three blocks' lists, at every rank: equal to
    the sorted keys at 64 candidates (an early end at once) and 65 (a pass
    first), with heavy ties, keys one apart and keys over all 64 bits."""
    rng = np.random.default_rng(len(case))
    if case == "gather_edge":
        keys = [int(k) for k in rng.integers(0, 1 << 62, 64)]
    elif case == "over_edge":
        keys = [int(k) for k in rng.integers(0, 1 << 62, 65)]
    elif case == "ties":
        keys = [int(k) for k in rng.integers(0, 3, 300)] + [1 << 40]
    elif case == "one_key_apart":
        keys = [(1 << 63) + int(k) for k in rng.integers(0, 2, 200)]
    else:
        keys = [int(k) for k in rng.integers(0, 1 << 64, 500, dtype=np.uint64)]
    blocks = [keys[0::3], keys[1::3], keys[2::3]]
    want = sorted(keys)
    for rank in range(len(keys)):
        sts, _ = _selects(blocks, [[], [], []], [rank, 0, len(keys) - 1], 0)
        assert sts[0]["prefix"] == want[rank]
        assert sts[2]["prefix"] == want[-1]
        plan = (sts[0]["passes"], sts[0]["gathered"])
        if case == "gather_edge":
            assert plan == (0, True)
        elif case == "over_edge":
            assert plan == (1, True)
        assert plan[0] <= 1 + -(-(64 - ak.FIRST_DIGIT_BITS) // ak.LATER_DIGIT_BITS)


@pytest.mark.parametrize("W", [1, 5, 31, 32, 33, 40, 64, 100])
def test_key_segments_tile_the_list(W):
    """The kernel's split of a block's key list among its key warps: the
    walkers are ceil(nd / 32) warps, at most 8 of 16; key warp q takes the
    contiguous jobs [q J / Q, (q + 1) J / Q) of the J = rows x chunks and
    its segment starts at (row of its first job) W + (its chunk) 32.  The
    segments tile the list exactly, each as long as its jobs' columns, and
    q J stays under 2^32 (the kernel's unsigned arithmetic)."""
    chunks = -(-W // 32)
    for nloc in (1, 2, 16, 33, 128, 273, 375):
        walkers = min(8, max(1, -(-nloc // 32)))
        Q = 16 - walkers
        jobs = nloc * chunks
        ends = []
        for q in range(Q):
            jb, je = q * jobs // Q, (q + 1) * jobs // Q
            start = jb // chunks * W + jb % chunks * 32
            cols = sum(min(32, W - j % chunks * 32) for j in range(jb, je))
            ends.append((start, start + cols))
        assert ends[0][0] == 0 and ends[-1][1] == nloc * W
        assert all(a[1] == b[0] for a, b in zip(ends, ends[1:]))
    assert 15 * ((1 << 28) + (1 << 23)) < 1 << 32


def test_geometry():
    """Stores whose rows fit a block's shared memory stage them there; a
    larger store (several thousand daemons, or a long window) is staged in
    global scratch, so every shape the mgr options allow launches."""
    assert ak.geometry(16, 32) == (1, 16, False)
    assert ak.geometry(1024, 32) == (8, 128, False)
    assert ak.geometry(130, 4) == (2, 65, False)
    assert ak.smem_bytes(128, 32) == 128 * (33 * 8 + 32 * 8 + 28 + 33)
    assert ak.smem_bytes(128, 32) <= ak.SMEM_LIMIT
    assert ak.stage_bytes(1024, 16, 32) == 0
    # the two histogram buffers (4096 four-byte bins each: two 2048-bin
    # first passes or four 1024-bin later ones) come first in a block's
    # shared memory; under 8 KiB of static arrays; 128 daemons of 32
    # samples take under half an SM's 228 KiB, so two blocks share an SM
    assert ak.HIST_BYTES == 32768 and ak.SMEM_LIMIT == 232448 - 32768 - 8192
    assert 2 << ak.FIRST_DIGIT_BITS == 4 << ak.LATER_DIGIT_BITS == 4096
    assert ak.GATHER_MAX == 64
    assert 2 * (ak.smem_bytes(128, 32) + ak.HIST_BYTES + 8192 + 1024) <= 228 * 1024
    # the largest store staged in shared memory, and the next one
    assert ak.geometry(2632, 32) == (8, 329, False)
    assert ak.geometry(2633, 32) == (8, 330, True)
    assert ak.geometry(2968, 32) == (8, 371, True)
    assert ak.geometry(16, 701) == (1, 16, False)
    assert ak.geometry(16, 702) == (1, 16, True)
    assert ak.geometry(16, 793) == (1, 16, True)
    assert ak.geometry(8192, 32) == (8, 1024, True)
    assert ak.stage_bytes(8192, 4, 32) == 8 * 4 * 1024 * 581
    with pytest.raises(ValueError, match="exceeds the kernel's launch"):
        an.AnalyticsEngine(16, 1 << 16, 4, device="cpu")
    with pytest.raises(ValueError, match="exceeds the kernel's launch"):
        ak.check_shape(1 << 16, 1, 1 << 15)
    assert ak.packed_words(16, 16) == 4 * 16 + 3 * 256 + 32


@pytest.mark.parametrize("shape", [(2968, 1, 32), (2969, 1, 32), (16, 2, 793)],
                         ids=lambda s: "x".join(map(str, s)))
def test_staged_shapes_match_reference(shape):
    """At stores staged in global scratch (past 2632 daemons at W = 32, or
    a window past 701 at D = 16), the engine and the kernel's model equal
    the reference's analyze_numpy bit for bit."""
    D, M, W = shape
    rng = np.random.default_rng(D + W)
    for vals, valid, cursor in (_random_store(rng, D, M, W),
                                _trap_store(rng, D, M, W, "full")):
        want = ref_analyze_numpy(vals, valid, cursor)
        eng = an.AnalyticsEngine(D, M, W, device="cpu")
        _assert_same(eng.analyze(vals, valid, cursor), want)
        got, _ = kernel_model(vals, valid, cursor)
        _assert_same(got, want)


def test_wrapper_checks_its_operands():
    v = torch.zeros((2, 3, 4), dtype=torch.int64)
    b = torch.zeros((2, 3, 4), dtype=torch.bool)
    c = torch.zeros(2, dtype=torch.int64)
    with pytest.raises(TypeError, match="int64"):
        ak.analyze(v.to(torch.int32), b, c)
    with pytest.raises(TypeError, match="bool"):
        ak.analyze(v, b.to(torch.uint8), c)
    with pytest.raises(ValueError, match="cursor"):
        ak.analyze(v, b, torch.zeros(3, dtype=torch.int64))
    ak.reset_launch_counts()
    ak.analyze(v, b, c)
    assert ak.launch_counts() == {"mgr_analytics": 0}   # the CPU runs the plain version


def test_failing_launch_raises_without_host_answer(monkeypatch):
    """A launch that fails reaches the caller of analyze and of prewarm;
    nothing answers from analyze_numpy and no fallback is counted."""
    def refuse(values, valid, cursor):
        raise RuntimeError("mgr_analytics kernel launch failed: cudaError 1")

    monkeypatch.setattr(ak, "analyze_packed", refuse)
    rng = np.random.default_rng(2)
    eng = an.AnalyticsEngine(5, 4, 12, device="cpu")
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.prewarm()
    with pytest.raises(RuntimeError, match="launch failed"):
        eng.analyze(*_random_store(rng))
    assert eng.stats["launches"] == 0 and "fallbacks" not in eng.stats
    assert eng.stats["passes"] == 1


def test_engine_span_and_counters():
    from ceph_tpu_torch.common.tracing import device_tracer

    rng = np.random.default_rng(9)
    eng = an.AnalyticsEngine(3, 2, 4, device="cpu")
    before = eng.metrics.dump().get("launches", 0)
    eng.prewarm()
    n_spans = len(device_tracer().find(kind="mgr_analytics", shape=str(eng.shape)))
    eng.analyze(*_random_store(rng, 3, 2, 4))
    spans = device_tracer().find(kind="mgr_analytics", shape=str(eng.shape))
    assert len(spans) == n_spans + 1 and spans[-1].name == "cuda_launch"
    assert eng.metrics.dump()["launches"] == before + 1


# ---------------------------------------------------------------------------
# The time-series store and the digest summary
# ---------------------------------------------------------------------------

def _reports(rng, n, daemons, metrics):
    """A seeded report sequence: each report a daemon and a random subset
    of metrics with values in and out of the clamp range."""
    out = []
    for i in range(n):
        d = daemons[rng.integers(len(daemons))]
        names = [m for m in metrics if rng.random() < 0.6]
        samples = {m: float(rng.choice([rng.uniform(0, 5000), -7.4, 1e13, 2.5]))
                   for m in names}
        out.append((d, samples, float(i)))
    return out


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_store_and_summary_match_reference(seed):
    """The same reports into both stores (daemon slots evicted LRU, metric
    slots overflowing), then the engine's result keyed back to names by
    both summaries."""
    rng = np.random.default_rng(seed)
    daemons = [f"osd.{i}" for i in range(9)] + ["mon.a", "mds.x"]
    metrics = [f"m{i}" for i in range(7)]
    shape = (6, 5, 8)
    port, ref = md.TimeSeriesStore(*shape), RefStore(*shape)
    port.reserve(["m0", "m1"])
    ref.reserve(["m0", "m1"])
    for daemon, samples, now in _reports(rng, 120, daemons, metrics):
        port.ingest(daemon, samples, now)
        ref.ingest(daemon, samples, now)
    for a, b in zip(port.snapshot(), ref.snapshot()):
        assert np.array_equal(a, b)
    assert port.daemons == ref.daemons and port.metric_names == ref.metric_names
    assert port.dropped_metrics == ref.dropped_metrics and port.dropped_metrics
    assert port.evictions == ref.evictions > 0
    assert port.last_seen == ref.last_seen
    for d in daemons:
        for m in metrics:
            assert port.series(d, m) == ref.series(d, m)
    assert md.SAMPLE_CLAMP == 1 << 40 and max(map(max, filter(None, (
        port.series(d, m) for d in daemons for m in metrics)))) == md.SAMPLE_CLAMP
    eng = an.AnalyticsEngine(*shape, device="cpu")
    result = eng.analyze(*port.snapshot())
    want = RefMgrDaemon._analytics_summary(types.SimpleNamespace(
        last_analytics=ref_analyze_numpy(*ref.snapshot()), store=ref))
    assert md.analytics_summary(port, result) == want
    assert md.analytics_summary(port, None) == {}


def test_summary_flags_the_slow_osd():
    store = md.TimeSeriesStore(8, 2, 6)
    for t in range(6):
        for i in range(6):
            store.ingest(f"osd.{i}", {"op_latency_us": 1000 if i == 4 else 100}, float(t))
    summary = md.analytics_summary(store, an.AnalyticsEngine(8, 2, 6, device="cpu").analyze(
        *store.snapshot()))
    assert summary["outliers"] == {"op_latency_us": ["osd.4"]}
    assert summary["percentiles"]["op_latency_us"] == {"p50": 100, "p95": 1000, "p99": 1000,
                                                       "n": 36}

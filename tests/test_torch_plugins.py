"""The port's isa, jerasure, shec, lrc and clay plugins against ceph_tpu's.

Both sides are built from the same profile and fed the same numpy
payloads on the CPU (``device="cpu"``); chunk bytes must be equal
(tolerance 0).  Every non-``jax`` entry of ``tests/golden/ec_kats.json``
is encoded on the host path and on the torch path (``device_min_bytes``
0, so every product goes through ``BitmatrixCodec`` on CPU tensors);
every erasure set up to m is decoded; the ``models/`` constructions are
held equal over a grid of (k, m, w); profile errors carry the reference's
errno.
"""

import errno
import hashlib
import itertools
import json
import os

import numpy as np
import pytest

from ceph_tpu.ec import ECError as RefECError
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.models import bitmatrices as ref_bm
from ceph_tpu.models import matrices as ref_mx
from ceph_tpu_torch.ec import ECError, registry
from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode
from ceph_tpu_torch.models import bitmatrices as bm
from ceph_tpu_torch.models import matrices as mx
from ceph_tpu_torch.ops import gf256
from ceph_tpu_torch.ops import rs_kernels as rk
from tests.xla_private import _private_xla_compiles  # noqa: F401

GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ec_kats.json")
with open(GOLDEN) as _f:
    CORPUS = {k: v for k, v in json.load(_f).items() if v["plugin"] != "jax"}


def _payloads() -> dict[str, bytes]:
    # tools/gen_ec_golden.py's payloads
    ramp = bytes(range(256)) * 17 + b"\x00\x01\x02"
    rnd = np.random.default_rng(0xCEF).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    return {"ramp4355": ramp, "rand8192": rnd}


PAYLOADS = _payloads()


def matrix_codes(ec) -> list[MatrixErasureCode]:
    """Every matrix code that runs a product for ``ec``: itself, CLAY's
    inner codes, LRC's layers."""
    if isinstance(ec, MatrixErasureCode):
        return [ec]
    if hasattr(ec, "layers"):
        return [c for layer in ec.layers for c in matrix_codes(layer.erasure_code)]
    return [ec.mds, ec.pft]


def _pair(entry: dict, torch_path: bool):
    port = registry.factory(entry["plugin"], dict(entry["profile"]), device="cpu")
    if torch_path:
        for c in matrix_codes(port):
            c.device_min_bytes = 0
    return ref_registry.factory(entry["plugin"], dict(entry["profile"])), port


def test_corpus_has_the_nineteen_profiles():
    assert len(CORPUS) == 19
    assert sorted({e["plugin"] for e in CORPUS.values()}) == [
        "clay", "isa", "jerasure", "lrc", "shec"]


@pytest.mark.parametrize("path", ["host", "torch"])
@pytest.mark.parametrize("pname", sorted(PAYLOADS))
@pytest.mark.parametrize("key", sorted(CORPUS), ids=lambda s: s[:60])
def test_kat_bytes(key, pname, path):
    entry = CORPUS[key]
    ref, port = _pair(entry, path == "torch")
    assert port.get_profile() == ref.get_profile()
    n = port.get_chunk_count()
    assert (n, port.get_data_chunk_count()) == (ref.get_chunk_count(),
                                                ref.get_data_chunk_count())
    payload = PAYLOADS[pname]
    rk.reset_launch_counts()
    got = port.encode(set(range(n)), payload)
    want = ref.encode(set(range(n)), payload)
    assert set(got) == set(want) == set(map(int, entry["chunks"][pname]))
    for i, chunk in got.items():
        w = entry["chunks"][pname][str(i)]
        raw = chunk.tobytes()
        assert len(raw) == w["len"] and raw[:32].hex() == w["head"]
        assert hashlib.sha256(raw).hexdigest() == w["sha256"], (key, pname, i)
        assert np.array_equal(chunk, want[i])
    assert set(rk.launch_counts().values()) == {0}


def _erasure_sets(n: int, m: int, stride: int = 1):
    """Every set of 1..m of n chunks; with ``stride``, every single
    erasure and every stride-th larger set."""
    sets = [s for e in range(1, m + 1) for s in itertools.combinations(range(n), e)]
    return [s for i, s in enumerate(sets) if len(s) == 1 or i % stride == 0]


@pytest.mark.parametrize("path", ["host", "torch"])
@pytest.mark.parametrize("key", sorted(CORPUS), ids=lambda s: s[:60])
def test_decode_every_erasure_set(key, path):
    """Every erasure set of up to m chunks (n - k for LRC) on the host
    path, every single erasure and a seventh of the larger sets on the
    torch path: the port decodes exactly what the reference decodes, or
    raises the same errno.  CLAY's sets are held against the written
    chunks, which equal the reference's (test_kat_bytes)."""
    entry = CORPUS[key]
    ref, port = _pair(entry, path == "torch")
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    m = n - k
    rng = np.random.default_rng(17)
    size = port.get_chunk_size(1) * k - 5
    payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
    enc = port.encode(set(range(n)), payload)
    clay = entry["plugin"] == "clay"
    if not clay:
        want_enc = ref.encode(set(range(n)), payload)
        assert all(np.array_equal(enc[i], want_enc[i]) for i in range(n))
    cs = len(enc[0])
    decoded = 0
    for lost in _erasure_sets(n, m, 7 if path == "torch" else 1):
        avail = {i: c for i, c in enc.items() if i not in lost}
        want = set(range(n))
        if not clay:
            try:
                ref_out = ref.decode(want, avail, cs)
            except RefECError as e:
                with pytest.raises(ECError) as ei:
                    port.decode(want, avail, cs)
                assert ei.value.errno == e.errno, lost
                continue
        got = port.decode(want, avail, cs)
        decoded += 1
        for i in range(n):
            assert np.array_equal(got[i], enc[i]), (lost, i)
            if not clay:
                assert np.array_equal(got[i], ref_out[i]), (lost, i)
    assert decoded >= n


@pytest.mark.parametrize("key", sorted(CORPUS), ids=lambda s: s[:60])
def test_minimum_to_decode_equal(key):
    entry = CORPUS[key]
    ref, port = _pair(entry, False)
    n = port.get_chunk_count()
    for lost in _erasure_sets(n, 2):
        avail = set(range(n)) - set(lost)
        for want in ({lost[0]}, set(lost), set(range(n))):
            try:
                expect = ref.minimum_to_decode(want, avail)
            except RefECError as e:
                with pytest.raises(ECError) as ei:
                    port.minimum_to_decode(want, avail)
                assert ei.value.errno == e.errno
                continue
            assert port.minimum_to_decode(want, avail) == expect, (want, avail)


# -- models/ ----------------------------------------------------------------

KM = [(k, m) for k in (1, 2, 3, 4, 6, 8, 10, 12) for m in (1, 2, 3, 4)]


@pytest.mark.parametrize("name", ["jerasure_rs_vandermonde_matrix", "cauchy_original_matrix",
                                  "cauchy_good_matrix", "isa_rs_vandermonde_matrix",
                                  "isa_cauchy_matrix"])
def test_matrix_constructions_equal(name):
    for k, m in KM:
        got, want = getattr(mx, name)(k, m), getattr(ref_mx, name)(k, m)
        assert got.dtype == want.dtype and np.array_equal(got, want), (name, k, m)


def test_r6_and_big_vandermonde_equal():
    for k in range(1, 13):
        assert np.array_equal(mx.jerasure_rs_r6_matrix(k), ref_mx.jerasure_rs_r6_matrix(k))
    for rows, cols in ((3, 2), (8, 5), (14, 10), (20, 12)):
        assert np.array_equal(mx._big_vandermonde_distribution_matrix(rows, cols),
                              ref_mx._big_vandermonde_distribution_matrix(rows, cols))


def test_shec_constructions_equal():
    for k in range(1, 13):
        for m in range(1, min(k, 20 - k) + 1):
            for c in range(1, m + 1):
                for single in (False, True):
                    assert np.array_equal(mx.shec_coding_matrix(k, m, c, single),
                                          ref_mx.shec_coding_matrix(k, m, c, single))
                for m1, c1 in ((0, 0), (1, 1), (m // 2, c // 2)):
                    assert mx.shec_recovery_efficiency(k, m1, m - m1, c1, c - c1) == \
                        ref_mx.shec_recovery_efficiency(k, m1, m - m1, c1, c - c1)
    for c in range(256):
        assert mx._bitmatrix_ones(c) == ref_mx._bitmatrix_ones(c)


@pytest.mark.parametrize("name,args", [
    ("liberation_bitmatrix", [(k, w) for w in (3, 5, 7, 11) for k in range(1, w + 1)]),
    ("blaum_roth_bitmatrix", [(k, w) for w in (4, 6, 7, 10) for k in range(1, w + 1)]),
    ("liber8tion_bitmatrix", [(k,) for k in range(1, 9)]),
])
def test_bitmatrices_equal(name, args):
    for a in args:
        assert np.array_equal(getattr(bm, name)(*a), getattr(ref_bm, name)(*a)), (name, a)
    with pytest.raises(ValueError):
        getattr(bm, name)(*(99,) * len(args[0]))


def test_gf_pow_equal():
    from ceph_tpu.ops import gf256 as ref_gf

    a = np.arange(256, dtype=np.uint8)
    for n in (0, 1, 2, 3, 7, 254, 255, 256, 1000):
        assert np.array_equal(gf256.gf_pow(a, n), ref_gf.gf_pow(a, n)), n


# -- profile errors -----------------------------------------------------------

ERRORS = [
    ("jerasure", {"k": "2", "m": "1", "mapping": "DD"}),
    ("jerasure", {"technique": "reed_sol_r6_op", "k": "4", "m": "3"}),
    ("jerasure", {"technique": "no_such_thing"}),
    ("jerasure", {"technique": "reed_sol_van", "w": "16"}),
    ("jerasure", {"technique": "cauchy_good", "packetsize": "6"}),
    ("jerasure", {"k": "2", "m": "2", "w": "6", "technique": "liberation"}),
    ("jerasure", {"k": "6", "m": "2", "w": "5", "technique": "liberation"}),
    ("jerasure", {"k": "3", "m": "3", "w": "7", "technique": "liberation"}),
    ("jerasure", {"k": "2", "m": "2", "w": "7", "technique": "liber8tion"}),
    ("jerasure", {"k": "2", "m": "2", "w": "8", "technique": "blaum_roth"}),
    ("isa", {"technique": "reed_sol_van", "k": "4", "m": "5"}),
    ("isa", {"technique": "reed_sol_van", "k": "22", "m": "4"}),
    ("isa", {"technique": "reed_sol_van", "k": "33", "m": "2"}),
    ("isa", {"technique": "nope"}),
    ("isa", {"k": "1", "m": "1"}),
    ("shec", {"k": "4", "m": "3"}),
    ("shec", {"k": "4", "m": "3", "c": "4"}),
    ("shec", {"k": "13", "m": "3", "c": "2"}),
    ("shec", {"k": "4", "m": "5", "c": "2"}),
    ("shec", {"technique": "triple"}),
    ("shec", {"k": "4", "m": "3", "c": "2", "w": "16"}),
    ("lrc", {"k": "4", "m": "2"}),
    ("lrc", {"k": "4", "m": "2", "l": "4"}),
    ("lrc", {"mapping": "DD_", "layers": "not json"}),
    ("lrc", {"mapping": "DD_", "layers": '[["DDc", ""], ["DDDc", ""]]'}),
    ("lrc", {"k": "4", "m": "2", "l": "3", "mapping": "DD"}),
    ("clay", {"k": "4", "m": "2", "d": "6"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "shec"}),
    ("clay", {"k": "4", "m": "2", "scalar_mds": "isa", "technique": "cauchy_good"}),
]


@pytest.mark.parametrize("plugin,profile", ERRORS,
                         ids=[f"{p}-{i}" for i, (p, _) in enumerate(ERRORS)])
def test_profile_errors_same_errno(plugin, profile):
    with pytest.raises(RefECError) as want:
        ref_registry.factory(plugin, dict(profile))
    with pytest.raises(ECError) as got:
        registry.factory(plugin, dict(profile), device="cpu")
    assert got.value.errno == want.value.errno


@pytest.mark.parametrize("plugin,profile", [
    ("isa", {}), ("jerasure", {}), ("jerasure", {"technique": "cauchy_orig"}),
    ("shec", {}), ("lrc", {"k": "4", "m": "2", "l": "3"}), ("clay", {}),
    ("clay", {"scalar_mds": "isa", "technique": "cauchy"}),
])
def test_defaults_and_geometry_equal(plugin, profile):
    """Defaults backfilled into the profile, chunk sizes, alignment and
    the chunk mapping, as the reference has them."""
    ref = ref_registry.factory(plugin, dict(profile))
    port = registry.factory(plugin, dict(profile), device="cpu")
    assert port.get_profile() == ref.get_profile()
    assert port.get_chunk_mapping() == ref.get_chunk_mapping()
    assert port.get_sub_chunk_count() == ref.get_sub_chunk_count()
    for size in (1, 4095, 65536, 1 << 20):
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)


def test_clay_scalar_mds_cuda_stands_for_jax():
    """``scalar_mds=cuda`` builds the inner codes the reference builds
    with ``scalar_mds=jax``: the same chunk bytes."""
    prof = {"k": "4", "m": "2", "d": "5"}
    port = registry.factory("clay", dict(prof, scalar_mds="cuda"), device="cpu")
    ref = ref_registry.factory("clay", dict(prof, scalar_mds="jax"))
    assert type(port.mds).__name__ == "ErasureCodeCuda"
    payload = PAYLOADS["rand8192"]
    got, want = port.encode(set(range(6)), payload), ref.encode(set(range(6)), payload)
    assert all(np.array_equal(got[i], want[i]) for i in range(6))


def test_lrc_create_rule_equal():
    from ceph_tpu.crush import builder as ref_builder
    from ceph_tpu.crush.types import CrushMap as RefMap
    from ceph_tpu_torch.crush import builder
    from ceph_tpu_torch.crush.types import CrushMap

    prof = {"k": "4", "m": "2", "l": "3", "crush-locality": "host",
            "crush-failure-domain": "osd"}
    ref_map, port_map = RefMap(), CrushMap()
    ref_builder.build_hierarchy(ref_map, osds_per_host=3, n_hosts=4)
    builder.build_hierarchy(port_map, osds_per_host=3, n_hosts=4)
    ref = ref_registry.factory("lrc", dict(prof))
    port = registry.factory("lrc", dict(prof), device="cpu")
    rid = port.create_rule("lrcrule", port_map)
    assert rid == ref.create_rule("lrcrule", ref_map)
    got, want = port_map.rules[rid], ref_map.rules[rid]
    assert [(int(s.op), s.arg1, s.arg2) for s in got.steps] == \
        [(int(s.op), s.arg1, s.arg2) for s in want.steps]
    with pytest.raises(ECError) as ei:
        port.create_rule("lrcrule", port_map)
    assert ei.value.errno == errno.EEXIST

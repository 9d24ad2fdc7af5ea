"""The port's ``cuda`` EC plugin and registry against ceph_tpu's ``jax``.

Both sides are built from the same profile (``plugin=jax`` becomes
``plugin=cuda``) and fed the same numpy payloads; chunk bytes must be
equal (tolerance 0).  ``device="cpu"`` runs the port on the CPU; with
``device-min-bytes=0`` every encode/decode takes the torch path.
"""

import errno
import hashlib
import json
import os

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu_torch.ec import ECError, ErasureCodePluginRegistry
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.plugins.cuda import ErasureCodeCuda
from tests.xla_private import _private_xla_compiles  # noqa: F401

PROFILES = [
    {"k": "8", "m": "3", "technique": "cauchy"},
    {"k": "4", "m": "2", "technique": "reed_sol_van"},
]
GOLDEN = os.path.join(os.path.dirname(__file__), "golden", "ec_kats.json")


def _pair(profile: dict, min_bytes: str | None):
    prof = dict(profile)
    if min_bytes is not None:
        prof["device-min-bytes"] = min_bytes
    return (ref_registry.factory("jax", dict(prof)),
            registry.factory("cuda", dict(prof), device="cpu"))


@pytest.mark.parametrize("min_bytes", [None, "0"])
@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: p["technique"])
def test_encode_decode_equal(profile, min_bytes):
    ref, port = _pair(profile, min_bytes)
    assert isinstance(port, ErasureCodeCuda)
    assert port.get_profile() == ref.get_profile()
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    assert (n, k) == (ref.get_chunk_count(), ref.get_data_chunk_count())
    rng = np.random.default_rng(11)
    for size in (1, 4095, k * 512, 3 * k * 4096 + 17):
        payload = rng.integers(0, 256, size, dtype=np.uint8).tobytes()
        assert port.get_chunk_size(size) == ref.get_chunk_size(size)
        want = ref.encode(set(range(n)), payload)
        got = port.encode(set(range(n)), payload)
        assert set(got) == set(want)
        for i in want:
            assert np.array_equal(got[i], want[i]), (size, i)
        for lost in [(0,), (1, n - 1), tuple(range(n - k))]:
            avail = {i: c for i, c in want.items() if i not in lost}
            d_ref = ref.decode(set(range(n)), avail)
            d_port = port.decode(set(range(n)), avail)
            for i in range(n):
                assert np.array_equal(d_port[i], d_ref[i]), (size, lost, i)
                assert np.array_equal(d_port[i], want[i]), (size, lost, i)
            assert np.array_equal(port.decode_concat(avail), ref.decode_concat(avail))


@pytest.mark.parametrize("profile", PROFILES, ids=lambda p: p["technique"])
def test_minimum_to_decode_equal(profile):
    ref, port = _pair(profile, None)
    n = port.get_chunk_count()
    for want, avail in [({0}, set(range(n))), ({0, 1}, set(range(1, n))),
                        ({n - 1}, set(range(n - 1)))]:
        assert port.minimum_to_decode(want, avail) == ref.minimum_to_decode(want, avail)
    with pytest.raises(ECError) as ei:
        port.minimum_to_decode({0}, {1})
    assert ei.value.errno == errno.EIO


def test_torch_path_taken_with_min_bytes_zero(monkeypatch):
    """device-min-bytes=0 sends every matmul through _apply_device (the
    torch path), with no host fallback around it."""
    _, port = _pair(PROFILES[0], "0")
    calls = []
    orig = port._apply_device

    def spy(M, rows):
        calls.append(rows.shape)
        return orig(M, rows)

    monkeypatch.setattr(port, "_apply_device", spy)
    port.encode(set(range(11)), bytes(8 * 512))
    assert calls == [(8, 512)]

    def boom(M, rows):
        raise RuntimeError("device failed")

    monkeypatch.setattr(port, "_apply_device", boom)
    with pytest.raises(RuntimeError):
        port.encode(set(range(11)), bytes(8 * 512))


def _golden_payloads() -> dict[str, bytes]:
    # mirrors tests/test_ec_golden.py / tools/gen_ec_golden.py
    ramp = bytes(range(256)) * 17 + b"\x00\x01\x02"
    rnd = np.random.default_rng(0xCEF).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    return {"ramp4355": ramp, "rand8192": rnd}


def _jax_kats():
    with open(GOLDEN) as f:
        corpus = json.load(f)
    return {key: e for key, e in corpus.items() if e["plugin"] == "jax"}


@pytest.mark.parametrize("min_bytes", [None, "0"])
@pytest.mark.parametrize("key", sorted(_jax_kats()))
def test_pinned_jax_kats(key, min_bytes):
    entry = _jax_kats()[key]
    prof = dict(entry["profile"])
    if min_bytes is not None:
        prof["device-min-bytes"] = min_bytes
    ec = registry.factory("cuda", prof, device="cpu")
    n = ec.get_chunk_count()
    for pname, payload in _golden_payloads().items():
        want = entry["chunks"][pname]
        enc = ec.encode(set(range(n)), payload)
        assert set(map(str, enc)) == set(want), (key, pname)
        for i, chunk in enc.items():
            w = want[str(i)]
            raw = chunk.tobytes()
            assert len(raw) == w["len"], (key, pname, i)
            assert raw[:32].hex() == w["head"], (key, pname, i)
            assert hashlib.sha256(raw).hexdigest() == w["sha256"], (key, pname, i)


def test_jax_kats_present():
    assert len(_jax_kats()) >= 2


class TestRegistry:
    def test_unknown_plugin_eio(self):
        with pytest.raises(ECError) as ei:
            ErasureCodePluginRegistry().factory("no_such_plugin", {}, device="cpu")
        assert ei.value.errno == errno.EIO

    def test_version_mismatch_exdev(self):
        with pytest.raises(ECError) as ei:
            ErasureCodePluginRegistry().factory(
                "missing_version", {}, directory="tests.ec_fail_plugins")
        assert ei.value.errno == errno.EXDEV

    def test_missing_entry_point_enoent(self):
        with pytest.raises(ECError) as ei:
            ErasureCodePluginRegistry().factory(
                "missing_entry_point", {}, directory="tests.ec_fail_plugins")
        assert ei.value.errno == errno.ENOENT

    def test_bad_technique_and_km(self):
        with pytest.raises(ECError) as ei:
            registry.factory("cuda", {"technique": "liber8tion"}, device="cpu")
        assert ei.value.errno == errno.ENOENT
        with pytest.raises(ECError) as ei:
            registry.factory("cuda", {"k": "200", "m": "57"}, device="cpu")
        assert ei.value.errno == errno.EINVAL

    def test_defaults_and_device(self):
        prof = {}
        ec = registry.factory("cuda", prof, device="cpu")
        assert (ec.get_data_chunk_count(), ec.get_coding_chunk_count()) == (8, 3)
        assert prof["technique"] == "cauchy"
        assert ec.device.type == "cpu"
        assert ec.get_alignment() == 512
        assert ec.get_chunk_size(4096 * 8) == 4096


class TestCreateRule:
    """``create_rule`` builds the same CRUSH rule as the reference on an
    equal map, step for step (the port's indep rule with Ceph's
    ``set_choose_tries 100`` besides), with the same errno mapping."""

    @staticmethod
    def _maps():
        from ceph_tpu.crush import builder as rb
        from ceph_tpu.crush.types import CrushMap as RCrushMap
        from ceph_tpu_torch.crush import builder as pb
        from ceph_tpu_torch.crush.types import CrushMap

        m, r = CrushMap(), RCrushMap()
        pb.build_hierarchy(m, osds_per_host=4, n_hosts=8)
        rb.build_hierarchy(r, osds_per_host=4, n_hosts=8)
        return m, r

    @staticmethod
    def _steps(rule):
        return (rule.rule_type, rule.device_class,
                [(int(s.op), s.arg1, s.arg2) for s in rule.steps])

    @pytest.mark.parametrize("extra", [
        {"crush-failure-domain": "host"},
        {"crush-failure-domain": "host", "crush-osds-per-failure-domain": "2",
         "crush-num-failure-domains": "3"},
        {"crush-failure-domain": "osd", "crush-device-class": "hdd"},
    ], ids=["indep host", "msr 3x2", "osd hdd"])
    def test_rule_equals_reference(self, extra):
        m, r = self._maps()
        prof = {"k": "4", "m": "2", "technique": "reed_sol_van", **extra}
        ref = ref_registry.factory("jax", dict(prof))
        port = registry.factory("cuda", dict(prof), device="cpu")
        rid = port.create_rule("ecpool", m)
        assert rid == ref.create_rule("ecpool", r)
        want = self._steps(r.rules[rid])
        if "crush-osds-per-failure-domain" not in extra:
            # the port's indep rule also sets Ceph's retry budget,
            # set_choose_tries 100 (CrushWrapper::add_simple_rule_at),
            # which the reference's omits
            from ceph_tpu_torch.crush.types import RuleOp

            want[2].insert(1, (int(RuleOp.SET_CHOOSE_TRIES), 100, 0))
        assert self._steps(m.rules[rid]) == want
        assert m.rule_names == r.rule_names == {"ecpool": rid}

    def test_indep_rule_leaves_no_hole_where_the_reference_does(self):
        """RS(8,3) over 12 hosts with one out: 11 positions on the 11 hosts
        left.  With the map's 50 tries the reference's rule leaves a
        ``NONE`` for 31 of 2,000 seeds (a PG degraded for good); the
        port's, with Ceph's ``set_choose_tries 100``, for none."""
        from ceph_tpu.crush import builder as rb
        from ceph_tpu.crush import mapper as rmapper
        from ceph_tpu.crush.types import CrushMap as RCrushMap
        from ceph_tpu_torch.crush import builder as pb
        from ceph_tpu_torch.crush import mapper as pmapper
        from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, CrushMap

        m, r = CrushMap(), RCrushMap()
        pb.build_hierarchy(m, osds_per_host=1, n_hosts=12)
        rb.build_hierarchy(r, osds_per_host=1, n_hosts=12)
        prof = {"k": "8", "m": "3"}
        pid = registry.factory("cuda", dict(prof), device="cpu").create_rule("ec", m)
        rid = ref_registry.factory("jerasure", dict(prof)).create_rule("ec", r)
        weights = [0x10000] * 12
        weights[5] = 0
        holes = {"port": 0, "ref": 0}
        for x in range(2000):
            port = pmapper.crush_do_rule(m, pid, x, 11, weights)
            ref = rmapper.crush_do_rule(r, rid, x, 11, weights)
            holes["port"] += CRUSH_ITEM_NONE in port
            holes["ref"] += CRUSH_ITEM_NONE in ref
            if CRUSH_ITEM_NONE not in ref:
                assert port == ref, x  # a retry past 50 changes nothing else
        assert holes == {"port": 0, "ref": 31}

    def test_errors_match_reference(self):
        m, r = self._maps()
        for prof, code in (({"crush-root": "nowhere"}, errno.ENOENT),
                           ({"crush-failure-domain": "planet"}, errno.ENOENT)):
            port = registry.factory("cuda", dict(prof), device="cpu")
            ref = ref_registry.factory("jax", dict(prof))
            for ec, crush in ((port, m), (ref, r)):
                with pytest.raises(Exception) as ei:
                    ec.create_rule("bad", crush)
                assert ei.value.errno == code
        port = registry.factory("cuda", {}, device="cpu")
        port.create_rule("twice", m)
        with pytest.raises(ECError) as ei:
            port.create_rule("twice", m)
        assert ei.value.errno == errno.EEXIST

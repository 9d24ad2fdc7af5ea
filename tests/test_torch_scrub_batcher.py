"""The port's ScrubVerifier on the CPU: the counterparts of
tests/test_scrub_batcher.py that run without a card.

Batched per-shard crc32c equals the native host loop (bucket padding
and lanes wider than the 64 KiB tile cap included); the re-encode
compare flags exactly the parity shards a host re-encode with
``gf_matmul`` flags; concurrent objects coalesce into fixed-shape
launches; after prewarm no launch is cold; and where the reference
answered a failed launch from the host, the port raises it to the
caller.  The same payloads through the reference ScrubVerifier give the
same results.  Every comparison is exact.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu.parallel.scrub_batcher import ScrubVerifier as RefVerifier
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.native import crc32c
from ceph_tpu_torch.ops.gf256 import gf_matmul
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.parallel.scrub_batcher import ObjectCheck, ScrubVerifier
from tests.xla_private import _private_xla_compiles  # noqa: F401


def _ec(k=3, m=2):
    return registry.factory("cuda", {"k": str(k), "m": str(m)}, device="cpu")


def _encoded_object(ec, seed, nbytes):
    k = ec.get_data_chunk_count()
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(nbytes) * k)
    rng = np.random.default_rng(seed)
    data = rng.integers(
        0, 256, sinfo.logical_to_next_stripe_offset(nbytes), dtype=np.uint8)
    return ecutil.encode(sinfo, ec, data)


def _host_parity_bad(ec, shards):
    """The oracle: re-encode the data shards with gf_matmul and compare
    with the stored parity shards."""
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    data = np.stack([np.asarray(shards[ec.chunk_index(c)]) for c in range(k)])
    expect = gf_matmul(ec.coding_matrix, data)
    return {
        ec.chunk_index(k + j) for j in range(n - k)
        if not np.array_equal(expect[j], np.asarray(shards[ec.chunk_index(k + j)]))
    }


def _ver(**kw):
    kw.setdefault("window_s", 0.002)
    return ScrubVerifier(device="cpu", **kw)


def _verify(ver, ec, objs):
    async def go():
        return await asyncio.gather(*(ver.verify_object(ec, o) for o in objs))

    return asyncio.run(go())


def test_bucket_ladder():
    assert ecutil.bucket_lanes(0, min_bucket=4096, tile_cap=65536) == []
    assert ecutil.bucket_lanes(100, min_bucket=4096, tile_cap=65536) == [(0, 100, 4096)]
    assert ecutil.bucket_lanes(4097, min_bucket=4096, tile_cap=65536) == [(0, 4097, 8192)]
    assert ecutil.bucket_lanes(65536, min_bucket=4096, tile_cap=65536) == [
        (0, 65536, 65536)]
    assert ecutil.bucket_lanes(150000, min_bucket=4096, tile_cap=65536) == [
        (0, 65536, 65536), (65536, 65536, 65536), (131072, 18928, 65536)]


@pytest.mark.parametrize("nbytes", [5000, 40000, 200000])
def test_crcs_match_host_loop(nbytes):
    """Below, at and above the column-lane tile cap."""
    ec = _ec()
    shards = _encoded_object(ec, 1, nbytes)
    (check,) = _verify(_ver(), ec, [shards])
    assert isinstance(check, ObjectCheck)
    assert set(check.crcs) == set(shards)
    for s, p in shards.items():
        assert check.crcs[s] == crc32c(p), s
    assert check.parity_bad == frozenset()


def test_bytes_payloads():
    ec = _ec()
    shards = {s: c.tobytes() for s, c in _encoded_object(ec, 2, 12345).items()}
    (check,) = _verify(_ver(), ec, [shards])
    for s, p in shards.items():
        assert check.crcs[s] == crc32c(p)
    assert check.parity_bad == frozenset()


@pytest.mark.parametrize("victim", [0, 3, 4])
def test_parity_mask_matches_host_reencode(victim):
    """A corrupt data shard breaks every parity equation it feeds; a
    corrupt parity shard breaks only its own; the crc still names the
    rotted shard."""
    ec = _ec()
    shards = _encoded_object(ec, 3, 30000)
    clean = {s: crc32c(p) for s, p in shards.items()}
    shards[victim] = shards[victim].copy()
    shards[victim][7] ^= 0xA5
    (check,) = _verify(_ver(), ec, [shards])
    assert check.parity_bad == frozenset(_host_parity_bad(ec, shards))
    assert check.parity_bad
    if victim >= ec.get_data_chunk_count():
        assert check.parity_bad == {victim}
    assert {s for s in shards if check.crcs[s] != clean[s]} == {victim}


def test_partial_object_skips_parity_not_crc():
    ec = _ec()
    shards = _encoded_object(ec, 4, 20000)
    del shards[2]
    (check,) = _verify(_ver(), ec, [shards])
    assert check.parity_bad is None
    for s, p in shards.items():
        assert check.crcs[s] == crc32c(p)


def test_no_ec_impl_still_crcs():
    shards = {0: np.arange(1000, dtype=np.uint8) % 251}
    (check,) = _verify(_ver(), None, [shards])
    assert check.parity_bad is None
    assert check.crcs[0] == crc32c(shards[0])


def test_empty_payload():
    (check,) = _verify(_ver(), None, [{0: b"", 1: b"x"}])
    assert check.crcs[0] == crc32c(b"")
    assert check.crcs[1] == crc32c(b"x")


def test_objects_share_launches_across_callers():
    """Six objects of one profile: one compare launch; their 30 shard
    lanes one 32-lane crc launch."""
    ec = _ec()
    objs = [_encoded_object(ec, 10 + i, 32768) for i in range(6)]
    ver = _ver(window_s=0.005)
    for o, ch in zip(objs, _verify(ver, ec, objs)):
        for s, p in o.items():
            assert ch.crcs[s] == crc32c(p)
        assert ch.parity_bad == frozenset()
    assert ver.stats["objects"] == 6
    assert ver.stats["enc_launches"] == 1, dict(ver.stats)
    assert ver.stats["crc_launches"] == 1, dict(ver.stats)
    assert ver.stats["batched_lanes"] == 30 + 6
    eff = ver.metrics.efficiency()
    assert 0 < eff["lane_occupancy"] <= 1
    assert 0 < eff["byte_occupancy"] <= 1
    assert any(k.startswith("launches_") for k in ver.metrics.dump())


def test_cross_profile_groups_split():
    """Different profiles share crc launches but never a compare."""
    ec_a, ec_b = _ec(3, 2), _ec(4, 2)
    objs_a = [_encoded_object(ec_a, 20 + i, 16384) for i in range(2)]
    objs_b = [_encoded_object(ec_b, 30 + i, 28000) for i in range(2)]
    ver = _ver(window_s=0.005)

    async def go():
        return await asyncio.gather(
            *(ver.verify_object(ec_a, o) for o in objs_a),
            *(ver.verify_object(ec_b, o) for o in objs_b))

    checks = asyncio.run(go())
    assert all(c.parity_bad == frozenset() for c in checks)
    assert ver.stats["enc_launches"] == 2, dict(ver.stats)
    assert ver.stats["crc_launches"] == 1, dict(ver.stats)


def test_prewarm_then_zero_cold_launches():
    ec = _ec()
    ver = _ver()
    n = ver.prewarm(ec)
    # 5 buckets x 2 batches, for the crc and the compare
    assert n == 20 and ver.stats["prewarmed_shapes"] == 20
    assert ver.stats["cold_launches"] == 0
    assert ver.prewarm(ec) == 0
    objs = [_encoded_object(ec, 40 + i, sz)
            for i, sz in enumerate([5000, 40000, 40000, 300000])]
    for o, ch in zip(objs, _verify(ver, ec, objs)):
        for s, p in o.items():
            assert ch.crcs[s] == crc32c(p)
    assert ver.stats["launches"] >= 2
    assert ver.stats["cold_launches"] == 0, dict(ver.stats)


def test_cold_launch_counted_without_warmup():
    ver = _ver(window_s=0.001)
    _verify(ver, None, [{0: np.zeros(100, np.uint8)}])
    assert ver.stats["cold_launches"] == 1, dict(ver.stats)


def test_launch_spans_recorded():
    from ceph_tpu_torch.common.tracing import device_tracer

    ec = _ec()
    before = {k: len(device_tracer().find(kind=k)) for k in ("scrub_crc", "scrub_enc")}
    _verify(_ver(), ec, [_encoded_object(ec, 60, 8192)])
    for k in before:
        spans = device_tracer().find(kind=k)
        assert len(spans) == before[k] + 1
        assert spans[-1].name == "cuda_launch" and spans[-1].duration is not None


@pytest.mark.parametrize("broken", ["_run_crc_group", "_run_enc_group"])
def test_failed_launch_raises_to_the_caller(monkeypatch, broken):
    """No host answer: a launch that raises reaches verify_object's
    caller (the reference answered from the host instead)."""
    ver = _ver()

    def boom(self, w, g):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(ScrubVerifier, broken, boom)
    ec = _ec()
    objs = [_encoded_object(ec, 50 + i, 150000) for i in range(2)]
    with pytest.raises(RuntimeError, match="launch failed"):
        _verify(ver, ec, objs)
    assert "fallbacks" not in ver.stats and "dispatch_fallbacks" not in ver.stats


@pytest.mark.parametrize("k,m,nbytes", [(3, 2, 5000), (4, 2, 40000), (8, 3, 90000)])
def test_side_by_side_with_reference(k, m, nbytes):
    """The same payloads (clean, a rotted data shard, a rotted parity
    shard, a missing shard) through the reference verifier and the
    port's give equal results."""
    ec, ref_ec = _ec(k, m), ref_registry.factory("jax", {"k": str(k), "m": str(m)})
    clean = _encoded_object(ec, 70, nbytes)
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(nbytes) * k)
    ref_shards = ref_ecutil.encode(
        ref_ecutil.StripeInfo(k, sinfo.stripe_width), ref_ec,
        ecutil.decode_concat(sinfo, ec, clean))
    for s in clean:
        assert np.array_equal(clean[s], ref_shards[s])
    rot_data = dict(clean)
    rot_data[1] = clean[1].copy()
    rot_data[1][3] ^= 0x10
    rot_parity = dict(clean)
    rot_parity[k] = clean[k].copy()
    rot_parity[k][-1] ^= 0x01
    partial = {s: c for s, c in clean.items() if s != 0}
    objs = [clean, rot_data, rot_parity, partial]
    got = _verify(_ver(), ec, objs)
    ref_ver = RefVerifier(window_s=0.002)

    async def go():
        return await asyncio.gather(*(ref_ver.verify_object(ref_ec, o) for o in objs))

    want = asyncio.run(go())
    for g, w in zip(got, want):
        assert w is not None
        assert g.crcs == w.crcs
        assert g.parity_bad == w.parity_bad
    assert got[0].parity_bad == frozenset()
    assert got[2].parity_bad == {k}
    assert got[3].parity_bad is None

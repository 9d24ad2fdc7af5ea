"""The port's DecodeAggregator on the CPU: the counterparts of
tests/test_decode_batcher.py that run without a card.

Batched equals per-object (byte-exact, against the port's and the JAX
package's decode_shards); four objects of one signature take one launch;
mixed signatures take separate launches; after prewarm no launch is
cold; the bucket counters hold; a failed launch reaches every waiter.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator, pow2_bucket
from tests.xla_private import _private_xla_compiles  # noqa: F401


def _ec(k=4, m=2):
    return registry.factory("cuda", {"k": str(k), "m": str(m)}, device="cpu")


def _encoded_object(ec, seed, nbytes):
    sinfo = ecutil.StripeInfo(
        ec.get_data_chunk_count(),
        ec.get_chunk_size(nbytes) * ec.get_data_chunk_count())
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, sinfo.logical_to_next_stripe_offset(nbytes),
                        dtype=np.uint8)
    return sinfo, ecutil.encode(sinfo, ec, data)


def _agg(**kw):
    return DecodeAggregator(device="cpu", window_s=0.005, **kw)


def _rebuild(agg, ec, objs, losses):
    async def go():
        async def one(obj, lost):
            sinfo, shards = obj
            avail = {s: c for s, c in shards.items() if s not in lost}
            return await ecutil.decode_shards_async(
                sinfo, ec, avail, set(lost), aggregator=agg)

        return await asyncio.gather(*(one(o, l) for o, l in zip(objs, losses)))

    return asyncio.run(go())


def test_pow2_bucket():
    assert pow2_bucket(1, 1) == 1
    assert pow2_bucket(5, 1) == 8
    assert pow2_bucket(100, 4096) == 4096
    assert pow2_bucket(4097, 4096) == 8192


@pytest.mark.parametrize("lost", [{0}, {2}, {1, 5}])
def test_batched_equals_per_object(lost):
    ec = _ec()
    ref = ref_registry.factory("jax", {"k": "4", "m": "2"})
    objs = [_encoded_object(ec, i, 40000 + 8192 * i) for i in range(6)]
    agg = _agg()
    outs = _rebuild(agg, ec, objs, [lost] * 6)
    for (sinfo, shards), rebuilt in zip(objs, outs):
        avail = {s: c for s, c in shards.items() if s not in lost}
        port_ref = ecutil.decode_shards(sinfo, ec, avail, set(lost))
        jax_ref = ref_ecutil.decode_shards(
            ref_ecutil.StripeInfo(4, sinfo.stripe_width), ref, avail, set(lost))
        assert set(rebuilt) == set(port_ref) == set(jax_ref) == set(lost)
        for s in lost:
            assert np.array_equal(rebuilt[s], shards[s]), s
            assert np.array_equal(rebuilt[s], port_ref[s]), s
            assert np.array_equal(rebuilt[s], jax_ref[s]), s
    assert agg.stats["requests"] == 6
    assert agg.stats["launches"] <= 2, dict(agg.stats)
    assert agg.stats["fallbacks"] == 0


def test_four_objects_one_launch():
    ec = _ec()
    objs = [_encoded_object(ec, 10 + i, 65536) for i in range(4)]
    agg = _agg()
    outs = _rebuild(agg, ec, objs, [{1}] * 4)
    for (_, shards), rebuilt in zip(objs, outs):
        assert np.array_equal(rebuilt[1], shards[1])
    assert agg.stats["launches"] == 1, dict(agg.stats)
    assert agg.stats["batched_requests"] == 4


def test_mixed_signatures_separate_launches():
    ec = _ec()
    objs = [_encoded_object(ec, 20 + i, 32768) for i in range(4)]
    losses = [{0}, {0}, {3}, {3}]
    agg = _agg()
    outs = _rebuild(agg, ec, objs, losses)
    for (_, shards), lost, rebuilt in zip(objs, losses, outs):
        for s in lost:
            assert np.array_equal(rebuilt[s], shards[s])
    assert agg.stats["launches"] == 2, dict(agg.stats)


def test_wide_payload_splits_into_tile_cap_lanes():
    """A 4 MiB RS(8,3) object: 512 KiB shards split into eight 64 KiB
    lanes, one full batch."""
    ec = _ec(8, 3)
    objs = [_encoded_object(ec, 70, 4 << 20)]
    agg = _agg()
    outs = _rebuild(agg, ec, objs, [{2, 9}])
    for s in (2, 9):
        assert np.array_equal(outs[0][s], objs[0][1][s])
    assert agg.stats["launches"] == 1
    assert agg.metrics.dump()["occupied_lanes_b8_w65536"] == 8


def test_prewarm_then_zero_cold_launches():
    ec = _ec()
    agg = _agg()
    _, shards = _encoded_object(ec, 30, 65536)
    cs = len(next(iter(shards.values())))
    n = agg.prewarm(ec, [cs], erasure_counts=(1,))
    assert n > 0
    assert agg.stats["cold_launches"] == 0
    assert agg.prewarm(ec, [cs], erasure_counts=(1,)) == 0  # already warm
    objs = [_encoded_object(ec, 40 + i, 65536) for i in range(5)]
    outs = _rebuild(agg, ec, objs, [{2}] * 5)
    for (_, sh), out in zip(objs, outs):
        assert np.array_equal(out[2], sh[2])
    assert agg.stats["launches"] >= 1
    assert agg.stats["cold_launches"] == 0, dict(agg.stats)


def test_cold_launch_counted_without_warmup():
    ec = _ec()
    agg = DecodeAggregator(device="cpu", window_s=0.001)
    _rebuild(agg, ec, [_encoded_object(ec, 50, 4096)], [{0}])
    assert agg.stats["cold_launches"] == 1


def test_bucket_counters_report_efficiency():
    ec = _ec()
    agg = _agg()
    objs = [_encoded_object(ec, 60 + i, 32768) for i in range(4)]
    _rebuild(agg, ec, objs, [{1}] * 4)
    eff = agg.metrics.efficiency()
    assert eff["launches"] >= 1
    assert 0 < eff["lane_occupancy"] <= 1
    assert 0 < eff["byte_occupancy"] <= 1
    assert any(k.startswith("launches_") for k in agg.metrics.dump())


def test_launch_span_recorded():
    from ceph_tpu_torch.common.tracing import device_tracer

    ec = _ec()
    agg = _agg()
    before = len(device_tracer().find(kind="decode_batch"))
    _rebuild(agg, ec, [_encoded_object(ec, 80, 8192)], [{0}])
    spans = device_tracer().find(kind="decode_batch")
    assert len(spans) == before + 1
    assert spans[-1].name == "cuda_launch" and spans[-1].duration is not None


def test_failed_launch_reaches_every_waiter(monkeypatch):
    """No host fallback: the launch's exception is raised to each caller."""
    ec = _ec()
    agg = _agg()

    def boom(group):
        raise RuntimeError("launch failed")

    monkeypatch.setattr(agg, "_run_group", boom)
    objs = [_encoded_object(ec, 90 + i, 8192) for i in range(3)]
    with pytest.raises(RuntimeError, match="launch failed"):
        _rebuild(agg, ec, objs, [{0}] * 3)
    assert agg.stats["fallbacks"] == 0

"""Cache tiering end to end (round-3 VERDICT item 7 acceptance):
a replicated cache tier over an EC base pool — writeback, hit/miss
counters, promote-on-read, flush/evict, and the tier agent under
target_max_bytes pressure.  Reference: src/osd/PrimaryLogPG.cc
(TierAgent/HitSet/promote_object), src/mon/OSDMonitor.cc tier verbs,
src/osdc/Objecter.cc read_tier/write_tier redirect.

The port's twin of tests/integration/test_cache_tier.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno

import numpy as np
import pytest

from ceph_tpu_torch.client.rados import ObjectOperation, RadosError
from ceph_tpu_torch.common import get_perf_counters

from tests.test_torch_mini_cluster import Cluster, run


async def _tiered(c, target_max_bytes: int = 0):
    await c.client.ec_profile_set(
        "p", {"plugin": "cuda", "k": "3", "m": "2"})
    await c.client.pool_create(
        "base", pg_num=4, pool_type="erasure", erasure_code_profile="p")
    await c.client.pool_create("hot", pg_num=4, size=3)
    for cmd in (
        {"prefix": "osd tier add", "pool": "base", "tierpool": "hot"},
        {"prefix": "osd tier cache-mode", "pool": "hot",
         "mode": "writeback"},
        {"prefix": "osd tier set-overlay", "pool": "base",
         "tierpool": "hot"},
    ):
        code, rs, _ = await c.client.command(cmd)
        assert code == 0, (cmd, rs)
    if target_max_bytes:
        code, rs, _ = await c.client.command({
            "prefix": "osd pool set", "pool": "hot",
            "var": "target_max_bytes", "val": str(target_max_bytes)})
        assert code == 0, rs
    await c.client._wait_new_map(c.client.osdmap.epoch - 1, timeout=10)
    return c.client.ioctx("base"), c.client.ioctx("hot")


def _tier_counter(c, name: str) -> float:
    return sum(
        get_perf_counters(f"osd.{o.id}").dump().get(name, 0)
        for o in c.osds if o is not None
    )


class TestWritebackTier:
    def test_overlay_routing_and_writeback(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                base_io, hot_io = await _tiered(c)
                payload = np.random.default_rng(1).integers(
                    0, 256, 150_000, dtype=np.uint8).tobytes()
                # a write to the BASE pool lands in the cache pool
                await base_io.write_full("obj", payload)
                assert await base_io.read("obj") == payload
                # the base pool itself has no head object yet
                # (writeback: dirty data lives in the tier) — read it
                # through an un-overlaid view by asking the hot pool
                hits = _tier_counter(c, "tier_hit")
                assert hits > 0
                # flush pushes it to the base; then evict drops it
                op = ObjectOperation().cache_flush()
                await hot_io.operate("obj", op)
                assert _tier_counter(c, "tier_flush") > 0
                await hot_io.operate("obj", ObjectOperation().cache_evict())
                assert _tier_counter(c, "tier_evict") > 0
                # read again: promote-on-miss pulls it back from base
                misses0 = _tier_counter(c, "tier_miss")
                assert await base_io.read("obj") == payload
                assert _tier_counter(c, "tier_miss") > misses0
                assert _tier_counter(c, "tier_promote") > 0

                # evicting a dirty object is refused
                await base_io.write_full("dirty", b"hot data")
                with pytest.raises(RadosError) as ei:
                    await hot_io.operate(
                        "dirty", ObjectOperation().cache_evict())
                assert ei.value.errno == errno.EBUSY
                # flush first, then evict succeeds
                await hot_io.operate("dirty", ObjectOperation().cache_flush())
                await hot_io.operate("dirty", ObjectOperation().cache_evict())
                assert await base_io.read("dirty") == b"hot data"

                # delete propagates through the tier to the base
                await base_io.remove("obj")
                with pytest.raises(RadosError):
                    await base_io.read("obj")
        run(go())

    def test_copy_from(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                base_io, hot_io = await _tiered(c)
                await base_io.write_full("src", b"copy me")
                await hot_io.operate("src", ObjectOperation().cache_flush())
                # copy-from into a different object of the hot pool
                op = ObjectOperation().copy_from(base_io.pool_id, "src")
                await hot_io.operate("dst", op)
                assert await hot_io.read("dst") == b"copy me"
        run(go())

    def test_agent_flush_evict_under_pressure(self):
        async def go():
            # tiny target: the agent must flush + evict to get under it
            async with Cluster(
                n_osds=6,
                osd_conf={"osd_tier_agent_interval": 0.2},
            ) as c:
                base_io, hot_io = await _tiered(
                    c, target_max_bytes=64 * 1024)
                blobs = {
                    f"o{i}": bytes([i]) * 30_000 for i in range(8)
                }   # 240 KB total >> 64 KB target
                for k, v in blobs.items():
                    await base_io.write_full(k, v)
                    await base_io.read(k)   # heat up later objects
                # wait for the agent to act
                for _ in range(60):
                    await asyncio.sleep(0.25)
                    if (_tier_counter(c, "tier_flush") > 0
                            and _tier_counter(c, "tier_evict") > 0):
                        break
                assert _tier_counter(c, "tier_flush") > 0
                assert _tier_counter(c, "tier_evict") > 0
                # every object still reads correctly (from cache or
                # promoted back from base)
                for k, v in blobs.items():
                    assert await base_io.read(k) == v, k
        run(go())

"""EC shard reads must fan out concurrently, not serially.

With ms_inject_delay-style per-send latency on the primary's messenger
(reference option family: src/common/options/global.yaml.in:1242-1267),
a k-shard read costs ~max(shard RTT), not sum — the reference sends
ECSubRead to every shard at once (src/osd/ECCommon.cc:440-445).

The port's twin of tests/integration/test_fanout_latency.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import time

from tests.test_torch_mini_cluster import Cluster, run


DELAY = 0.4


class TestReadFanout:
    def test_degraded_read_latency_is_max_not_sum(self):
        async def go():
            async with Cluster(n_osds=8) as c:
                await c.client.ec_profile_set(
                    "lat", {"plugin": "cuda", "k": "4", "m": "2"}
                )
                pool = await c.client.pool_create(
                    "latp", pg_num=1, pool_type="erasure",
                    erasure_code_profile="lat",
                )
                ioctx = c.client.ioctx("latp")
                payload = bytes(range(256)) * 256  # 64 KiB
                await ioctx.write_full("obj", payload)

                # find the primary for this object's pg and slow down
                # every message it sends
                om = c.client.osdmap
                p = om.get_pg_pool(pool)
                from ceph_tpu_torch.client.rados import object_to_pg

                pg = object_to_pg(p, "obj")
                _, _, _, primary = om.pg_to_up_acting_osds(pg)
                prim = c.osds[primary]
                prim.messenger.inject_delay = DELAY
                try:
                    t0 = time.perf_counter()
                    got = await ioctx.read("obj")
                    elapsed = time.perf_counter() - t0
                finally:
                    prim.messenger.inject_delay = 0.0
                assert got == payload
                # k=4 shards, >=3 remote sub-reads + the client reply all
                # pay DELAY once each leg; a serial fan-out would pay
                # >= 3*DELAY for the reads alone (>= 1.6s total).
                assert elapsed < 3 * DELAY, (
                    f"read took {elapsed:.2f}s with {DELAY}s injected "
                    f"per-send delay: shard fan-out is serialized"
                )

        run(go())

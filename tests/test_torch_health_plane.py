"""PG-stats/health plane: OSD beacons carry per-PG stats, the mon
aggregates them into status/health with real checks, and tests wait on
"all PGs active+clean" via the MON — not by probing OSDs (VERDICT r2
missing #3; reference src/mgr/DaemonServer.cc, src/mon/HealthMonitor.cc,
qa/standalone/ceph-helpers.sh wait_for_clean).

The port's twin of tests/integration/test_health_plane.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

import asyncio
import json

from tests.test_torch_mini_cluster import Cluster, run


class TestHealthPlane:
    def test_wait_clean_and_health_ok(self):
        async def go():
            async with Cluster(n_osds=5) as c:
                await c.client.pool_create("hp", pg_num=8, size=3)
                io = c.client.ioctx("hp")
                for i in range(6):
                    await io.write_full(f"o{i}", b"x" * 2000)
                st = await c.client.wait_clean(timeout=30)
                assert st["health"]["status"] == "HEALTH_OK", st["health"]
                pgs = st["pgs"]
                assert pgs["by_state"] == {"active+clean": pgs["num_pgs"]}
                assert pgs["num_objects"] >= 6
                # the pg stat command exposes per-pg detail
                code, _, data = await c.client.command({"prefix": "pg stat"})
                assert code == 0
                book = json.loads(data)["pg_stats"]
                assert len(book) == pgs["num_pgs"]
                assert all(v["state"] == "active+clean" for v in book.values())

        run(go())

    def test_osd_down_degrades_then_recovers(self):
        async def go():
            async with Cluster(n_osds=5) as c:
                await c.client.pool_create("hp", pg_num=8, size=3)
                io = c.client.ioctx("hp")
                for i in range(4):
                    await io.write_full(f"o{i}", b"y" * 1500)
                await c.client.wait_clean(timeout=30)

                victim = 4
                await c.osds[victim].stop()
                c.osds[victim] = None
                await c.client.command(
                    {"prefix": "osd down", "id": str(victim)})

                # health must flag the down osd and degraded pgs
                async def health():
                    code, _, data = await c.client.command(
                        {"prefix": "health"})
                    assert code == 0
                    return json.loads(data)

                for _ in range(60):
                    h = await health()
                    if ("OSD_DOWN" in h["checks"]
                            and "PG_DEGRADED" in h["checks"]):
                        break
                    await asyncio.sleep(0.2)
                assert h["status"] == "HEALTH_WARN"
                assert "OSD_DOWN" in h["checks"], h
                assert "PG_DEGRADED" in h["checks"], h

                # revive: cluster must go clean again THROUGH the mon view
                from ceph_tpu_torch.osd.daemon import OSDDaemon

                c.osds[victim] = OSDDaemon(victim, c.mon.addr, device="cpu")
                await c.osds[victim].start()
                st = await c.client.wait_clean(timeout=40)
                assert "OSD_DOWN" not in st["health"]["checks"]

        run(go())

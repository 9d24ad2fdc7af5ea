"""End-to-end mgr telemetry: a vstart-style cluster where OSDs stream
MMgrReports, `ceph osd perf` and the mgr's prometheus endpoint show
live per-OSD latency series, and the batched analytics pass runs with
ZERO in-path XLA compiles (prewarm asserted) — the mgr PR's
integration acceptance.

The port's twin of tests/integration/test_mgr_cluster.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import json
import urllib.request

import pytest

from ceph_tpu_torch.client import RadosClient
from ceph_tpu_torch.common import ConfigProxy
from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.mgr.daemon import MgrDaemon
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.osd.daemon import OSDDaemon

N_OSDS = 3


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


def _conf():
    return ConfigProxy({
        "mgr_beacon_interval": 0.1,
        "mgr_report_interval": 0.2,
        "mgr_digest_interval": 0.2,
        "mgr_module_tick_interval": 0.1,
        "mon_mgr_beacon_grace": 2.0,
    })


class MgrCluster:
    def __init__(self, n_osds: int = N_OSDS):
        crush = CrushMap()
        B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
        self.mon = Monitor(crush=crush, conf=_conf(), device="cpu")
        self.mgr: MgrDaemon | None = None
        self.osds: list[OSDDaemon] = [None] * n_osds
        self.client = RadosClient(client_id=5151)

    async def __aenter__(self):
        await self.mon.start()
        self.mgr = MgrDaemon("x", [self.mon.addr], conf=_conf(), device="cpu")
        await self.mgr.start()
        for i in range(len(self.osds)):
            self.osds[i] = OSDDaemon(i, self.mon.addr, conf=_conf(), device="cpu")
            await self.osds[i].start()
        await self.client.connect(*self.mon.addr)
        return self

    async def __aexit__(self, *exc):
        await self.client.shutdown()
        for osd in self.osds:
            if osd is not None:
                await osd.stop()
        await self.mgr.stop()
        await self.mon.stop()

    async def wait_warm(self):
        for _ in range(600):
            if (self.mgr._warm_task is None
                    or self.mgr._warm_task.done()) and all(
                    not o._warm_tasks for o in self.osds if o):
                return
            await asyncio.sleep(0.05)


async def _http_get(host: str, port: int, path: str) -> bytes:
    return await asyncio.get_running_loop().run_in_executor(
        None,
        lambda: urllib.request.urlopen(
            f"http://{host}:{port}{path}", timeout=5).read(),
    )


class TestMgrEndToEnd:
    def test_reports_osd_perf_prometheus_zero_cold(self):
        async def go():
            async with MgrCluster() as c:
                await c.wait_warm()
                await c.client.pool_create("rbd", pg_num=8, size=2)
                io = c.client.ioctx("rbd")

                cold0 = int(c.mgr.engine.stats.get("cold_launches", 0))
                assert cold0 == 0
                assert int(c.mgr.engine.stats.get(
                    "prewarmed_shapes", 0)) == 1

                async def traffic():
                    for r in range(60):
                        for i in range(6):
                            await io.write_full(
                                f"obj{i}", b"m" * 4096 * (i + 1))
                            await io.read(f"obj{i}")
                        await asyncio.sleep(0.1)

                t = asyncio.ensure_future(traffic())
                try:
                    # every OSD registers and reports land
                    deadline = asyncio.get_running_loop().time() + 40
                    while True:
                        sess = c.mgr.sessions
                        if all(
                            sess.get(f"osd.{i}", {}).get("reports", 0)
                            >= 3 for i in range(N_OSDS)
                        ):
                            break
                        assert asyncio.get_running_loop().time() \
                            < deadline, sorted(sess)
                        await asyncio.sleep(0.2)

                    # `ceph osd perf` shows per-OSD latency rows fed
                    # from the mgr's time-series store
                    rows = {}
                    while True:
                        _c, _rs, data = await c.client.command(
                            {"prefix": "osd perf"})
                        doc = json.loads(data)
                        rows = {r["id"]: r for r in
                                doc.get("osd_perf_infos", [])}
                        if (len(rows) == N_OSDS and any(
                                r["commit_latency_ms"] > 0
                                for r in rows.values())):
                            break
                        assert asyncio.get_running_loop().time() \
                            < deadline, rows
                        await asyncio.sleep(0.2)
                    assert doc["source_mgr"] == "x"

                    # the prometheus module serves the CLUSTER
                    # exposition: per-OSD latency series + histograms
                    # + analytics percentiles
                    prom = c.mgr.modules["prometheus"]
                    assert prom.running and prom.addr
                    body = (await _http_get(
                        *prom.addr, "/metrics")).decode()
                    assert "ceph_tpu_osd_0_write_lat_us" in body
                    assert "ceph_tpu_osd_1_op " in body or \
                        "ceph_tpu_osd_1_op\n" in body or \
                        "ceph_tpu_osd_1_op" in body
                    assert "_latency_bucket{le=" in body
                    assert "ceph_tpu_cluster_write_lat_us_p50" in body

                    # the analytics ran batched with ZERO in-path
                    # compiles (the prewarm discipline)
                    st = c.mgr.engine.stats
                    assert st.get("launches", 0) >= 2
                    assert st.get("cold_launches", 0) == 0
                    assert st.get("fallbacks", 0) == 0

                    # status carries the mgr line
                    _c, _rs, data = await c.client.command(
                        {"prefix": "status"})
                    mgr_block = json.loads(data)["mgr"]
                    assert mgr_block["active"] == "x"
                    assert mgr_block["available"]
                finally:
                    t.cancel()

        run(go())

    def test_dashboard_serves_mgr_aggregated_metrics(self):
        """/metrics on the mon dashboard serves the mgr's aggregated
        exposition when a mgr is active, and the overview page shows
        the mgr line + slowest-OSD list."""

        async def go():
            from ceph_tpu_torch.mgr.dashboard import Dashboard

            async with MgrCluster() as c:
                await c.wait_warm()
                await c.client.pool_create("rbd", pg_num=4, size=2)
                io = c.client.ioctx("rbd")
                for i in range(8):
                    await io.write_full(f"d{i}", b"z" * 8192)
                dash = Dashboard(c.mon)
                host, port = await dash.start()
                try:
                    # wait until a digest whose rendered prometheus
                    # text carries OSD series reaches the mon (the
                    # first digests may predate the OSD sessions)
                    deadline = asyncio.get_running_loop().time() + 40
                    while "ceph_tpu_osd_0_" not in (
                            (c.mon._mgr_digest or {}).get(
                                "prometheus") or ""):
                        assert asyncio.get_running_loop().time() \
                            < deadline, sorted(c.mgr.sessions)
                        await io.write_full("dd", b"q" * 4096)
                        await asyncio.sleep(0.2)
                    body = (await _http_get(
                        host, port, "/metrics")).decode()
                    # cluster-aggregated (per-daemon series), not just
                    # this process's local collections
                    assert "ceph_tpu_osd_0_" in body
                    page = (await _http_get(host, port, "/")).decode()
                    assert "x(active)" in page
                    assert "slowest osds" in page
                finally:
                    await dash.stop()

        run(go())

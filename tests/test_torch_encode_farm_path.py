"""The encode service in the port's production I/O path.

The port's twin of tests/integration/test_encode_farm_path.py's daemon
cases (:33, :59, :157): client writes to an EC pool flow through the
daemon's EncodeService, which coalesces concurrent ops into one
dispatch; degraded reads route reconstruction the same way.  The
reference's first two cases run on its 8-device CPU mesh and reach the
service through ``osd_ec_encode_farm=auto``; a CPU daemon of the port
attaches the service only when asked (``on``), so these cases set it and
the service runs in single-device mode on the CPU.  Reference seam:
src/osd/ECCommon.cc:749 fan-out / ECUtil.cc:123 per-op encode loop
becoming one batched device computation.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.parallel import encode_service as es
from tests.test_torch_mini_cluster import Cluster, run

FARM_ON = {"osd_ec_encode_farm": "on"}


@pytest.fixture(autouse=True)
def fresh_service():
    es.reset_shared()
    yield
    es.reset_shared()


def _payload(i: int) -> bytes:
    rng = np.random.default_rng(i)
    return rng.integers(0, 256, 96 * 1024 + 512 * i, dtype=np.uint8).tobytes()


def _dispatches(stats: dict) -> int:
    return sum(stats.get(k, 0) for k in ("single_dispatches", "dp_dispatches", "tp_dispatches"))


class TestFarmInWritePath:
    def test_concurrent_writes_coalesce_and_roundtrip(self):
        async def go():
            async with Cluster(n_osds=6, osd_conf=FARM_ON) as c:
                await c.client.ec_profile_set("p", {
                    "plugin": "cuda", "k": "4", "m": "2",
                    "crush-failure-domain": "host"})
                await c.client.pool_create(
                    "ecp", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("ecp")
                svc = es.shared(device="cpu")
                assert svc.active()
                assert all(o.encode_service is svc for o in c.osds)
                await asyncio.gather(*(
                    io.write_full(f"obj-{i}", _payload(i)) for i in range(12)
                ))
                stats = dict(svc.stats)
                assert _dispatches(stats) > 0, f"farm never dispatched: {stats}"
                # coalescing: fewer dispatches than encoded ops
                assert stats["coalesced"] > _dispatches(stats), stats
                for i in range(12):
                    assert await io.read(f"obj-{i}") == _payload(i)

        run(go())

    def test_degraded_read_and_recovery_through_farm(self):
        async def go():
            async with Cluster(n_osds=6, osd_conf=FARM_ON) as c:
                await c.client.ec_profile_set("p", {
                    "plugin": "cuda", "k": "4", "m": "2",
                    "crush-failure-domain": "host"})
                await c.client.pool_create(
                    "ecp", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("ecp")
                data = _payload(99)
                await io.write_full("victim", data)
                svc = es.shared(device="cpu")
                before = dict(svc.stats)

                from ceph_tpu_torch.osd.daemon import object_to_pg
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                pg = object_to_pg(pool, "victim")
                _, _, acting, primary = om.pg_to_up_acting_osds(pg)
                kill = next(o for o in acting if o != primary and o >= 0)
                epoch = om.epoch
                await c.osds[kill].stop()
                c.osds[kill] = None
                code, _, _ = await c.client.command(
                    {"prefix": "osd down", "id": str(kill)})
                assert code == 0
                await c.wait_epoch(epoch + 1)
                # degraded read must reconstruct — and use the farm
                assert await io.read("victim") == data
                after = dict(svc.stats)
                assert _dispatches(after) > _dispatches(before), (before, after)

        run(go())


class TestSingleDeviceCoalescing:
    """Single-device microbatching: with ONE device and no mesh, the
    service still coalesces concurrent per-PG encodes into one dispatch
    per window — requests concatenate along S.  The mode is the same on
    any device; the test drives it with a CPU device."""

    def test_daemon_path_single_device(self):
        async def go():
            svc = es.EncodeService(
                device="cpu", min_bytes=4096, window_s=0.005)

            async with Cluster(
                n_osds=6,
                osd_conf={"osd_ec_encode_farm": "on"},
            ) as c:
                for o in c.osds:
                    o._encode_service = svc
                    o._encode_service_resolved = True
                await c.client.ec_profile_set("p", {
                    "plugin": "cuda", "k": "4", "m": "2",
                    "crush-failure-domain": "host"})
                await c.client.pool_create(
                    "sdp", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("sdp")
                await asyncio.gather(*(
                    io.write_full(f"o{i}", _payload(i)) for i in range(10)
                ))
                stats = dict(svc.stats)
                assert stats.get("single_dispatches", 0) > 0, stats
                # ≪N dispatches for N concurrent encodes
                assert stats["coalesced"] > stats["single_dispatches"], stats
                for i in range(10):
                    assert await io.read(f"o{i}") == _payload(i)

        run(go())

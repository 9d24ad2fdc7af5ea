"""End-to-end mini-cluster of the port: mon + OSDs + client over real TCP.

The port's twin of tests/integration/test_mini_cluster.py: the same
cases over ``ceph_tpu_torch``, every daemon on ``device="cpu"`` (the
kernels' plain versions) and the EC profiles on the ``cuda`` plugin
where the reference's names ``jax``.  :class:`Cluster` is the port's
twin of the reference's harness; the port's other cluster tests import
it from here.  It drops the process-wide encode service and batchers
when a cluster ends, so each cluster starts with its own.

Everything runs in one asyncio loop with real localhost TCP sockets —
the same wire path separate processes would use.
"""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.client import RadosClient
from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.mon import Monitor
from ceph_tpu_torch.osd.daemon import OSDDaemon
from ceph_tpu_torch.osd.types import pg_t
from ceph_tpu_torch.store import coll_t, ghobject_t

N_OSDS = 8


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, 120))
    finally:
        loop.close()


def reset_shared() -> None:
    """Drop the port's three process-wide device services."""
    from ceph_tpu_torch.parallel import decode_batcher, encode_service, scrub_batcher

    encode_service.reset_shared()
    decode_batcher.reset_shared()
    scrub_batcher.reset_shared()


class Cluster:
    """A port mon, ``n_mgrs`` port mgrs, ``n_osds`` port OSDs (one a
    host) and a port client, all on ``device`` (the CPU unless a test
    asks for another)."""

    def __init__(self, n_osds: int = N_OSDS, osd_conf: dict | None = None,
                 store_factory=None, mon_conf: dict | None = None,
                 n_mgrs: int = 0, mgr_conf: dict | None = None,
                 device="cpu"):
        from ceph_tpu_torch.common import ConfigProxy

        self.osd_conf = osd_conf
        self.store_factory = store_factory
        self.mgr_conf = mgr_conf
        self.device = device
        crush = CrushMap()
        # one osd per host: failure domain host == osd for small tests
        B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
        self.mon = Monitor(
            crush=crush,
            conf=ConfigProxy(mon_conf) if mon_conf else None,
            device=device)
        self.osds: list[OSDDaemon] = [None] * n_osds
        self.mgrs: list = [None] * n_mgrs
        self.client = RadosClient(client_id=4242)

    async def __aenter__(self):
        reset_shared()
        await self.mon.start()
        from ceph_tpu_torch.common import ConfigProxy
        from ceph_tpu_torch.mgr.daemon import MgrDaemon

        for i in range(len(self.mgrs)):
            conf = ConfigProxy(self.mgr_conf) if self.mgr_conf else None
            self.mgrs[i] = MgrDaemon(f"mgr{i}", [self.mon.addr], conf=conf,
                                     device=self.device)
            await self.mgrs[i].start()
        for i in range(len(self.osds)):
            conf = ConfigProxy(self.osd_conf) if self.osd_conf else None
            store = self.store_factory(i) if self.store_factory else None
            self.osds[i] = OSDDaemon(i, self.mon.addr, conf=conf, store=store,
                                     device=self.device)
            await self.osds[i].start()
        await self.client.connect(*self.mon.addr)
        return self

    async def __aexit__(self, *exc):
        await self.client.shutdown()
        for osd in self.osds:
            if osd is not None:
                await osd.stop()
        for mgr in self.mgrs:
            if mgr is not None:
                await mgr.stop()
        await self.mon.stop()
        reset_shared()

    async def wait_epoch(self, epoch: int) -> None:
        await self.client._wait_new_map(epoch - 1, timeout=10)
        assert self.client.osdmap.epoch >= epoch


PAYLOADS = {
    "obj-small": b"hello erasure world",
    "obj-exact": bytes(range(256)) * 64,          # 16 KiB
    "obj-odd": b"\xab" * 40961,                   # crosses stripes, odd tail
    "obj-empty": b"",
}


class TestReplicatedPool:
    def test_write_read_stat_remove(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data
                    assert await io.stat(oid) == len(data)
                assert await io.read("obj-exact", off=100, length=16) == (
                    PAYLOADS["obj-exact"][100:116]
                )
                await io.remove("obj-small")
                with pytest.raises(OSError):
                    await io.read("obj-small")

        run(go())

    def test_write_read_on_kstore(self, tmp_path):
        """OSDs on the durable objects-in-kv engine (KStore over FileDB):
        exercises blocking_commit off-loop commits through the daemon."""
        from ceph_tpu_torch.kv import FileDB
        from ceph_tpu_torch.store.kstore import KStore

        def factory(i):
            s = KStore(FileDB(str(tmp_path / f"osd{i}")))
            s.mount()
            return s

        async def go():
            async with Cluster(store_factory=factory) as c:
                await c.client.pool_create("rbd", pg_num=4, size=3)
                io = c.client.ioctx("rbd")
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data

        run(go())


class TestErasureCodedPool:
    async def _make_ec_pool(self, c: Cluster, k=4, m=2, plugin="cuda"):
        await c.client.ec_profile_set(
            "ecprofile", {
                "plugin": plugin, "k": str(k), "m": str(m),
                "crush-failure-domain": "host",
            },
        )
        await c.client.pool_create(
            "ecpool", pg_num=8, pool_type="erasure",
            erasure_code_profile="ecprofile",
        )
        return c.client.ioctx("ecpool")

    def test_ec_round_trip(self):
        async def go():
            async with Cluster() as c:
                io = await self._make_ec_pool(c)
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data
                    assert await io.stat(oid) == len(data)
                # ranged read across a stripe boundary
                got = await io.read("obj-odd", off=16380, length=100)
                assert got == PAYLOADS["obj-odd"][16380:16480]
                await io.remove("obj-exact")
                with pytest.raises(OSError):
                    await io.read("obj-exact")

        run(go())

    def test_shards_live_on_distinct_osds(self):
        async def go():
            async with Cluster() as c:
                io = await self._make_ec_pool(c)
                await io.write_full("placed", b"x" * 20000)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = pool.raw_pg_to_pg(object_to_pg(pool, "placed"))
                _, _, acting, _ = om.pg_to_up_acting_osds(pg, folded=True)
                assert len(set(acting)) == 6  # k+m distinct osds
                for shard, osd in enumerate(acting):
                    store = c.osds[osd].store
                    cl = coll_t(pool.id, pg.ps, shard)
                    assert store.exists(cl, ghobject_t("placed", shard=shard))

        run(go())

    def test_degraded_read_after_osd_down(self):
        async def go():
            async with Cluster() as c:
                io = await self._make_ec_pool(c)
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                # find a shard owner of obj-odd and kill it
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = object_to_pg(pool, "obj-odd")
                _, _, acting, primary = om.pg_to_up_acting_osds(pg)
                victim = next(o for o in acting if o != primary)
                epoch = om.epoch
                await c.osds[victim].stop()
                c.osds[victim] = None
                code, _, _ = await c.client.command(
                    {"prefix": "osd down", "id": str(victim)}
                )
                assert code == 0
                await c.wait_epoch(epoch + 1)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data  # parity reconstruct

        run(go())

    def test_failure_report_marks_peer_down(self):
        """Kill an OSD without telling the mon: the next write's broken
        sub-op connection must produce an MOSDFailure -> new epoch ->
        retried write succeeds (OSD.cc failure-report path)."""

        async def go():
            async with Cluster() as c:
                io = await self._make_ec_pool(c)
                await io.write_full("canary", b"c" * 9000)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = object_to_pg(pool, "canary")
                _, _, acting, primary = om.pg_to_up_acting_osds(pg)
                victim = next(o for o in acting if o != primary)
                await c.osds[victim].stop()
                c.osds[victim] = None
                # no mon command: the write path must detect it
                await io.write_full("canary", b"d" * 9000)
                assert await io.read("canary") == b"d" * 9000
                assert not c.client.osdmap.is_up(victim)

        run(go())

    def test_recovery_rebuilds_lost_shards(self):
        async def go():
            async with Cluster() as c:
                io = await self._make_ec_pool(c)
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = object_to_pg(pool, "obj-odd")
                folded = pool.raw_pg_to_pg(pg)
                _, _, acting0, primary0 = om.pg_to_up_acting_osds(pg)
                victim = next(o for o in acting0 if o != primary0)
                epoch = om.epoch
                await c.osds[victim].stop()
                c.osds[victim] = None
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.client.command({"prefix": "osd out", "id": str(victim)})
                await c.wait_epoch(epoch + 2)
                om2 = c.client.osdmap
                _, _, acting1, _ = om2.pg_to_up_acting_osds(pg)
                assert victim not in acting1
                assert all(o != 0x7FFFFFFF for o in acting1), acting1
                # poll until the replacement member holds the shard
                new_shard, new_osd = next(
                    (s, o) for s, o in enumerate(acting1) if o not in acting0
                )
                store = c.osds[new_osd].store
                cl = coll_t(pool.id, folded.ps, new_shard)
                o = ghobject_t("obj-odd", shard=new_shard)
                for _ in range(100):
                    if store.exists(cl, o):
                        break
                    await asyncio.sleep(0.1)
                assert store.exists(cl, o), "recovery did not rebuild the shard"
                # the rebuilt cluster survives ANOTHER osd loss
                _, _, acting1, primary1 = om2.pg_to_up_acting_osds(pg)
                victim2 = next(
                    o for o in acting1 if o not in (primary1, new_osd)
                )
                epoch = om2.epoch
                await c.osds[victim2].stop()
                c.osds[victim2] = None
                await c.client.command({"prefix": "osd down", "id": str(victim2)})
                await c.wait_epoch(epoch + 1)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data

        run(go())


class TestReplicatedRecovery:
    def test_full_object_push_to_new_member(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("robj", b"r" * 5000)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = object_to_pg(pool, "robj")
                folded = pool.raw_pg_to_pg(pg)
                _, _, acting0, primary0 = om.pg_to_up_acting_osds(pg)
                victim = next(o for o in acting0 if o != primary0)
                epoch = om.epoch
                await c.osds[victim].stop()
                c.osds[victim] = None
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.client.command({"prefix": "osd out", "id": str(victim)})
                await c.wait_epoch(epoch + 2)
                om2 = c.client.osdmap
                _, _, acting1, _ = om2.pg_to_up_acting_osds(pg)
                new_osd = next(o for o in acting1 if o not in acting0)
                store = c.osds[new_osd].store
                cl = coll_t(pool.id, folded.ps, -1)
                for _ in range(100):
                    if store.exists(cl, ghobject_t("robj")):
                        break
                    await asyncio.sleep(0.1)
                assert store.read(cl, ghobject_t("robj")) == b"r" * 5000

        run(go())


class TestFaultInjection:
    def test_ops_survive_injected_socket_failures(self):
        """ms_inject_socket_failures-style chaos: every Nth outgoing
        message tears the connection down; the resend machinery must
        still complete every op (the thrash-suite contract)."""

        async def go():
            async with Cluster(
                n_osds=6, osd_conf={"ms_inject_socket_failures": 60}
            ) as c:
                await c.client.pool_create("rbd", pg_num=4, size=2)
                io = c.client.ioctx("rbd")
                for i in range(12):
                    await io.write_full(f"o{i}", bytes([i]) * 3000)
                for i in range(12):
                    assert await io.read(f"o{i}") == bytes([i]) * 3000

        run(go())


class TestCompressedTransport:
    def test_cluster_io_with_forced_compression(self):
        """Whole-cluster I/O with on-wire compression negotiated on
        every inter-daemon connection (compression_onwire twin)."""
        conf = {"ms_compress_mode": "force", "ms_compress_min_size": 128}

        async def go():
            async with Cluster(n_osds=4, osd_conf=conf) as c:
                await c.client.pool_create("cp", pg_num=4, size=3)
                io = c.client.ioctx("cp")
                for oid, data in PAYLOADS.items():
                    await io.write_full(oid, data)
                for oid, data in PAYLOADS.items():
                    assert await io.read(oid) == data
                # at least one OSD-to-OSD connection actually negotiated
                assert any(
                    conn.compressor is not None
                    for osd in c.osds if osd is not None
                    for conn in osd.messenger._conns.values()
                ), "no inter-daemon connection negotiated compression"

        run(go())

"""Disk-fault tolerance end to end: injected store faults against a
live mini-cluster.

The reference's degraded-path contract (qa/standalone/erasure-code/
test-erasure-eio.sh + PrimaryLogPG read-error repair): a shard EIO is
an ERASURE — the read decodes around it and returns correct data, the
damaged shard is quarantined and rebuilt in the background, replicated
reads fail over to a healthy replica, and repeated medium errors
escalate to marking the OSD down so peering re-places its data.

The port's twin of tests/integration/test_disk_faults.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno

import pytest

from ceph_tpu_torch.common.fault_injector import FAULTS
from ceph_tpu_torch.osd.daemon import object_to_pg
from ceph_tpu_torch.store import coll_t, ghobject_t

from tests.test_torch_mini_cluster import Cluster, run



@pytest.fixture(autouse=True)
def _no_armed_faults():
    """FAULTS is process-wide: leave no point armed for the tests that
    run after these in the same worker."""
    yield
    FAULTS.clear()


def _blockstore_factory(tmp_path):
    from ceph_tpu_torch.store.blockstore import BlockStore

    def factory(i):
        s = BlockStore(str(tmp_path / f"osd{i}"))
        s.mount()
        return s

    return factory


async def _wait_warm(c) -> None:
    """EC-profile prewarm must finish before cold-launch deltas are
    judged (the chaos runner waits the same way)."""
    for _ in range(300):
        if all(not osd._warm_tasks for osd in c.osds if osd):
            return
        await asyncio.sleep(0.05)


def _cold_launches() -> int:
    from ceph_tpu_torch.parallel import decode_batcher, scrub_batcher

    return int(
        decode_batcher.shared("cpu").stats.get("cold_launches", 0)
    ) + int(scrub_batcher.shared("cpu").stats.get("cold_launches", 0))


async def _primary_with_data_shard(c, io, pool_name, k):
    """Write objects until one's acting primary holds a DATA shard
    (shard < k): only then does the primary's own store serve one of
    the k chunks a normal read fetches."""
    om = c.client.osdmap
    pid = om.lookup_pg_pool_name(pool_name)
    pool = om.get_pg_pool(pid)
    for i in range(32):
        oid = f"df-obj{i}"
        pg = object_to_pg(pool, oid)
        _u, _up, acting, primary = om.pg_to_up_acting_osds(pg)
        shard = next(
            (s for s, o in enumerate(acting) if o == primary), None)
        if primary >= 0 and shard is not None and shard < k:
            return oid, pg, acting, primary, shard
    pytest.skip("no object mapped a data shard onto its primary")


class TestECDecodeAround:
    def test_local_shard_eio_decodes_around_and_repairs(self, tmp_path):
        """THE acceptance path: a bit-rotted local shard (checksum EIO
        on read) becomes an erasure — the client read returns correct
        data via decode-around — and the background chain (verify ->
        quarantine -> rebuild) leaves a REPAIRED shard behind, with
        zero in-path XLA compiles."""

        async def go():
            async with Cluster(
                n_osds=5, store_factory=_blockstore_factory(tmp_path)
            ) as c:
                await c.client.ec_profile_set(
                    "dfp", {"plugin": "cuda", "k": "2", "m": "1"})
                await c.client.pool_create(
                    "ecdf", pg_num=4, pool_type="erasure",
                    erasure_code_profile="dfp")
                io = c.client.ioctx("ecdf")
                payload = bytes(range(256)) * 128  # 32 KiB, > inline
                for i in range(32):
                    await io.write_full(f"df-obj{i}", payload)
                oid, pg, acting, primary, shard = (
                    await _primary_with_data_shard(c, io, "ecdf", k=2))
                await _wait_warm(c)
                cold_before = _cold_launches()

                # rot the primary's own shard at rest: its next local
                # read fails the blob crc with EIO
                FAULTS.inject(
                    f"store.read.osd.{primary}", bitflip=True, count=1)
                assert await io.read(oid) == payload  # decode-around
                assert FAULTS.fired(f"store.read.osd.{primary}") == 1

                osd = c.osds[primary]
                pool = c.client.osdmap.get_pg_pool(io.pool_id)
                coll = osd._shard_coll(pool, pg, shard)
                obj = ghobject_t(oid, shard=shard)

                # background repair: the rotten shard is quarantined
                # and rebuilt from the surviving members
                healed = False
                for _ in range(100):
                    await asyncio.sleep(0.1)
                    if not osd.store.exists(coll, obj):
                        continue  # quarantined, rebuild in flight
                    try:
                        osd.store.read(coll, obj)
                        healed = True
                        break
                    except OSError:
                        continue
                assert healed, "rotten shard never repaired"
                assert oid in osd._read_error_ledger
                assert osd.perf.dump().get("ec_eio_decode_around", 0) >= 1
                # repaired shard serves reads again, locally
                assert await io.read(oid) == payload
                assert osd.store.fsck() == []  # rot gone at rest
                assert _cold_launches() == cold_before

        run(go())


class TestReplicatedReadFailover:
    def test_primary_medium_error_fails_over_and_heals(self, tmp_path):
        async def go():
            async with Cluster(
                n_osds=4, store_factory=_blockstore_factory(tmp_path)
            ) as c:
                await c.client.pool_create("repdf", pg_num=8, size=2)
                io = c.client.ioctx("repdf")
                payload = b"replicated-payload!" * 2048  # > inline
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                oid = "rep-obj0"
                await io.write_full(oid, payload)
                pg = object_to_pg(pool, oid)
                _u, _up, acting, primary = om.pg_to_up_acting_osds(pg)

                FAULTS.inject(
                    f"store.read.osd.{primary}", bitflip=True, count=1)
                # the client still reads correct data: primary fails
                # over to the healthy replica
                assert await io.read(oid) == payload
                osd = c.osds[primary]
                assert osd.perf.dump().get("rep_read_failover", 0) >= 1

                from ceph_tpu_torch.osd.pgutil import NO_SHARD

                coll = osd._shard_coll(pool, pg, NO_SHARD)
                obj = ghobject_t(oid)
                healed = False
                for _ in range(100):
                    await asyncio.sleep(0.1)
                    if not osd.store.exists(coll, obj):
                        continue
                    try:
                        osd.store.read(coll, obj)
                        healed = True
                        break
                    except OSError:
                        continue
                assert healed, "rotten replica copy never repaired"
                assert await io.read(oid) == payload
                assert osd.store.fsck() == []

        run(go())

    def test_transient_eio_does_not_quarantine(self, tmp_path):
        """A one-shot EIO (loose cabling, not rot) must not cost the
        shard: the verification re-read passes and the object stays."""

        async def go():
            async with Cluster(
                n_osds=3, store_factory=_blockstore_factory(tmp_path)
            ) as c:
                await c.client.pool_create("tr", pg_num=4, size=2)
                io = c.client.ioctx("tr")
                payload = b"transient" * 4096
                await io.write_full("t-obj", payload)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                pg = object_to_pg(pool, "t-obj")
                _u, _up, _a, primary = om.pg_to_up_acting_osds(pg)
                FAULTS.inject(
                    f"store.read.osd.{primary}", error=errno.EIO, count=1)
                assert await io.read("t-obj") == payload  # failover
                await asyncio.sleep(0.5)  # let the verify task run
                osd = c.osds[primary]
                # verification re-read passed: no ledger entry, no
                # quarantine, local copy intact
                assert "t-obj" not in osd._read_error_ledger
                from ceph_tpu_torch.osd.pgutil import NO_SHARD

                coll = osd._shard_coll(pool, pg, NO_SHARD)
                assert osd.store.exists(coll, ghobject_t("t-obj"))

        run(go())


class TestReadErrorEscalation:
    def test_dying_disk_marks_itself_down(self, tmp_path):
        """Sticky EIO on every read: after osd_max_object_read_errors
        distinct objects confirm persistent damage, the OSD reports
        itself failed and stops — the map marks it down and client I/O
        keeps working off the surviving members."""

        async def go():
            crash_dir = str(tmp_path / "crash")
            async with Cluster(
                n_osds=4,
                store_factory=_blockstore_factory(tmp_path),
                osd_conf={"osd_max_object_read_errors": 2,
                          "crash_dir": crash_dir},
            ) as c:
                await c.client.pool_create("dd", pg_num=8, size=2)
                io = c.client.ioctx("dd")
                payload = b"dying-disk" * 2048
                oids = [f"dd-obj{i}" for i in range(12)]
                for oid in oids:
                    await io.write_full(oid, payload)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                by_primary: dict[int, list[str]] = {}
                for oid in oids:
                    pg = object_to_pg(pool, oid)
                    _u, _up, _a, p = om.pg_to_up_acting_osds(pg)
                    by_primary.setdefault(p, []).append(oid)
                victim, victim_oids = max(
                    by_primary.items(), key=lambda kv: len(kv[1]))
                assert len(victim_oids) >= 2

                FAULTS.inject(
                    f"store.read.osd.{victim}", error=errno.EIO,
                    count=None)  # sticky: the whole disk is dying
                for oid in victim_oids:
                    # reads still answer correctly (replica failover)
                    assert await io.read(oid) == payload

                down = False
                for _ in range(100):
                    await asyncio.sleep(0.1)
                    if not c.client.osdmap.is_up(victim):
                        down = True
                        break
                assert down, "dying disk never escalated to markdown"
                assert c.osds[victim]._disk_escalated
                # event-plane wiring: the self-markdown emitted a
                # cluster-log entry and persisted a crash dump
                tail = " | ".join(
                    e["message"] for e in c.osds[victim].clog.tail())
                assert "marking self down" in tail
                from ceph_tpu_torch.common.crash import scan_crashes

                dumps = scan_crashes(crash_dir)
                assert any(
                    m["entity"] == f"osd.{victim}"
                    and "read-error ledger" in m["reason"]
                    for m in dumps), dumps
                FAULTS.clear()
                # the cluster serves every object without the dead osd
                for oid in oids:
                    assert await io.read(oid) == payload

        run(go())


class TestMemStoreScrubHeals:
    def test_silent_bitflip_flagged_by_deep_scrub_and_repaired(self):
        """MemStore rot is SILENT (no checksums): only deep scrub's
        cross-member crc comparison catches it, and `pg repair` pushes
        the majority copy over the rotten member."""

        async def go():
            import json

            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("ms", pg_num=4, size=3)
                io = c.client.ioctx("ms")
                payload = b"memstore-rot" * 512
                await io.write_full("ms-obj", payload)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                pg = object_to_pg(pool, "ms-obj")
                _u, _up, acting, primary = om.pg_to_up_acting_osds(pg)
                replica = next(o for o in acting if o != primary)
                pgid = f"{io.pool_id}.{pool.raw_pg_to_pg(pg).ps}"

                # rot one REPLICA at rest; the primary's reads never
                # touch it, so nothing surfaces until deep scrub reads
                # every member
                FAULTS.inject(
                    f"store.read.osd.{replica}", bitflip=True, count=1)
                code, _rs, data = await c.client.command(
                    {"prefix": "pg deep-scrub", "pgid": pgid})
                assert code == 0
                report = json.loads(data)
                kinds = {i["kind"] for i in report["inconsistencies"]}
                assert "deep-replica-crc" in kinds

                code, _rs, data = await c.client.command(
                    {"prefix": "pg repair", "pgid": pgid})
                assert code == 0
                report = json.loads(data)
                assert report["inconsistencies"] == []
                assert "ms-obj" in report["repaired"]
                # the healed member agrees with the cluster again
                code, _rs, data = await c.client.command(
                    {"prefix": "pg deep-scrub", "pgid": pgid})
                assert json.loads(data)["inconsistencies"] == []
                assert await io.read("ms-obj") == payload

        run(go())


class TestClientResendRobustness:
    def test_dead_primary_window_completes_exactly_once(self):
        """An op submitted while its primary is dead completes after
        the remap — applied exactly once: a duplicate resend with the
        same reqid is answered from the dup ledger, not re-applied."""

        async def go():
            from ceph_tpu_torch.msg.messages import MOSDOp, OP_APPEND, OSDOp

            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("rr", pg_num=8, size=2)
                io = c.client.ioctx("rr")
                # spread connections so peers notice the kill fast
                for i in range(8):
                    await io.write_full(f"seed{i}", b"x" * 512)
                await io.write_full("rr-obj", b"base-")
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                pg = object_to_pg(pool, "rr-obj")
                _u, _up, _a, primary = om.pg_to_up_acting_osds(pg)

                await c.osds[primary].stop()
                op = MOSDOp(pool=io.pool_id, oid="rr-obj",
                            ops=[OSDOp(OP_APPEND, data=b"tail")])
                op.reqid = f"client.{c.client.id}:exactly-once"
                # submitted during the dead-primary window: resends
                # ride the map changes until the new primary applies it
                rep1 = await c.client._submit(io.pool_id, op)
                assert rep1.result == 0
                assert await io.read("rr-obj") == b"base-tail"
                # duplicate resend, SAME reqid: dedup answers, no
                # second append
                rep2 = await c.client._submit(io.pool_id, op)
                assert rep2.result == 0
                assert await io.read("rr-obj") == b"base-tail"

        run(go())

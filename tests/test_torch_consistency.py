"""Log-based consistency: stale shards, delete replay, log sync, scrub.

The scenarios behind the reference's PGLog/peering machinery
(doc/dev/osd_internals/log_based_pg.rst): an OSD that missed writes
while down must not serve stale chunks (version-checked reads), must be
repaired to the newest version (log-delta recovery), must replay
deletes, and scrub must find what recovery missed.

The port's twin of tests/integration/test_consistency.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import json

import pytest

from ceph_tpu_torch.osd.daemon import OSDDaemon, object_to_pg
from ceph_tpu_torch.store import coll_t, ghobject_t

from tests.test_torch_mini_cluster import Cluster, run


class TestStaleShardConsistency:
    def _setup(self):
        return Cluster(n_osds=8)

    async def _ec_pool(self, c, k=4, m=2):
        await c.client.ec_profile_set(
            "p", {"plugin": "cuda", "k": str(k), "m": str(m)}
        )
        await c.client.pool_create(
            "ec", pg_num=4, pool_type="erasure", erasure_code_profile="p"
        )
        return c.client.ioctx("ec")

    @staticmethod
    def _placement(c, io, oid):
        om = c.client.osdmap
        pool = om.get_pg_pool(io.pool_id)
        pg = object_to_pg(pool, oid)
        _, _, acting, primary = om.pg_to_up_acting_osds(pg)
        return pool, pg, acting, primary

    async def _revive(self, c, victim, store):
        """Restart an OSD with its old (stale) store."""
        c.osds[victim] = OSDDaemon(victim, c.mon.addr, store=store, device="cpu")
        epoch = c.client.osdmap.epoch
        await c.osds[victim].start()
        await c.wait_epoch(epoch + 1)

    def test_revived_osd_with_stale_shard_is_repaired(self):
        async def go():
            async with self._setup() as c:
                io = await self._ec_pool(c)
                v1 = b"\x11" * 20000
                v2 = b"\x22" * 24000
                await io.write_full("obj", v1)
                pool, pg, acting, primary = self._placement(c, io, "obj")
                victim = next(o for o in acting if o != primary)
                vshard = acting.index(victim)
                store = c.osds[victim].store
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.wait_epoch(epoch + 1)
                # degraded overwrite: victim misses v2
                await io.write_full("obj", v2)
                # revive with the STALE store
                await self._revive(c, victim, store)
                # reads are correct immediately (stale chunk rejected)
                assert await io.read("obj") == v2
                # and recovery rewrites the stale shard in place
                folded = pool.raw_pg_to_pg(pg)
                cl = coll_t(pool.id, folded.ps, vshard)
                o = ghobject_t("obj", shard=vshard)
                from ceph_tpu_torch.osd.daemon import VERSION_ATTR, _v_parse

                want = None
                for _ in range(100):
                    if store.exists(cl, o):
                        vv = _v_parse(store.getattr(cl, o, VERSION_ATTR))
                        prim_store = c.osds[primary].store
                        pshard = acting.index(primary)
                        pv = _v_parse(
                            prim_store.getattr(
                                coll_t(pool.id, folded.ps, pshard),
                                ghobject_t("obj", shard=pshard),
                                VERSION_ATTR,
                            )
                        )
                        if vv == pv:
                            want = vv
                            break
                    await asyncio.sleep(0.1)
                assert want is not None, "stale shard never repaired"
                # after repair a read using the victim's shard round-trips
                assert await io.read("obj") == v2

        run(go())

    def test_delete_replayed_on_revived_member(self):
        async def go():
            async with self._setup() as c:
                io = await self._ec_pool(c)
                await io.write_full("doomed", b"x" * 9000)
                pool, pg, acting, primary = self._placement(c, io, "doomed")
                victim = next(o for o in acting if o != primary)
                vshard = acting.index(victim)
                store = c.osds[victim].store
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.wait_epoch(epoch + 1)
                await io.remove("doomed")
                await self._revive(c, victim, store)
                folded = pool.raw_pg_to_pg(pg)
                cl = coll_t(pool.id, folded.ps, vshard)
                o = ghobject_t("doomed", shard=vshard)
                for _ in range(100):
                    if not store.exists(cl, o):
                        break
                    await asyncio.sleep(0.1)
                assert not store.exists(cl, o), "logged delete not replayed"

        run(go())

    def test_log_sync_after_recovery(self):
        async def go():
            async with self._setup() as c:
                io = await self._ec_pool(c)
                await io.write_full("a", b"a" * 5000)
                pool, pg, acting, primary = self._placement(c, io, "a")
                victim = next(o for o in acting if o != primary)
                vshard = acting.index(victim)
                store = c.osds[victim].store
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.wait_epoch(epoch + 1)
                await io.write_full("a", b"b" * 5000)
                await io.write_full("a2", b"c" * 5000)
                await self._revive(c, victim, store)
                # victim's persisted pg log must catch up to the primary's
                from ceph_tpu_torch.osd.pglog import PGLog

                folded = pool.raw_pg_to_pg(pg)
                cl = coll_t(pool.id, folded.ps, vshard)
                pshard = acting.index(primary)
                pcl = coll_t(pool.id, folded.ps, pshard)
                for _ in range(100):
                    vlog = PGLog(cl)
                    vlog.load(store)
                    plog = PGLog(pcl)
                    plog.load(c.osds[primary].store)
                    if (
                        vlog.info.last_update == plog.info.last_update
                        and vlog.info.last_update.version > 0
                    ):
                        break
                    await asyncio.sleep(0.1)
                assert vlog.info.last_update == plog.info.last_update

        run(go())


class TestScrub:
    async def _ec_pool(self, c):
        await c.client.ec_profile_set(
            "p", {"plugin": "cuda", "k": "2", "m": "1"}
        )
        await c.client.pool_create(
            "ec", pg_num=4, pool_type="erasure", erasure_code_profile="p"
        )
        return c.client.ioctx("ec")

    def test_clean_pg_scrubs_clean(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await self._ec_pool(c)
                for i in range(6):
                    await io.write_full(f"o{i}", bytes([i]) * (1000 * (i + 1)))
                pool = c.client.osdmap.get_pg_pool(io.pool_id)
                for ps in range(pool.pg_num):
                    code, _, data = await c.client.command(
                        {"prefix": "pg deep-scrub", "pgid": f"{io.pool_id}.{ps}"}
                    )
                    assert code == 0, data
                    report = json.loads(data)
                    assert report["inconsistencies"] == [], report

        run(go())

    def test_deep_scrub_finds_bitrot(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await self._ec_pool(c)
                await io.write_full("victim", b"v" * 12000)
                pool, pg, acting, primary = (
                    TestStaleShardConsistency._placement(c, io, "victim")
                )
                folded = pool.raw_pg_to_pg(pg)
                # flip a byte in shard 1 directly in its store (bitrot)
                shard = 1
                osd = acting[shard]
                store = c.osds[osd].store
                cl = coll_t(pool.id, folded.ps, shard)
                o = ghobject_t("victim", shard=shard)
                raw = bytearray(store.read(cl, o))
                raw[100] ^= 0xFF
                from ceph_tpu_torch.store import Transaction

                store.queue_transaction(Transaction().write(cl, o, 0, bytes(raw)))
                code, _, data = await c.client.command({
                    "prefix": "pg deep-scrub",
                    "pgid": f"{io.pool_id}.{folded.ps}",
                })
                assert code == 0
                report = json.loads(data)
                kinds = {i["kind"] for i in report["inconsistencies"]}
                assert "deep-crc" in kinds, report
                # shallow scrub does NOT see it (versions agree)
                code, _, data = await c.client.command({
                    "prefix": "pg scrub",
                    "pgid": f"{io.pool_id}.{folded.ps}",
                })
                report = json.loads(data)
                assert report["inconsistencies"] == [], report

        run(go())


class TestTrimmedLogBackfill:
    """A member that was down past the log-trim window: the delta is
    gapped, so recovery must backfill — repairing objects whose entries
    were trimmed and removing strays without resurrecting deletes."""

    def test_backfill_past_trim_window(self):
        from ceph_tpu_torch.common import ConfigProxy

        conf = {"osd_min_pg_log_entries": 4, "osd_max_pg_log_entries": 4}

        async def go():
            async with Cluster(n_osds=8, osd_conf=conf) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "2", "m": "1"}
                )
                await c.client.pool_create(
                    "ec", pg_num=1, pool_type="erasure",
                    erasure_code_profile="p",
                )
                io = c.client.ioctx("ec")
                await io.write_full("kept", b"\x01" * 5000)
                await io.write_full("doomed", b"\x02" * 5000)
                pool, pg, acting, primary = (
                    TestStaleShardConsistency._placement(c, io, "kept")
                )
                victim = next(o for o in acting if o != primary)
                vshard = acting.index(victim)
                store = c.osds[victim].store
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                await c.client.command({"prefix": "osd down", "id": str(victim)})
                await c.wait_epoch(epoch + 1)
                # while the victim is down: overwrite, delete, and churn
                # well past the 4-entry log window
                await io.write_full("kept", b"\x03" * 6000)
                await io.remove("doomed")
                for i in range(10):
                    await io.write_full(f"churn{i}", bytes([i]) * 2000)
                await self_revive(c, victim, store)
                folded = pool.raw_pg_to_pg(pg)
                cl = coll_t(pool.id, folded.ps, vshard)
                kept_o = ghobject_t("kept", shard=vshard)
                doomed_o = ghobject_t("doomed", shard=vshard)
                from ceph_tpu_torch.osd.daemon import VERSION_ATTR

                ok = False
                for _ in range(150):
                    has_doomed = store.exists(cl, doomed_o)
                    churned = all(
                        store.exists(cl, ghobject_t(f"churn{i}", shard=vshard))
                        for i in range(10)
                    )
                    if not has_doomed and churned and store.exists(cl, kept_o):
                        ok = True
                        break
                    await asyncio.sleep(0.1)
                assert ok, (
                    "backfill incomplete: doomed=%s churned=%s kept=%s"
                    % (
                        store.exists(cl, doomed_o),
                        [store.exists(cl, ghobject_t(f"churn{i}", shard=vshard)) for i in range(10)],
                        store.exists(cl, kept_o),
                    )
                )
                # deleted object stays deleted cluster-wide
                with pytest.raises(OSError):
                    await io.read("doomed")
                assert await io.read("kept") == b"\x03" * 6000

        async def self_revive(c, victim, store):
            c.osds[victim] = OSDDaemon(
                victim, c.mon.addr, store=store, conf=ConfigProxy(conf), device="cpu"
            )
            epoch = c.client.osdmap.epoch
            await c.osds[victim].start()
            await c.wait_epoch(epoch + 1)

        run(go())


class TestKillBackfillerMidTransfer:
    """Kill the PRIMARY while its backfill pass is mid-transfer: the
    remote reservation slots it held on the acting peers must be swept
    when the map marks it down (reserver-death release), and after the
    primary revives the interrupted backfill must converge — no slot
    may stay parked behind the dead reserver (the
    kill-backfiller-mid-transfer deadlock)."""

    def test_primary_killed_mid_backfill_converges(self):
        from ceph_tpu_torch.common import ConfigProxy
        from ceph_tpu_torch.common.metrics import get_perf_counters

        conf = {
            # tiny log window: the revived member's delta is gapped,
            # forcing the backfill path rather than log replay
            "osd_min_pg_log_entries": 4, "osd_max_pg_log_entries": 4,
            # serialize + pace pushes so the pass is long enough to
            # kill mid-transfer deterministically
            "osd_recovery_max_active": 1, "osd_recovery_sleep": 0.25,
        }

        async def go():
            async with Cluster(n_osds=5, osd_conf=conf) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "2", "m": "1"}
                )
                await c.client.pool_create(
                    "ec", pg_num=1, pool_type="erasure",
                    erasure_code_profile="p",
                )
                io = c.client.ioctx("ec")
                await io.write_full("seed-obj", b"\x01" * 4000)
                pool, pg, acting, primary = (
                    TestStaleShardConsistency._placement(c, io, "seed-obj")
                )
                folded = pool.raw_pg_to_pg(pg)
                victim = next(o for o in acting if o != primary)
                vshard = acting.index(victim)
                vstore = c.osds[victim].store
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                await c.client.command(
                    {"prefix": "osd down", "id": str(victim)})
                await c.wait_epoch(epoch + 1)
                # churn past the 4-entry window while the member is down
                for i in range(12):
                    await io.write_full(f"churn{i}", bytes([i + 1]) * 3000)
                # per-run counter baseline: the registry is
                # process-global and survives daemon restarts
                pcs = get_perf_counters(f"osd.{primary}")
                base_s = pcs.dump().get("backfill_started", 0.0)
                base_c = pcs.dump().get("backfill_completed", 0.0)
                await revive(c, victim, vstore)
                # wait for the primary's backfill pass to be IN FLIGHT
                inflight = False
                for _ in range(300):
                    d = pcs.dump()
                    if (d.get("backfill_started", 0.0) - base_s
                            > d.get("backfill_completed", 0.0) - base_c):
                        inflight = True
                        break
                    await asyncio.sleep(0.02)
                assert inflight, "backfill pass never started"
                # kill the backfilling PRIMARY mid-transfer
                pstore = c.osds[primary].store
                epoch = c.client.osdmap.epoch
                await c.osds[primary].stop()
                await c.client.command(
                    {"prefix": "osd down", "id": str(primary)})
                await c.wait_epoch(epoch + 1)
                # the dead reserver's remote GRANTs must be swept once
                # the down-map lands (peers re-pass and sweep on entry)
                key = (pool.id, folded.ps, primary)
                swept = False
                for _ in range(200):
                    holders = [
                        o for o in acting
                        if o != primary and c.osds[o] is not None
                        and not c.osds[o].stopping
                        and key in c.osds[o]._remote_grants
                    ]
                    if not holders:
                        swept = True
                        break
                    await asyncio.sleep(0.05)
                assert swept, "grant for dead primary never swept"
                # revive the primary: the interrupted backfill resumes
                # (re-reserving releases/re-grants idempotently) and
                # the once-down member converges to full content
                await revive(c, primary, pstore)
                cl = coll_t(pool.id, folded.ps, vshard)
                ok = False
                for _ in range(300):
                    if all(
                        vstore.exists(
                            cl, ghobject_t(f"churn{i}", shard=vshard))
                        for i in range(12)
                    ) and vstore.exists(
                            cl, ghobject_t("seed-obj", shard=vshard)):
                        ok = True
                        break
                    await asyncio.sleep(0.1)
                assert ok, "interrupted backfill never converged"
                for i in range(12):
                    assert await io.read(f"churn{i}") == bytes([i + 1]) * 3000
                assert await io.read("seed-obj") == b"\x01" * 4000

        async def revive(c, osd_id, store):
            c.osds[osd_id] = OSDDaemon(
                osd_id, c.mon.addr, store=store, conf=ConfigProxy(conf), device="cpu"
            )
            epoch = c.client.osdmap.epoch
            await c.osds[osd_id].start()
            await c.wait_epoch(epoch + 1)

        run(go())

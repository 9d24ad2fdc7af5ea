"""Steady-state transfer discipline end to end.

The acceptance proof for the transfer-guard runtime twin (ctlint's
transfer rule family, ceph_tpu/common/transfer_guard.py): one full EC
write -> lost-shard recovery decode -> deep scrub cycle — plus live
mgr analytics digests — runs with the guard ARMED (the daemons arm it
themselves once EC map-install warmup completes), and the steady
state performs

- ``host_transfers == 0``: no implicit host<->device transfer inside
  any guarded launch window (every transfer is an explicit
  device_put/device_get at a baselined by-design boundary), and
- ``cold_launches == 0``: no XLA compile on the I/O path

while ``guard_windows`` grows — proving the guard was live around the
real decode/scrub launches, not just configured.

The port's twin of tests/integration/test_transfer_guard.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import json

import numpy as np

from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.store import coll_t, ghobject_t

from tests.test_torch_mini_cluster import Cluster, run


class TestTransferGuardSteadyState:
    def test_ec_write_recover_scrub_zero_host_transfers(self):
        from ceph_tpu_torch.parallel import decode_batcher, scrub_batcher

        decode_batcher.reset_shared()
        scrub_batcher.reset_shared()
        tg.disarm()

        async def go():
            async with Cluster(n_osds=6, n_mgrs=1) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2",
                          "crush-failure-domain": "host"})
                await c.client.pool_create(
                    "tgp", pg_num=4, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("tgp")
                payload = np.random.default_rng(7).integers(
                    0, 256, 40000, dtype=np.uint8).tobytes()
                await io.write_full("victim", payload)
                await c.client.wait_clean(timeout=30)

                # map-install EC warmup must land; the daemons arm the
                # guard right after it (osd_transfer_guard=auto)
                for osd in c.osds:
                    if osd is not None and osd._warm_tasks:
                        await asyncio.gather(*list(osd._warm_tasks))
                for _ in range(200):
                    if tg.active():
                        break
                    await asyncio.sleep(0.05)
                assert tg.active(), "daemons never armed the guard"

                agg = decode_batcher.shared("cpu")
                ver = scrub_batcher.shared("cpu")
                base = tg.snapshot()
                assert base["host_transfers"] == 0, \
                    tg.guard_counters().dump()

                # -- recovery decode: lose a shard holder -------------
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                from ceph_tpu_torch.osd.daemon import object_to_pg

                pg = object_to_pg(pool, "victim")
                folded = pool.raw_pg_to_pg(pg)
                _, _, acting0, primary0 = om.pg_to_up_acting_osds(pg)
                victim = next(o for o in acting0 if o != primary0)
                epoch = om.epoch
                await c.osds[victim].stop()
                c.osds[victim] = None
                await c.client.command(
                    {"prefix": "osd down", "id": str(victim)})
                await c.client.command(
                    {"prefix": "osd out", "id": str(victim)})
                await c.wait_epoch(epoch + 2)
                om2 = c.client.osdmap
                _, _, acting1, _ = om2.pg_to_up_acting_osds(pg)
                assert victim not in acting1
                new_shard, new_osd = next(
                    (s, o) for s, o in enumerate(acting1)
                    if o not in acting0)
                store = c.osds[new_osd].store
                cl = coll_t(pool.id, folded.ps, new_shard)
                o = ghobject_t("victim", shard=new_shard)
                for _ in range(120):
                    if store.exists(cl, o):
                        break
                    await asyncio.sleep(0.1)
                assert store.exists(cl, o), \
                    "recovery did not rebuild the shard"
                assert await io.read("victim") == payload

                # -- deep scrub over the recovered pg -----------------
                await c.client.wait_clean(timeout=30)
                code, _, data = await c.client.command({
                    "prefix": "pg deep-scrub",
                    "pgid": f"{io.pool_id}.{folded.ps}"})
                assert code == 0
                assert json.loads(data)["inconsistencies"] == []

                # -- a couple of live analytics digests ---------------
                await asyncio.sleep(1.2)

                after = tg.snapshot()
                # THE invariant: zero implicit transfers in the whole
                # steady-state cycle...
                assert after["host_transfers"] == 0, after
                # ...with the guard demonstrably live around launches
                assert after["guard_windows"] > base["guard_windows"], (
                    base, after)
                # and zero in-path compiles, as ever
                assert agg.stats.get("cold_launches", 0) == 0, \
                    dict(agg.stats)
                assert ver.stats.get("cold_launches", 0) == 0, \
                    dict(ver.stats)
                # the batched paths actually ran (this is not a
                # vacuous pass through host fallbacks)
                assert agg.stats.get("launches", 0) >= 1, dict(agg.stats)
                assert ver.stats.get("launches", 0) >= 1, dict(ver.stats)
                assert agg.stats.get("fallbacks", 0) == 0, dict(agg.stats)
                assert ver.stats.get(
                    "dispatch_fallbacks", 0) == 0, dict(ver.stats)
                mgr = c.mgrs[0]
                assert mgr.engine.stats.get("cold_launches", 0) == 0
                assert mgr.engine.stats.get("fallbacks", 0) == 0

        try:
            run(go())
        finally:
            tg.disarm()

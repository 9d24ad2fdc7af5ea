"""A revived primary serves no op from an object it is missing.

An OSD that was down while its replicated PG took writes comes back as
the PG's primary with those writes in its peers' logs but not in its
store.  Peering adopts the peers' log entries (``_prime_interval``); an
op on an object those entries name must first bring the object to its
logged version (the reference Ceph's ``is_missing_object`` wait in
``PrimaryLogPG::do_op``), or a read returns the stale copy and a write
under a newer SnapContext clones the stale copy into the snapshot.  The
``client-netem`` chaos scenario found both (``stale_read``,
``snap_moved``).  Here the revived daemon's background recovery is held
off, so the op meets the missing object every time."""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.osd.daemon import OSDDaemon, object_to_pg

from tests.test_torch_mini_cluster import Cluster, run

V1, V2, V3 = b"\x11" * 8192, b"\x22" * 8192, b"\x33" * 8192


async def _no_recovery() -> None:
    """Stands in for the revived daemon's ``_recover_all``."""


@pytest.mark.parametrize("op", ["read", "snap_write"])
def test_revived_primary_recovers_the_object_before_the_op(op):
    async def go():
        async with Cluster(n_osds=3) as c:
            await c.client.pool_create("rep", pg_num=1, size=2)
            io = c.client.ioctx("rep")
            await io.write_full("o", V1)
            om = c.client.osdmap
            pg = object_to_pg(om.get_pg_pool(io.pool_id), "o")
            primary = om.pg_to_up_acting_osds(pg)[3]
            store = c.osds[primary].store
            epoch = om.epoch
            await c.osds[primary].stop()
            await c.client.command({"prefix": "osd down", "id": str(primary)})
            await c.wait_epoch(epoch + 1)
            # the primary misses v2 and the snapshot
            await io.write_full("o", V2)
            snapid = await io.selfmanaged_snap_create()
            io.set_snap_context(snapid, [snapid])
            osd = OSDDaemon(primary, c.mon.addr, store=store, device="cpu")
            osd._recover_all = _no_recovery
            c.osds[primary] = osd
            epoch = c.client.osdmap.epoch
            await osd.start()
            await c.wait_epoch(epoch + 1)
            om = c.client.osdmap
            assert om.pg_to_up_acting_osds(pg)[3] == primary
            if op == "read":
                # two reads at once: both wait for the one recovery
                assert await asyncio.gather(io.read("o"), io.read("o")) == [V2, V2]
            else:
                await io.write_full("o", V3)
                assert await io.read("o") == V3
                snap = c.client.ioctx("rep").dup()
                snap.snap_set_read(snapid)
                assert await snap.read("o") == V2

    run(go())

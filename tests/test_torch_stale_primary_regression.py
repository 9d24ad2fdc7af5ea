"""Deterministic regression for the stale-shard scrub flake
(ROADMAP: thrash-window EC shard one version stale, flagged by
post-settle shallow scrub, ~1/16 sweeps — root-caused by the chaos x
load composition runs, which reproduced it 100%).

The mechanism, replayed here without chaos:

1. write v1 — all members hold it;
2. kill the pg's PRIMARY; the mon marks it down; a degraded write
   lands v2 on the survivors (legal: live set >= min_size);
3. revive the old primary on its old store; it leads the pg again;
4. write v3 through it.

Before the fix set, step 4's primary minted v3 from its STALE log
(version-counter collision inside the degraded window), every log's
last_update converged, missing_from() scoped nothing, and the revived
member's shard stayed at v1 until a scrub flagged it — while the
cluster reported active+clean.  The fixes under test:

- peering-before-active (``_prime_interval``): the revived primary
  adopts the acting set's log before serving, so the mint is
  collision-free and its own staleness lands in its log;
- the log-vs-store self-audit + contiguity floor reported through
  ``MOSDPGInfo``, scoping recovery at what members actually HOLD;
- ``_reconcile_object`` refusing to claim success over unprobed
  members.

The test demands: post-settle deep scrub of every PG reports zero
inconsistencies AND the final read returns v3, for BOTH pool types.

The port's twin of tests/integration/test_stale_primary_regression.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import json

import pytest

from ceph_tpu_torch.osd.daemon import OSDDaemon, object_to_pg
from ceph_tpu_torch.osd.types import pg_t

from tests.test_torch_mini_cluster import Cluster, run

CONF_MON = {"mon_osd_beacon_grace": 0.6}
CONF_OSD = {"osd_beacon_report_interval": 0.15}


async def _wait_down(client, osd_id: int, timeout: float = 15.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        om = client.osdmap
        if om is not None and not om.is_up(osd_id):
            return
        await asyncio.sleep(0.1)
    raise TimeoutError(f"osd.{osd_id} never marked down")


async def _wait_up(client, osd_id: int, timeout: float = 15.0):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while loop.time() < deadline:
        om = client.osdmap
        if om is not None and om.is_up(osd_id):
            return
        await asyncio.sleep(0.1)
    raise TimeoutError(f"osd.{osd_id} never marked up")


async def _write_retry(io, oid: str, data: bytes, timeout: float = 30.0):
    """write_full with patience: during the down-window and the revive
    the op may bounce EAGAIN/fail over; the objecter retries inside
    its deadline."""
    await asyncio.wait_for(io.write_full(oid, data), timeout)


async def _scenario(c: Cluster, pool_name: str, payload_len: int):
    io = c.client.ioctx(pool_name)
    oid = "victim"
    v1 = b"\x01" * payload_len
    v2 = b"\x02" * payload_len
    v3 = b"\x03" * payload_len
    await _write_retry(io, oid, v1)
    om = c.client.osdmap
    pid = io.pool_id
    pool = om.get_pg_pool(pid)
    pg = pool.raw_pg_to_pg(object_to_pg(pool, oid))
    _u, _up, _acting, primary = om.pg_to_up_acting_osds(pg, folded=True)
    assert primary >= 0
    # 2. kill the primary, keep its store (the chaos revive contract)
    victim = c.osds[primary]
    store = victim.store
    c.osds[primary] = None
    await victim.stop()
    await _wait_down(c.client, primary)
    # degraded write: survivors take it
    await _write_retry(io, oid, v2)
    # 3. revive on the old store; it re-leads the pg
    from ceph_tpu_torch.common import ConfigProxy

    c.osds[primary] = OSDDaemon(
        primary, c.mon.addr, store=store, conf=ConfigProxy(CONF_OSD), device="cpu")
    await c.osds[primary].start()
    # 4. write racing the revive: the op should land in the revived
    # primary's pre-recovery window, where only the peering-before-
    # active gate (+ the audit/floor scoping behind it) keeps the
    # version stream honest
    w3 = asyncio.ensure_future(_write_retry(io, oid, v3))
    await _wait_up(c.client, primary)
    await w3
    await c.client.wait_clean(timeout=60)
    # give the revived member's recovery one settle beat
    await asyncio.sleep(0.5)
    # every PG deep-scrubs clean — the flake's signature was a
    # shallow version mismatch surviving into scrub
    for ps in range(pool.pg_num):
        rep = None
        for _attempt in range(8):
            code, _rs, data = await c.client.command({
                "prefix": "pg deep-scrub", "pgid": f"{pid}.{ps}"})
            if code == 0:
                rep = json.loads(data)
                break
            await asyncio.sleep(0.3)
        assert rep is not None, f"scrub of {pid}.{ps} never ran"
        assert rep["inconsistencies"] == [], rep
    assert await io.read(oid) == v3


class TestStalePrimaryRegression:
    def test_replicated(self):
        async def go():
            async with Cluster(
                n_osds=3, mon_conf=CONF_MON, osd_conf=CONF_OSD,
            ) as c:
                await c.client.pool_create("spr", pg_num=4, size=2)
                await c.client.wait_clean(timeout=30)
                await _scenario(c, "spr", 4096)

        run(go())

    def test_erasure(self):
        async def go():
            async with Cluster(
                n_osds=4, mon_conf=CONF_MON, osd_conf=CONF_OSD,
            ) as c:
                await c.client.ec_profile_set(
                    "sprp", {"plugin": "cuda", "k": "2", "m": "1"})
                await c.client.pool_create(
                    "sprec", pg_num=2, pool_type="erasure",
                    erasure_code_profile="sprp")
                await c.client.wait_clean(timeout=30)
                await _scenario(c, "sprec", 8192)

        run(go())

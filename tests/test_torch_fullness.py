"""Cluster fullness guard rails (reference src/osd/OSD.cc:773
recalc_full_state / :890 _check_full, src/mon/OSDMonitor.cc:669-671
full ratios): statfs flows osd->mon on beacons, the mon commits
per-OSD NEARFULL/BACKFILLFULL/FULL map bits with health checks, client
writes to full PGs bounce with ENOSPC (deletes pass), `df`/`osd df`
report, and backfillfull replicas REJECT_TOOFULL new reservations.

The port's twin of tests/integration/test_fullness.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno
import json

import pytest

from ceph_tpu_torch.client.rados import RadosError
from ceph_tpu_torch.store.memstore import MemStore

from tests.test_torch_mini_cluster import Cluster, run

QUOTA = 512 * 1024
OBJ = 96 * 1024


async def _health(client) -> dict:
    code, _rs, data = await client.command({"prefix": "health"})
    assert code == 0
    return json.loads(data)


async def _wait_check(client, check: str, present: bool, timeout=30.0):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        h = await _health(client)
        if (check in h.get("checks", {})) == present:
            return h
        await asyncio.sleep(0.2)
    raise TimeoutError(f"{check} never became present={present}: {h}")


class TestFullness:
    def test_fill_full_bounce_delete_resume(self):
        async def go():
            async with Cluster(
                n_osds=3,
                osd_conf={"osd_beacon_report_interval": 0.2},
                store_factory=lambda i: MemStore(quota_bytes=QUOTA),
            ) as c:
                await c.client.pool_create("fullp", pg_num=8, size=2)
                io = c.client.ioctx("fullp")
                await c.client.wait_clean(timeout=30)

                # fill until the mon flags FULL (beacon statfs -> map
                # bits -> health ERR); every accepted write is recorded
                written = []
                saw_enospc = False
                for i in range(24):
                    try:
                        await io.write_full(f"o{i}", b"\xab" * OBJ)
                        written.append(f"o{i}")
                    except RadosError as e:
                        assert e.errno == errno.ENOSPC
                        saw_enospc = True
                        break
                    await asyncio.sleep(0.1)
                h = await _wait_check(c.client, "OSD_FULL", True)
                assert h["status"] == "HEALTH_ERR"

                # once FULL is committed, further writes bounce
                if not saw_enospc:
                    with pytest.raises(RadosError) as ei:
                        await io.write_full("post-full", b"x" * OBJ)
                    assert ei.value.errno == errno.ENOSPC

                # df / osd df report the condition
                code, _rs, data = await c.client.command({"prefix": "df"})
                assert code == 0
                df = json.loads(data)
                assert df["stats"]["total_bytes"] == 3 * QUOTA
                assert df["stats"]["total_used_bytes"] > 0
                assert df["pools"]["fullp"]["objects"] == len(written)
                code, _rs, data = await c.client.command(
                    {"prefix": "osd df"})
                assert code == 0
                nodes = json.loads(data)["nodes"]
                assert len(nodes) == 3
                assert any("full" in n["state"] for n in nodes)

                # deletes must pass while FULL — they are the way out
                for name in written:
                    await io.remove(name)
                await _wait_check(c.client, "OSD_FULL", False)

                # writes flow again
                await io.write_full("after", b"y" * 1024)
                assert await io.read("after") == b"y" * 1024

        run(go())

    def test_backfillfull_rejects_reservation(self):
        """A replica past mon_osd_backfillfull_ratio answers
        REJECT_TOOFULL (backfill_reservation.rst contract)."""

        async def go():
            async with Cluster(
                n_osds=2,
                osd_conf={"osd_beacon_report_interval": 0.2},
                store_factory=lambda i: MemStore(quota_bytes=QUOTA),
            ) as c:
                from ceph_tpu_torch.msg.messages import MBackfillReserve

                replica = c.osds[1]
                # drive the replica's store past backfillfull
                ratio = replica.conf["mon_osd_backfillfull_ratio"]
                replica.store.quota_bytes = QUOTA
                fill = int(QUOTA * ratio) + 4096
                from ceph_tpu_torch.store import Transaction, coll_t, ghobject_t

                t = Transaction()
                cl = coll_t(99, 0, -1)
                t.create_collection(cl)
                t.write(cl, ghobject_t("ballast"), 0, b"\0" * fill)
                replica.store.queue_transaction(t)
                replica._statfs()  # refresh the cached ratio

                replies = []

                class _Conn:
                    async def send_message(self, m):
                        replies.append(m)

                msg = MBackfillReserve(
                    tid=1, op=MBackfillReserve.REQUEST, pool=1, ps=0,
                    from_osd=0, priority=1)
                msg.conn = _Conn()
                await replica._handle_backfill_reserve(msg)
                assert replies
                assert replies[0].op == MBackfillReserve.REJECT_TOOFULL

                # free the ballast: reservations flow again
                t2 = Transaction()
                t2.remove(cl, ghobject_t("ballast"))
                replica.store.queue_transaction(t2)
                replica._statfs()
                msg2 = MBackfillReserve(
                    tid=2, op=MBackfillReserve.REQUEST, pool=1, ps=0,
                    from_osd=0, priority=1)
                msg2.conn = _Conn()
                await replica._handle_backfill_reserve(msg2)
                assert replies[1].op == MBackfillReserve.GRANT

        run(go())

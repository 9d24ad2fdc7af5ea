"""Monitor quorum: elections, replicated commands, leader failover.

Integration coverage for the Paxos layer (mon/paxos.py): a
3-monitor quorum must elect the lowest rank, replicate every map
mutation to all members, redirect clients to the leader, and survive
the leader's death with a fresh election — while OSDs and clients keep
working (the mon quorum availability contract).

The port's twin of tests/integration/test_quorum.py: the same cases over
``ceph_tpu_torch``, every daemon on the CPU."""

from __future__ import annotations

import asyncio
import functools

from ceph_tpu_torch.client import RadosClient
from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch import mon as _mon
from ceph_tpu_torch.osd import daemon as _daemon

from tests.test_torch_mini_cluster import run


#: the daemons of these tests run on the CPU (the kernels' plain versions)
Monitor = functools.partial(_mon.Monitor, device="cpu")
OSDDaemon = functools.partial(_daemon.OSDDaemon, device="cpu")

class QuorumCluster:
    def __init__(self, n_mons: int = 3, n_osds: int = 4):
        crush = CrushMap()
        B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
        self.mons = [
            Monitor(crush=crush.copy(), rank=r, n_mons=n_mons)
            for r in range(n_mons)
        ]
        self.n_osds = n_osds
        self.osds: list[_daemon.OSDDaemon] = []
        self.client = RadosClient(client_id=777)

    async def __aenter__(self):
        for m in self.mons:
            await m.start()
        self.monmap = [m.addr for m in self.mons]
        for m in self.mons:
            await m.open_quorum(self.monmap)
        for m in self.mons:
            await m.wait_stable()
        for i in range(self.n_osds):
            osd = OSDDaemon(i, self.monmap)
            await osd.start()
            self.osds.append(osd)
        await self.client.connect_multi(self.monmap)
        return self

    async def __aexit__(self, *exc):
        await self.client.shutdown()
        for o in self.osds:
            if o is not None:
                await o.stop()
        for m in self.mons:
            if m is not None:
                await m.stop()


class TestQuorum:
    def test_lowest_rank_leads_and_commands_replicate(self):
        async def go():
            async with QuorumCluster() as c:
                assert c.mons[0].is_leader
                assert not c.mons[1].is_leader
                await c.client.pool_create("rbd", pg_num=4, size=2)
                io = c.client.ioctx("rbd")
                await io.write_full("q", b"quorum bytes")
                assert await io.read("q") == b"quorum bytes"
                # every member applied the same committed log
                await asyncio.sleep(0.2)
                epochs = [m.osdmap.epoch for m in c.mons]
                assert len(set(epochs)) == 1, epochs
                for m in c.mons:
                    assert m.osdmap.pool_names.get(1) == "rbd"
                    assert m.paxos.last_committed == c.mons[0].paxos.last_committed

        run(go())

    def test_command_to_peon_redirects_to_leader(self):
        async def go():
            async with QuorumCluster() as c:
                # point the client's mon session at a peon
                c.client._mon_conn = await c.client.messenger.connect_to(
                    ("mon", 2), *c.monmap[2]
                )
                from ceph_tpu_torch.msg.messages import MMonSubscribe

                await c.client._mon_conn.send_message(MMonSubscribe())
                pid = await c.client.pool_create("viapeon", pg_num=4, size=2)
                assert pid == 1
                for m in c.mons:
                    assert m.osdmap.pool_names.get(1) == "viapeon"

        run(go())

    def test_leader_failover(self):
        async def go():
            async with QuorumCluster() as c:
                await c.client.pool_create("rbd", pg_num=4, size=2)
                io = c.client.ioctx("rbd")
                await io.write_full("pre", b"before failover")
                # kill the leader (mon.0)
                await c.mons[0].stop()
                c.mons[0] = None
                # surviving mons elect mon.1
                for _ in range(100):
                    if c.mons[1].is_leader:
                        break
                    await asyncio.sleep(0.1)
                assert c.mons[1].is_leader
                # client redirects, commands + I/O still work
                pid = await c.client.pool_create("post", pg_num=4, size=2)
                assert pid == 2
                # the client may have been subscribed to mon.0: re-home
                await c.client.connect_multi(
                    [m.addr for m in c.mons if m is not None]
                )
                io2 = c.client.ioctx("post")
                await io2.write_full("after", b"after failover")
                assert await io2.read("after") == b"after failover"
                assert await io.read("pre") == b"before failover"
                assert c.mons[1].osdmap.pool_names.get(2) == "post"
                assert c.mons[2].osdmap.pool_names.get(2) == "post"

        run(go())

    def test_osd_failure_report_via_peon_still_marks_down(self):
        async def go():
            async with QuorumCluster() as c:
                await c.client.pool_create("rbd", pg_num=4, size=2)
                # osd.3 boots against a PEON: boot must forward to leader
                extra = OSDDaemon(3, c.monmap[2])
                # (it already booted via mon.0 in setup; re-targeting the
                # mon conn of osd.2 instead)
                await extra.stop()
                code, _, data = await c.client.command({"prefix": "status"})
                assert code == 0
                # drive 'osd down' through a peon redirect
                c.client._mon_conn = await c.client.messenger.connect_to(
                    ("mon", 1), *c.monmap[1]
                )
                epoch = c.mons[0].osdmap.epoch
                code, rs, _ = await c.client.command(
                    {"prefix": "osd down", "id": "3"}
                )
                assert code == 0, rs
                await asyncio.sleep(0.2)
                # the command must have committed a down-mark epoch on
                # every member; the LIVE osd.3 then re-asserts itself
                # (map-says-down -> re-boot), so check the transition,
                # not the final state
                from ceph_tpu_torch.osd.mapenc import decode_osdmap

                for m in c.mons:
                    assert any(
                        e > epoch and not decode_osdmap(blob).is_up(3)
                        for e, blob in list(m._epoch_blobs.items())
                    ), f"mon.{m.rank} never saw osd.3 down"

        run(go())


class TestBalanceCommand:
    def test_osd_balance_replicates_upmaps(self):
        async def go():
            async with QuorumCluster(n_mons=3, n_osds=8) as c:
                await c.client.pool_create("big", pg_num=128, size=3)
                code, rs, data = await c.client.command(
                    {"prefix": "osd balance"}
                )
                assert code == 0, rs
                import json

                swaps = json.loads(data)["swaps"]
                assert swaps > 0
                await asyncio.sleep(0.3)
                # upmap table replicated to every quorum member
                tables = [len(m.osdmap.pg_upmap_items) for m in c.mons]
                assert tables == [swaps] * 3, tables
                # I/O still correct under the new mappings
                io = c.client.ioctx("big")
                await io.write_full("balanced", b"b" * 4000)
                assert await io.read("balanced") == b"b" * 4000

        run(go())

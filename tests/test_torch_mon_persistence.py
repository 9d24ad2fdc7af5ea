"""Mon store persistence + OSD<->OSD heartbeats.

The reference monitor keeps all state in a Paxos-committed kv store
replayed on restart (src/mon/MonitorDBStore.h, src/mon/Paxos.h:174);
failure detection pairs mon beacons with OSD<->OSD pings
(OSD::handle_osd_ping src/osd/OSD.cc:5735, OSDMonitor::check_failure
src/mon/OSDMonitor.cc:3242).  These tests pin both: a full-cluster
kill-and-restart recovers every map/pool/profile/object, and a peer
whose data path goes silent is marked down by peer reports while its
beacon keeps flowing.

The port's twin of tests/integration/test_mon_persistence.py over
``ceph_tpu_torch``, every daemon on the CPU.
"""

from __future__ import annotations

import asyncio
import functools
import random

import pytest

from ceph_tpu_torch.common import ConfigProxy
from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch import mon as _mon
from ceph_tpu_torch.osd import daemon as _daemon
from ceph_tpu_torch.store.filestore import FileStore

from tests.test_torch_mini_cluster import Cluster, run


#: the daemons of these tests run on the CPU (the kernels' plain versions)
Monitor = functools.partial(_mon.Monitor, device="cpu")
OSDDaemon = functools.partial(_daemon.OSDDaemon, device="cpu")

def _filestore(tmp_path, name: str) -> FileStore:
    s = FileStore(str(tmp_path / name))
    s.mount()
    return s


class TestMonPersistence:
    def test_mon_restart_recovers_state(self, tmp_path):
        """Kill the (single) mon; a new process over the same store
        serves the same epoch, pools, and profiles."""
        async def go():
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
            store = _filestore(tmp_path, "mon0")
            mon = Monitor(crush=crush, store=store)
            await mon.start()

            from ceph_tpu_torch.client import RadosClient
            osds = []
            for i in range(4):
                o = OSDDaemon(i, mon.addr)
                await o.start()
                osds.append(o)
            cl = RadosClient(client_id=7)
            await cl.connect(*mon.addr)
            await cl.ec_profile_set("p", {"plugin": "cuda", "k": "2", "m": "1"})
            await cl.pool_create("data", pg_num=4, pool_type="erasure",
                                 erasure_code_profile="p")
            await cl.pool_create("meta", pg_num=4, size=3)
            # the mon's own epoch, not the client's view (subscription
            # delivery can lag the last commit by a beat)
            epoch_before = mon.osdmap.epoch
            pools_before = dict(mon.osdmap.pool_names)
            await cl.shutdown()
            # mon first: peers report the first-stopped OSD's resets,
            # which would commit extra 'down' epochs mid-teardown
            await mon.stop()
            for o in osds:
                await o.stop()
            store.umount()

            # restart over the same backing files (fresh objects)
            store2 = _filestore(tmp_path, "mon0")
            mon2 = Monitor(crush=crush, store=store2)
            await mon2.start()
            assert mon2.osdmap.epoch == epoch_before
            assert dict(mon2.osdmap.pool_names) == pools_before
            assert "p" in mon2.osdmap.erasure_code_profiles
            # the state machine still works: create another pool
            cl2 = RadosClient(client_id=8)
            osds2 = []
            for i in range(4):
                o = OSDDaemon(i, mon2.addr)
                await o.start()
                osds2.append(o)
            await cl2.connect(*mon2.addr)
            await cl2.pool_create("more", pg_num=4, size=2)
            assert cl2.osdmap.lookup_pg_pool_name("more") >= 0
            await cl2.shutdown()
            for o in osds2:
                await o.stop()
            await mon2.stop()

        run(go())

    def test_full_cluster_kill_and_restart(self, tmp_path):
        """Everything dies (mon + all OSDs on FileStores); the restarted
        cluster serves every object with all maps intact."""
        async def go():
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=5)
            mon_store = _filestore(tmp_path, "mon")
            osd_stores = [_filestore(tmp_path, f"osd{i}") for i in range(5)]

            from ceph_tpu_torch.client import RadosClient
            mon = Monitor(crush=crush, store=mon_store)
            await mon.start()
            osds = []
            for i in range(5):
                o = OSDDaemon(i, mon.addr, store=osd_stores[i])
                await o.start()
                osds.append(o)
            cl = RadosClient(client_id=9)
            await cl.connect(*mon.addr)
            await cl.ec_profile_set("p", {"plugin": "cuda", "k": "3", "m": "2"})
            await cl.pool_create("data", pg_num=8, pool_type="erasure",
                                 erasure_code_profile="p")
            io = cl.ioctx("data")
            rng = random.Random(5)
            payloads = {
                f"o{i}": rng.randbytes(rng.randrange(1, 40000))
                for i in range(8)
            }
            for oid, data in payloads.items():
                await io.write_full(oid, data)
            await io.write("o0", b"PATCH", off=100)
            payloads["o0"] = (
                payloads["o0"][:100].ljust(100, b"\0") + b"PATCH"
                + payloads["o0"][105:]
            ) if len(payloads["o0"]) > 105 else (
                payloads["o0"][:100].ljust(100, b"\0") + b"PATCH"
            )
            await cl.shutdown()
            await mon.stop()  # mon first: see test above
            for o in osds:
                await o.stop()
            mon_store.umount()
            for s in osd_stores:
                s.umount()

            # cold restart: new processes, same disks
            mon_store2 = _filestore(tmp_path, "mon")
            mon2 = Monitor(crush=crush, store=mon_store2)
            await mon2.start()
            osds2 = []
            for i in range(5):
                s = _filestore(tmp_path, f"osd{i}")
                o = OSDDaemon(i, mon2.addr, store=s)
                await o.start()
                osds2.append(o)
            cl2 = RadosClient(client_id=10)
            await cl2.connect(*mon2.addr)
            io2 = cl2.ioctx("data")
            for oid, data in payloads.items():
                assert await io2.read(oid) == data, oid
            await cl2.shutdown()
            for o in osds2:
                await o.stop()
            await mon2.stop()

        run(go())

    def test_trimmed_log_full_sync(self, tmp_path):
        """A mon that slept through more commits than the kept log must
        rejoin via the SYNC snapshot (trim makes incremental catch-up
        impossible)."""
        async def go():
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=3)
            mons = [
                Monitor(crush=crush, rank=r, n_mons=3,
                        store=_filestore(tmp_path, f"mon{r}"),
                        paxos_trim_max=20, paxos_trim_keep=10)
                for r in range(3)
            ]
            monmap = [await m.start() for m in mons]
            for m in mons:
                await m.open_quorum(monmap)
            for m in mons:
                await m.wait_stable()
            leader = None
            for _ in range(100):
                leader = next((m for m in mons if m.is_leader), None)
                if leader is not None:
                    break
                await asyncio.sleep(0.1)
            assert leader is not None, "election never settled"

            # isolate mon.2, then push > trim_max commits
            await mons[2].stop()
            for i in range(30):
                await leader._propose({
                    "op": "profile", "name": f"prof{i}",
                    "profile": {"plugin": "cuda", "k": "2", "m": "1"},
                })
            assert leader.paxos.first_committed > 1  # log actually trimmed

            # mon.2 rejoins from its (stale) store
            m2 = Monitor(crush=crush, rank=2, n_mons=3,
                         store=_filestore(tmp_path, "mon2"),
                         paxos_trim_max=20, paxos_trim_keep=10)
            addr = await m2.start()
            monmap2 = [monmap[0], monmap[1], addr]
            for m in (mons[0], mons[1], m2):
                m.monmap = monmap2
            await m2.open_quorum(monmap2)
            await m2.wait_stable()
            # trigger catch-up: the leader commits one more value and
            # the gap forces mon.2 to FETCH -> SYNC.  The rejoin can
            # churn an election round; retry the propose until the
            # quorum settles.
            members = (mons[0], mons[1], m2)
            for _try in range(20):
                try:
                    await leader._propose({
                        "op": "profile", "name": "last",
                        "profile": {"plugin": "cuda", "k": "2", "m": "1"},
                    })
                    break
                except ConnectionError:
                    await asyncio.sleep(0.3)
                    leader = next(
                        (m for m in members if m.is_leader), leader
                    )
            else:
                raise AssertionError("quorum never settled after rejoin")
            for _ in range(100):
                if (
                    m2.paxos.last_committed == leader.paxos.last_committed
                    and "last" in m2.osdmap.erasure_code_profiles
                ):
                    break
                await asyncio.sleep(0.1)
            assert "last" in m2.osdmap.erasure_code_profiles
            assert "prof0" in m2.osdmap.erasure_code_profiles  # via snapshot
            assert m2.paxos.last_committed == leader.paxos.last_committed
            for m in (mons[0], mons[1], m2):
                await m.stop()

        run(go())


class TestHeartbeats:
    def test_silent_peer_marked_down_by_reports(self):
        """A peer that answers beacons but drops peer pings (silent
        data-path partition) is marked down by heartbeat reports —
        beacon-only detection cannot see this failure."""
        async def go():
            conf = {
                "osd_heartbeat_interval": 0.15,
                "osd_heartbeat_grace": 0.8,
            }
            async with Cluster(n_osds=4, osd_conf=conf) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                victim = 2
                c.osds[victim].drop_pings = True
                epoch = c.client.osdmap.epoch

                # beacons keep flowing (daemon stays alive) but the
                # data path is "partitioned": peers must report it.
                # The victim re-boots when it sees itself down (it IS
                # alive), so scan the epoch history for the down-mark
                # instead of racing the flap.
                from ceph_tpu_torch.osd.mapenc import decode_osdmap

                def marked_down() -> bool:
                    return any(
                        e > epoch and not decode_osdmap(blob).is_up(victim)
                        for e, blob in list(c.mon._epoch_blobs.items())
                    )

                for _ in range(100):
                    if marked_down():
                        break
                    await asyncio.sleep(0.1)
                assert marked_down(), (
                    "heartbeat reports did not mark the silent peer down"
                )

        run(go())

    def test_min_down_reporters_quorum(self):
        """With min_down_reporters=2 a single report is not enough."""
        async def go():
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=3)
            mon = Monitor(crush=crush, min_down_reporters=2)
            await mon.start()
            osds = []
            for i in range(3):
                o = OSDDaemon(i, mon.addr)
                await o.start()
                osds.append(o)
            from ceph_tpu_torch.msg.messages import MOSDFailure
            # keep the victim from re-asserting itself (this test pins
            # the mon-side reporter quorum, not the flap cycle)
            osds[2].stopping = True
            epoch = mon.osdmap.epoch  # fresh reports, not pre-boot strays
            conn = await osds[0].messenger.connect_to(("mon", 0), *mon.addr)
            await conn.send_message(
                MOSDFailure(reporter=0, failed=2, epoch=epoch))
            await asyncio.sleep(0.3)
            assert mon.osdmap.is_up(2)  # one report: still up
            conn1 = await osds[1].messenger.connect_to(("mon", 0), *mon.addr)
            await conn1.send_message(
                MOSDFailure(reporter=1, failed=2, epoch=epoch))
            for _ in range(30):
                if not mon.osdmap.is_up(2):
                    break
                await asyncio.sleep(0.1)
            assert not mon.osdmap.is_up(2)  # second distinct reporter
            for o in osds:
                await o.stop()
            await mon.stop()

        run(go())

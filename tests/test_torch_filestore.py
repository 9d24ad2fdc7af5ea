"""FileStore durability tests: WAL replay, torn tails, checkpoints,
and a daemon-restart flow (reference analogue: store_test.cc over a
journaling backend + its crash-replay cases).

The port's twin of tests/test_filestore.py: the same cases over
``ceph_tpu_torch``, the daemon restart case's daemons on the CPU.
"""

from __future__ import annotations

import os
import struct

import pytest

from ceph_tpu_torch.store import Transaction, coll_t, ghobject_t
from ceph_tpu_torch.store.filestore import FileStore, decode_txn, encode_txn

C = coll_t(1, 0, 0)
O1 = ghobject_t("a")
O2 = ghobject_t("b")


@pytest.fixture
def store(tmp_path):
    s = FileStore(str(tmp_path / "osd0"))
    s.mount()
    yield s


def reopen(store) -> FileStore:
    s2 = FileStore(store.path, checkpoint_bytes=store.checkpoint_bytes)
    s2.mount()
    return s2


class TestTxnCodec:
    def test_all_ops_roundtrip(self):
        t = (
            Transaction()
            .create_collection(C)
            .touch(C, O1)
            .write(C, O1, 4, b"abc")
            .zero(C, O1, 0, 2)
            .truncate(C, O1, 6)
            .setattrs(C, O1, {"x": b"\x01"})
            .rmattr(C, O1, "gone")
            .omap_setkeys(C, O1, {"k": b"v"})
            .omap_rmkeys(C, O1, ["dead"])
            .omap_clear(C, O1)
            .clone(C, O1, O2)
            .remove(C, O2)
            .collection_move_rename(C, O1, C, O2)
            .remove_collection(coll_t(9, 9))
        )
        t2 = decode_txn(encode_txn(t))
        assert t2.ops == t.ops


class TestDurability:
    def test_state_survives_reopen(self, store):
        store.queue_transaction(
            Transaction().create_collection(C).write(C, O1, 0, b"persist")
            .setattrs(C, O1, {"v": b"1"}).omap_setkeys(C, O1, {"log.1": b"e"})
        )
        s2 = reopen(store)
        assert s2.read(C, O1) == b"persist"
        assert s2.getattr(C, O1, "v") == b"1"
        assert s2.omap_get(C, O1) == {"log.1": b"e"}

    def test_unacked_torn_tail_is_dropped(self, store):
        store.queue_transaction(
            Transaction().create_collection(C).write(C, O1, 0, b"good")
        )
        # simulate a crash mid-append: garbage half-record at the tail
        with open(os.path.join(store.path, "wal.log"), "ab") as f:
            f.write(struct.pack("<HI", 0xC397, 9999) + b"partial")
        s2 = reopen(store)
        assert s2.read(C, O1) == b"good"
        # and the store keeps working after recovery
        s2.queue_transaction(Transaction().write(C, O2, 0, b"after"))
        assert reopen(s2).read(C, O2) == b"after"

    def test_corrupt_crc_stops_replay(self, store):
        store.queue_transaction(
            Transaction().create_collection(C).write(C, O1, 0, b"one")
        )
        store.queue_transaction(Transaction().write(C, O2, 0, b"two"))
        walfn = os.path.join(store.path, "wal.log")
        raw = bytearray(open(walfn, "rb").read())
        raw[-3] ^= 0xFF  # flip a byte inside the LAST record's body
        open(walfn, "wb").write(bytes(raw))
        s2 = reopen(store)
        assert s2.read(C, O1) == b"one"       # first record intact
        assert not s2.exists(C, O2)           # corrupted one dropped

    def test_checkpoint_compacts_wal(self, tmp_path):
        s = FileStore(str(tmp_path / "cp"), checkpoint_bytes=2000)
        s.mount()
        s.queue_transaction(Transaction().create_collection(C))
        for i in range(20):
            s.queue_transaction(
                Transaction().write(C, ghobject_t(f"o{i}"), 0, b"x" * 200)
            )
        assert os.path.exists(os.path.join(s.path, "checkpoint"))
        assert os.path.getsize(os.path.join(s.path, "wal.log")) < 2000
        s2 = reopen(s)
        for i in range(20):
            assert s2.read(C, ghobject_t(f"o{i}")) == b"x" * 200

    def test_failed_txn_not_persisted(self, store):
        store.queue_transaction(Transaction().create_collection(C))
        with pytest.raises(FileNotFoundError):
            store.queue_transaction(
                Transaction().write(C, O1, 0, b"ok").remove(C, ghobject_t("nope"))
            )
        s2 = reopen(store)
        assert not s2.exists(C, O1)

    def test_umount_checkpoints(self, store):
        store.queue_transaction(
            Transaction().create_collection(C).write(C, O1, 0, b"um")
        )
        store.umount()
        assert os.path.getsize(os.path.join(store.path, "wal.log")) == 0
        s2 = FileStore(store.path)
        s2.mount()
        assert s2.read(C, O1) == b"um"


class TestDaemonRestart:
    def test_osd_restart_from_disk(self, tmp_path):
        """An OSD serving from a FileStore restarts with its data —
        recovery sees a consistent member, not an empty one."""
        import asyncio

        from ceph_tpu_torch.client import RadosClient
        from ceph_tpu_torch.crush import builder as B
        from ceph_tpu_torch.crush.types import CrushMap
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.osd.daemon import OSDDaemon

        async def go():
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
            mon = Monitor(crush=crush, device="cpu")
            await mon.start()
            stores = {}
            osds = {}
            for i in range(4):
                stores[i] = FileStore(str(tmp_path / f"osd{i}"))
                stores[i].mount()
                osds[i] = OSDDaemon(i, mon.addr, store=stores[i], device="cpu")
                await osds[i].start()
            cl = RadosClient(client_id=3)
            await cl.connect(*mon.addr)
            await cl.ec_profile_set("p", {"plugin": "cuda", "k": "2", "m": "1"})
            await cl.pool_create(
                "ec", pg_num=4, pool_type="erasure", erasure_code_profile="p"
            )
            io = cl.ioctx("ec")
            await io.write_full("durable", b"d" * 9000)
            # stop an OSD, then bring it back from DISK (fresh FileStore)
            victim = 1
            epoch = cl.osdmap.epoch
            await osds[victim].stop()
            stores[victim].umount()
            await cl.command({"prefix": "osd down", "id": str(victim)})
            await cl._wait_new_map(epoch, timeout=10)
            fresh = FileStore(str(tmp_path / f"osd{victim}"))
            fresh.mount()
            osds[victim] = OSDDaemon(victim, mon.addr, store=fresh, device="cpu")
            await osds[victim].start()
            await asyncio.sleep(0.5)
            assert await io.read("durable") == b"d" * 9000
            await cl.shutdown()
            for o in osds.values():
                await o.stop()
            await mon.stop()

        loop = asyncio.new_event_loop()
        try:
            loop.run_until_complete(asyncio.wait_for(go(), 60))
        finally:
            loop.close()

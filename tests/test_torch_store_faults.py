"""Store-level fault injection points (the disk-fault tolerance
chain's first link): memstore/blockstore/bluefs read, write, commit
and mount paths honor armed FAULTS points, keyed per store via
``fault_domain`` — EIO on read, torn write on commit, and at-rest bit
flips that BlockStore's checksum-at-rest surfaces as EIO.

The port's twin of tests/test_store_faults.py: the same cases over
``ceph_tpu_torch``.
"""

import errno

import pytest

from ceph_tpu_torch.common.fault_injector import FAULTS, InjectedError
from ceph_tpu_torch.store import MemStore, Transaction, coll_t, ghobject_t
from ceph_tpu_torch.store.blockstore import BlockStore


@pytest.fixture(autouse=True)
def _no_armed_faults():
    """FAULTS is process-wide: leave no point armed for the tests that
    run after these in the same worker."""
    FAULTS.clear()
    yield
    FAULTS.clear()


C = coll_t(1, 0)
O1 = ghobject_t("obj1")
O2 = ghobject_t("obj2")


def _mkstore_mem(domain="osd.7"):
    s = MemStore()
    s.fault_domain = domain
    t = Transaction()
    t.create_collection(C)
    t.write(C, O1, 0, b"payload-" * 1000)
    s.queue_transaction(t)
    return s


def _mkstore_block(tmp_path, domain="osd.7"):
    s = BlockStore(str(tmp_path / "bs"))
    s.fault_domain = domain
    s.mount()
    t = Transaction()
    t.create_collection(C)
    t.write(C, O1, 0, b"payload-" * 8192)  # > INLINE_MAX: a real blob
    s.queue_transaction(t)
    return s


class TestMemStoreFaults:
    def test_read_eio_scoped_and_bare(self):
        s = _mkstore_mem()
        FAULTS.inject("store.read.osd.7", error=errno.EIO, count=1)
        with pytest.raises(InjectedError) as ei:
            s.read(C, O1)
        assert ei.value.errno == errno.EIO
        assert s.read(C, O1).startswith(b"payload-")  # one-shot
        # the bare key hits every store regardless of domain
        FAULTS.inject("store.read", error=errno.EIO, count=1)
        with pytest.raises(InjectedError):
            s.read(C, O1)

    def test_wrong_domain_is_a_noop(self):
        s = _mkstore_mem()
        FAULTS.inject("store.read.osd.8", error=errno.EIO, count=1)
        assert s.read(C, O1).startswith(b"payload-")
        assert FAULTS.fired("store.read.osd.8") == 0

    def test_torn_write_applies_a_prefix_then_fails(self):
        s = _mkstore_mem()
        FAULTS.inject("store.write.osd.7", torn=True, count=1)
        t = Transaction()
        t.touch(C, O2)
        t.write(C, O2, 0, b"x" * 100)
        t.setattrs(C, O2, {"a": b"1"})
        t.omap_setkeys(C, O2, {"k": b"v"})
        with pytest.raises(InjectedError):
            s.queue_transaction(t)
        # the tear: first half (touch + write) landed, the rest did not
        assert s.exists(C, O2)
        assert s.read(C, O2) == b"x" * 100
        assert s.getattrs(C, O2) == {}
        assert s.omap_get(C, O2) == {}

    def test_commit_fault_applies_but_reports_failure(self):
        s = _mkstore_mem()
        FAULTS.inject("store.commit.osd.7", error=errno.EIO, count=1)
        acked = []
        t = Transaction()
        t.write(C, O2, 0, b"y" * 10)
        t.register_on_commit(lambda: acked.append(1))
        with pytest.raises(InjectedError):
            s.queue_transaction(t)
        # lost-ack flavor: state applied, caller never told
        assert s.read(C, O2) == b"y" * 10
        assert acked == []

    def test_bitflip_is_silent_at_rest(self):
        """MemStore has no checksums: the flip persists at rest and
        reads serve corrupt bytes silently — the store class only deep
        scrub's cross-member comparison can catch."""
        s = _mkstore_mem()
        clean = s.read(C, O1)
        FAULTS.inject("store.read.osd.7", bitflip=True, count=1)
        rotten = s.read(C, O1)
        assert rotten != clean and len(rotten) == len(clean)
        assert s.read(C, O1) == rotten  # damage persists at rest

    def test_mount_fault(self):
        s = MemStore()
        s.fault_domain = "osd.7"
        FAULTS.inject("store.mount.osd.7", error=errno.EIO, count=1)
        with pytest.raises(InjectedError):
            s.mount()


class TestBlockStoreFaults:
    def test_read_eio_one_shot(self, tmp_path):
        s = _mkstore_block(tmp_path)
        FAULTS.inject("store.read.osd.7", error=errno.EIO, count=1)
        with pytest.raises(InjectedError):
            s.read(C, O1)
        assert s.read(C, O1).startswith(b"payload-")

    def test_bitflip_surfaces_as_checksum_eio(self, tmp_path):
        """The BlueStore bit-rot model: one flipped stored bit fails
        the blob crc on EVERY subsequent read (EIO, errno 5) and fsck
        reports the blob — persistent damage, not a transient error."""
        s = _mkstore_block(tmp_path)
        FAULTS.inject("store.read.osd.7", bitflip=True, count=1)
        with pytest.raises(OSError) as ei:
            s.read(C, O1)
        assert ei.value.errno == 5
        with pytest.raises(OSError):  # fault consumed; the ROT persists
            s.read(C, O1)
        assert FAULTS.fired("store.read.osd.7") == 1
        bad = s.fsck()
        assert bad, "fsck must report the rotten blob"
        # metadata stays intact: the damage is data-plane only
        assert s.stat(C, O1) == 8 * 8192

    def test_bitflip_skips_blobless_objects(self, tmp_path):
        s = _mkstore_block(tmp_path)
        t = Transaction()
        t.write(C, O2, 0, b"tiny")  # inline: no blob to rot
        s.queue_transaction(t)
        FAULTS.inject("store.read.osd.7", bitflip=True, count=1)
        assert s.read(C, O2) == b"tiny"
        assert FAULTS.fired("store.read.osd.7") == 0  # still armed
        with pytest.raises(OSError):
            s.read(C, O1)  # first blob-backed read takes the hit

    def test_torn_write_keeps_old_state_and_leaks_reclaim(self, tmp_path):
        """BlockStore's true crash shape: blob data written, kv commit
        dropped — the object keeps its committed content and the next
        mount's fsck-lite sweep reclaims the orphan blobs."""
        s = _mkstore_block(tmp_path)
        FAULTS.inject("store.write.osd.7", torn=True, count=1)
        t = Transaction()
        t.write(C, O1, 0, b"NEWDATA!" * 8192)
        with pytest.raises(InjectedError):
            s.queue_transaction(t)
        assert s.read(C, O1) == b"payload-" * 8192  # old state intact
        assert s.fsck() == []
        s.umount()
        s2 = BlockStore(str(tmp_path / "bs"))
        s2.mount()  # allocator sweep reclaims the leaked blobs
        assert s2.read(C, O1) == b"payload-" * 8192
        assert s2.fsck() == []
        s2.umount()

    def test_commit_fault_leaves_object_unchanged(self, tmp_path):
        s = _mkstore_block(tmp_path)
        FAULTS.inject("store.commit.osd.7", error=errno.EIO, count=1)
        t = Transaction()
        t.write(C, O1, 0, b"NEWDATA!" * 8192)
        with pytest.raises(InjectedError):
            s.queue_transaction(t)
        assert s.read(C, O1) == b"payload-" * 8192

    def test_mount_fault(self, tmp_path):
        s = BlockStore(str(tmp_path / "bs2"))
        s.fault_domain = "osd.7"
        FAULTS.inject("store.mount.osd.7", error=errno.EIO, count=1)
        with pytest.raises(InjectedError):
            s.mount()
        s.mount()  # one-shot: the retry mounts clean
        s.umount()

    def test_bluefs_mount_and_commit_points(self, tmp_path):
        # fresh store: BlueFS-lite hosts the kv on the same device
        FAULTS.inject("store.mount.bluefs", error=errno.EIO, count=1)
        s = BlockStore(str(tmp_path / "bs3"))
        with pytest.raises(InjectedError):
            s.mount()
        FAULTS.clear()
        s = BlockStore(str(tmp_path / "bs3"))
        s.mount()
        FAULTS.inject("store.commit.bluefs", error=errno.EIO, count=1)
        t = Transaction()
        t.create_collection(C)
        with pytest.raises(InjectedError):
            s.queue_transaction(t)
        s.umount()

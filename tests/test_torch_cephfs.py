"""CephFS-lite end to end: mkdir/create/write/rename/readdir/unlink
over a live mini-cluster, plus MDS restart journal replay — the
VERDICT round-3 item 2 acceptance flow (reference analogues:
qa/workunits/fs/misc, src/mds/journal.cc replay).

The port's twin of tests/integration/test_cephfs.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import errno

import numpy as np
import pytest

from ceph_tpu_torch.fs import FSClient, FSError, MDSDaemon

from tests.test_torch_mini_cluster import Cluster, run


async def _fs(c, flush_every: int = 128, ec_data: bool = False):
    await c.client.pool_create("cephfs.meta", pg_num=4, size=3)
    if ec_data:
        await c.client.ec_profile_set(
            "fsp", {"plugin": "cuda", "k": "3", "m": "2"})
        await c.client.pool_create(
            "cephfs.data", pg_num=8, pool_type="erasure",
            erasure_code_profile="fsp")
    else:
        await c.client.pool_create("cephfs.data", pg_num=8, size=3)
    mds = MDSDaemon(0, c.mon.addr, flush_every=flush_every)
    await mds.start()
    fs = FSClient(mds.addr, c.client.ioctx("cephfs.data"))
    await fs.mount()
    return mds, fs


class TestPosixSurface:
    def test_dirs_files_rename_unlink(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    await fs.mkdir("/a")
                    await fs.mkdir("/a/b")
                    with pytest.raises(FSError) as ei:
                        await fs.mkdir("/a")
                    assert ei.value.errno == errno.EEXIST
                    with pytest.raises(FSError) as ei:
                        await fs.mkdir("/nope/c")
                    assert ei.value.errno == errno.ENOENT

                    # create + write + read (crosses stripe units)
                    f = await fs.create("/a/b/data.bin")
                    payload = np.random.default_rng(3).integers(
                        0, 256, 300_000, dtype=np.uint8).tobytes()
                    await f.write(0, payload)
                    assert await f.read(0) == payload
                    # overwrite inside + read a slice
                    await f.write(1000, b"\xee" * 500)
                    want = payload[:1000] + b"\xee" * 500 + payload[1500:]
                    assert await f.read(900, 800) == want[900:1700]

                    # reopen sees the reported size
                    f2 = await fs.open("/a/b/data.bin")
                    assert f2.size == len(payload)
                    assert await f2.read(0) == want

                    # stat/readdir
                    attr = await fs.stat("/a/b/data.bin")
                    assert attr["type"] == "file"
                    assert attr["size"] == len(payload)
                    names = sorted(await fs.readdir("/a/b"))
                    assert names == ["data.bin"]
                    root = await fs.readdir("/")
                    assert list(root) == ["a"]

                    # rename within and across directories
                    await fs.mkdir("/target")
                    await fs.rename("/a/b/data.bin", "/target/moved.bin")
                    with pytest.raises(FSError):
                        await fs.stat("/a/b/data.bin")
                    f3 = await fs.open("/target/moved.bin")
                    assert await f3.read(0) == want

                    # rename onto an existing file replaces it (and
                    # purges the victim's data)
                    g = await fs.create("/target/victim.bin")
                    await g.write(0, b"victim")
                    await fs.rename("/target/moved.bin",
                                    "/target/victim.bin")
                    f4 = await fs.open("/target/victim.bin")
                    assert await f4.read(0) == want

                    # unlink + rmdir ordering rules
                    with pytest.raises(FSError) as ei:
                        await fs.rmdir("/target")
                    assert ei.value.errno == errno.ENOTEMPTY
                    await fs.unlink("/target/victim.bin")
                    await fs.rmdir("/target")
                    with pytest.raises(FSError) as ei:
                        await fs.unlink("/a/b")   # a dir
                    assert ei.value.errno == errno.EISDIR
                    await fs.rmdir("/a/b")
                    await fs.rmdir("/a")
                    assert await fs.readdir("/") == {}
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_symlink_truncate(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    f = await fs.create("/file")
                    await f.write(0, b"0123456789" * 100)
                    await fs.symlink("/link", "/file")
                    assert await fs.readlink("/link") == "/file"
                    assert (await fs.stat("/link"))["type"] == "symlink"
                    # shrink, then read through a fresh handle
                    await fs.truncate("/file", 10)
                    f2 = await fs.open("/file")
                    assert f2.size == 10
                    assert await f2.read(0) == b"0123456789"
                    # grow-by-truncate reads zeros (sparse)
                    await fs.truncate("/file", 20)
                    f3 = await fs.open("/file")
                    assert await f3.read(0) == b"0123456789" + b"\0" * 10
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_data_on_ec_pool(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c, ec_data=True)
                try:
                    f = await fs.create("/ec.bin")
                    payload = np.random.default_rng(11).integers(
                        0, 256, 200_000, dtype=np.uint8).tobytes()
                    await f.write(0, payload)
                    f2 = await fs.open("/ec.bin")
                    assert await f2.read(0) == payload
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())


class TestJournalReplay:
    def test_mds_crash_replays_unflushed_ops(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                # flush_every high: nothing writes back before the crash
                mds, fs = await _fs(c, flush_every=10_000)
                await fs.mkdir("/d")
                f = await fs.create("/d/f1")
                await f.write(0, b"persisted across mds death")
                await fs.mkdir("/d/sub")
                await fs.rename("/d/f1", "/d/sub/f1")
                await fs.create("/d/doomed")
                await fs.unlink("/d/doomed")
                await fs.unmount()
                await mds.crash()   # no flush: dirfrags never written

                mds2 = MDSDaemon(0, c.mon.addr, flush_every=10_000)
                await mds2.start()  # journal replay rebuilds everything
                fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                await fs2.mount()
                try:
                    assert sorted(await fs2.readdir("/d")) == ["sub"]
                    assert sorted(await fs2.readdir("/d/sub")) == ["f1"]
                    f2 = await fs2.open("/d/sub/f1")
                    assert await f2.read(0) == b"persisted across mds death"
                    # ino allocator replayed past every used ino: new
                    # files must not collide with pre-crash data objects
                    f3 = await fs2.create("/d/new")
                    await f3.write(0, b"fresh")
                    assert await (await fs2.open("/d/new")).read(0) == b"fresh"
                    assert await f2.read(0) == b"persisted across mds death"
                finally:
                    await fs2.unmount()
                    await mds2.stop()

        run(go())

    def test_flush_then_crash_replays_tail_only(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c, flush_every=10_000)
                await fs.mkdir("/pre")
                await (await fs.create("/pre/a")).write(0, b"AA")
                await fs.sync()     # checkpoint: dirfrags durable
                # post-checkpoint tail, unflushed
                await (await fs.create("/pre/b")).write(0, b"BB")
                await fs.rename("/pre/a", "/pre/a2")
                await fs.unmount()
                await mds.crash()

                mds2 = MDSDaemon(0, c.mon.addr)
                await mds2.start()
                fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                await fs2.mount()
                try:
                    assert sorted(await fs2.readdir("/pre")) == ["a2", "b"]
                    assert await (await fs2.open("/pre/a2")).read(0) == b"AA"
                    assert await (await fs2.open("/pre/b")).read(0) == b"BB"
                finally:
                    await fs2.unmount()
                    await mds2.stop()

        run(go())

    def test_clean_restart_after_stop(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                await fs.mkdir("/keep")
                await (await fs.create("/keep/f")).write(0, b"data!")
                await fs.unmount()
                await mds.stop()    # clean: flush + trim

                mds2 = MDSDaemon(0, c.mon.addr)
                await mds2.start()
                # trimmed journal: nothing to replay, state from dirfrags
                assert mds2.journal.min_seg == mds2.journal.cur_seg
                fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                await fs2.mount()
                try:
                    assert await (await fs2.open("/keep/f")).read(0) == b"data!"
                finally:
                    await fs2.unmount()
                    await mds2.stop()

        run(go())


class TestReviewFixes:
    def test_rename_into_own_subtree_einval(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    await fs.mkdir("/a")
                    await fs.mkdir("/a/b")
                    with pytest.raises(FSError) as ei:
                        await fs.rename("/a", "/a/b/c")
                    assert ei.value.errno == errno.EINVAL
                    # a sibling rename still works
                    await fs.rename("/a/b", "/a/b2")
                    assert sorted(await fs.readdir("/a")) == ["b2"]
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_retried_mutation_deduplicated(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    await fs.mkdir("/d")
                    # replay the exact wire request (same _reqid): the
                    # MDS must return the ORIGINAL answer, not EEXIST
                    out1 = await fs.request("mkdir", path="/d/x")
                    from ceph_tpu_torch.msg.messages import MClientRequest
                    tid = 9_999
                    fut = None
                    args = {"path": "/d/x", "mode": 0o755,
                            "_reqid": None}
                    # reuse the reqid the client generated: grab it by
                    # sending through the raw path ourselves
                    out2 = None
                    # simulate: second send with an explicit fixed reqid
                    r1 = await _raw(fs, "mkdir", {"path": "/d/y",
                                                  "_reqid": "42:1"})
                    assert r1.result == 0
                    r2 = await _raw(fs, "mkdir", {"path": "/d/y",
                                                  "_reqid": "42:1"})
                    assert r2.result == 0          # dedup, not EEXIST
                    assert r2.out == r1.out
                    r3 = await _raw(fs, "mkdir", {"path": "/d/y",
                                                  "_reqid": "42:2"})
                    assert r3.result == -errno.EEXIST  # genuinely new
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_truncate_journal_first(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c, flush_every=10_000)
                f = await fs.create("/t.bin")
                await f.write(0, b"Z" * 100_000)
                await fs.truncate("/t.bin", 7)
                await fs.unmount()
                await mds.crash()   # truncate event only in journal
                mds2 = MDSDaemon(0, c.mon.addr)
                await mds2.start()
                fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                await fs2.mount()
                try:
                    f2 = await fs2.open("/t.bin")
                    assert f2.size == 7
                    assert await f2.read(0) == b"Z" * 7
                finally:
                    await fs2.unmount()
                    await mds2.stop()

        run(go())


async def _raw(fs, op, args):
    """Send a request with caller-controlled args (fixed _reqid)."""
    import asyncio as _a

    from ceph_tpu_torch.msg.messages import MClientRequest

    tid = next(fs._tids)
    fut = _a.get_running_loop().create_future()
    fs._waiters[tid] = fut
    try:
        await fs._conn.send_message(MClientRequest(tid=tid, op=op, args=args))
        return await _a.wait_for(fut, 10)
    finally:
        fs._waiters.pop(tid, None)


class TestCapabilities:
    """The Locker-lite cap protocol: EXCL buffering, recall-on-
    conflict with flush, write-cap-gated size authority (reference
    src/mds/Locker.cc issue/revoke)."""

    def test_two_clients_coherent_via_recall(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs_a = await _fs(c)
                fs_b = FSClient(mds.addr, c.client.ioctx("cephfs.data"),
                                client_id=909)
                await fs_b.mount()
                try:
                    # A is the sole writer: EXCL, size buffered
                    fa = await fs_a.create("/shared.txt")
                    await fa.write(0, b"written by A" * 100)
                    from ceph_tpu_torch.fs.mds import CAP_EXCL

                    assert fs_a._caps[fa.ino] & CAP_EXCL
                    assert fa.ino in fs_a._dirty  # buffered, no flush yet

                    # B opens: the MDS recalls A's EXCL, A flushes its
                    # buffered size, B sees every byte A wrote
                    fb = await fs_b.open("/shared.txt")
                    assert fb.size == 1200
                    assert await fb.read(0) == b"written by A" * 100
                    # A's cap was downgraded and its dirty state flushed
                    assert not (fs_a._caps.get(fa.ino, 0) & CAP_EXCL)
                    assert fa.ino not in fs_a._dirty

                    # B stats through the MDS: size reflects the flush
                    attr = await fs_b.stat("/shared.txt")
                    assert attr["size"] == 1200

                    # B opens for write: A's remaining caps recall
                    # fully, so B is now the sole (EXCL) writer and
                    # buffers; A's next stat recalls B's EXCL and sees
                    # the flushed size — coherence both directions
                    fb2 = await fs_b.open("/shared.txt", want="w")
                    await fb2.write(1200, b"tail-from-B")
                    assert fb2.ino in fs_b._dirty  # buffered under EXCL
                    attr = await fs_a.stat("/shared.txt")
                    assert attr["size"] == 1200 + len(b"tail-from-B")
                    assert fb2.ino not in fs_b._dirty  # flushed by recall
                finally:
                    await fs_b.unmount()
                    await fs_a.unmount()
                    await mds.stop()

        run(go())

    def test_size_authority_requires_write_cap(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    f = await fs.create("/gated.txt")
                    await f.write(0, b"x" * 100)
                    await f.fsync()

                    # a second session WITHOUT any cap on the ino
                    rogue = FSClient(
                        mds.addr, c.client.ioctx("cephfs.data"),
                        client_id=666)
                    await rogue.mount()
                    reply = await _raw(rogue, "report_size", {
                        "path": "/gated.txt", "ino": f.ino,
                        "size": 999999, "_reqid": "rogue:1"})
                    assert reply.result == -errno.EPERM
                    attr = await fs.stat("/gated.txt")
                    assert attr["size"] == 100  # authority intact
                    await rogue.unmount()
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_excl_flush_survives_mds_restart(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c, flush_every=4)
                try:
                    f = await fs.create("/sur.txt")
                    await f.write(0, b"y" * 5000)
                    await f.fsync()          # size journaled at the MDS
                    await mds.crash()        # die without writeback
                    mds2 = MDSDaemon(0, c.mon.addr)
                    await mds2.start()       # journal replay
                    fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                    await fs2.mount()
                    f2 = await fs2.open("/sur.txt")
                    assert f2.size == 5000
                    assert await f2.read(0) == b"y" * 5000
                    await fs2.unmount()
                    await mds2.stop()
                finally:
                    await fs.unmount()

        run(go())


class TestSnapshots:
    """SnapRealm-lite: .snap namespaces over frozen manifests with
    data-pool COW (reference src/mds/SnapRealm.cc + snapc plumbing)."""

    def test_snapshot_freezes_data_and_metadata(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c)
                try:
                    await fs.mkdir("/proj")
                    f = await fs.create("/proj/notes.txt")
                    await f.write(0, b"version-one")
                    await f.fsync()
                    await fs.snap_create("/proj", "s1")

                    # overwrite + extend + add a sibling after the snap
                    f2 = await fs.open("/proj/notes.txt", want="w")
                    await f2.write(0, b"VERSION-TWO-LONGER")
                    await f2.fsync()
                    g = await fs.create("/proj/later.txt")
                    await g.write(0, b"after")
                    await g.fsync()

                    # live view
                    live = await fs.open("/proj/notes.txt")
                    assert await live.read(0) == b"VERSION-TWO-LONGER"

                    # snapshot view: pre-snap data AND namespace
                    snap = await fs.open("/proj/.snap/s1/notes.txt")
                    assert snap.size == len(b"version-one")
                    assert await snap.read(0) == b"version-one"
                    names = sorted(await fs.readdir("/proj/.snap/s1"))
                    assert names == ["notes.txt"]  # later.txt absent
                    snaps = sorted(await fs.readdir("/proj/.snap"))
                    assert snaps == ["s1"]

                    # snapshots are read-only
                    with pytest.raises(FSError) as ei:
                        await fs.create("/proj/.snap/s1/new.txt")
                    assert ei.value.errno == errno.EROFS
                    with pytest.raises(FSError):
                        await snap.write(0, b"nope")

                    # unlink the live file: the snapshot still reads
                    await fs.unlink("/proj/notes.txt")
                    snap2 = await fs.open("/proj/.snap/s1/notes.txt")
                    assert await snap2.read(0) == b"version-one"

                    # remove the snapshot: namespace gone
                    await fs.snap_remove("/proj", "s1")
                    with pytest.raises(FSError) as ei:
                        await fs.open("/proj/.snap/s1/notes.txt")
                    assert ei.value.errno == errno.ENOENT
                finally:
                    await fs.unmount()
                    await mds.stop()

        run(go())

    def test_snapshot_survives_mds_restart(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs = await _fs(c, flush_every=4)
                try:
                    await fs.mkdir("/d")
                    f = await fs.create("/d/a")
                    await f.write(0, b"frozen")
                    await f.fsync()
                    await fs.snap_create("/d", "keep")
                    f2 = await fs.open("/d/a", want="w")
                    await f2.write(0, b"THAWED")
                    await f2.fsync()
                    await mds.crash()

                    mds2 = MDSDaemon(0, c.mon.addr)
                    await mds2.start()
                    fs2 = FSClient(mds2.addr, c.client.ioctx("cephfs.data"))
                    await fs2.mount()
                    snap = await fs2.open("/d/.snap/keep/a")
                    assert await snap.read(0) == b"frozen"
                    live = await fs2.open("/d/a")
                    assert await live.read(0) == b"THAWED"
                    await fs2.unmount()
                    await mds2.stop()
                finally:
                    await fs.unmount()

        run(go())


class TestSnapCoherence:
    """ADVICE r5 fixes: a snapshot freeze must see buffered EXCL state,
    and cap coherence must not be disabled for files merely NAMED with
    a .snap prefix."""

    def test_snap_sees_buffered_excl_size(self):
        """Writer A holds EXCL with a buffered (unflushed) size; a
        DIFFERENT client snapshots the dir.  The frozen manifest must
        record the full size — the MDS recalls EXCL across the subtree
        before freezing (client-side flush_dirty alone can't cover the
        other session's buffer)."""
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs_a = await _fs(c)
                fs_b = FSClient(mds.addr, c.client.ioctx("cephfs.data"),
                                client_id=910)
                await fs_b.mount()
                try:
                    await fs_a.mkdir("/snapd")
                    f = await fs_a.create("/snapd/big.bin")
                    payload = b"Z" * 9000
                    await f.write(0, payload)
                    from ceph_tpu_torch.fs.mds import CAP_EXCL

                    assert fs_a._caps[f.ino] & CAP_EXCL
                    assert f.ino in fs_a._dirty  # buffered, NOT fsynced

                    await fs_b.snap_create("/snapd", "s1")
                    snap = await fs_b.open("/snapd/.snap/s1/big.bin")
                    assert snap.size == len(payload)
                    assert await snap.read(0) == payload
                    attr = await fs_b.stat("/snapd/.snap/s1/big.bin")
                    assert attr["size"] == len(payload)
                finally:
                    await fs_b.unmount()
                    await fs_a.unmount()
                    await mds.stop()

        run(go())

    def test_dot_snapshot_named_file_keeps_coherence(self):
        """A file named '.snapshot' (substring of a .snap path, NOT a
        snapshot component) still gets recall-based coherence."""
        async def go():
            async with Cluster(n_osds=6) as c:
                mds, fs_a = await _fs(c)
                fs_b = FSClient(mds.addr, c.client.ioctx("cephfs.data"),
                                client_id=911)
                await fs_b.mount()
                try:
                    await fs_a.mkdir("/dir")
                    f = await fs_a.create("/dir/.snapshot")
                    await f.write(0, b"q" * 4321)
                    assert f.ino in fs_a._dirty  # buffered under EXCL

                    # B's stat must recall A's EXCL (the old substring
                    # test skipped any path containing '/.snap')
                    attr = await fs_b.stat("/dir/.snapshot")
                    assert attr["size"] == 4321
                    assert f.ino not in fs_a._dirty  # flushed by recall
                finally:
                    await fs_b.unmount()
                    await fs_a.unmount()
                    await mds.stop()

        run(go())

"""RBD object-map/fast-diff, journaling crash replay, and rbd-mirror
(reference src/librbd/object_map/, src/librbd/journal/,
src/tools/rbd_mirror/) over a live mini-cluster.

The port's twin of tests/integration/test_rbd_mirror.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import errno

import pytest

from ceph_tpu_torch.rbd import RBD, RBDError
from ceph_tpu_torch.rbd import journal as J
from ceph_tpu_torch.rbd import objectmap as OM
from ceph_tpu_torch.rbd.mirror import MirrorDaemon

from tests.test_torch_mini_cluster import Cluster, run

MB = 1 << 20


async def _two_pools(c):
    await c.client.pool_create("poolA", pg_num=4, size=2)
    await c.client.pool_create("poolB", pg_num=4, size=2)
    return (
        RBD(c.client.ioctx("poolA")),
        RBD(c.client.ioctx("poolB")),
    )


class TestObjectMapFastDiff:
    def test_states_and_diff(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "om", size=8 * MB, order=20,  # 8 x 1MiB objects
                    features=("object-map", "fast-diff"))
                img = await rbd.open("om")
                assert img.objmap is not None
                await img.write(0, b"a" * MB)          # obj 0
                await img.write(3 * MB, b"b" * MB)     # obj 3
                assert img.objmap.get(0) == OM.OBJECT_EXISTS
                assert img.objmap.get(1) == OM.OBJECT_NONEXISTENT
                assert img.objmap.get(3) == OM.OBJECT_EXISTS
                # allocated-extent diff without touching data objects
                assert await img.fast_diff() == [(0, MB), (3 * MB, MB)]

                await img.snap_create("s1")
                assert img.objmap.get(0) == OM.OBJECT_EXISTS_CLEAN
                await img.write(5 * MB, b"c" * MB)     # obj 5, post-snap
                await img.write(0, b"A" * MB)          # obj 0 redirtied
                diff = await img.fast_diff("s1")
                assert diff == [(0, MB), (5 * MB, MB)]

                # the map survives reopen, and reads are correct on
                # short-circuit objects (nonexistent -> zeros)
                img2 = await rbd.open("om")
                assert img2.objmap.get(5) == OM.OBJECT_EXISTS
                assert await img2.read(MB, 16) == b"\0" * 16
                assert await img2.read(0, 4) == b"AAAA"

        run(go())

    def test_resize_trims_map(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "rs", size=4 * MB, order=20, features=("object-map",))
                img = await rbd.open("rs")
                await img.write(3 * MB, b"z" * MB)
                await img.resize(2 * MB)
                assert img.objmap.n_objs == 2
                await img.resize(4 * MB)
                # regrown space is provably empty again
                assert img.objmap.get(3) == OM.OBJECT_NONEXISTENT
                assert await img.read(3 * MB, 8) == b"\0" * 8

        run(go())


class TestJournaling:
    def test_crash_replay_applies_pending_events(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "jr", size=4 * MB, order=20, features=("journaling",))
                img = await rbd.open("jr")
                await img.write(0, b"committed")
                # simulate a crash mid-write: the event is journaled
                # but never applied (no data write, no commit)
                jr = J.Journal(rbd.meta, "jr")
                await jr.append(J.WRITE, {"off": MB}, b"crashed-write")
                # reopen = librbd open-time replay
                img2 = await rbd.open("jr")
                assert await img2.read(MB, 13) == b"crashed-write"
                assert await img2.read(0, 9) == b"committed"
                # replay advanced commit_pos: nothing pending
                assert await img2.journal.commit_pos() == \
                    await img2.journal.tail_seq()

        run(go())

    def test_trim_respects_peers(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "tr", size=4 * MB, order=20, features=("journaling",))
                img = await rbd.open("tr")
                await img.journal.register_peer("site-b")
                await img.write(0, b"one")
                await img.write(16, b"two")
                # data path committed both, but the peer saw nothing:
                # trim must keep every event
                assert await img.journal.trim() == 0
                await img.journal.peer_commit(
                    "site-b", await img.journal.tail_seq())
                assert await img.journal.trim() == 2

        run(go())


class TestMirror:
    def test_bootstrap_replay_and_failover(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                src, dst = await _two_pools(c)
                await src.create(
                    "vm", size=4 * MB, order=20, features=("journaling",))
                img = await src.open("vm")
                await img.write(0, b"primary-data")
                m = MirrorDaemon(src, dst, peer_name="site-b")
                n = await m.sync_image("vm")
                assert n >= 1
                assert m.stats["images_bootstrapped"] == 1

                dimg = await dst.open("vm")
                assert await dimg.read(0, 12) == b"primary-data"
                assert not dimg.primary
                # the copy refuses writes while non-primary
                with pytest.raises(RBDError) as ei:
                    await dimg.write(0, b"x")
                assert ei.value.errno == errno.EROFS

                # incremental replay: new writes + a snapshot flow over
                await img.write(2 * MB, b"delta")
                await img.snap_create("s1")
                await m.sync_image("vm")
                dimg = await dst.open("vm")
                assert await dimg.read(2 * MB, 5) == b"delta"
                assert "s1" in dimg.snaps

                # failover: demote A, promote B; direction flips
                await img.demote()
                await dimg.promote()
                await dimg.write(0, b"site-b-now")
                with pytest.raises(RBDError):
                    srcimg = await src.open("vm")
                    await srcimg.write(0, b"nope")
                # a demoted source replays nothing
                assert await m.sync_image("vm") == 0

        run(go())

    def test_continuous_mode(self):
        async def go():
            import asyncio

            async with Cluster(n_osds=4) as c:
                src, dst = await _two_pools(c)
                await src.create(
                    "cm", size=2 * MB, order=20, features=("journaling",))
                img = await src.open("cm")
                m = MirrorDaemon(src, dst)
                m.start(interval=0.05)
                try:
                    await img.write(0, b"streamed")
                    for _ in range(100):
                        try:
                            dimg = await dst.open("cm")
                            if await dimg.read(0, 8) == b"streamed":
                                break
                        except RBDError:
                            pass
                        await asyncio.sleep(0.1)
                    assert await (await dst.open("cm")).read(0, 8) == \
                        b"streamed"
                finally:
                    await m.stop()

        run(go())


class TestFastDiffIntervals:
    def test_diff_sees_writes_between_intermediate_snapshots(self):
        """A write landed between s1 and s2 (then frozen EXISTS_CLEAN
        by s2) must still show in fast_diff('s1') — the union over
        intermediate snapshot maps, not just the endpoints."""
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "iv", size=8 * MB, order=20,
                    features=("object-map", "fast-diff"))
                img = await rbd.open("iv")
                await img.write(0, b"a" * MB)
                await img.snap_create("s1")
                await img.write(2 * MB, b"b" * MB)   # between s1 and s2
                await img.snap_create("s2")          # freezes obj2 clean
                await img.write(4 * MB, b"c" * MB)   # after s2
                diff = await img.fast_diff("s1")
                assert (2 * MB, MB) in diff, diff    # the frozen write
                assert (4 * MB, MB) in diff, diff
                assert (0, MB) not in diff, diff     # unchanged since s1
                # diff from s2 must NOT include the s1..s2 write
                diff2 = await img.fast_diff("s2")
                assert (2 * MB, MB) not in diff2, diff2
                assert (4 * MB, MB) in diff2, diff2

        run(go())


class TestReplayOnDemotedImage:
    def test_crash_replay_succeeds_after_demote(self):
        """A pending journal event + demote (mirror failover) must not
        make the image unopenable — replay suspends the EROFS guard."""
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd, _ = await _two_pools(c)
                await rbd.create(
                    "dm", size=4 * MB, order=20, features=("journaling",))
                img = await rbd.open("dm")
                await img.demote()
                jr = J.Journal(rbd.meta, "dm")
                await jr.append(J.WRITE, {"off": 0}, b"pending")
                img2 = await rbd.open("dm")   # replay despite demotion
                assert not img2.primary       # role preserved
                assert await img2.read(0, 7) == b"pending"

        run(go())

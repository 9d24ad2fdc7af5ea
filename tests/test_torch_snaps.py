"""Snapshots/clones: self-managed + pool snaps, COW, rollback, trim.

Behavioral twins of the reference's snap machinery
(src/osd/SnapMapper.h:122, PrimaryLogPG make_writeable /
find_object_context / _rollback_to, librados selfmanaged_snap_*).

The port's twin of tests/integration/test_snaps.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

import asyncio

import pytest

from ceph_tpu_torch.client.rados import RadosError
from tests.test_torch_mini_cluster import Cluster, run


async def _make_pool(c, name="snp", kind="replicated"):
    if kind == "erasure":
        await c.client.ec_profile_set(
            "snp-prof", {"plugin": "cuda", "k": "3", "m": "2",
                         "crush-failure-domain": "host"})
        await c.client.pool_create(
            name, pg_num=8, pool_type="erasure",
            erasure_code_profile="snp-prof")
    else:
        await c.client.pool_create(name, pg_num=8, size=3)
    return c.client.ioctx(name)


@pytest.fixture(params=["replicated", "erasure"])
def kind(request):
    return request.param


class TestSelfManagedSnaps:
    def test_cow_preserves_snapshot_content(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"version-1")
                snap = await io.selfmanaged_snap_create()
                io.set_snap_context(snap, [snap])
                await io.write_full("obj", b"version-2-longer")
                # head reads the new data
                assert await io.read("obj") == b"version-2-longer"
                # the snap still reads the old data
                io.snap_set_read(snap)
                assert await io.read("obj") == b"version-1"
                io.snap_set_read(None)
                # a second snap + partial overwrite
                snap2 = await io.selfmanaged_snap_create()
                io.set_snap_context(snap2, [snap2, snap])
                await io.write("obj", b"XX", 0)
                assert await io.read("obj") == b"XXrsion-2-longer"
                io.snap_set_read(snap2)
                assert await io.read("obj") == b"version-2-longer"
                io.snap_set_read(snap)
                assert await io.read("obj") == b"version-1"

        run(go())

    def test_list_snaps_and_clone_metadata(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"a" * 100)
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.write_full("obj", b"b" * 200)
                ss = await io.list_snaps("obj")
                assert ss["seq"] == s1
                assert len(ss["clones"]) == 1
                assert ss["clones"][0]["id"] == s1
                assert ss["clones"][0]["snaps"] == [s1]
                assert ss["clones"][0]["size"] == 100

        run(go())

    def test_write_to_snap_is_erofs(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"x")
                s1 = await io.selfmanaged_snap_create()
                io.snap_set_read(s1)
                with pytest.raises(RadosError) as ei:
                    await io.write_full("obj", b"y")
                import errno
                assert ei.value.errno == errno.EROFS

        run(go())

    def test_rollback_restores_content_and_attrs(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"golden")
                await io.setxattr("obj", "tag", b"old")
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.write_full("obj", b"scribbled-over")
                await io.setxattr("obj", "tag", b"new")
                await io.rollback("obj", s1)
                assert await io.read("obj") == b"golden"
                assert await io.getxattr("obj", "tag") == b"old"

        run(go())

    def test_delete_head_keeps_snaps_readable(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"keep-me")
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.remove("obj")
                with pytest.raises(RadosError):
                    await io.read("obj")          # head is gone
                io.snap_set_read(s1)
                assert await io.read("obj") == b"keep-me"
                # recreate head over the whiteout
                io.snap_set_read(None)
                await io.write_full("obj", b"reborn")
                assert await io.read("obj") == b"reborn"
                io.snap_set_read(s1)
                assert await io.read("obj") == b"keep-me"

        run(go())

    def test_snap_remove_trims_clones(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"v1")
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.write_full("obj", b"v2")
                assert len((await io.list_snaps("obj"))["clones"]) == 1
                await io.selfmanaged_snap_remove(s1)
                # the trimmer runs off the new map; poll for the clone drop
                for _ in range(50):
                    ss = await io.list_snaps("obj")
                    if not ss["clones"]:
                        break
                    await asyncio.sleep(0.1)
                assert not ss["clones"], ss
                io.snap_set_read(s1)
                with pytest.raises(RadosError):
                    await io.read("obj")
                io.snap_set_read(None)
                assert await io.read("obj") == b"v2"

        run(go())


class TestPoolSnaps:
    def test_pool_snap_context_applies_to_plain_writes(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                io = await _make_pool(c)
                await io.write_full("obj", b"before-pool-snap")
                code, _, data = await c.client.command({
                    "prefix": "osd pool mksnap", "pool": "snp",
                    "snap": "nightly"})
                assert code == 0
                import json
                snapid = json.loads(data)["snapid"]
                # wait for the map with the pool snap to reach the client
                for _ in range(50):
                    pool = c.client.osdmap.get_pg_pool(io.pool_id)
                    if pool.pool_snaps.get("nightly") == snapid:
                        break
                    await asyncio.sleep(0.1)
                # a plain write (no client snapc) COWs under the pool snapc
                await io.write_full("obj", b"after-pool-snap")
                io.snap_set_read(snapid)
                assert await io.read("obj") == b"before-pool-snap"

        run(go())


class TestSnapsUnderThrash:
    def test_snap_contents_survive_churn(self):
        """Snapshot contents must survive OSD kill/revive churn (the
        thrash-erasure-code + snaps suites' core invariant)."""
        import random

        from ceph_tpu_torch.osd.daemon import OSDDaemon

        async def go():
            async with Cluster(n_osds=7) as c:
                io = await _make_pool(c, kind="erasure")
                rng = random.Random(7)
                snaps: list[tuple[int, dict[str, bytes]]] = []
                state: dict[str, bytes] = {}
                oids = [f"s{i}" for i in range(6)]

                async def churn():
                    stores = {}
                    for _ in range(4):
                        await asyncio.sleep(rng.uniform(0.2, 0.4))
                        up = [i for i, o in enumerate(c.osds) if o is not None]
                        downed = [i for i in range(len(c.osds))
                                  if c.osds[i] is None]
                        if len(up) > 5 and (not downed or rng.random() < 0.6):
                            v = rng.choice(up)
                            stores[v] = c.osds[v].store
                            await c.osds[v].stop()
                            c.osds[v] = None
                            await c.client.command(
                                {"prefix": "osd down", "id": str(v)})
                        elif downed:
                            b = rng.choice(downed)
                            c.osds[b] = OSDDaemon(
                                b, c.mon.addr, store=stores.pop(b), device="cpu")
                            await c.osds[b].start()
                    for i in range(len(c.osds)):
                        if c.osds[i] is None and i in stores:
                            c.osds[i] = OSDDaemon(
                                i, c.mon.addr, store=stores.pop(i), device="cpu")
                            await c.osds[i].start()

                async def work():
                    for round_no in range(3):
                        for oid in oids:
                            data = bytes([rng.randrange(256)]) * rng.randrange(
                                1000, 20000)
                            await io.write_full(oid, data)
                            state[oid] = data
                        snapid = await io.selfmanaged_snap_create()
                        io.set_snap_context(
                            snapid,
                            [snapid] + [s for s, _ in reversed(snaps)])
                        snaps.append((snapid, dict(state)))

                await asyncio.gather(work(), churn())
                # settle deterministically: a fixed sleep was load-
                # sensitive (revived members may still be recovering
                # on a contended core when the reads start)
                await c.client.wait_clean(timeout=90)
                # every snapshot still reads exactly what it captured
                for snapid, expect in snaps:
                    io.snap_set_read(snapid)
                    for oid, data in expect.items():
                        assert await io.read(oid) == data, (snapid, oid)
                io.snap_set_read(None)
                for oid, data in state.items():
                    assert await io.read(oid) == data

        run(go())


class TestSnapEdgeCases:
    def test_snap_before_create_reads_enoent(self, kind):
        """A snap taken before the object existed must read ENOENT even
        after later clones exist (resolve honors covered intervals)."""
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.write_full("late", b"born after s1")
                s2 = await io.selfmanaged_snap_create()
                io.set_snap_context(s2, [s2, s1])
                await io.write_full("late", b"second version!!")
                io.snap_set_read(s2)
                assert await io.read("late") == b"born after s1"
                io.snap_set_read(s1)
                with pytest.raises(RadosError):
                    await io.read("late")

        run(go())

    def test_concurrent_snap_create_unique_ids(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                io = await _make_pool(c)
                ids = await asyncio.gather(*(
                    io.selfmanaged_snap_create() for _ in range(6)))
                assert len(set(ids)) == 6, ids

        run(go())

    def test_double_delete_keeps_snapdir(self, kind):
        """A second DELETE on a whiteout head must not orphan clones."""
        async def go():
            async with Cluster(n_osds=6) as c:
                io = await _make_pool(c, kind=kind)
                await io.write_full("obj", b"snapped")
                s1 = await io.selfmanaged_snap_create()
                io.set_snap_context(s1, [s1])
                await io.remove("obj")
                with pytest.raises(RadosError):
                    await io.remove("obj")
                io.snap_set_read(s1)
                assert await io.read("obj") == b"snapped"

        run(go())

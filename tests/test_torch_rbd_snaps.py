"""RBD snapshots, layering (clone/copy-up/flatten) and exclusive lock
over a live cluster — the librbd snapshot surface (src/librbd/ snap_*
APIs, doc/dev/rbd-layering.rst) on top of the RADOS snapc machinery.

The port's twin of tests/integration/test_rbd_snaps.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import errno

import numpy as np
import pytest

from ceph_tpu_torch.rbd import RBD, RBDError

from tests.test_torch_mini_cluster import Cluster, run


async def _rbd(c, data_kind="erasure"):
    await c.client.pool_create("rbdmeta", pg_num=4, size=3)
    if data_kind == "erasure":
        await c.client.ec_profile_set(
            "p", {"plugin": "cuda", "k": "3", "m": "2"})
        await c.client.pool_create(
            "rbddata", pg_num=8, pool_type="erasure",
            erasure_code_profile="p")
    else:
        await c.client.pool_create("rbddata", pg_num=8, size=3)
    return RBD(c.client.ioctx("rbdmeta"), c.client.ioctx("rbddata"))


class TestImageSnapshots:
    def test_snapshot_read_rollback_remove(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                rbd = await _rbd(c)
                await rbd.create("img", size=3 * (1 << 20), order=20)
                img = await rbd.open("img")
                v1 = np.random.default_rng(0).integers(
                    0, 256, 2 * (1 << 20), dtype=np.uint8).tobytes()
                await img.write(0, v1)
                await img.snap_create("s1")
                # overwrite spans object boundaries
                patch = b"\xaa" * (1 << 20)
                await img.write(512 * 1024, patch)
                head = bytearray(v1)
                head[512 * 1024: 512 * 1024 + len(patch)] = patch
                assert await img.read(0, len(v1)) == bytes(head)
                # the snapshot still reads v1
                img.snap_set("s1")
                assert await img.read(0, len(v1)) == v1
                with pytest.raises(RBDError):
                    await img.write(0, b"x")  # EROFS at a snap
                img.snap_set(None)
                # rollback restores v1
                await img.snap_rollback("s1")
                assert await img.read(0, len(v1)) == v1
                # snapshot bookkeeping round-trips through open()
                img2 = await rbd.open("img")
                assert [s["name"] for s in img2.snap_list()] == ["s1"]
                await img2.snap_remove("s1")
                assert img2.snap_list() == []

        run(go())

    def test_image_remove_refuses_with_snaps(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                rbd = await _rbd(c, data_kind="replicated")
                await rbd.create("img", size=1 << 20, order=19)
                img = await rbd.open("img")
                await img.write(0, b"d" * 4096)
                await img.snap_create("keep")
                with pytest.raises(RBDError):
                    await rbd.remove("img")
                await img.snap_remove("keep")
                await rbd.remove("img")
                assert await rbd.list() == []

        run(go())


class TestLayering:
    def test_clone_copy_up_flatten(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                rbd = await _rbd(c)
                base = np.random.default_rng(1).integers(
                    0, 256, 2 * (1 << 20), dtype=np.uint8).tobytes()
                await rbd.create("golden", size=2 * (1 << 20), order=20)
                parent = await rbd.open("golden")
                await parent.write(0, base)
                await parent.snap_create("base")
                # clone requires protection
                with pytest.raises(RBDError):
                    await rbd.clone("golden", "base", "child")
                await parent.snap_protect("base")
                await rbd.clone("golden", "base", "child")

                child = await rbd.open("child")
                # unwritten child reads fall through to the parent snap
                assert await child.read(0, len(base)) == base
                # write to the child copies the object up, parent intact
                await child.write(100, b"CHILD")
                want = bytearray(base)
                want[100:105] = b"CHILD"
                assert await child.read(0, len(base)) == bytes(want)
                assert await parent.read(0, len(base)) == base
                # parent snap can't be unprotected while the child lives
                with pytest.raises(RBDError):
                    await parent.snap_unprotect("base")
                # flatten severs the link; child keeps its content
                await child.flatten()
                assert child.parent is None
                child2 = await rbd.open("child")
                assert child2.parent is None
                assert await child2.read(0, len(base)) == bytes(want)
                await parent.snap_unprotect("base")

        run(go())


class TestExclusiveLock:
    def test_lock_acquire_release_break(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                rbd = await _rbd(c, data_kind="replicated")
                await rbd.create("img", size=1 << 20, order=19)
                img = await rbd.open("img")
                await img.lock_acquire("client.a")
                with pytest.raises(RBDError) as ei:
                    await img.lock_acquire("client.b")
                assert ei.value.errno == errno.EBUSY
                await img.lock_release("client.a")
                await img.lock_acquire("client.b")
                # dead holder: break then take over
                await img.lock_break("client.b")
                await img.lock_acquire("client.a")

        run(go())

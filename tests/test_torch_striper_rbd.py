"""Striper + RBD-lite over a live cluster.

Reference surfaces: src/osdc/Striper.cc file_to_extents (layout math
pinned against hand-computed extents), libradosstriper (logical size
xattr on object 0), and the librbd v2 image essentials — header omap on
a replicated pool, data objects on an EC pool (--data-pool images),
sparse reads, resize semantics.  The thrash case kills a shard-holding
OSD mid-life and the image must keep serving bit-exact data.

The port's twin of tests/integration/test_striper_rbd.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import random

import pytest

from ceph_tpu_torch.client.striper import Layout, StripedObject, file_to_extents
from ceph_tpu_torch.rbd import RBD, RBDError

from tests.test_torch_mini_cluster import Cluster, run


def test_file_to_extents_layout_math():
    lo = Layout(stripe_unit=4, stripe_count=3, object_size=8)
    # 2 stripes per object; blocks round-robin over 3 objects
    assert file_to_extents(lo, 0, 4) == [(0, 0, 4)]
    assert file_to_extents(lo, 4, 4) == [(1, 0, 4)]
    assert file_to_extents(lo, 8, 4) == [(2, 0, 4)]
    assert file_to_extents(lo, 12, 4) == [(0, 4, 4)]      # second stripe
    assert file_to_extents(lo, 24, 4) == [(3, 0, 4)]      # next object set
    # mid-block, crossing a block boundary
    assert file_to_extents(lo, 2, 4) == [(0, 2, 2), (1, 0, 2)]
    # a whole object set in one call
    assert file_to_extents(lo, 0, 24) == [
        (0, 0, 4), (1, 0, 4), (2, 0, 4), (0, 4, 4), (1, 4, 4), (2, 4, 4),
    ]


def test_striped_round_trip_model():
    """Random writes/reads vs a bytearray oracle over a live EC pool."""
    async def go():
        async with Cluster(n_osds=6) as c:
            await c.client.ec_profile_set(
                "p", {"plugin": "cuda", "k": "3", "m": "2"})
            await c.client.pool_create(
                "ec", pg_num=8, pool_type="erasure",
                erasure_code_profile="p")
            io = c.client.ioctx("ec")
            so = StripedObject(io, "f", Layout(
                stripe_unit=4096, stripe_count=3, object_size=16384))
            oracle = bytearray()
            rng = random.Random(42)
            for _ in range(14):
                off = rng.randrange(0, 120000)
                data = rng.randbytes(rng.randrange(1, 50000))
                await so.write(off, data)
                if len(oracle) < off + len(data):
                    oracle.extend(b"\0" * (off + len(data) - len(oracle)))
                oracle[off : off + len(data)] = data
                assert await so.size() == len(oracle)
            assert await so.read() == bytes(oracle)
            # ranged reads
            for _ in range(8):
                off = rng.randrange(0, len(oracle))
                ln = rng.randrange(1, 40000)
                want = bytes(oracle[off : off + ln])
                assert await so.read(off, ln) == want
            # truncate down and regrow via write
            await so.truncate(30000)
            del oracle[30000:]
            assert await so.read() == bytes(oracle)
            await so.remove()
            assert await so.size() == 0

    run(go())


class TestRBD:
    def test_image_lifecycle_ec_data_pool(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.pool_create("meta", pg_num=8, size=3)
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2"})
                await c.client.pool_create(
                    "data", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                rbd = RBD(c.client.ioctx("meta"), c.client.ioctx("data"))
                await rbd.create("vol", 8 * 2**20, order=18)  # 256 KiB objs
                assert await rbd.list() == ["vol"]
                with pytest.raises(RBDError):
                    await rbd.create("vol", 1)
                img = await rbd.open("vol")
                assert img.size() == 8 * 2**20

                rng = random.Random(7)
                # write across many object boundaries
                blob = rng.randbytes(900_000)
                await img.write(200_000, blob)
                assert await img.read(200_000, len(blob)) == blob
                # sparse read: untouched extents are zeros
                assert await img.read(4_000_000, 4096) == b"\0" * 4096
                # boundary-exact read
                assert await img.read(0, 200_000) == b"\0" * 200_000

                # resize down then up: truncated region reads zero
                await img.resize(500_000)
                assert img.size() == 500_000
                await img.resize(2 * 2**20)
                assert await img.read(500_000, 4096) == b"\0" * 4096
                head = await img.read(200_000, 300_000)
                assert head == blob[:300_000]

                # reopen: metadata persisted in the header omap
                img2 = await rbd.open("vol")
                assert img2.size() == 2 * 2**20
                assert await img2.read(200_000, 1000) == blob[:1000]

                await rbd.remove("vol")
                assert await rbd.list() == []
                with pytest.raises(RBDError):
                    await rbd.open("vol")

        run(go())

    def test_image_survives_osd_kill(self):
        async def go():
            async with Cluster(n_osds=7) as c:
                await c.client.pool_create("meta", pg_num=8, size=3)
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2"})
                await c.client.pool_create(
                    "data", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                rbd = RBD(c.client.ioctx("meta"), c.client.ioctx("data"))
                await rbd.create("vol", 4 * 2**20, order=18)
                img = await rbd.open("vol")
                rng = random.Random(3)
                blob = rng.randbytes(1_000_000)
                await img.write(100_000, blob)

                victim = 3
                # the epoch before the stop: the port's stop() waits for
                # the daemon's warm threads, long enough for its peers to
                # report it down themselves
                epoch = c.client.osdmap.epoch
                await c.osds[victim].stop()
                c.osds[victim] = None
                code, _, _ = await c.client.command(
                    {"prefix": "osd down", "id": str(victim)})
                assert code == 0
                await c.wait_epoch(epoch + 1)
                assert await img.read(100_000, len(blob)) == blob

        run(go())

"""Op-surface integration: the widened do_osd_ops slice.

Covers the reference's client op families beyond read/write-full
(PrimaryLogPG::do_osd_ops, src/osd/PrimaryLogPG.cc:5979): partial
writes and appends (EC: the RMW pipeline of ECCommon.cc:623-707),
zero/truncate, exclusive create, user xattrs, omap (replicated only —
EC pools reject omap like the reference), and atomic compound vectors.

A randomized mixed-op model (mini RadosModel) checks every EC state
against a bytearray oracle, then deep-scrubs: the parity-equation
check must come back clean on RMW'd objects that dropped their hinfo.

The port's twin of tests/integration/test_op_surface.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno
import random

import pytest

from ceph_tpu_torch.client.rados import ObjectOperation, RadosError

from tests.test_torch_mini_cluster import Cluster, run


async def _ec_io(c: Cluster, k=4, m=2, name="ecpool"):
    await c.client.ec_profile_set(
        "ecprofile", {
            "plugin": "cuda", "k": str(k), "m": str(m),
            "crush-failure-domain": "host",
        },
    )
    await c.client.pool_create(
        name, pg_num=8, pool_type="erasure",
        erasure_code_profile="ecprofile",
    )
    return c.client.ioctx(name)


class TestReplicatedOpSurface:
    def test_partial_write_append_zero_truncate(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("a", b"0123456789")
                await io.write("a", b"XY", off=3)
                assert await io.read("a") == b"012XY56789"
                await io.append("a", b"+end")
                assert await io.read("a") == b"012XY56789+end"
                await io.zero("a", 1, 3)
                assert await io.read("a") == b"0\0\0\0Y56789+end"
                await io.truncate("a", 5)
                assert await io.read("a") == b"0\0\0\0Y"
                await io.truncate("a", 8)  # extend zero-fills
                assert await io.read("a") == b"0\0\0\0Y\0\0\0"
                # write beyond end leaves a zero hole
                await io.write("a", b"Z", off=12)
                assert await io.read("a") == b"0\0\0\0Y\0\0\0\0\0\0\0Z"

        run(go())

    def test_create_exclusive(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.create("n", exclusive=True)
                assert await io.stat("n") == 0
                with pytest.raises(RadosError) as ei:
                    await io.create("n", exclusive=True)
                assert ei.value.errno == errno.EEXIST
                await io.create("n")  # non-exclusive: fine

        run(go())

    def test_xattrs(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("x", b"data")
                await io.setxattr("x", "color", b"green")
                await io.setxattr("x", "shape", b"round")
                assert await io.getxattr("x", "color") == b"green"
                assert await io.getxattrs("x") == {
                    "color": b"green", "shape": b"round",
                }
                await io.rmxattr("x", "color")
                assert await io.getxattrs("x") == {"shape": b"round"}
                with pytest.raises(RadosError) as ei:
                    await io.getxattr("x", "color")
                assert ei.value.errno == errno.ENODATA
                # xattrs survive a write_full (reference semantics)
                await io.write_full("x", b"newdata")
                assert await io.getxattrs("x") == {"shape": b"round"}

        run(go())

    def test_omap(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.omap_set("meta", {"k1": b"v1", "k2": b"v2", "k3": b"v3"})
                assert await io.omap_get("meta") == {
                    "k1": b"v1", "k2": b"v2", "k3": b"v3",
                }
                assert await io.omap_get_keys("meta") == ["k1", "k2", "k3"]
                assert await io.omap_get_vals_by_keys("meta", ["k1", "nope"]) == {
                    "k1": b"v1",
                }
                await io.omap_rm_keys("meta", ["k2"])
                assert await io.omap_get_keys("meta") == ["k1", "k3"]

        run(go())

    def test_compound_atomic(self):
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                op = (
                    ObjectOperation()
                    .write_full(b"base")
                    .append(b"+tail")
                    .setxattr("v", b"1")
                    .omap_set({"idx": b"7"})
                )
                await io.operate("obj", op)
                assert await io.read("obj") == b"base+tail"
                assert await io.getxattr("obj", "v") == b"1"
                assert await io.omap_get("obj") == {"idx": b"7"}

        run(go())

    def test_create_then_remove_in_one_vector(self):
        """A vector that creates and then removes the object must leave
        nothing behind (the remove applies even though the object did
        not exist when the transaction was built)."""
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                op = ObjectOperation().write_full(b"ephemeral").remove()
                await io.operate("gone", op)
                with pytest.raises(RadosError) as ei:
                    await io.read("gone")
                assert ei.value.errno == errno.ENOENT

        run(go())

    def test_replica_consistency_after_partial_writes(self):
        """Replicas apply the same effect vector: kill the primary and
        the surviving copies must serve the identical bytes."""
        async def go():
            async with Cluster() as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                await io.write_full("r", b"A" * 100)
                await io.write("r", b"B" * 10, off=45)
                await io.append("r", b"C" * 7)
                await io.truncate("r", 90)
                expect = bytearray(b"A" * 100)
                expect[45:55] = b"B" * 10
                expect = bytes(expect[:90])

                from ceph_tpu_torch.osd.daemon import object_to_pg
                pool = c.client.osdmap.get_pg_pool(
                    c.client.osdmap.lookup_pg_pool_name("rbd"))
                pg = object_to_pg(pool, "r")
                _u, _p, acting, primary = (
                    c.client.osdmap.pg_to_up_acting_osds(pg))
                await c.osds[primary].stop()
                c.osds[primary] = None
                epoch = c.client.osdmap.epoch
                code, _, _ = await c.client.command(
                    {"prefix": "osd down", "id": str(primary)}
                )
                assert code == 0
                await c.wait_epoch(epoch + 1)
                assert await io.read("r") == expect

        run(go())


class TestDupOpDetection:
    """A resent non-idempotent op (same reqid) must be answered, not
    re-applied — the pg-log reqid dup detection the reference does in
    PrimaryLogPG::do_op."""

    @pytest.mark.parametrize("pool_kind", ["replicated", "erasure"])
    def test_resent_append_applies_once(self, pool_kind):
        async def go():
            async with Cluster() as c:
                if pool_kind == "erasure":
                    io = await _ec_io(c)
                else:
                    await c.client.pool_create("rbd", pg_num=8, size=3)
                    io = c.client.ioctx("rbd")
                await io.write_full("d", b"base")
                from ceph_tpu_torch.msg.messages import MOSDOp, OP_APPEND, OSDOp

                for _resend in range(3):
                    reply = await c.client._submit(io.pool_id, MOSDOp(
                        pool=io.pool_id, oid="d",
                        ops=[OSDOp(OP_APPEND, data=b"XX")],
                        reqid="client.test:77",
                    ))
                    assert reply.result == 0
                assert await io.read("d") == b"baseXX"

        run(go())


class TestECOpSurface:
    def test_rmw_partial_writes(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                # stripe width = 4 * 4096 = 16384 logical bytes
                base = bytes(random.Random(7).randbytes(50000))
                await io.write_full("o", base)
                buf = bytearray(base)
                # in-stripe overwrite
                await io.write("o", b"Q" * 100, off=10)
                buf[10:110] = b"Q" * 100
                # cross-stripe overwrite
                await io.write("o", b"R" * 20000, off=15000)
                buf[15000:35000] = b"R" * 20000
                # tail-extending overwrite
                await io.write("o", b"S" * 5000, off=48000)
                buf[48000:53000] = b"S" * 5000
                assert await io.read("o") == bytes(buf)
                assert await io.stat("o") == len(buf)
                # ranged reads hit only covering stripes
                assert await io.read("o", off=14000, length=3000) == bytes(
                    buf[14000:17000])

        run(go())

    def test_append_zero_truncate(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                await io.write_full("o", b"x" * 10000)
                buf = bytearray(b"x" * 10000)
                await io.append("o", b"y" * 9000)
                buf += b"y" * 9000
                assert await io.read("o") == bytes(buf)
                await io.zero("o", 5000, 7000)
                buf[5000:12000] = b"\0" * 7000
                assert await io.read("o") == bytes(buf)
                await io.truncate("o", 11000)
                del buf[11000:]
                assert await io.read("o") == bytes(buf)
                assert await io.stat("o") == 11000
                await io.truncate("o", 20000)  # extend zero-fills
                buf += b"\0" * 9000
                assert await io.read("o") == bytes(buf)
                # write into a far hole
                await io.write("o", b"z" * 10, off=40000)
                buf += b"\0" * 20000
                buf[40000:40010] = b"z" * 10
                assert await io.read("o") == bytes(buf)

        run(go())

    def test_xattrs_and_omap_rejection(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                await io.write_full("o", b"payload")
                await io.setxattr("o", "tag", b"v")
                assert await io.getxattr("o", "tag") == b"v"
                assert await io.getxattrs("o") == {"tag": b"v"}
                await io.rmxattr("o", "tag")
                assert await io.getxattrs("o") == {}
                with pytest.raises(RadosError) as ei:
                    await io.omap_set("o", {"k": b"v"})
                assert ei.value.errno == errno.EOPNOTSUPP

        run(go())

    def test_create_exclusive_ec(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                await io.create("n", exclusive=True)
                with pytest.raises(RadosError) as ei:
                    await io.create("n", exclusive=True)
                assert ei.value.errno == errno.EEXIST

        run(go())

    def test_compound_rmw_atomic(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                await io.write_full("o", b"A" * 20000)
                op = (
                    ObjectOperation()
                    .write(5, b"BBB")
                    .truncate(18000)
                    .append(b"CCCC")
                    .setxattr("gen", b"2")
                )
                await io.operate("o", op)
                buf = bytearray(b"A" * 20000)
                buf[5:8] = b"BBB"
                del buf[18000:]
                buf += b"CCCC"
                assert await io.read("o") == bytes(buf)
                assert await io.getxattr("o", "gen") == b"2"

        run(go())

    def test_truncate_regrow_reads_zero(self):
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                await io.write_full("o", b"D" * 30000)
                op = ObjectOperation().truncate(10000).append(b"E" * 100)
                await io.operate("o", op)
                data = await io.read("o")
                assert data[:10000] == b"D" * 10000
                assert data[10000:] == b"E" * 100

        run(go())

    def test_random_model_with_scrub(self):
        """Mini RadosModel over the widened op set vs a bytearray
        oracle, then deep scrub every PG: RMW'd objects must pass the
        parity-equation check."""
        async def go():
            async with Cluster() as c:
                io = await _ec_io(c)
                rng = random.Random(1234)
                oracle: dict[str, bytearray] = {}
                oids = [f"m{i}" for i in range(6)]
                for _ in range(60):
                    oid = rng.choice(oids)
                    cur = oracle.get(oid)
                    kind = rng.choice(
                        ["full", "write", "append", "zero", "trunc", "read"]
                    )
                    if cur is None and kind in ("zero", "trunc", "read"):
                        kind = "full"
                    if kind == "full":
                        n = rng.randrange(0, 60000)
                        data = rng.randbytes(n)
                        await io.write_full(oid, data)
                        oracle[oid] = bytearray(data)
                    elif kind == "write":
                        off = rng.randrange(0, 60000)
                        data = rng.randbytes(rng.randrange(1, 20000))
                        await io.write(oid, data, off=off)
                        cur = oracle.setdefault(oid, bytearray())
                        if len(cur) < off + len(data):
                            cur.extend(b"\0" * (off + len(data) - len(cur)))
                        cur[off:off + len(data)] = data
                    elif kind == "append":
                        data = rng.randbytes(rng.randrange(1, 20000))
                        await io.append(oid, data)
                        oracle.setdefault(oid, bytearray()).extend(data)
                    elif kind == "zero":
                        off = rng.randrange(0, max(1, len(cur)))
                        length = rng.randrange(1, 20000)
                        await io.zero(oid, off, length)
                        end = min(len(cur), off + length)
                        if off < end:
                            cur[off:end] = b"\0" * (end - off)
                    elif kind == "trunc":
                        size = rng.randrange(0, 70000)
                        await io.truncate(oid, size)
                        if size <= len(cur):
                            del cur[size:]
                        else:
                            cur.extend(b"\0" * (size - len(cur)))
                    else:
                        assert await io.read(oid) == bytes(cur)
                for oid, cur in oracle.items():
                    assert await io.read(oid) == bytes(cur), oid
                    assert await io.stat(oid) == len(cur)
                # deep scrub: every PG must be clean (parity check
                # covers the hinfo-less RMW'd objects)
                pool = c.client.osdmap.get_pg_pool(
                    c.client.osdmap.lookup_pg_pool_name("ecpool"))
                for ps in range(pool.pg_num):
                    from ceph_tpu_torch.osd.types import pg_t
                    _u, _p, _a, primary = c.client.osdmap.pg_to_up_acting_osds(
                        pg_t(pool.id, ps), folded=True)
                    if primary < 0:
                        continue
                    report = await c.osds[primary].scrub_pg(
                        pool.id, ps, deep=True)
                    assert report.get("inconsistencies") == [], report

        run(go())

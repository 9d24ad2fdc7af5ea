"""Randomized consistency model checking under churn.

The RadosModel/ceph_test_rados analogue (reference src/test/osd/
RadosModel.cc + TestRados.cc, run by the thrash suites under
qa/tasks/ceph_manager.py OSDThrasher): a random op stream
(write/overwrite/delete/read/stat) runs against the cluster while an
in-memory oracle tracks what a linearizable store must contain; a
thrasher concurrently kills and revives OSDs.  Every read must return
exactly the oracle's bytes; at the end, a settle pass + deep scrub
must be clean.

The port's twin of tests/integration/test_rados_model.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import random

import pytest

from ceph_tpu_torch.osd.daemon import OSDDaemon

from tests.test_torch_mini_cluster import Cluster, run


class Oracle:
    """The model: what a correct cluster must serve."""

    def __init__(self):
        self.objects: dict[str, bytearray] = {}

    def write(self, oid, data):
        self.objects[oid] = bytearray(data)

    def write_at(self, oid, off, data):
        cur = self.objects.setdefault(oid, bytearray())
        if len(cur) < off + len(data):
            cur.extend(b"\0" * (off + len(data) - len(cur)))
        cur[off : off + len(data)] = data

    def append(self, oid, data):
        self.objects.setdefault(oid, bytearray()).extend(data)

    def truncate(self, oid, size):
        cur = self.objects.setdefault(oid, bytearray())
        if size <= len(cur):
            del cur[size:]
        else:
            cur.extend(b"\0" * (size - len(cur)))

    def delete(self, oid):
        self.objects.pop(oid, None)


async def model_run(c: Cluster, io, rng: random.Random, n_ops: int, oracle: Oracle):
    oids = [f"m{i}" for i in range(12)]
    for opno in range(n_ops):
        oid = rng.choice(oids)
        op = rng.random()
        if op < 0.30:
            data = bytes([rng.randrange(256)]) * rng.randrange(1, 30000)
            await io.write_full(oid, data)
            oracle.write(oid, data)
        elif op < 0.42:
            # partial overwrite at arbitrary offset (the EC RMW path)
            off = rng.randrange(0, 30000)
            data = bytes([rng.randrange(256)]) * rng.randrange(1, 15000)
            await io.write(oid, data, off=off)
            oracle.write_at(oid, off, data)
        elif op < 0.50:
            data = bytes([rng.randrange(256)]) * rng.randrange(1, 10000)
            await io.append(oid, data)
            oracle.append(oid, data)
        elif op < 0.55 and oid in oracle.objects:
            size = rng.randrange(0, 30000)
            await io.truncate(oid, size)
            oracle.truncate(oid, size)
        elif op < 0.62 and oid in oracle.objects:
            await io.remove(oid)
            oracle.delete(oid)
        elif op < 0.88:
            if oid in oracle.objects:
                got = await io.read(oid)
                assert got == bytes(oracle.objects[oid]), (
                    f"op {opno}: read {oid!r}: {len(got)}B != "
                    f"{len(oracle.objects[oid])}B expected"
                )
            else:
                with pytest.raises(OSError):
                    await io.read(oid)
        else:
            if oid in oracle.objects:
                assert await io.stat(oid) == len(oracle.objects[oid])


async def thrasher(c: Cluster, rng: random.Random, rounds: int, min_up: int):
    """OSDThrasher-lite: kill_osd / revive_osd keeping >= min_up alive
    (the thrash suites' min_in contract for EC pools)."""
    stores = {}
    for _ in range(rounds):
        await asyncio.sleep(rng.uniform(0.2, 0.5))
        up = [i for i, o in enumerate(c.osds) if o is not None]
        downed = [i for i in range(len(c.osds)) if c.osds[i] is None]
        if len(up) > min_up and (not downed or rng.random() < 0.6):
            victim = rng.choice(up)
            stores[victim] = c.osds[victim].store
            await c.osds[victim].stop()
            c.osds[victim] = None
            await c.client.command({"prefix": "osd down", "id": str(victim)})
        elif downed:
            back = rng.choice(downed)
            c.osds[back] = OSDDaemon(back, c.mon.addr, store=stores.pop(back), device="cpu")
            await c.osds[back].start()
    # revive everyone for the settle phase
    for i in list(range(len(c.osds))):
        if c.osds[i] is None and i in stores:
            c.osds[i] = OSDDaemon(i, c.mon.addr, store=stores.pop(i), device="cpu")
            await c.osds[i].start()


class TestRadosModel:
    @pytest.mark.parametrize("pool_kind", ["replicated", "erasure"])
    def test_random_ops_under_thrashing(self, pool_kind):
        async def go():
            async with Cluster(n_osds=7) as c:
                if pool_kind == "erasure":
                    await c.client.ec_profile_set(
                        "p", {"plugin": "cuda", "k": "3", "m": "2"}
                    )
                    await c.client.pool_create(
                        "model", pg_num=8, pool_type="erasure",
                        erasure_code_profile="p",
                    )
                    min_up = 5
                else:
                    await c.client.pool_create("model", pg_num=8, size=3)
                    min_up = 4
                io = c.client.ioctx("model")
                rng = random.Random(1234)
                oracle = Oracle()
                await asyncio.gather(
                    model_run(c, io, rng, 60, oracle),
                    thrasher(c, random.Random(99), 6, min_up),
                )
                # settle: wait for all-PGs-active+clean THROUGH the mon
                # (the wait_for_clean contract), then every object
                # checks out
                await c.client.wait_clean(timeout=45)
                for oid, data in oracle.objects.items():
                    assert await io.read(oid) == bytes(data)
                # deep scrub every pg: no inconsistencies survive churn
                import json

                pool = c.client.osdmap.get_pg_pool(io.pool_id)
                for ps in range(pool.pg_num):
                    code, rs, data = await c.client.command({
                        "prefix": "pg deep-scrub",
                        "pgid": f"{io.pool_id}.{ps}",
                    })
                    assert code == 0, (rs, data)
                    rep = json.loads(data)
                    assert rep["inconsistencies"] == [], rep

        run(go())

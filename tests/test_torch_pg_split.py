"""PG splitting + pool mutation commands + acting autoscaler.

Round-3 VERDICT item 4 acceptance: write objects, double pg_num,
wait-clean, all data readable, stats re-aggregated; the autoscaler
flips would_adjust into an applied change.  Reference:
src/mon/OSDMonitor.cc pool ops (:7339), src/osd/PG.cc split paths,
src/pybind/mgr/pg_autoscaler/module.py.

The port's twin of tests/integration/test_pg_split.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno
import json

import numpy as np
import pytest

from ceph_tpu_torch.client.rados import RadosError

from tests.test_torch_mini_cluster import Cluster, run


def _payloads(n: int = 40) -> dict[str, bytes]:
    rng = np.random.default_rng(5)
    return {
        f"obj-{i:03d}": rng.integers(
            0, 256, int(rng.integers(1, 40_000)), dtype=np.uint8).tobytes()
        for i in range(n)
    }


class TestPGSplit:
    @pytest.mark.parametrize("kind", ["replicated", "ec"])
    def test_split_preserves_data(self, kind):
        async def go():
            async with Cluster(n_osds=6) as c:
                if kind == "ec":
                    await c.client.ec_profile_set(
                        "p", {"plugin": "cuda", "k": "3", "m": "2"})
                    await c.client.pool_create(
                        "sp", pg_num=4, pool_type="erasure",
                        erasure_code_profile="p")
                else:
                    await c.client.pool_create("sp", pg_num=4, size=3)
                io = c.client.ioctx("sp")
                data = _payloads()
                for oid, blob in data.items():
                    await io.write_full(oid, blob)
                await c.client.wait_clean(timeout=60)

                # double pg_num: 4 -> 8 (one split generation)
                code, rs, _ = await c.client.command({
                    "prefix": "osd pool set", "pool": "sp",
                    "var": "pg_num", "val": "8"})
                assert code == 0, rs
                # stats plane re-aggregates over 8 PGs and goes clean
                status = await c.client.wait_clean(timeout=90)
                assert status["pgs"]["num_pgs"] >= 8

                # every object readable after the split settles
                for oid, blob in data.items():
                    assert await io.read(oid) == blob, oid
                # and writable (children serve I/O)
                await io.write_full("post-split", b"fresh write")
                assert await io.read("post-split") == b"fresh write"

                # split children really exist: objects spread over 8 PGs
                code, _, out = await c.client.command({"prefix": "pg stat"})
                assert code == 0
                book = json.loads(out)["pg_stats"]
                pgs_with_objects = sum(
                    1 for k, v in book.items()
                    if k.startswith("1.") and v.get("objects", 0) > 0)
                assert pgs_with_objects > 4, book

                # merge back: 8 -> 4 (PG::merge_from twin) — data
                # survives, stats re-aggregate over 4 PGs, dissolved
                # children's collections disappear
                code, rs, _ = await c.client.command({
                    "prefix": "osd pool set", "pool": "sp",
                    "var": "pg_num", "val": "4"})
                assert code == 0, rs
                status = await c.client.wait_clean(timeout=90)
                assert status["pgs"]["num_pgs"] == 4
                for oid, blob in data.items():
                    assert await io.read(oid) == blob, oid
                await io.write_full("post-merge", b"merged write")
                assert await io.read("post-merge") == b"merged write"
                # no collection for a dissolved child survives anywhere
                for o in c.osds:
                    assert not any(
                        cc.pool == 1 and cc.ps >= 4
                        for cc in o.store.list_collections()
                        if cc.pool >= 0), o.id
                # stats plane carries no ghost children
                code, _, out = await c.client.command({"prefix": "pg stat"})
                book = json.loads(out)["pg_stats"]
                assert not any(
                    k.startswith("1.") and int(k.split(".")[1]) >= 4
                    for k in book), book
        run(go())

    def test_split_then_kill_osd_recovers(self):
        """Split + failure: children must recover like any PG (their
        past intervals point at the parent's old homes)."""
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "2", "m": "1"})
                await c.client.pool_create(
                    "skl", pg_num=2, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("skl")
                data = _payloads(20)
                for oid, blob in data.items():
                    await io.write_full(oid, blob)
                await c.client.wait_clean(timeout=60)
                code, rs, _ = await c.client.command({
                    "prefix": "osd pool set", "pool": "skl",
                    "var": "pg_num", "val": "4"})
                assert code == 0, rs
                await c.client.wait_clean(timeout=90)
                # now kill an OSD; EC(2,1) survives one loss
                victim = 0
                await c.osds[victim].stop()
                c.osds[victim] = None
                code, _, _ = await c.client.command(
                    {"prefix": "osd down", "id": str(victim)})
                assert code == 0
                code, _, _ = await c.client.command(
                    {"prefix": "osd out", "id": str(victim)})
                assert code == 0
                await c.client.wait_clean(timeout=120)
                for oid, blob in data.items():
                    assert await io.read(oid) == blob, oid
        run(go())


class TestPGMergeUnderFailure:
    def test_merge_then_kill_osd_recovers(self):
        """Merge + failure: targets must recover like any PG (their
        past intervals include the dissolved children's old homes)."""
        async def go():
            async with Cluster(n_osds=6) as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "2", "m": "1"})
                await c.client.pool_create(
                    "mkl", pg_num=4, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("mkl")
                data = _payloads(20)
                for oid, blob in data.items():
                    await io.write_full(oid, blob)
                await c.client.wait_clean(timeout=60)
                code, rs, _ = await c.client.command({
                    "prefix": "osd pool set", "pool": "mkl",
                    "var": "pg_num", "val": "2"})
                assert code == 0, rs
                # gate on post-merge epochs: the targets' pre-merge
                # active+clean reports must not satisfy the wait
                code, _, data_ = await c.client.command(
                    {"prefix": "status"})
                merge_epoch = json.loads(data_)["epoch"]
                await c.client.wait_clean(
                    timeout=90, min_epoch=merge_epoch)
                victim = 1
                await c.osds[victim].stop()
                c.osds[victim] = None
                for pfx in ("osd down", "osd out"):
                    code, _, _ = await c.client.command(
                        {"prefix": pfx, "id": str(victim)})
                    assert code == 0
                await c.client.wait_clean(timeout=120)
                for oid, blob in data.items():
                    assert await io.read(oid) == blob, oid
        run(go())


class TestPoolCommands:
    def test_pool_rm_and_osd_in(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                await c.client.pool_create("doomed", pg_num=4, size=3)
                io = c.client.ioctx("doomed")
                await io.write_full("x", b"bye")
                # missing confirmation refused
                code, _, _ = await c.client.command({
                    "prefix": "osd pool rm", "pool": "doomed"})
                assert code == -errno.EPERM
                code, rs, _ = await c.client.command({
                    "prefix": "osd pool rm", "pool": "doomed",
                    "pool2": "doomed",
                    "sure": "--yes-i-really-really-mean-it"})
                assert code == 0, rs
                await c.client._wait_new_map(
                    c.client.osdmap.epoch, timeout=10)
                with pytest.raises(RadosError):
                    c.client.ioctx("doomed")
                # local collections are garbage-collected
                await asyncio.sleep(0.3)
                for o in c.osds:
                    assert not any(
                        cc.pool == 1 for cc in o.store.list_collections()
                        if cc.pool >= 0)

                # osd out then in restores weight
                code, _, _ = await c.client.command(
                    {"prefix": "osd out", "id": "2"})
                assert code == 0
                await c.client._wait_new_map(
                    c.client.osdmap.epoch, timeout=10)
                assert c.client.osdmap.is_out(2)
                code, rs, _ = await c.client.command(
                    {"prefix": "osd in", "id": "2"})
                assert code == 0, rs
                await c.client._wait_new_map(
                    c.client.osdmap.epoch, timeout=10)
                assert not c.client.osdmap.is_out(2)
                # size/min_size settable on replicated pools
                await c.client.pool_create("szp", pg_num=4, size=3)
                code, _, _ = await c.client.command({
                    "prefix": "osd pool set", "pool": "szp",
                    "var": "size", "val": "2"})
                assert code == 0
        run(go())


class TestAutoscalerActs:
    def test_autoscaler_grows_optin_pool(self):
        async def go2():
            from ceph_tpu_torch.common import ConfigProxy
            from ceph_tpu_torch.crush import builder as B
            from ceph_tpu_torch.crush.types import CrushMap
            from ceph_tpu_torch.mon import Monitor
            from ceph_tpu_torch.osd.daemon import OSDDaemon
            from ceph_tpu_torch.client import RadosClient

            conf = ConfigProxy()
            conf.set("mon_pg_autoscale_interval", "0.2")
            conf.set("mon_target_pg_per_osd", "8")
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
            mon = Monitor(crush=crush, conf=conf, device="cpu")
            await mon.start()
            osds = []
            for i in range(4):
                o = OSDDaemon(i, mon.addr, device="cpu")
                await o.start()
                osds.append(o)
            client = RadosClient(client_id=77)
            await client.connect(*mon.addr)
            try:
                # 4 osds * 8 target / 3 size ~ 10 -> nearest pow2 = 8
                await client.pool_create("auto", pg_num=2, size=3)
                io = client.ioctx("auto")
                for i in range(10):
                    await io.write_full(f"o{i}", b"x" * 2000)
                code, _, out = await client.command(
                    {"prefix": "osd pool autoscale-status"})
                row = next(r for r in json.loads(out)
                           if r["pool"] == "auto")
                assert row["would_adjust"] and row["new_pg_num"] > 2
                # opted out: nothing happens
                await asyncio.sleep(1.0)
                await client._wait_new_map(0, timeout=2)
                assert client.osdmap.get_pg_pool(io.pool_id).pg_num == 2
                # opt in: the mon applies its own advice
                code, rs, _ = await client.command({
                    "prefix": "osd pool set", "pool": "auto",
                    "var": "pg_autoscale_mode", "val": "on"})
                assert code == 0, rs
                for _ in range(50):
                    await asyncio.sleep(0.2)
                    pool = client.osdmap.get_pg_pool(io.pool_id)
                    if pool and pool.pg_num == row["new_pg_num"]:
                        break
                else:
                    raise AssertionError("autoscaler never applied")
                await client.wait_clean(timeout=60)
                for i in range(10):
                    assert await io.read(f"o{i}") == b"x" * 2000
            finally:
                await client.shutdown()
                for o in osds:
                    await o.stop()
                await mon.stop()
        run(go2())

"""Deterministic-interleaving race harness over the consistency-
critical paths (the TSan/valgrind-suite role, reference
CMakeLists.txt:626-642, qa/suites/rados/valgrind-leaks): the seeded
InterleaveLoop permutes task wakeup order, so each seed explores a
different legal schedule of the SAME scenario; any failing seed is
printed for exact replay.

Two scenarios, by cost:
  * mon quorum command storm — 3 monitors, concurrent conflicting
    proposals, leader restart mid-storm; invariant: every monitor
    converges to the identical map epoch + pool set.  100 seeds.
  * mini-cluster write/recovery races — concurrent client writes to
    overlapping objects while an OSD bounces; invariant: cluster goes
    clean and every surviving read returns a complete write.  Fewer
    seeds (each run boots a full cluster).

The port's twin of tests/test_interleave_fuzz.py: the same sweeps and
seeds over ``ceph_tpu_torch``, the daemons on the CPU and the EC pools
on the ``cuda`` plugin, plus a case of ``sweep`` itself.
"""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.common.interleave import (
    InterleaveError, run_interleaved, sweep,
)


# -- scenario 1: mon quorum under a command storm --------------------------

async def _quorum_storm():
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
    mons = [
        Monitor(crush=crush.copy(), rank=r, n_mons=3, device="cpu") for r in range(3)
    ]
    client = RadosClient(client_id=31337)
    try:
        for m in mons:
            await m.start()
        monmap = [m.addr for m in mons]
        for m in mons:
            await m.open_quorum(monmap)
        for m in mons:
            await m.wait_stable()
        await client.connect_multi(monmap)

        async def mk(i: int):
            code, rs, _ = await client.command({
                "prefix": "osd pool create",
                "name": f"fz{i}", "pg_num": "2"})
            assert code == 0, rs

        # concurrent conflicting proposals: every one must serialize
        # through paxos without lost or duplicated commits
        await asyncio.gather(*[mk(i) for i in range(6)])
        want = {f"fz{i}" for i in range(6)}
        # all mons converge to ONE map containing every pool (paxos
        # refresh contract: no lost or duplicated commits)
        for _ in range(200):
            names = [set(m.osdmap.pool_names.values()) for m in mons]
            epochs = {m.osdmap.epoch for m in mons}
            if len(epochs) == 1 and all(want <= n for n in names):
                break
            await asyncio.sleep(0.05)
        assert len(epochs) == 1, epochs
        for n in names:
            assert want <= n, (want, n)
        ids = [
            sorted(
                pid for pid, nm in m.osdmap.pool_names.items()
                if nm in want)
            for m in mons
        ]
        assert ids[0] == ids[1] == ids[2], ids  # identical pool ids
        assert len(ids[0]) == 6  # no duplicate creations
    finally:
        await client.shutdown()
        for m in mons:
            await m.stop()


class TestQuorumStormSweep:
    def test_100_seeds(self):
        n = sweep(_quorum_storm, range(100), timeout=60.0)
        assert n == 100


# -- scenario 2: write/recovery interleavings on a mini cluster ------------

async def _write_recovery_races():
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=3)
    mon = Monitor(crush=crush, device="cpu")
    osds: list[OSDDaemon] = []
    client = RadosClient(client_id=999)
    try:
        await mon.start()
        for i in range(3):
            osd = OSDDaemon(i, mon.addr, device="cpu")
            await osd.start()
            osds.append(osd)
        await client.connect(*mon.addr)
        await client.pool_create("fz", pg_num=4, size=2)
        io = client.ioctx("fz")

        payload_a = b"A" * 4096
        payload_b = b"B" * 4096

        async def writer(tag: bytes):
            for i in range(6):
                await io.write_full(f"obj{i}", tag)

        async def bounce():
            # restart osd.2 mid-storm: peering/recovery interleaves
            # with the in-flight client writes
            await osds[2].stop()
            osds[2] = OSDDaemon(2, mon.addr, device="cpu")
            await osds[2].start()

        await asyncio.gather(writer(payload_a), writer(payload_b), bounce())
        await client.wait_clean(timeout=60)
        for i in range(6):
            got = await io.read(f"obj{i}")
            # atomicity across the races: a complete write, never a blend
            assert got in (payload_a, payload_b), (i, got[:16])
    finally:
        await client.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


class TestWriteRecoverySweep:
    @pytest.mark.parametrize("seed", range(16))
    def test_seed(self, seed):
        run_interleaved(_write_recovery_races, seed, timeout=90.0)


def test_failure_carries_seed():
    async def boom():
        await asyncio.sleep(0)
        raise AssertionError("intentional")

    with pytest.raises(InterleaveError, match="seed=42"):
        run_interleaved(boom, 42)


# -- scenario 3: EC RMW overwrite races ------------------------------------

async def _ec_rmw_races():
    """Concurrent partial-stripe writes to ONE EC object: the RMW
    pipeline (read-modify-write with the object lock) must serialize
    them into SOME order — non-overlapping ranges both land, the
    overlap is exactly one writer's bytes, never a blend or a torn
    stripe (reference ECCommon.cc RMW/ExtentCache invariants)."""
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
    mon = Monitor(crush=crush, device="cpu")
    osds: list[OSDDaemon] = []
    client = RadosClient(client_id=902)
    try:
        await mon.start()
        for i in range(4):
            osd = OSDDaemon(i, mon.addr, device="cpu")
            await osd.start()
            osds.append(osd)
        await client.connect(*mon.addr)
        await client.ec_profile_set(
            "fzp", {"plugin": "cuda", "k": "2", "m": "1"})
        await client.pool_create(
            "fzec", pg_num=2, pool_type="erasure",
            erasure_code_profile="fzp")
        io = client.ioctx("fzec")

        # base object spans several stripes
        base = b"\x00" * (12 * 1024)
        await io.write_full("obj", base)

        A, B_, CHUNK = b"\xaa", b"\xbb", 4 * 1024

        async def writer(pat: bytes, off: int):
            await io.write("obj", pat * (2 * CHUNK), off=off)

        # A covers [0, 8k), B covers [4k, 12k): overlap [4k, 8k)
        await asyncio.gather(writer(A, 0), writer(B_, CHUNK))
        got = await io.read("obj")
        assert len(got) == len(base)
        assert got[:CHUNK] == A * CHUNK                 # A-only region
        assert got[2 * CHUNK:3 * CHUNK] == B_ * CHUNK   # B-only region
        overlap = got[CHUNK:2 * CHUNK]
        assert overlap in (A * CHUNK, B_ * CHUNK), overlap[:8]
    finally:
        await client.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


class TestECRMWSweep:
    @pytest.mark.parametrize("seed", range(8))
    def test_seed(self, seed):
        run_interleaved(_ec_rmw_races, seed, timeout=90.0)


# -- scenario 4: cache-tier promote vs write -------------------------------

async def _tier_promote_vs_write():
    """Reads promoting an object into the cache tier racing fresh
    writes to the same key: the promoted copy must never shadow a
    NEWER write (the object-lock-over-tier-admission contract,
    osd/tiering.py)."""
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=3)
    mon = Monitor(crush=crush, device="cpu")
    osds: list[OSDDaemon] = []
    client = RadosClient(client_id=903)
    try:
        await mon.start()
        for i in range(3):
            osd = OSDDaemon(i, mon.addr, device="cpu")
            await osd.start()
            osds.append(osd)
        await client.connect(*mon.addr)
        await client.pool_create("base", pg_num=2, size=2)
        await client.pool_create("hot", pg_num=2, size=2)
        for cmd in (
            {"prefix": "osd tier add", "pool": "base",
             "tierpool": "hot"},
            {"prefix": "osd tier cache-mode", "pool": "hot",
             "mode": "writeback"},
            {"prefix": "osd tier set-overlay", "pool": "base",
             "tierpool": "hot"},
        ):
            code, rs, _ = await client.command(cmd)
            assert code == 0, rs
        await client._wait_new_map(client.osdmap.epoch, timeout=10)
        io = client.ioctx("base")

        # cold object in the base pool (written pre-tier via direct
        # pool id lookup is moot — write through, then flush by agent
        # is out of scope: the povotal race is read-promote vs write)
        await io.write_full("k", b"v0" * 100)

        results: list[bytes] = []

        async def reader():
            for _ in range(4):
                results.append(await io.read("k"))

        async def writer():
            await io.write_full("k", b"v1" * 100)
            await io.write_full("k", b"v2" * 100)

        await asyncio.gather(reader(), writer(), reader())
        # final state: the LAST write wins — a stale promote must not
        # have resurrected v0/v1
        final = await io.read("k")
        assert final == b"v2" * 100, final[:8]
        for got in results:
            assert got in (b"v0" * 100, b"v1" * 100, b"v2" * 100)
    finally:
        await client.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


class TestTierPromoteSweep:
    @pytest.mark.parametrize("seed", range(8))
    def test_seed(self, seed):
        run_interleaved(_tier_promote_vs_write, seed, timeout=90.0)


# -- scenario 5: PG split vs client I/O ------------------------------------

async def _split_vs_io():
    """pg_num doubling mid-write-storm: every write acked before,
    during, or after the split must be readable once the dust
    settles (reference PG split + RetryPG/EAGAIN client contract)."""
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=3)
    mon = Monitor(crush=crush, device="cpu")
    osds: list[OSDDaemon] = []
    client = RadosClient(client_id=904)
    try:
        await mon.start()
        for i in range(3):
            osd = OSDDaemon(i, mon.addr, device="cpu")
            await osd.start()
            osds.append(osd)
        await client.connect(*mon.addr)
        await client.pool_create("sp", pg_num=2, size=2)
        io = client.ioctx("sp")

        async def writer(lo: int, hi: int):
            for i in range(lo, hi):
                await io.write_full(f"o{i}", f"val-{i}".encode() * 50)

        async def split():
            code, rs, _ = await client.command({
                "prefix": "osd pool set", "pool": "sp",
                "var": "pg_num", "val": "4"})
            assert code == 0, rs

        await asyncio.gather(writer(0, 8), split(), writer(8, 16))
        await client.wait_clean(timeout=60)
        for i in range(16):
            assert await io.read(f"o{i}") == f"val-{i}".encode() * 50, i
    finally:
        await client.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


class TestSplitVsIOSweep:
    @pytest.mark.parametrize("seed", range(8))
    def test_seed(self, seed):
        run_interleaved(_split_vs_io, seed, timeout=90.0)


# -- scenario 6: RGW multipart complete vs abort ---------------------------

async def _multipart_complete_vs_abort():
    """CompleteMultipartUpload racing AbortMultipartUpload on one
    upload id: whichever wins, the bucket must land in a whole state —
    either the stitched object with every byte, or no object — and
    never a readable object with missing parts (reference
    rgw_multi.cc complete/abort mutual exclusion)."""
    from ceph_tpu_torch.rgw import RGWStore
    from ceph_tpu_torch.rgw.store import RGWError

    from tests.test_torch_mini_cluster import Cluster

    async with Cluster(n_osds=3) as c:
        await c.client.pool_create("rgw.meta", pg_num=2, size=2)
        await c.client.pool_create("rgw.data", pg_num=2, size=2)
        store = RGWStore(
            c.client.ioctx("rgw.meta"),
            {"default": c.client.ioctx("rgw.data")},
            chunk_size=64 * 1024,
        )
        await store.create_user("u", "U", access_key="AK", secret_key="SK")
        bucket = await store.create_bucket("b", "u")
        upload = await store.initiate_multipart(bucket, "big", "bin")
        p1 = b"\x01" * (300 * 1024)
        p2 = b"\x02" * (200 * 1024)
        e1 = await store.upload_part(bucket, "big", upload, 1, p1)
        e2 = await store.upload_part(bucket, "big", upload, 2, p2)

        outcome: dict = {}

        async def complete():
            try:
                await store.complete_multipart(
                    bucket, "big", upload, [(1, e1), (2, e2)])
                outcome["complete"] = True
            except RGWError:
                outcome["complete"] = False

        async def abort():
            try:
                await store.abort_multipart(bucket, "big", upload)
                outcome["abort"] = True
            except RGWError:
                outcome["abort"] = False

        await asyncio.gather(complete(), abort())
        try:
            meta, data = await store.get_object(bucket, "big")
            # complete won somewhere in the interleaving: the object
            # must be WHOLE
            assert data == p1 + p2
            assert meta["size"] == len(p1) + len(p2)
        except RGWError as e:
            # abort won: no object, and S3 listing agrees
            assert e.code == "NoSuchKey"
            res = await store.list_objects(bucket)
            assert res["entries"] == []


class TestMultipartRaceSweep:
    @pytest.mark.parametrize("seed", range(8))
    def test_seed(self, seed):
        run_interleaved(_multipart_complete_vs_abort, seed, timeout=90.0)


# -- scenario 7: deep scrub + repair vs concurrent overwrites --------------

async def _scrub_vs_overwrite():
    """Deep scrub + `pg repair` sweeping a PG WHILE clients overwrite
    the same objects: the chunked scan (now concurrent within a chunk,
    feeding the batched scrub verifier) must never report a false
    inconsistency — every apparent mismatch must re-verify clean under
    the object lock — and repair must never clobber an acked write
    (the repair re-verify + authoritative-push contract,
    osd/scrubber.py)."""
    import json

    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
    mon = Monitor(crush=crush, device="cpu")
    osds: list[OSDDaemon] = []
    client = RadosClient(client_id=907)
    try:
        await mon.start()
        for i in range(4):
            osd = OSDDaemon(i, mon.addr, device="cpu")
            await osd.start()
            osds.append(osd)
        await client.connect(*mon.addr)
        await client.ec_profile_set(
            "svp", {"plugin": "cuda", "k": "2", "m": "1"})
        await client.pool_create(
            "sv", pg_num=2, pool_type="erasure",
            erasure_code_profile="svp")
        io = client.ioctx("sv")
        n_obj = 4
        acked: dict[int, bytes] = {}
        for i in range(n_obj):
            acked[i] = bytes([i + 1]) * 6144
            await io.write_full(f"o{i}", acked[i])

        async def writer(i: int):
            # overwrites racing the scan; each ack updates the oracle
            for g in range(1, 4):
                data = bytes([0x10 * g + i]) * 6144
                await io.write_full(f"o{i}", data)
                acked[i] = data

        async def repair_sweep() -> list[dict]:
            reports = []
            for ps in range(2):
                code, _rs, data = await client.command({
                    "prefix": "pg repair",
                    "pgid": f"{io.pool_id}.{ps}"})
                assert code == 0
                reports.append(json.loads(data))
            return reports

        results = await asyncio.gather(
            *(writer(i) for i in range(n_obj)), repair_sweep())
        for rep in results[-1]:
            # racing writes may trip the scan mid-update, but the
            # under-lock re-verify must clear every one: a surviving
            # inconsistency here is a FALSE positive
            assert rep["inconsistencies"] == [], rep
            # ...and nothing consistent may have been "repaired"
            assert rep["repaired"] == [], rep
        for i in range(n_obj):
            assert await io.read(f"o{i}") == acked[i], i
    finally:
        await client.shutdown()
        for o in osds:
            await o.stop()
        await mon.stop()


class TestScrubVsOverwriteSweep:
    @pytest.mark.parametrize("seed", range(8))
    def test_seed(self, seed):
        run_interleaved(_scrub_vs_overwrite, seed, timeout=90.0)


def test_sweep_counts_green_seeds_and_stops_at_the_first_red():
    seen = []

    async def ok():
        await asyncio.sleep(0)

    assert sweep(ok, range(5)) == 5

    async def third_fails():
        seen.append(len(seen))
        await asyncio.sleep(0)
        if len(seen) == 3:
            raise ValueError("third")

    with pytest.raises(InterleaveError, match="seed=12") as e:
        sweep(third_fails, range(10, 20))
    assert e.value.seed == 12 and len(seen) == 3

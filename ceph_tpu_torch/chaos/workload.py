"""Concurrent replicated+EC workload with a recorded op history.

The ``ceph_test_rados`` role (src/test/osd/TestRados.cc +
RadosModel.h): drive writes/reads/snaps against live pools while the
thrasher runs, recording every operation with logical start/finish
timestamps so the invariant checkers (ceph_tpu/chaos/invariants.py)
can judge the run afterwards — no acked write lost, no stale or
corrupted read, snapshots frozen at their creation-time content.

Oracle design: every object has ONE writer task issuing versioned
payloads v1, v2, ... (writers to the same object would make the oracle
either-or; versioned single-writer sequences make it a total order —
the model RadosModel.h uses).  Payloads are self-describing
(``pool|oid|vN|`` header + version-derived fill), so a read can be
validated standalone: parse the version, regenerate the expected
bytes, compare exactly.  A blend of two writes, a torn stripe or a
bit-flip all fail the comparison.

Timestamps are a process-local logical clock (monotonic counter): the
runner is single-loop asyncio, so ``start < ack`` intervals order
exactly like the real submissions.

Counterpart of ``ceph_tpu/chaos/workload.py``: the same payload bytes and history.
"""

from __future__ import annotations

import asyncio
import itertools
import logging

log = logging.getLogger("ceph_tpu_torch.chaos")

_HEADER_SEP = b"|#|"


def payload_for(pool: str, oid: str, version: int, size: int) -> bytes:
    """Deterministic self-describing payload for (pool, oid, version)."""
    header = f"{pool}|{oid}|v{version}".encode() + _HEADER_SEP
    fill = bytes([(version * 31 + len(oid) * 7) % 251 + 1])
    if size < len(header):
        size = len(header)
    return header + fill * (size - len(header))


def parse_payload(data: bytes) -> tuple[str, str, int] | None:
    """Recover (pool, oid, version) from a read, or None when the
    bytes are not a whole, untampered payload of any version."""
    if not data or _HEADER_SEP not in data[:128]:
        return None
    header, _rest = data.split(_HEADER_SEP, 1)
    try:
        pool, oid, vtag = header.decode().split("|")
        version = int(vtag[1:])
    except (ValueError, UnicodeDecodeError):
        return None
    if payload_for(pool, oid, version, len(data)) != data:
        return None  # right shape, wrong bytes: blended/torn/corrupt
    return pool, oid, version


class History:
    """The recorded operation history one run produces."""

    def __init__(self):
        self._clock = itertools.count(1)
        self.writes: list[dict] = []
        self.reads: list[dict] = []
        self.snaps: list[dict] = []

    def now(self) -> int:
        return next(self._clock)

    def record_write(self, pool, oid, version, start, ack, error=None,
                     errno=None):
        self.writes.append({
            "pool": pool, "oid": oid, "version": version,
            "start": start, "ack": ack, "error": error,
            "errno": errno,
        })

    def record_read(self, pool, oid, start, end, version=None,
                    valid=False, error=None):
        self.reads.append({
            "pool": pool, "oid": oid, "start": start, "end": end,
            "version": version, "valid": valid, "error": error,
        })

    def record_snap(self, pool, oid, snapid, expect_version):
        self.snaps.append({
            "pool": pool, "oid": oid, "snapid": snapid,
            "expect_version": expect_version, "removed": False,
        })

    def mark_snap_removed(self, pool, oid, snapid):
        for s in self.snaps:
            if (s["pool"], s["oid"], s["snapid"]) == (pool, oid, snapid):
                s["removed"] = True

    def summary(self) -> dict:
        acked = sum(1 for w in self.writes if w["ack"] is not None)
        return {
            "writes": len(self.writes), "writes_acked": acked,
            "reads": len(self.reads),
            "reads_errored": sum(
                1 for r in self.reads if r["error"] is not None),
            "snaps": len(self.snaps),
        }


class Workload:
    """Drives the pools; owns the history.

    ``pools`` entries: {"name": str, "type": "replicated"|"erasure",
    "snaps": bool} — pools must already exist.  ``object_size`` should
    stay a multiple of one EC stripe so thrash-time recovery decodes
    hit the prewarmed batcher buckets (the cold_launches==0 invariant
    is part of the point)."""

    def __init__(
        self, client, pools: list[dict], *, objects: int = 4,
        rounds: int = 3, object_size: int = 8192,
        read_loops: int = 4, write_gap: float = 0.0,
    ):
        self.client = client
        self.pools = pools
        self.objects = objects
        self.rounds = rounds
        self.object_size = object_size
        self.read_loops = read_loops
        # pause between one writer's rounds: scenarios that need the
        # write stream to SPAN the whole thrash window (degraded-disk:
        # the mgr's detection pipeline observes live traffic) pace
        # their writers instead of bursting every round up front
        self.write_gap = write_gap
        self.history = History()
        self._done = asyncio.Event()

    def _oids(self, pool_name: str) -> list[str]:
        return [f"{pool_name}-obj{i}" for i in range(self.objects)]

    async def _writer(self, pool: dict, oid: str) -> None:
        h = self.history
        io = self.client.ioctx(pool["name"]).dup()
        # snaps run on EC pools too: snap-frozen-content under thrash
        # is exactly where EC COW clones (shard-granular) can diverge
        # from the replicated path (thrash-erasure-code + snaps role)
        snaps_on = pool.get("snaps")
        last_acked = 0
        snap_ids: list[int] = []
        snap_of: dict[int, int] = {}  # snapid -> round it froze
        for v in range(1, self.rounds + 1):
            data = payload_for(pool["name"], oid, v, self.object_size)
            start = h.now()
            try:
                await io.write_full(oid, data)
            except OSError as e:
                h.record_write(pool["name"], oid, v, start, None,
                               error=str(e),
                               errno=getattr(e, "errno", None))
                continue
            h.record_write(pool["name"], oid, v, start, h.now())
            last_acked = v
            if snaps_on and v == max(1, self.rounds // 2):
                # freeze the current content under a self-managed snap
                # mid-thrash; the final invariant replays the read
                try:
                    snapid = await io.selfmanaged_snap_create()
                    snap_ids.insert(0, snapid)
                    io.set_snap_context(snapid, list(snap_ids))
                    h.record_snap(pool["name"], oid, snapid, last_acked)
                    snap_of[snapid] = last_acked
                except OSError as e:
                    log.debug("chaos workload: snap failed: %s", e)
            await asyncio.sleep(self.write_gap)
        if snaps_on and snap_ids and self._snap_remove_for(oid):
            # snap REMOVE under thrash (half the objects, derived from
            # the oid): trim must reap the clone without disturbing the
            # head — the post-settle deep scrub judges the debris and
            # the removed snap leaves the frozen-content oracle
            victim_snap = snap_ids[-1]  # the oldest recorded snap
            try:
                await io.selfmanaged_snap_remove(victim_snap)
                snap_ids.remove(victim_snap)
                io.set_snap_context(
                    snap_ids[0] if snap_ids else victim_snap,
                    list(snap_ids))
                h.mark_snap_removed(pool["name"], oid, victim_snap)
            except OSError as e:
                log.debug("chaos workload: snap remove failed: %s", e)

    @staticmethod
    def _snap_remove_for(oid: str) -> bool:
        """Deterministic half of the objects exercise snap removal
        (the other half keeps its snap for the frozen-content read)."""
        return sum(oid.encode()) % 2 == 0

    async def _reader(self, pool: dict) -> None:
        h = self.history
        io = self.client.ioctx(pool["name"]).dup()
        oids = self._oids(pool["name"])
        for loop_i in range(self.read_loops):
            for oid in oids:
                if self._done.is_set():
                    return
                start = h.now()
                try:
                    data = await io.read(oid)
                except OSError as e:
                    # ENOENT after an acked write is judged by the
                    # checker; other errors are availability noise
                    h.record_read(
                        pool["name"], oid, start, h.now(),
                        error=f"errno={getattr(e, 'errno', None)}")
                    continue
                parsed = parse_payload(data)
                h.record_read(
                    pool["name"], oid, start, h.now(),
                    version=parsed[2] if parsed else None,
                    valid=parsed is not None
                    and parsed[0] == pool["name"] and parsed[1] == oid,
                )
                await asyncio.sleep(0.01)

    async def run(self) -> History:
        """Run writers and readers to completion; returns the history."""
        writers = [
            self._writer(pool, oid)
            for pool in self.pools for oid in self._oids(pool["name"])
        ]
        readers = [self._reader(pool) for pool in self.pools]

        async def _drive_writers():
            try:
                await asyncio.gather(*writers)
            finally:
                self._done.set()

        await asyncio.gather(_drive_writers(), *readers)
        return self.history

    # -- post-thrash verification reads --------------------------------

    async def final_reads(self) -> list[dict]:
        """Read back every object head (and every recorded snap) after
        the cluster settled; returns read records for the checker."""
        out: list[dict] = []
        for pool in self.pools:
            io = self.client.ioctx(pool["name"])
            for oid in self._oids(pool["name"]):
                rec = {"pool": pool["name"], "oid": oid, "kind": "final"}
                try:
                    data = await io.read(oid)
                    parsed = parse_payload(data)
                    rec["version"] = parsed[2] if parsed else None
                    rec["valid"] = (
                        parsed is not None and parsed[0] == pool["name"]
                        and parsed[1] == oid
                    )
                except OSError as e:
                    rec["error"] = f"errno={getattr(e, 'errno', None)}"
                out.append(rec)
        for snap in self.history.snaps:
            if snap.get("removed"):
                continue  # trimmed under thrash: no content to freeze
            io = self.client.ioctx(snap["pool"]).dup()
            io.snap_set_read(snap["snapid"])
            rec = {
                "pool": snap["pool"], "oid": snap["oid"], "kind": "snap",
                "snapid": snap["snapid"],
                "expect_version": snap["expect_version"],
            }
            try:
                data = await io.read(snap["oid"])
                parsed = parse_payload(data)
                rec["version"] = parsed[2] if parsed else None
                rec["valid"] = parsed is not None
            except OSError as e:
                rec["error"] = f"errno={getattr(e, 'errno', None)}"
            out.append(rec)
        return out

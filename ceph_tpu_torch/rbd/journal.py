"""RBD image journaling (reference src/journal/ Journaler +
src/librbd/journal/): a durable, ordered event log of image mutations,
written BEFORE the data path applies them.

Layout on the metadata pool:

  ``journal.<image>``            omap: ``commit_pos`` (highest seq the
                                 data path has durably applied) and
                                 per-peer mirror positions
                                 (``peer.<name>``)
  ``journal_data.<image>.<seq>`` one object per event: a JSON header
                                 line + raw payload bytes

Crash contract (the reference's journal replay on open): an event at
seq > commit_pos may or may not have reached the data objects — replay
re-applies every such event in order; all events are idempotent
(absolute-offset writes, absolute resizes), so double-apply is safe.

The same log is the rbd-mirror feed (ceph_tpu_torch/rbd/mirror.py): a peer
replays events into a secondary cluster and records its own position
under ``peer.<name>`` so trim never drops an event a peer still needs.

Counterpart of ``ceph_tpu/rbd/journal.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno
import json


WRITE = "write"
DISCARD = "discard"
RESIZE = "resize"
SNAP_CREATE = "snap_create"
SNAP_REMOVE = "snap_remove"


class Journal:
    def __init__(self, ioctx, image_name: str):
        self._io = ioctx
        self.image_name = image_name
        self.header_oid = f"journal.{image_name}"
        self._next_seq: int | None = None
        # seqs whose data-path application finished but whose
        # predecessors have not: commit_pos may only advance over a
        # CONTIGUOUS applied prefix, or replay-after-crash would skip
        # a durably journaled, never-applied event
        self._applied: set[int] = set()
        # tail_seq must be MONOTONIC on the wire: concurrent appends
        # completing out of order must not regress it (a regressed
        # tail hides a durably appended event from replay)
        self._tail_lock = asyncio.Lock()
        self._tail_persisted = -1
        self._commit_lock = asyncio.Lock()

    def _data_oid(self, seq: int) -> str:
        return f"journal_data.{self.image_name}.{seq:016x}"

    async def _header(self) -> dict[str, bytes]:
        try:
            return await self._io.omap_get(self.header_oid)
        except OSError as e:
            if e.errno == errno.ENOENT:
                return {}
            raise

    async def commit_pos(self) -> int:
        return int((await self._header()).get("commit_pos", b"-1"))

    async def tail_seq(self) -> int:
        """Highest seq ever appended (-1 = empty journal)."""
        return int((await self._header()).get("tail_seq", b"-1"))

    # -- producer ----------------------------------------------------------

    async def append(self, event: str, meta: dict, payload: bytes = b"") -> int:
        """Durably log one event; returns its seq.  MUST complete
        before the data path applies the mutation (write-ahead)."""
        if self._next_seq is None:
            self._next_seq = await self.tail_seq() + 1
        seq = self._next_seq
        self._next_seq += 1
        head = dict(meta)
        head["event"] = event
        hdr = json.dumps(head).encode()
        await self._io.write_full(
            self._data_oid(seq),
            len(hdr).to_bytes(4, "big") + hdr + payload)
        async with self._tail_lock:
            if seq > self._tail_persisted:
                await self._io.omap_set(
                    self.header_oid, {"tail_seq": str(seq).encode()})
                self._tail_persisted = seq
        return seq

    async def commit(self, seq: int) -> None:
        """The data path has durably applied event ``seq``.  commit_pos
        advances to the end of the contiguous applied prefix — an
        out-of-order completion (concurrent writes) parks here until
        its predecessors land."""
        self._applied.add(seq)
        # the read-advance-write below must be atomic: two concurrent
        # commits both reading a stale cur can transiently regress
        # commit_pos (parking trim below an applied seq) — same race
        # _tail_lock closes for tail_seq
        async with self._commit_lock:
            cur = await self.commit_pos()
            new = cur
            while new + 1 in self._applied:
                new += 1
            if new > cur:
                for s in range(cur + 1, new + 1):
                    self._applied.discard(s)
                await self._io.omap_set(
                    self.header_oid, {"commit_pos": str(new).encode()})

    # -- consumers ---------------------------------------------------------

    async def read_event(self, seq: int) -> tuple[dict, bytes] | None:
        try:
            raw = await self._io.read(self._data_oid(seq))
        except OSError as e:
            if e.errno == errno.ENOENT:
                return None
            raise
        n = int.from_bytes(raw[:4], "big")
        return json.loads(raw[4 : 4 + n]), raw[4 + n :]

    async def events_after(self, pos: int):
        """(seq, header, payload) for every event with seq > pos, in
        order."""
        tail = await self.tail_seq()
        out = []
        for seq in range(pos + 1, tail + 1):
            ev = await self.read_event(seq)
            if ev is not None:
                out.append((seq, ev[0], ev[1]))
        return out

    # -- mirror peers ------------------------------------------------------

    async def peer_pos(self, peer: str) -> int:
        return int((await self._header()).get(f"peer.{peer}", b"-1"))

    async def peer_commit(self, peer: str, seq: int) -> None:
        cur = await self.peer_pos(peer)
        if seq > cur:
            await self._io.omap_set(
                self.header_oid, {f"peer.{peer}": str(seq).encode()})

    async def register_peer(self, peer: str) -> None:
        hdr = await self._header()
        if f"peer.{peer}" not in hdr:
            await self._io.omap_set(
                self.header_oid, {f"peer.{peer}": b"-1"})

    # -- trim --------------------------------------------------------------

    async def trim(self) -> int:
        """Drop event objects every consumer (data path + all peers)
        has passed.  Returns how many were removed."""
        hdr = await self._header()
        floor = int(hdr.get("commit_pos", b"-1"))
        for k, v in hdr.items():
            if k.startswith("peer."):
                floor = min(floor, int(v))
        trimmed = int(hdr.get("trimmed_to", b"-1"))
        n = 0
        for seq in range(trimmed + 1, floor + 1):
            try:
                await self._io.remove(self._data_oid(seq))
                n += 1
            except OSError as e:
                if e.errno != errno.ENOENT:
                    raise
        if floor > trimmed:
            await self._io.omap_set(
                self.header_oid, {"trimmed_to": str(floor).encode()})
        return n

    async def destroy(self) -> None:
        tail = await self.tail_seq()
        for seq in range(tail + 1):
            try:
                await self._io.remove(self._data_oid(seq))
            except OSError as e:
                if e.errno != errno.ENOENT:
                    raise
        try:
            await self._io.remove(self.header_oid)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise

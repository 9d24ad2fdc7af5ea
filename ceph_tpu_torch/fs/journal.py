"""MDS metadata journal on RADOS — the Journaler twin.

The reference journals every metadata mutation into a striped RADOS
log before applying it to the in-memory cache (src/osdc/Journaler.cc:
a header object holding {trimmed_pos, expire_pos, write_pos} plus data
objects `<ino>.<objno>`), and replays it on MDS restart
(src/mds/journal.cc EMetaBlob::replay).

Lite shape, same contract: a header object (``<name>``) whose omap
carries {min_seg, next_seq, ino_next}; events append as JSON lines to
segment objects ``<name>.<seg>`` (rotated at ``seg_bytes``); replay
reads every live segment in order; checkpoint (after the dirty
dirfrags flush back) advances min_seg and deletes the old segments —
the LogSegment expiry dance.

Events must be idempotent under re-apply: a crash between the dirfrag
flush and the trim replays a prefix of already-applied events.

Counterpart of ``ceph_tpu/fs/journal.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import errno
import json

from ceph_tpu_torch.client.rados import RadosError

HEADER_KEY = "journal.header"


class Journaler:
    def __init__(self, io, name: str = "mds0.journal",
                 seg_bytes: int = 4 * 2**20):
        self.io = io
        self.name = name
        self.seg_bytes = seg_bytes
        self.min_seg = 0       # first live segment
        self.cur_seg = 0       # segment appends go to
        self.next_seq = 1
        self._cur_size = 0

    def _seg_oid(self, seg: int) -> str:
        return f"{self.name}.{seg:08x}"

    async def load(self) -> tuple[dict, list[dict]]:
        """Read header + replay events.  Returns (header_state, events)
        where events is every record since the last checkpoint, in
        append order."""
        state: dict = {}
        try:
            got = await self.io.omap_get_vals_by_keys(self.name, [HEADER_KEY])
            raw = got.get(HEADER_KEY)
            if raw:
                state = json.loads(raw)
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        self.min_seg = state.get("min_seg", 0)
        events: list[dict] = []
        seg = self.min_seg
        while True:
            try:
                data = await self.io.read(self._seg_oid(seg))
            except RadosError as e:
                if e.errno == errno.ENOENT:
                    break
                raise
            self.cur_seg, self._cur_size = seg, len(data)
            for line in data.splitlines():
                if line.strip():
                    events.append(json.loads(line))
            seg += 1
        if events:
            self.next_seq = max(e["seq"] for e in events) + 1
        else:
            self.next_seq = state.get("next_seq", 1)
            self.cur_seg = max(self.cur_seg, self.min_seg)
        return state, events

    async def append(self, event: dict) -> int:
        """Durable append; returns the assigned seq.  The write rides
        the replicated meta pool's commit path, so when this returns
        the event survives an MDS crash."""
        event = dict(event)
        event["seq"] = self.next_seq
        self.next_seq += 1
        line = json.dumps(event).encode() + b"\n"
        if self._cur_size and self._cur_size + len(line) > self.seg_bytes:
            self.cur_seg += 1
            self._cur_size = 0
        await self.io.append(self._seg_oid(self.cur_seg), line)
        self._cur_size += len(line)
        return event["seq"]

    async def checkpoint(self, state: dict) -> None:
        """All events so far are reflected in the flushed dirfrags:
        persist the header and drop every old segment (LogSegment
        expiry + Journaler::trim)."""
        old_min = self.min_seg
        # appends continue into a fresh segment; everything before it
        # is dead weight once the header lands
        if self._cur_size:
            self.cur_seg += 1
            self._cur_size = 0
        self.min_seg = self.cur_seg
        hdr = dict(state)
        hdr["min_seg"] = self.min_seg
        hdr["next_seq"] = self.next_seq
        await self.io.omap_set(self.name, {
            HEADER_KEY: json.dumps(hdr).encode(),
        })
        for seg in range(old_min, self.min_seg):
            try:
                await self.io.remove(self._seg_oid(seg))
            except RadosError:
                pass

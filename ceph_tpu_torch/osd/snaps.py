"""Snapshot model: SnapContext, SnapSet, clone resolution.

Behavioral twin of the reference's snap machinery (src/osd/osd_types.h
``SnapSet``/``SnapContext``, src/osd/SnapMapper.h:122, PrimaryLogPG's
make_writeable/find_object_context):

- a write carries a **SnapContext** (seq = newest snap id, snaps =
  existing snap ids newest-first);
- the primary compares snapc.seq against the object's **SnapSet** seq;
  if the context is newer, the head is **cloned** (copy-on-write) into
  a clone object whose id is the newest snap it covers, and the SnapSet
  (an xattr on the head) records the clone and the snaps it covers;
- a read at snap s resolves to the oldest clone whose id >= s, else the
  head (find_object_context semantics);
- removing a snap adds it to the pool's removed_snaps; the trimmer
  deletes clones once every snap they cover is removed (SnapMapper /
  snap trim worker role).

Self-managed snaps (librados selfmanaged_snap_*) and pool snaps
(``osd pool mksnap``) share this machinery — pool snaps simply use the
pool's own snap context, as in the reference (pg_pool_t::get_snap_context).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

#: CEPH_NOSNAP (src/include/rados.h): "the head object"
NOSNAP = 0xFFFFFFFFFFFFFFFE

#: xattr on the head object holding the encoded SnapSet (reference
#: SS_ATTR "snapset")
SS_ATTR = "ss"
#: xattr on a clone object listing the snaps it covers
SNAPS_ATTR = "snaps"
#: xattr marking a logically-deleted head that still anchors clones —
#: the reference's snapdir object role
WHITEOUT_ATTR = "whiteout"


@dataclass
class SnapContext:
    """seq + existing snap ids, newest first (reference SnapContext)."""

    seq: int = 0
    snaps: list[int] = field(default_factory=list)

    def valid(self) -> bool:
        return not self.snaps or (
            self.seq >= self.snaps[0]
            and all(a > b for a, b in zip(self.snaps, self.snaps[1:]))
        )


@dataclass
class CloneInfo:
    id: int                      # newest snap the clone covers
    snaps: list[int] = field(default_factory=list)  # covered, newest first
    size: int = 0


@dataclass
class SnapSet:
    """Per-object snapshot state (reference SnapSet), stored as the
    head's SS_ATTR xattr.  ``clones`` is ordered oldest -> newest."""

    seq: int = 0
    clones: list[CloneInfo] = field(default_factory=list)

    # -- codec ---------------------------------------------------------

    def to_bytes(self) -> bytes:
        return json.dumps({
            "seq": self.seq,
            "clones": [
                {"id": c.id, "snaps": c.snaps, "size": c.size}
                for c in self.clones
            ],
        }).encode()

    @classmethod
    def from_bytes(cls, raw: bytes | None) -> "SnapSet":
        if not raw:
            return cls()
        d = json.loads(raw)
        return cls(
            seq=d["seq"],
            clones=[CloneInfo(c["id"], list(c["snaps"]), c["size"])
                    for c in d["clones"]],
        )

    # -- write-side (make_writeable) -----------------------------------

    def needs_cow(self, snapc: SnapContext) -> bool:
        """True when a write under ``snapc`` must clone the head first
        (PrimaryLogPG::make_writeable condition)."""
        return bool(snapc.snaps) and snapc.seq > self.seq

    def make_clone(self, snapc: SnapContext, head_size: int) -> CloneInfo:
        """Record the COW clone for a write under ``snapc``; returns the
        new clone (id = newest snap covered)."""
        covered = [s for s in snapc.snaps if s > self.seq]
        assert covered, "needs_cow was False"
        clone = CloneInfo(id=covered[0], snaps=covered, size=head_size)
        self.clones.append(clone)
        self.seq = snapc.seq
        return clone

    def advance_seq(self, snapc: SnapContext) -> None:
        """A write under a newer context with no new snaps to cover
        (e.g. head did not exist): just move seq forward."""
        if snapc.seq > self.seq:
            self.seq = snapc.seq

    # -- read-side (find_object_context) -------------------------------

    def resolve(self, snapid: int) -> int | None:
        """Map a read snap id to the object that serves it: a clone id,
        NOSNAP for the head (oldest clone with id >= snapid), or None
        when no clone covers the snap — the object did not exist at
        that snap (find_object_context checks the covered interval)."""
        for c in self.clones:
            if c.id >= snapid:
                if c.snaps and snapid < c.snaps[-1]:
                    return None  # gap: object absent at that snap
                return c.id
        return NOSNAP

    def clone_by_id(self, cloneid: int) -> CloneInfo | None:
        for c in self.clones:
            if c.id == cloneid:
                return c
        return None

    def drop_clone(self, cloneid: int) -> None:
        self.clones = [c for c in self.clones if c.id != cloneid]


def encode_snaps(snaps: list[int]) -> bytes:
    return json.dumps(snaps).encode()


def decode_snaps(raw: bytes | None) -> list[int]:
    return json.loads(raw) if raw else []

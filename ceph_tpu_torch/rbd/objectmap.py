"""RBD object-map + fast-diff (reference src/librbd/object_map/,
src/cls/rbd/cls_rbd.cc OBJECT_* states).

Two bits of state per data object, persisted in a small RADOS object
(``rbd_object_map.<image>`` for head, ``rbd_object_map.<image>.<snapid>``
frozen per snapshot):

  NONEXISTENT (0)  no data object — reads short-circuit to zeros /
                   parent without an ENOENT round trip
  EXISTS (1)       written since the last snapshot (dirty)
  PENDING (2)      delete in flight
  EXISTS_CLEAN (3) exists, unchanged since the last snapshot

Update protocol mirrors the reference's crash direction: the map is
marked EXISTS *before* the data write lands (a crash leaves a false
EXISTS — harmless), and PENDING before a delete with NONEXISTENT
recorded after (a crash re-runs the delete).

fast-diff falls out of the states: objects EXISTS/PENDING in a later
map differ from the earlier snapshot; EXISTS_CLEAN ones provably do
not — diffing two snapshots costs two small map reads instead of a
scan of every data object.

Counterpart of ``ceph_tpu/rbd/objectmap.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import errno

OBJECT_NONEXISTENT = 0
OBJECT_EXISTS = 1
OBJECT_PENDING = 2
OBJECT_EXISTS_CLEAN = 3


class ObjectMap:
    """The per-image (or per-snapshot) 2-bit state vector."""

    def __init__(self, ioctx, image_name: str, n_objs: int,
                 snap_id: int | None = None):
        self._io = ioctx
        self.image_name = image_name
        self.snap_id = snap_id
        self.n_objs = n_objs
        self._bits = bytearray((n_objs + 3) // 4)
        self.loaded = False

    @property
    def oid(self) -> str:
        base = f"rbd_object_map.{self.image_name}"
        return base if self.snap_id is None else f"{base}.{self.snap_id:x}"

    # -- persistence -------------------------------------------------------

    async def load(self) -> "ObjectMap":
        try:
            raw = await self._io.read(self.oid, off=0, length=0)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise
            raw = b""
        bits = bytearray((self.n_objs + 3) // 4)
        bits[: len(raw)] = raw[: len(bits)]
        self._bits = bits
        self.loaded = True
        return self

    async def save(self) -> None:
        await self._io.write_full(self.oid, bytes(self._bits))

    async def remove(self) -> None:
        try:
            await self._io.remove(self.oid)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise

    # -- state bits --------------------------------------------------------

    def get(self, objno: int) -> int:
        if objno >= self.n_objs:
            return OBJECT_NONEXISTENT
        return (self._bits[objno >> 2] >> ((objno & 3) * 2)) & 3

    def set(self, objno: int, state: int) -> bool:
        """Returns True when the state actually changed."""
        byte, shift = objno >> 2, (objno & 3) * 2
        cur = (self._bits[byte] >> shift) & 3
        if cur == state:
            return False
        self._bits[byte] = (
            self._bits[byte] & ~(3 << shift)) | (state << shift)
        return True

    def resize(self, n_objs: int) -> None:
        bits = bytearray((n_objs + 3) // 4)
        keep = min(len(bits), len(self._bits))
        bits[:keep] = self._bits[:keep]
        if n_objs < self.n_objs:
            # clear the partial byte's dead lanes
            for objno in range(n_objs, min(self.n_objs, len(bits) * 4)):
                byte, shift = objno >> 2, (objno & 3) * 2
                if byte < len(bits):
                    bits[byte] &= ~(3 << shift)
        self._bits = bits
        self.n_objs = n_objs

    def freeze_clean(self) -> None:
        """snap_create transition: every EXISTS object becomes
        EXISTS_CLEAN — from here on EXISTS means 'dirtied since this
        snapshot' (the fast-diff invariant)."""
        for objno in range(self.n_objs):
            if self.get(objno) == OBJECT_EXISTS:
                self.set(objno, OBJECT_EXISTS_CLEAN)

    def snapshot_copy(self, snap_id: int) -> "ObjectMap":
        om = ObjectMap(self._io, self.image_name, self.n_objs, snap_id)
        om._bits = bytearray(self._bits)
        om.loaded = True
        return om

    # -- fast-diff ---------------------------------------------------------

    def diff(self, since: "ObjectMap | None") -> list[int]:
        """Object numbers that (may) differ from ``since`` (an older
        snapshot's map; None = everything that exists).  EXISTS_CLEAN
        in self with the same state in ``since`` is provably unchanged."""
        def present(state: int) -> bool:
            return state in (OBJECT_EXISTS, OBJECT_EXISTS_CLEAN)

        out = []
        for objno in range(self.n_objs):
            s = self.get(objno)
            if since is None:
                if s != OBJECT_NONEXISTENT:
                    out.append(objno)
                continue
            o = since.get(objno) if objno < since.n_objs \
                else OBJECT_NONEXISTENT
            if s in (OBJECT_EXISTS, OBJECT_PENDING):
                out.append(objno)  # dirtied since the last freeze
            elif present(s) != present(o):
                out.append(objno)  # appeared/vanished between maps
        return out

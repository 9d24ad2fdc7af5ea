"""Client-side striping — the Striper/libradosstriper twin.

The reference maps a logical byte stream onto RADOS objects with a
RAID0-style layout (src/osdc/Striper.cc file_to_extents: stripe_unit
bytes round-robin across stripe_count objects, object_size bytes per
object before moving to the next object set; libradosstriper stores
the logical size in an xattr of the first object).  Same math here,
issued as parallel IoCtx ops.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass

SIZE_XATTR = "striper.size"


@dataclass(frozen=True)
class Layout:
    """file_layout_t (src/include/fs_types.h): all byte counts."""

    stripe_unit: int = 65536
    stripe_count: int = 4
    object_size: int = 4 * 2**20

    def __post_init__(self):
        assert self.object_size % self.stripe_unit == 0
        assert self.stripe_unit > 0 and self.stripe_count > 0


def file_to_extents(
    layout: Layout, off: int, length: int
) -> list[tuple[int, int, int]]:
    """Striper::file_to_extents (Striper.cc:47): logical [off, off+len)
    -> [(object_no, object_off, len)] runs, in logical order."""
    su, sc, osz = layout.stripe_unit, layout.stripe_count, layout.object_size
    stripes_per_object = osz // su
    out: list[tuple[int, int, int]] = []
    pos = off
    end = off + length
    while pos < end:
        blockno = pos // su           # which stripe_unit block
        stripeno = blockno // sc      # which stripe (row)
        stripepos = blockno % sc      # which object column
        objectsetno = stripeno // stripes_per_object
        objectno = objectsetno * sc + stripepos
        block_off = pos % su
        obj_off = (stripeno % stripes_per_object) * su + block_off
        n = min(su - block_off, end - pos)
        if out and out[-1][0] == objectno and (
            out[-1][1] + out[-1][2] == obj_off
        ):
            out[-1] = (objectno, out[-1][1], out[-1][2] + n)
        else:
            out.append((objectno, obj_off, n))
        pos += n
    return out


class StripedObject:
    """A logically-striped byte stream over one pool
    (libradosstriper::RadosStriper surface: write/read/trunc/stat)."""

    def __init__(self, ioctx, name: str, layout: Layout | None = None):
        self.io = ioctx
        self.name = name
        self.layout = layout or Layout()

    def _oid(self, objectno: int) -> str:
        return f"{self.name}.{objectno:016x}"

    async def size(self) -> int:
        import errno as _e

        try:
            raw = await self.io.getxattr(self._oid(0), SIZE_XATTR)
            return int(raw)
        except OSError as err:
            if err.errno in (_e.ENOENT, _e.ENODATA):
                return 0  # never written
            raise  # a transient error must NOT read as "empty file" —
            # the next write would shrink the logical size over live data

    async def _set_size(self, size: int) -> None:
        await self.io.setxattr(self._oid(0), SIZE_XATTR, str(size).encode())

    async def write(self, off: int, data: bytes) -> None:
        extents = file_to_extents(self.layout, off, len(data))
        pos = 0
        writes = []
        for objectno, obj_off, n in extents:
            writes.append(self.io.write(
                self._oid(objectno), data[pos : pos + n], off=obj_off
            ))
            pos += n
        await asyncio.gather(*writes)
        cur = await self.size()
        if off + len(data) > cur:
            await self._set_size(off + len(data))

    async def read(self, off: int = 0, length: int = 0) -> bytes:
        size = await self.size()
        end = size if length == 0 else min(off + length, size)
        if off >= end:
            return b""
        extents = file_to_extents(self.layout, off, end - off)

        async def _read_one(objectno: int, obj_off: int, n: int) -> bytes:
            try:
                chunk = await self.io.read(
                    self._oid(objectno), off=obj_off, length=n
                )
            except OSError as e:
                import errno as _e

                if e.errno == _e.ENOENT:
                    chunk = b""  # sparse hole
                else:
                    raise
            return chunk.ljust(n, b"\0")  # short object => zeros

        parts = await asyncio.gather(*(
            _read_one(*ext) for ext in extents
        ))
        return b"".join(parts)

    async def truncate(self, size: int) -> None:
        cur = await self.size()
        if size < cur:
            # drop whole objects past the end, trim the boundary object
            old_extents = file_to_extents(self.layout, 0, cur)
            live: dict[int, int] = {}
            if size > 0:
                for objectno, obj_off, n in file_to_extents(self.layout, 0, size):
                    live[objectno] = max(live.get(objectno, 0), obj_off + n)
            ops = []
            for objectno, _o, _n in old_extents:
                if objectno not in live:
                    ops.append(self._remove_quiet(self._oid(objectno)))
            for objectno, keep in live.items():
                ops.append(self.io.truncate(self._oid(objectno), keep))
            await asyncio.gather(*ops)
        await self._set_size(size)

    async def _remove_quiet(self, oid: str) -> None:
        import errno as _e

        try:
            await self.io.remove(oid)
        except OSError as err:
            if err.errno != _e.ENOENT:
                raise

    async def remove(self) -> None:
        size = await self.size()
        seen = {0}
        ops = [self._remove_quiet(self._oid(0))]
        for objectno, _o, _n in file_to_extents(self.layout, 0, max(size, 1)):
            if objectno not in seen:
                seen.add(objectno)
                ops.append(self._remove_quiet(self._oid(objectno)))
        await asyncio.gather(*ops)

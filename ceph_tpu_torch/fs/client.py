"""CephFS client-lite: POSIX-style API over MDS + direct data I/O.

Twin of the userspace client (src/client/Client.cc): metadata ops go
to the MDS as MClientRequest/MClientReply; file DATA bypasses the MDS
entirely — the client stripes bytes straight to the data pool using
the file's layout (src/osdc/Striper.cc file_to_extents, objects named
``<ino hex>.<objno 08x>``).

Capabilities (Client.cc cap handling, lite): ``open``/``create``
return cap bits.  A sole writer holds EXCL and BUFFERS size/mtime
updates locally — no per-write round-trip — flushing them on
``fsync``/``close``/``unmount`` or when the MDS recalls the cap
(MClientCaps REVOKE -> FLUSH -> ACK).  Without EXCL, each extending
write reports its size synchronously (``report_size``, which the MDS
only accepts from write-cap holders).

Snapshots: the MDS pushes the data pool's snap context (MClientCaps
SNAPC) and the client stamps it on writes, so object-level COW clones
happen under overwrite; ``dir/.snap/<name>/file`` paths open
read-only handles whose data reads resolve at the snapid.

Counterpart of ``ceph_tpu/fs/client.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno
import itertools

from ceph_tpu_torch.client.rados import IoCtx, RadosError
from ceph_tpu_torch.client.striper import Layout, file_to_extents
from ceph_tpu_torch.msg.messages import MClientCaps, MClientReply, MClientRequest
from ceph_tpu_torch.msg.messenger import Messenger

from .mds import CAP_EXCL, CAP_RD, CAP_WR, FSError  # noqa: F401

REQUEST_TIMEOUT = 30.0


class FSClient:
    """Mounts the filesystem: MDS session + data-pool handle."""

    def __init__(self, mds_addr: tuple[str, int], data_io: IoCtx,
                 client_id: int | None = None):
        import os

        self.mds_addr = mds_addr
        self.data_io = data_io
        cid = client_id if client_id is not None else (os.getpid() << 8) | 3
        self.messenger = Messenger(("client", cid), self._dispatch)
        self._conn = None
        self._tids = itertools.count(1)
        self._waiters: dict[int, asyncio.Future] = {}
        # unique per MOUNT, not per entity: reqids from a previous
        # session of the same client must never hit the MDS's
        # completed-request cache (the reference's mon-issued global_id
        # plays this role)
        self._session = os.urandom(8).hex()
        # caps: ino -> bits; dirty buffered attrs: ino -> {path, size,
        # mtime} (flushed on fsync/close/recall/unmount)
        self._caps: dict[int, int] = {}
        self._dirty: dict[int, dict] = {}

    async def mount(self) -> None:
        self._conn = await self.messenger.connect(*self.mds_addr)

    async def unmount(self) -> None:
        try:
            await self.flush_dirty()
        except (FSError, ConnectionError, OSError):
            pass
        await self.messenger.shutdown()

    async def _dispatch(self, msg) -> None:
        if isinstance(msg, MClientReply):
            fut = self._waiters.get(msg.tid)
            if fut and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, MClientCaps):
            if msg.op == MClientCaps.REVOKE:
                await self._handle_revoke(msg)
            elif msg.op == MClientCaps.SNAPC:
                self.data_io.set_snap_context(msg.snap_seq, msg.snaps)

    async def _handle_revoke(self, msg: MClientCaps) -> None:
        """Flush buffered dirty state, downgrade to msg.caps, ack."""
        dirty = self._dirty.pop(msg.ino, None)
        try:
            if dirty is not None:
                await msg.conn.send_message(MClientCaps(
                    op=MClientCaps.FLUSH, ino=msg.ino,
                    path=dirty["path"], size=dirty.get("size", -1),
                    mtime=dirty.get("mtime", -1.0)))
            if msg.caps:
                self._caps[msg.ino] = msg.caps
            else:
                self._caps.pop(msg.ino, None)
            await msg.conn.send_message(MClientCaps(
                tid=msg.tid, op=MClientCaps.ACK, ino=msg.ino))
        except (ConnectionError, OSError):
            pass

    async def flush_dirty(self) -> None:
        """Push every buffered size/mtime to the MDS (cap flush on
        unmount / fsync-all)."""
        for ino, dirty in list(self._dirty.items()):
            await self.request(
                "report_size", path=dirty["path"], ino=ino,
                size=dirty.get("size", 0),
                mtime=dirty.get("mtime"))
            self._dirty.pop(ino, None)

    async def request(self, op: str, **args) -> dict:
        # one reqid across every retry of this logical request: the MDS
        # deduplicates a mutation whose first attempt landed but whose
        # reply was lost (completed_requests, Client.cc resend rules)
        args["_reqid"] = f"{self._session}:{next(self._tids)}"
        for attempt in range(3):
            tid = next(self._tids)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters[tid] = fut
            try:
                await self._conn.send_message(
                    MClientRequest(tid=tid, op=op, args=args))
                reply: MClientReply = await asyncio.wait_for(
                    fut, REQUEST_TIMEOUT)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                # session reset (MDS restart) or lost reply: reconnect
                # and resend — the Client.cc session-reconnect behavior.
                # Caps are session state: a reset drops them all.
                self._caps.clear()
                await asyncio.sleep(0.2 * (attempt + 1))
                try:
                    self._conn = await self.messenger.connect(*self.mds_addr)
                except (ConnectionError, OSError):
                    pass
                continue
            finally:
                self._waiters.pop(tid, None)
            if reply.result < 0:
                raise FSError(-reply.result, f"{op} failed")
            return reply.out
        raise FSError(errno.ETIMEDOUT, f"{op}: mds unreachable")

    # -- metadata ------------------------------------------------------

    async def mkdir(self, path: str, mode: int = 0o755) -> None:
        await self.request("mkdir", path=path, mode=mode)

    async def rmdir(self, path: str) -> None:
        await self.request("rmdir", path=path)

    async def unlink(self, path: str) -> None:
        await self.request("unlink", path=path)

    async def rename(self, src: str, dst: str) -> None:
        await self.request("rename", src=src, dst=dst)
        for d in self._dirty.values():
            if d.get("path") == src:
                d["path"] = dst  # flushes must chase the new name

    async def stat(self, path: str) -> dict:
        attr = (await self.request("stat", path=path))["attr"]
        # overlay OUR buffered (EXCL) attrs: a client always sees its
        # own writes even before the cap flush lands.  A snapshot view
        # is frozen past — the live file's buffered size must NOT leak
        # into it (the attr shares the live ino)
        if attr.get("snapid") is not None:
            return attr
        d = self._dirty.get(attr.get("ino"))
        if d is not None:
            if "size" in d:
                attr["size"] = max(attr.get("size", 0), d["size"])
            if "mtime" in d:
                attr["mtime"] = d["mtime"]
        return attr

    async def readdir(self, path: str) -> dict[str, dict]:
        return (await self.request("readdir", path=path))["entries"]

    async def symlink(self, path: str, target: str) -> None:
        await self.request("symlink", path=path, target=target)

    async def readlink(self, path: str) -> str:
        return (await self.request("readlink", path=path))["target"]

    async def truncate(self, path: str, size: int) -> None:
        # flush OUR buffered extension first: the MDS decides
        # shrink-vs-grow against its recorded size, so a buffered
        # larger size must land before the truncate judges it
        for ino, d in list(self._dirty.items()):
            if d.get("path") == path:
                self._dirty.pop(ino, None)
                await self.request(
                    "report_size", path=path, ino=ino,
                    size=d.get("size", 0), mtime=d.get("mtime"))
        await self.request("setattr", path=path, size=size)

    async def sync(self) -> None:
        """fsync-the-filesystem: flush caps + force the MDS journal
        trim."""
        await self.flush_dirty()
        await self.request("flush")

    # -- snapshots -----------------------------------------------------

    async def snap_create(self, path: str, name: str) -> int:
        # buffered EXCL size/mtime must reach the MDS BEFORE it freezes
        # the manifest, or the snapshot records a stale smaller size
        # and snap reads silently truncate acked writes
        await self.flush_dirty()
        out = await self.request("snap_create", path=path, name=name)
        seq, snaps = out["snapc"]
        self.data_io.set_snap_context(seq, snaps)
        return out["snapid"]

    async def snap_remove(self, path: str, name: str) -> None:
        out = await self.request("snap_remove", path=path, name=name)
        seq, snaps = out["snapc"]
        self.data_io.set_snap_context(seq, snaps)

    # -- file I/O ------------------------------------------------------

    def _adopt(self, out: dict) -> None:
        if out.get("caps"):
            self._caps[out["ino"]] = out["caps"]
        snapc = out.get("snapc")
        if snapc:
            self.data_io.set_snap_context(snapc[0], snapc[1])

    def _eff_size(self, out: dict) -> int:
        d = self._dirty.get(out["ino"])
        if d is not None and "size" in d:
            return max(out["size"], d["size"])
        return out["size"]

    async def create(self, path: str, mode: int = 0o644) -> "File":
        out = await self.request("create", path=path, mode=mode)
        self._adopt(out)
        return File(self, path, out["ino"], self._eff_size(out),
                    Layout(*out["layout"]))

    async def open(self, path: str, want: str = "r") -> "File":
        out = await self.request("open", path=path, want=want)
        self._adopt(out)
        return File(self, path, out["ino"], self._eff_size(out),
                    Layout(*out["layout"]),
                    snapid=out.get("snapid"))


class File:
    """An open file: striped data I/O + cap-aware size tracking (Fh).
    ``snapid`` set = a read-only handle inside a ``.snap`` path."""

    def __init__(self, fs: FSClient, path: str, ino: int, size: int,
                 layout: Layout, snapid: int | None = None):
        self.fs = fs
        self.path = path
        self.ino = ino
        self.size = size
        self.layout = layout
        self.snapid = snapid
        if snapid is not None:
            # dedicated snap-read handle: reads resolve at the snapid
            # (librados snap_set_read), never at head
            self._io = IoCtx(fs.data_io.client, fs.data_io.pool_id)
            self._io.snap_set_read(snapid)
        else:
            self._io = fs.data_io

    def _oid(self, objectno: int) -> str:
        return f"{self.ino:x}.{objectno:08x}"

    async def write(self, off: int, data: bytes) -> None:
        if self.snapid is not None:
            raise FSError(errno.EROFS, "snapshot handle")
        if not data:
            return
        pos = 0
        writes = []
        for objectno, obj_off, n in file_to_extents(
                self.layout, off, len(data)):
            writes.append(self.fs.data_io.write(
                self._oid(objectno), data[pos:pos + n], off=obj_off))
            pos += n
        await asyncio.gather(*writes)
        if off + len(data) > self.size:
            self.size = off + len(data)
            if self.fs._caps.get(self.ino, 0) & CAP_EXCL:
                # sole writer: buffer the attr update (no round-trip);
                # flushed on fsync/close/recall
                d = self.fs._dirty.setdefault(
                    self.ino, {"path": self.path})
                d["size"] = max(d.get("size", 0), self.size)
                import time as _time

                d["mtime"] = _time.time()
            else:
                await self.fs.request(
                    "report_size", path=self.path, ino=self.ino,
                    size=self.size)

    async def read(self, off: int = 0, length: int | None = None) -> bytes:
        end = self.size if length is None else min(off + length, self.size)
        if off >= end:
            return b""

        async def _one(objectno: int, obj_off: int, n: int) -> bytes:
            try:
                chunk = await self._io.read(
                    self._oid(objectno), off=obj_off, length=n)
            except RadosError as e:
                if e.errno != errno.ENOENT:
                    raise
                chunk = b""  # sparse hole
            return chunk.ljust(n, b"\0")

        parts = await asyncio.gather(*(
            _one(*ext)
            for ext in file_to_extents(self.layout, off, end - off)))
        return b"".join(parts)

    async def fsync(self) -> None:
        """Flush buffered caps state; refresh our size view."""
        dirty = self.fs._dirty.pop(self.ino, None)
        if dirty is not None:
            await self.fs.request(
                "report_size", path=self.path, ino=self.ino,
                size=dirty.get("size", 0), mtime=dirty.get("mtime"))
        attr = await self.fs.stat(self.path)
        self.size = attr["size"]

    async def close(self) -> None:
        """Flush buffered size/mtime (the cap-flush half of release)."""
        dirty = self.fs._dirty.pop(self.ino, None)
        if dirty is not None:
            await self.fs.request(
                "report_size", path=self.path, ino=self.ino,
                size=dirty.get("size", 0), mtime=dirty.get("mtime"))

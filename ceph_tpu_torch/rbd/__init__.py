"""RBD: a block-image layer over RADOS — the librbd slice.

Mirrors the reference's v2 image format essentials (src/librbd/,
doc/dev/rbd-layering.rst): a small header object holds image metadata
in omap (``rbd_header.<id>``: size, order, object_prefix, snapshots,
parent link), a directory object maps names to ids (``rbd_directory``),
and data lives in ``<prefix>.<objectno:016x>`` objects of 2^order bytes
each.  Like the reference's ``--data-pool`` images, metadata can sit on
a replicated pool while data objects ride an erasure-coded pool.

Capabilities:

- create / open / list / remove; ranged sparse read/write; resize; stat
- **snapshots** (librbd snap_create/snap_list/snap_set/snap_rollback/
  snap_remove, protect/unprotect): each image owns a self-managed RADOS
  SnapContext on its data pool, so image snapshots are object-level COW
  clones underneath (ceph_tpu_torch/osd/snaps.py machinery);
- **layering** (librbd clone/flatten, rbd-layering.rst): a clone's
  header records (parent image, parent snap, overlap); reads fall
  through to the parent's snapshot for objects the child has not
  written; writes copy-up the parent object first, exactly the
  reference's object-granularity COW;
- **exclusive lock** via the in-OSD ``lock`` object class on the header
  (librbd's exclusive_lock feature over cls_lock);
- **object-map / fast-diff** (``features=["object-map"]``,
  src/librbd/object_map/): a 2-bit-per-object state vector that
  short-circuits reads of nonexistent objects and diffs two snapshots
  without touching data objects (ceph_tpu_torch/rbd/objectmap.py);
- **journaling** (``features=["journaling"]``, src/librbd/journal/):
  write-ahead event log on the metadata pool, replayed on open after a
  crash and consumed by rbd-mirror (ceph_tpu_torch/rbd/journal.py);
- **mirroring** (src/tools/rbd_mirror/): journal-based one-way replay
  into a second cluster, with promote/demote (ceph_tpu_torch/rbd/mirror.py).

Counterpart of ``ceph_tpu/rbd/__init__.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno
import json

from ceph_tpu_torch.rbd import objectmap as _OM

RBD_DIRECTORY = "rbd_directory"
DEFAULT_ORDER = 22  # 4 MiB objects, the reference default


class RBDError(OSError):
    pass


class RBD:
    """Pool-level image operations (librbd::RBD)."""

    def __init__(self, meta_ioctx, data_ioctx=None):
        self.meta = meta_ioctx
        self.data = data_ioctx or meta_ioctx

    async def create(
        self, name: str, size: int, order: int = DEFAULT_ORDER,
        features: tuple[str, ...] | list[str] = (),
    ) -> None:
        for f in features:
            if f not in ("object-map", "fast-diff", "journaling"):
                raise RBDError(errno.EINVAL, f"unknown feature {f!r}")
        existing = await self._dir()
        if name in existing:
            raise RBDError(errno.EEXIST, f"image {name!r} exists")
        header = f"rbd_header.{name}"
        await self.meta.omap_set(header, {
            "size": str(size).encode(),
            "order": str(order).encode(),
            "object_prefix": f"rbd_data.{name}".encode(),
            "features": ",".join(features).encode(),
            "primary": b"1",
        })
        await self.meta.omap_set(RBD_DIRECTORY, {name: b"1"})

    async def clone(
        self, parent_name: str, snap_name: str, clone_name: str,
    ) -> None:
        """librbd clone: a new image layered on a PROTECTED parent
        snapshot (rbd-layering.rst)."""
        parent = await self.open(parent_name)
        snap = parent.snaps.get(snap_name)
        if snap is None:
            raise RBDError(errno.ENOENT, f"no snap {snap_name!r}")
        if not snap.get("protected"):
            raise RBDError(
                errno.EINVAL, f"snap {snap_name!r} is not protected")
        existing = await self._dir()
        if clone_name in existing:
            raise RBDError(errno.EEXIST, f"image {clone_name!r} exists")
        await self.meta.omap_set(f"rbd_header.{clone_name}", {
            "size": str(snap["size"]).encode(),
            "order": str(parent.order).encode(),
            "object_prefix": f"rbd_data.{clone_name}".encode(),
            "parent": json.dumps({
                "image": parent_name, "snap": snap_name,
                "snapid": snap["id"], "overlap": snap["size"],
            }).encode(),
        })
        await self.meta.omap_set(RBD_DIRECTORY, {clone_name: b"1"})

    async def _dir(self) -> dict[str, bytes]:
        try:
            return await self.meta.omap_get(RBD_DIRECTORY)
        except OSError as e:
            if e.errno == errno.ENOENT:
                return {}
            raise

    async def list(self) -> list[str]:
        return sorted(await self._dir())

    async def remove(self, name: str) -> None:
        # replay=False: re-applying journal events into an image about
        # to be destroyed is wasted work, and an unreplayable event
        # (e.g. a crash-torn WRITE past a later shrink) would make the
        # image undeletable
        img = await self.open(name, replay=False)
        if img.snaps:
            raise RBDError(errno.ENOTEMPTY, "image has snapshots")
        await img.remove_data()
        try:
            await self.meta.remove(f"rbd_header.{name}")
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise
        await self.meta.omap_rm_keys(RBD_DIRECTORY, [name])

    async def open(self, name: str, replay: bool = True) -> "Image":
        """``replay=False`` opens without journal crash-replay — the
        stance of a NON-OWNING reader (rbd-mirror): replaying another
        client's in-flight events would make this handle a second
        writer and advance the owner's commit_pos under it."""
        try:
            meta = await self.meta.omap_get(f"rbd_header.{name}")
        except OSError as e:
            raise RBDError(errno.ENOENT, f"no image {name!r}") from e
        if "size" not in meta:
            raise RBDError(errno.ENOENT, f"no image {name!r}")
        feats = meta.get("features", b"").decode()
        img = Image(
            self, name,
            size=int(meta["size"]),
            order=int(meta["order"]),
            prefix=meta["object_prefix"].decode(),
            snaps=json.loads(meta.get("snaps", b"{}")),
            parent=json.loads(meta["parent"]) if "parent" in meta else None,
            features=frozenset(f for f in feats.split(",") if f),
            primary=meta.get("primary", b"1") == b"1",
        )
        img._apply_snapc()
        await img._init_features(replay=replay)
        return img


class Image:
    """An open image handle (librbd::Image)."""

    def __init__(self, rbd: RBD, name: str, size: int, order: int,
                 prefix: str, snaps: dict | None = None,
                 parent: dict | None = None,
                 features: frozenset[str] = frozenset(),
                 primary: bool = True):
        self.rbd = rbd
        self.name = name
        self._size = size
        self.order = order
        self.obj_size = 1 << order
        self.prefix = prefix
        #: snap name -> {"id": rados snapid, "size": int, "protected": bool}
        self.snaps: dict[str, dict] = snaps or {}
        #: layering link: {"image", "snap", "snapid", "overlap"} or None
        self.parent = parent
        self.features = features
        #: mirroring role: a demoted (non-primary) image refuses writes
        self.primary = primary
        # per-image data handle: the image's own SnapContext lives here
        self._io = rbd.data.dup()
        self._read_snap_name: str | None = None
        self._parent_img: "Image | None" = None  # lazy, header cached
        self.objmap = None  # ObjectMap when the feature is on
        self.journal = None  # Journal when the feature is on
        self._replaying = False

    def _n_objs(self, size: int | None = None) -> int:
        size = self._size if size is None else size
        return (size + self.obj_size - 1) // self.obj_size

    async def _init_features(self, replay: bool = True) -> None:
        if "object-map" in self.features or "fast-diff" in self.features:
            from ceph_tpu_torch.rbd.objectmap import ObjectMap

            self.objmap = await ObjectMap(
                self.rbd.meta, self.name, self._n_objs()).load()
        if "journaling" in self.features:
            from ceph_tpu_torch.rbd.journal import Journal

            self.journal = Journal(self.rbd.meta, self.name)
            if replay:
                await self._journal_replay()

    async def _journal_replay(self) -> None:
        """Open-time crash recovery (librbd journal replay): re-apply
        every event past commit_pos; events are idempotent."""
        pos = await self.journal.commit_pos()
        events = await self.journal.events_after(pos)
        if not events:
            return
        for seq, head, payload in events:
            await self._apply_journal_event(head, payload)
            await self.journal.commit(seq)

    async def _apply_journal_event(self, head: dict, payload: bytes) -> None:
        """Apply one journaled event to the data path — shared by
        open-time crash replay and rbd-mirror replay (the single
        dispatch over event types; keep it the only one).

        Runs with the guards the PUBLIC ops enforce suspended: replay
        must succeed on a demoted image (mirror failover with a
        pending event would otherwise make the image unopenable), and
        a WRITE journaled before a later-applied shrink may exceed the
        current size — grow for the apply; the RESIZE event that
        follows in the log restores the final geometry."""
        from ceph_tpu_torch.rbd import journal as J

        saved_primary, self.primary = self.primary, True
        self._replaying = True
        try:
            ev = head["event"]
            if ev == J.WRITE:
                end = head["off"] + len(payload)
                if end > self._size:
                    await self.resize(end)
                await self.write(head["off"], payload)
            elif ev == J.RESIZE:
                await self.resize(head["size"])
            elif ev == J.SNAP_CREATE:
                if head["name"] not in self.snaps:
                    await self.snap_create(head["name"])
            elif ev == J.SNAP_REMOVE:
                if head["name"] in self.snaps:
                    await self.snap_remove(head["name"])
        finally:
            self.primary = saved_primary
            self._replaying = False

    # -- basics --------------------------------------------------------

    def size(self) -> int:
        return self._size

    def _oid(self, objectno: int) -> str:
        return f"{self.prefix}.{objectno:016x}"

    def _extents(self, off: int, length: int):
        out = []
        pos, end = off, off + length
        while pos < end:
            objno, obj_off = divmod(pos, self.obj_size)
            n = min(self.obj_size - obj_off, end - pos)
            out.append((objno, obj_off, n))
            pos += n
        return out

    # -- snapshots -----------------------------------------------------

    def _apply_snapc(self) -> None:
        ids = sorted((s["id"] for s in self.snaps.values()), reverse=True)
        self._io.set_snap_context(ids[0] if ids else 0, ids)

    async def _save_header(self, **extra) -> None:
        kv = {"snaps": json.dumps(self.snaps).encode()}
        for k, v in extra.items():
            kv[k] = v
        await self.rbd.meta.omap_set(f"rbd_header.{self.name}", kv)

    async def snap_create(self, snap_name: str) -> int:
        """librbd snap_create: allocate a self-managed RADOS snap and
        fold it into the image's write context — data objects COW on
        the next write."""
        if snap_name in self.snaps:
            raise RBDError(errno.EEXIST, f"snap {snap_name!r} exists")
        if self.journal is not None and not self._replaying:
            from ceph_tpu_torch.rbd import journal as J

            await self.journal.append(
                J.SNAP_CREATE, {"name": snap_name})
        snapid = await self._io.selfmanaged_snap_create()
        self.snaps[snap_name] = {
            "id": snapid, "size": self._size, "protected": False,
        }
        self._apply_snapc()
        await self._save_header()
        if self.objmap is not None:
            # freeze the map under the snap's name, then downgrade the
            # head's EXISTS to EXISTS_CLEAN: from now on EXISTS means
            # 'dirtied since this snapshot' (fast-diff invariant)
            await self.objmap.snapshot_copy(snapid).save()
            self.objmap.freeze_clean()
            await self.objmap.save()
        return snapid

    def snap_list(self) -> list[dict]:
        return [
            {"name": n, **info} for n, info in sorted(
                self.snaps.items(), key=lambda kv: kv[1]["id"])
        ]

    def snap_set(self, snap_name: str | None) -> None:
        """Point READS at a snapshot (None = head), librbd snap_set."""
        if snap_name is not None and snap_name not in self.snaps:
            raise RBDError(errno.ENOENT, f"no snap {snap_name!r}")
        self._read_snap_name = snap_name

    async def snap_protect(self, snap_name: str) -> None:
        self._snap(snap_name)["protected"] = True
        await self._save_header()

    async def snap_unprotect(self, snap_name: str) -> None:
        # the reference refuses while children exist; scan the directory
        for child in await self.rbd.list():
            try:
                img = await self.rbd.open(child)
            except RBDError:
                continue
            if img.parent and img.parent["image"] == self.name \
                    and img.parent["snap"] == snap_name:
                raise RBDError(errno.EBUSY, f"snap has child {child!r}")
        self._snap(snap_name)["protected"] = False
        await self._save_header()

    def _snap(self, snap_name: str) -> dict:
        try:
            return self.snaps[snap_name]
        except KeyError:
            raise RBDError(errno.ENOENT, f"no snap {snap_name!r}") from None

    async def snap_remove(self, snap_name: str) -> None:
        info = self._snap(snap_name)
        if info.get("protected"):
            raise RBDError(errno.EBUSY, f"snap {snap_name!r} is protected")
        if self.journal is not None and not self._replaying:
            from ceph_tpu_torch.rbd import journal as J

            await self.journal.append(
                J.SNAP_REMOVE, {"name": snap_name})
        if self._read_snap_name == snap_name:
            self._read_snap_name = None  # handle falls back to head
        del self.snaps[snap_name]
        self._apply_snapc()
        await self._save_header()
        await self._io.selfmanaged_snap_remove(info["id"])
        if self.objmap is not None:
            from ceph_tpu_torch.rbd.objectmap import ObjectMap

            await ObjectMap(
                self.rbd.meta, self.name, 0, info["id"]).remove()

    async def snap_rollback(self, snap_name: str) -> None:
        """librbd snap_rollback: restore head data to the snapshot."""
        info = self._snap(snap_name)
        snapid = info["id"]
        snap_objs = (info["size"] + self.obj_size - 1) // self.obj_size
        head_objs = (self._size + self.obj_size - 1) // self.obj_size
        reader = self._io.dup()
        reader.snap_set_read(snapid)

        async def _one(objno: int) -> None:
            oid = self._oid(objno)
            try:
                await reader.stat(oid)
                existed = True
            except OSError as e:
                if e.errno != errno.ENOENT:
                    raise
                existed = False
            if existed:
                await self._io.rollback(oid, snapid)
            else:
                try:
                    await self._io.remove(oid)
                except OSError as e:
                    if e.errno != errno.ENOENT:
                        raise

        await asyncio.gather(*(
            _one(i) for i in range(max(snap_objs, head_objs))
        ))
        self._size = info["size"]
        await self._save_header(size=str(self._size).encode())
        if self.objmap is not None:
            # head data now equals the snapshot: adopt its frozen map
            from ceph_tpu_torch.rbd.objectmap import ObjectMap

            snap_map = await ObjectMap(
                self.rbd.meta, self.name,
                self._n_objs(info["size"]), snapid).load()
            self.objmap._bits = bytearray(snap_map._bits)
            self.objmap.n_objs = snap_map.n_objs
            await self.objmap.save()

    # -- exclusive lock (cls_lock over the header) ---------------------

    async def lock_acquire(self, owner: str, shared: bool = False) -> None:
        """librbd exclusive_lock via the in-OSD lock class."""
        try:
            await self.rbd.meta.execute(
                f"rbd_header.{self.name}", "lock", "lock",
                json.dumps({
                    "name": "rbd_lock",
                    "type": "shared" if shared else "exclusive",
                    "cookie": "", "owner": owner,
                }).encode())
        except OSError as e:
            if e.errno == errno.EBUSY:
                raise RBDError(errno.EBUSY, "image is locked") from e
            raise

    async def lock_release(self, owner: str) -> None:
        await self.rbd.meta.execute(
            f"rbd_header.{self.name}", "lock", "unlock",
            json.dumps({
                "name": "rbd_lock", "cookie": "", "owner": owner,
            }).encode())

    async def lock_break(self, owner: str) -> None:
        await self.rbd.meta.execute(
            f"rbd_header.{self.name}", "lock", "break_lock",
            json.dumps({"name": "rbd_lock", "owner": owner}).encode())

    # -- layering ------------------------------------------------------

    async def _parent_read(self, objno: int) -> bytes | None:
        """The parent snapshot's bytes for this child object (None =
        beyond overlap / parent hole)."""
        if self.parent is None:
            return None
        base = objno * self.obj_size
        if base >= self.parent["overlap"]:
            return None
        if self._parent_img is None:
            self._parent_img = await self.rbd.open(self.parent["image"])
        parent = self._parent_img
        pio = parent._io.dup()
        pio.snap_set_read(self.parent["snapid"])
        want = min(self.obj_size, self.parent["overlap"] - base)
        try:
            data = await pio.read(self._oid_of(parent, objno), off=0,
                                  length=want)
        except OSError as e:
            if e.errno == errno.ENOENT:
                return None
            raise
        return data

    @staticmethod
    def _oid_of(img: "Image", objno: int) -> str:
        return f"{img.prefix}.{objno:016x}"

    async def _copy_up(self, objno: int) -> None:
        """Object-granularity COW from the parent before the first
        child write (librbd copy-up)."""
        data = await self._parent_read(objno)
        if data:
            await self._io.write_full(self._oid(objno), data)

    async def flatten(self) -> None:
        """librbd flatten: copy every still-inherited object up, then
        sever the parent link."""
        if self.parent is None:
            return
        n_objs = (self._size + self.obj_size - 1) // self.obj_size

        async def _one(objno: int) -> None:
            try:
                await self._io.stat(self._oid(objno))
                return  # child already owns it
            except OSError as e:
                if e.errno != errno.ENOENT:
                    raise
            await self._copy_up(objno)

        await asyncio.gather(*(_one(i) for i in range(n_objs)))
        self.parent = None
        self._parent_img = None
        await self.rbd.meta.omap_rm_keys(
            f"rbd_header.{self.name}", ["parent"])

    # -- I/O -----------------------------------------------------------

    async def write(self, off: int, data: bytes) -> None:
        if self._read_snap_name is not None:
            raise RBDError(errno.EROFS, "image is set to a snapshot")
        if not self.primary:
            raise RBDError(errno.EROFS, "image is non-primary (demoted)")
        if off + len(data) > self._size:
            raise RBDError(errno.EINVAL, "write past image size")
        seq = None
        if self.journal is not None and not self._replaying:
            from ceph_tpu_torch.rbd import journal as J

            # write-ahead: the event is durable before any data object
            # changes (journal replay re-applies it after a crash)
            seq = await self.journal.append(J.WRITE, {"off": off}, data)
        if self.objmap is not None:
            # mark EXISTS before the data lands: a crash leaves a
            # false EXISTS (harmless), never a false NONEXISTENT
            await self._objmap_mark(
                [e[0] for e in self._extents(off, len(data))],
                _OM.OBJECT_EXISTS)
        pos = 0
        writes = []
        for objno, obj_off, n in self._extents(off, len(data)):
            writes.append(self._write_one(
                objno, obj_off, data[pos : pos + n]))
            pos += n
        await asyncio.gather(*writes)
        if seq is not None:
            await self.journal.commit(seq)

    async def _objmap_mark(self, objnos, state: int) -> None:
        changed = [self.objmap.set(o, state) for o in list(objnos)]
        if any(changed):
            await self.objmap.save()

    async def _write_one(self, objno: int, obj_off: int, chunk: bytes) -> None:
        if self.parent is not None:
            # copy-up unless the child already owns the object
            try:
                await self._io.stat(self._oid(objno))
            except OSError as e:
                if e.errno == errno.ENOENT:
                    await self._copy_up(objno)
                else:
                    raise
        await self._io.write(self._oid(objno), chunk, off=obj_off)

    async def read(self, off: int, length: int) -> bytes:
        read_snap = None
        bound = self._size
        if self._read_snap_name is not None:
            info = self._snap(self._read_snap_name)
            read_snap = info["id"]
            bound = info["size"]
        end = min(off + length, bound)
        if off >= end:
            return b""

        async def _one(objno: int, obj_off: int, n: int) -> bytes:
            if (
                read_snap is None and self.objmap is not None
                and self.objmap.get(objno) == _OM.OBJECT_NONEXISTENT
            ):
                # object-map fast path: provably no data object — skip
                # the OSD round trip, fall straight to parent/zeros
                chunk = b""
                if self.parent is not None:
                    pdata = await self._parent_read(objno)
                    if pdata is not None:
                        chunk = pdata[obj_off : obj_off + n]
                return chunk.ljust(n, b"\0")
            io = self._io
            if read_snap is not None:
                io = self._io.dup()
                io.snap_set_read(read_snap)
            try:
                chunk = await io.read(
                    self._oid(objno), off=obj_off, length=n
                )
            except OSError as e:
                if e.errno == errno.ENOENT:
                    chunk = b""
                else:
                    raise
            if not chunk and self.parent is not None:
                pdata = await self._parent_read(objno)
                if pdata is not None:
                    chunk = pdata[obj_off : obj_off + n]
            return chunk.ljust(n, b"\0")

        parts = await asyncio.gather(*(
            _one(*ext) for ext in self._extents(off, end - off)
        ))
        return b"".join(parts)

    async def resize(self, new_size: int) -> None:
        if self.journal is not None and not self._replaying:
            from ceph_tpu_torch.rbd import journal as J

            seq = await self.journal.append(J.RESIZE, {"size": new_size})
        else:
            seq = None
        await self._resize_inner(new_size)
        if self.objmap is not None:
            self.objmap.resize(self._n_objs(new_size))
            await self.objmap.save()
        if seq is not None:
            await self.journal.commit(seq)

    async def _resize_inner(self, new_size: int) -> None:
        if new_size < self._size:
            # drop whole objects past the end; trim the boundary object
            first_dead = (new_size + self.obj_size - 1) // self.obj_size
            last_old = (self._size + self.obj_size - 1) // self.obj_size
            ops = []
            for objno in range(first_dead, last_old):
                ops.append(self._remove_quiet(self._oid(objno)))
            if new_size % self.obj_size:
                ops.append(self._trim_quiet(
                    self._oid(new_size // self.obj_size),
                    new_size % self.obj_size,
                ))
            if ops:
                await asyncio.gather(*ops)
            if self.parent is not None and \
                    self.parent["overlap"] > new_size:
                # shrink clips the parent overlap permanently: space
                # re-grown later must read zeros, not parent bytes
                self.parent["overlap"] = new_size
                await self.rbd.meta.omap_set(
                    f"rbd_header.{self.name}",
                    {"parent": json.dumps(self.parent).encode()})
        self._size = new_size
        await self.rbd.meta.omap_set(f"rbd_header.{self.name}", {
            "size": str(new_size).encode(),
        })

    async def _trim_quiet(self, oid: str, keep: int) -> None:
        try:
            cur = await self._io.stat(oid)
        except OSError as e:
            if e.errno == errno.ENOENT:
                return
            raise
        if cur > keep:
            # through the image handle: its SnapContext makes the OSD
            # clone before the cut, so snapshots keep the trimmed bytes
            await self._io.truncate(oid, keep)

    async def _remove_quiet(self, oid: str) -> None:
        try:
            await self._io.remove(oid)
        except OSError as e:
            if e.errno != errno.ENOENT:
                raise

    # -- fast-diff / mirroring roles -----------------------------------

    async def fast_diff(
        self, from_snap: str | None = None,
    ) -> list[tuple[int, int]]:
        """librbd diff_iterate with whole-object=true over the object
        maps (src/librbd/api/DiffIterate.cc fast-diff path): byte
        extents that may differ from ``from_snap`` (None = allocated
        extents), WITHOUT reading any data object.

        EXISTS in a map means 'dirtied since the PREVIOUS snapshot',
        so the endpoint maps alone can't see a write that landed
        between two intermediate snapshots and was then frozen to
        EXISTS_CLEAN — the union over every snapshot map taken after
        ``from_snap``, plus head, can."""
        if self.objmap is None:
            raise RBDError(errno.EOPNOTSUPP, "fast-diff requires object-map")
        if from_snap is None:
            changed = set(self.objmap.diff(None))
        else:
            from ceph_tpu_torch.rbd.objectmap import ObjectMap

            info = self._snap(from_snap)
            since = await ObjectMap(
                self.rbd.meta, self.name,
                self._n_objs(info["size"]), info["id"]).load()
            later = [
                s for s in self.snaps.values() if s["id"] > info["id"]
            ]
            maps = list(await asyncio.gather(*(
                ObjectMap(
                    self.rbd.meta, self.name,
                    self._n_objs(s["size"]), s["id"]).load()
                for s in sorted(later, key=lambda s: s["id"])
            ))) + [self.objmap]
            changed = set()
            for m in maps:
                changed.update(m.diff(since))
        out = []
        for objno in sorted(changed):
            base = objno * self.obj_size
            if base < self._size:
                out.append((base, min(self.obj_size, self._size - base)))
        return out

    async def demote(self) -> None:
        """rbd mirror demote: this side stops accepting writes (the
        peer may promote)."""
        self.primary = False
        await self.rbd.meta.omap_set(
            f"rbd_header.{self.name}", {"primary": b"0"})

    async def promote(self) -> None:
        self.primary = True
        await self.rbd.meta.omap_set(
            f"rbd_header.{self.name}", {"primary": b"1"})

    async def remove_data(self) -> None:
        if self.objmap is not None:
            await self.objmap.remove()
        if self.journal is not None:
            await self.journal.destroy()
        await asyncio.gather(*(
            self._remove_quiet(self._oid(i)) for i in range(self._n_objs())
        ))

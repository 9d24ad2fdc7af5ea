"""MDS-lite: the single-active metadata server.

Behavioral twin of the reference MDS reduced to one rank, no subtree
migration (src/mds/MDSDaemon.cc boot, src/mds/Server.cc request
dispatch, src/mds/MDCache.cc the inode/dentry cache): directory
content lives as omap on per-directory "dirfrag" objects in the
metadata pool (``<ino hex>.00000000``, the CDir backing store), with
each inode embedded in its parent's primary dentry exactly like the
reference stores InodeStore inline; every mutation journals first
(:mod:`ceph_tpu_torch.fs.journal`, the src/mds/journal.cc EMetaBlob
discipline) then applies to the cache, and dirty dirfrags flush back
lazily — restart replays the journal over the flushed state.

File DATA does not pass through the MDS: clients stripe file bytes
directly to the data pool as ``<ino hex>.<objno 8x>`` objects (the
CephFS file layout); the MDS allocates inos, owns size/mtime truth,
and purges data on unlink — the PurgeQueue role, done inline.

**Capabilities (the Locker role, src/mds/Locker.cc reduced to one
file lock class).**  Per-(session, ino) cap bits: RD (may cache
attrs), WR (may report size), EXCL (may BUFFER size/mtime updates
locally).  A writer opening alone gets RD|WR|EXCL; a second client
touching the file forces a recall — the MDS sends MClientCaps REVOKE,
the holder FLUSHes its buffered size/mtime (journaled as setattr) and
ACKs — so every size the MDS serves reflects all flushed writes, and
only sessions holding WR may move a size (closing the v1
any-client-reports-anything hole).

**Snapshots (SnapRealm-lite, src/mds/SnapRealm.cc + snapc plumbing).**
``snap_create(dir, name)`` allocates a self-managed snapid on the DATA
pool (object-level COW under overwrite, ceph_tpu_torch/osd/snaps.py), then
freezes the subtree's metadata into a manifest object
(``snapmeta.<ino hex>.<snapid>``) — written before the journal event
so replay always finds it.  Clients learn the new snap context via an
MClientCaps SNAPC broadcast and stamp subsequent data writes with it.
Reads traverse ``dir/.snap/<name>/...`` against the manifest, with
file data read at the snapid.  The snap context is data-pool-global
(a conservative superset of the per-realm context the reference
computes — extra clones, never missing ones).

Counterpart of ``ceph_tpu/fs/mds.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno
import itertools
import logging
import time

from ceph_tpu_torch.client.rados import ObjectOperation, RadosClient, RadosError
from ceph_tpu_torch.client.striper import Layout, file_to_extents
from ceph_tpu_torch.msg.messages import MClientCaps, MClientReply, MClientRequest
from ceph_tpu_torch.msg.messenger import Messenger

from .journal import Journaler

log = logging.getLogger("ceph_tpu_torch.mds")

ROOT_INO = 1  # MDS_INO_ROOT (src/mds/mdstypes.h)
DEFAULT_LAYOUT = [65536, 4, 4 * 2**20]  # [stripe_unit, stripe_count, object_size]

# cap bits (the CEPH_CAP_FILE_* lattice collapsed to three rungs)
CAP_RD = 1    # may cache attrs / serve stat locally
CAP_WR = 2    # may write data + report size (setattr/flush accepted)
CAP_EXCL = 4  # sole writer: may buffer size/mtime, flushed on recall


class FSError(OSError):
    pass


def _err(code: int, msg: str) -> FSError:
    return FSError(code, msg)


class MDSDaemon:
    """One MDS rank over the shared Messenger, backed by RADOS pools.

    ``flush_every``: dirty-dirfrag writeback + journal checkpoint cadence
    in events (LogSegment size, tiny here so tests hit both paths).
    """

    def __init__(self, rank: int, mon_addr: tuple[str, int],
                 meta_pool: str = "cephfs.meta",
                 data_pool: str = "cephfs.data",
                 flush_every: int = 128, conf=None):
        self.rank = rank
        self.mon_addr = mon_addr
        self.meta_pool = meta_pool
        self.data_pool = data_pool
        self.flush_every = flush_every
        self.messenger = Messenger(("mds", rank), self._dispatch)
        self.rados: RadosClient | None = None
        self.journal: Journaler | None = None
        self.ino_next = ROOT_INO + 1
        # MDCache: ino -> {"entries": {name: rec}, "dirty": bool}
        self._dirs: dict[int, dict] = {}
        self._doomed: set[int] = set()     # dirfrag objects to remove at flush
        self._mutation_lock = asyncio.Lock()  # single-MDS total order
        self._events_since_flush = 0
        # completed-request cache (the reference session's
        # completed_requests): reqid -> reply payload, rebuilt from the
        # journal on replay, so a client retrying a mutation whose
        # first attempt landed gets its original answer instead of
        # EEXIST/ENOENT
        self._completed: dict[str, dict] = {}
        self._cur_reqid: str | None = None
        self._cur_conn = None
        self.addr: tuple[str, int] | None = None
        # caps (Locker): ino -> {conn: bits}; conns are the sessions
        self._cap_holders: dict[int, dict] = {}
        self._cap_tids = itertools.count(1)
        self._cap_waiters: dict[int, asyncio.Future] = {}
        self._sessions: set = set()  # live conns (for SNAPC broadcast)
        # snapshots (SnapRealm-lite): dir ino -> {name: {"id", "t"}}
        self._realms: dict[int, dict] = {}
        self._snap_seq = 0
        # mgr report stream (MgrMap rides the rados session's mon
        # subscription; reports go out over our own messenger)
        from ceph_tpu_torch.common import ConfigProxy, get_perf_counters
        from ceph_tpu_torch.common.tracing import Tracer
        from ceph_tpu_torch.mgr.client import MgrClient

        self.conf = conf if conf is not None else ConfigProxy()
        self.perf = get_perf_counters(f"mds.{rank}")
        self.tracer = Tracer(
            f"mds.{rank}",
            ring_max=self.conf["trace_ring_max"],
            sample_rate=self.conf["trace_sample_rate"],
            tail_slow_s=(self.conf["trace_tail_slow_s"] or None),
        )
        self.messenger.tracer = self.tracer
        self._admin = None
        self.mgr_client = MgrClient(
            f"mds.{rank}", self.messenger, self.conf,
            self._mgr_collect, tracers=(self.tracer,))

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        self.rados = RadosClient(client_id=(7000 + self.rank))
        await self.rados.connect(*self.mon_addr)
        self.meta_io = self.rados.ioctx(self.meta_pool)
        self.data_io = self.rados.ioctx(self.data_pool)
        self.journal = Journaler(self.meta_io, f"mds{self.rank}.journal")
        state, events = await self.journal.load()
        self.ino_next = state.get("ino_next", ROOT_INO + 1)
        self._realms = {
            int(k): v for k, v in state.get("realms", {}).items()}
        self._snap_seq = state.get("snap_seq", 0)
        for ev in events:
            await self._apply(ev, replay=True)
        self.addr = await self.messenger.bind()
        sock_path = self.conf["admin_socket"]
        if sock_path:
            from ceph_tpu_torch.common import AdminSocket

            self._admin = AdminSocket(
                sock_path.replace("$id", f"mds.{self.rank}"))
            self._admin.register(
                "dump_traces", "recent spans (blkin/otel role)",
                lambda cmd: self.tracer.dump(),
            )
            self._admin.register(
                "perf dump", "dump perf counters",
                lambda cmd: self.perf.dump(),
            )
            self._admin.register(
                "status", "daemon status",
                lambda cmd: {
                    "mds": self.rank,
                    "cached_dirs": len(self._dirs),
                    "sessions": len(self._sessions),
                },
            )
            await self._admin.start()
        self.rados.set_mgr_map_listener(self.mgr_client.handle_mgr_map)
        self.mgr_client.start()
        log.info("mds.%d: up at %s, replayed %d events",
                 self.rank, self.addr, len(events))

    async def stop(self) -> None:
        """Clean shutdown: flush + trim, then drop sessions."""
        await self.mgr_client.stop()
        if self._admin is not None:
            await self._admin.stop()
        async with self._mutation_lock:
            await self._flush()
        await self.messenger.shutdown()
        await self.rados.shutdown()

    async def crash(self) -> None:
        """Test hook: die WITHOUT flushing — restart must replay."""
        await self.mgr_client.stop()
        if self._admin is not None:
            await self._admin.stop()
        await self.messenger.shutdown()
        await self.rados.shutdown()

    def _mgr_collect(self) -> dict:
        return {
            "counters": self.perf.dump(),
            "gauges": {
                "cached_dirs": float(len(self._dirs)),
                "sessions": float(len(self._sessions)),
            },
            "status": {"rank": self.rank,
                       "snap_seq": self._snap_seq},
        }

    # -- dirfrag cache (MDCache/CDir) ----------------------------------

    def _dirfrag_oid(self, ino: int) -> str:
        return f"{ino:x}.00000000"

    async def _dir(self, ino: int) -> dict:
        d = self._dirs.get(ino)
        if d is None:
            import json

            try:
                omap = await self.meta_io.omap_get(self._dirfrag_oid(ino))
            except RadosError as e:
                if e.errno != errno.ENOENT:
                    raise
                omap = {}
            d = {"entries": {k: json.loads(v) for k, v in omap.items()},
                 "dirty": False}
            self._dirs[ino] = d
        return d

    async def _flush(self) -> None:
        """Write back dirty dirfrags, delete doomed ones, checkpoint
        the journal (LogSegment expiry)."""
        import json

        for ino, d in list(self._dirs.items()):
            if not d["dirty"] or ino in self._doomed:
                continue
            op = ObjectOperation().omap_clear().omap_set({
                name: json.dumps(rec).encode()
                for name, rec in d["entries"].items()
            })
            await self.meta_io.operate(self._dirfrag_oid(ino), op)
            d["dirty"] = False
        for ino in list(self._doomed):
            try:
                await self.meta_io.remove(self._dirfrag_oid(ino))
            except RadosError:
                pass
            self._doomed.discard(ino)
            self._dirs.pop(ino, None)
        await self.journal.checkpoint({
            "ino_next": self.ino_next,
            "realms": {str(k): v for k, v in self._realms.items()},
            "snap_seq": self._snap_seq,
        })
        self._events_since_flush = 0

    async def _journal_and_apply(self, ev: dict) -> None:
        if self._cur_reqid:
            ev["reqid"] = self._cur_reqid
        await self.journal.append(ev)
        await self._apply(ev)
        self._events_since_flush += 1
        if self._events_since_flush >= self.flush_every:
            await self._flush()

    @staticmethod
    def _reply_of(ev: dict) -> dict:
        """The reply payload a journaled mutation produced — derivable
        from the event, so replay can rebuild the completed-request
        cache."""
        op = ev["op"]
        if op == "create":
            return {"ino": ev["ino"], "size": 0, "layout": ev["layout"],
                    "existed": False}
        if op in ("mkdir", "symlink"):
            return {"ino": ev["ino"]}
        return {}

    def _record_completed(self, reqid: str, out: dict) -> None:
        self._completed[reqid] = out
        while len(self._completed) > 4096:
            self._completed.pop(next(iter(self._completed)))

    # -- event application (EMetaBlob::replay) -------------------------

    async def _apply(self, ev: dict, replay: bool = False) -> None:
        """Idempotent apply of a journal event to the cache.  During
        replay the affected dirfrags load from their flushed state
        first, then the event lands on top."""
        op = ev["op"]
        if ev.get("reqid"):
            self._record_completed(ev["reqid"], self._reply_of(ev))
        if op in ("mkdir", "create", "symlink"):
            d = await self._dir(ev["p"])
            rec = {"ino": ev["ino"], "mtime": ev["t"],
                   "mode": ev.get("mode", 0o644)}
            if op == "mkdir":
                rec["type"] = "dir"
            elif op == "create":
                rec["type"] = "file"
                rec["size"] = 0
                rec["layout"] = ev["layout"]
            else:
                rec["type"] = "symlink"
                rec["target"] = ev["target"]
            d["entries"][ev["n"]] = rec
            d["dirty"] = True
            if replay:
                self.ino_next = max(self.ino_next, ev["ino"] + 1)
        elif op in ("unlink", "rmdir"):
            d = await self._dir(ev["p"])
            d["entries"].pop(ev["n"], None)
            d["dirty"] = True
            if op == "rmdir":
                self._doomed.add(ev["ino"])
                self._dirs.pop(ev["ino"], None)
            purge = ev.get("purge")
            if purge:
                await self._purge_data(
                    purge["ino"], purge["size"], purge["layout"])
        elif op == "rename":
            src = await self._dir(ev["sp"])
            dst = await self._dir(ev["dp"])
            rec = src["entries"].pop(ev["sn"], None)
            purge = ev.get("purge")
            if purge:
                await self._purge_data(
                    purge["ino"], purge["size"], purge["layout"])
            if ev.get("doom") is not None:  # replaced an empty dir
                self._doomed.add(ev["doom"])
                self._dirs.pop(ev["doom"], None)
            if rec is not None:
                dst["entries"][ev["dn"]] = rec
            src["dirty"] = dst["dirty"] = True
        elif op == "setattr":
            d = await self._dir(ev["p"])
            rec = d["entries"].get(ev["n"])
            trunc = ev.get("truncate")
            if trunc:
                # data truncation lives HERE, after the event is
                # durable: a crash before the append leaves the file
                # intact; replay re-truncates (idempotent)
                await self._truncate_data(trunc, ev["size"])
            if rec is not None:
                for f in ("size", "mtime", "mode"):
                    if f in ev:
                        rec[f] = ev[f]
                d["dirty"] = True
        elif op == "snap_create":
            realm = self._realms.setdefault(ev["ino"], {})
            realm[ev["n"]] = {"id": ev["snapid"], "t": ev["t"]}
            self._snap_seq = max(self._snap_seq, ev["snapid"])
        elif op == "snap_remove":
            realm = self._realms.get(ev["ino"], {})
            realm.pop(ev["n"], None)
            if not realm:
                self._realms.pop(ev["ino"], None)
            # idempotent cleanup, also on replay: a crash between the
            # journal append and these removals must not leak the
            # manifest or the rados snap (clone space) forever
            try:
                await self.meta_io.remove(
                    f"snapmeta.{ev['ino']:x}.{ev['snapid']}")
            except RadosError:
                pass
            try:
                await self.data_io.selfmanaged_snap_remove(ev["snapid"])
            except RadosError:
                pass
        else:  # pragma: no cover
            log.warning("mds: unknown journal op %r", op)

    async def _purge_data(self, ino: int, size: int, layout: list) -> None:
        """Inline PurgeQueue: drop the file's data objects."""
        lay = Layout(*layout)
        objnos = {0}
        for objectno, _o, _n in file_to_extents(lay, 0, max(size, 1)):
            objnos.add(objectno)
        for objectno in objnos:
            try:
                await self.data_io.remove(f"{ino:x}.{objectno:08x}")
            except RadosError:
                pass

    # -- path resolution (MDCache::path_traverse) ----------------------

    @staticmethod
    def _split(path: str) -> list[str]:
        parts = [p for p in path.split("/") if p]
        if any(p == ".." for p in parts):
            raise _err(errno.EINVAL, "'..' not supported")
        return [p for p in parts if p != "."]

    async def _resolve_dir(self, parts: list[str]) -> int:
        """Walk every component as a directory; returns its ino."""
        ino = ROOT_INO
        for name in parts:
            d = await self._dir(ino)
            rec = d["entries"].get(name)
            if rec is None:
                raise _err(errno.ENOENT, name)
            if rec["type"] != "dir":
                raise _err(errno.ENOTDIR, name)
            ino = rec["ino"]
        return ino

    async def _resolve_parent(self, path: str) -> tuple[int, str]:
        parts = self._split(path)
        if not parts:
            raise _err(errno.EINVAL, "root")
        if ".snap" in parts:
            raise _err(errno.EROFS, "snapshots are read-only")
        return await self._resolve_dir(parts[:-1]), parts[-1]

    async def _snap_lookup(self, path: str) -> tuple[dict, int] | None:
        """Resolve a ``dir/.snap/<name>/rest`` path against the frozen
        manifest; returns (rec, snapid) or None for live paths."""
        import json

        parts = self._split(path)
        if ".snap" not in parts:
            return None
        i = parts.index(".snap")
        if i == len(parts) - 1:
            raise _err(errno.EINVAL, ".snap itself is not a snapshot")
        dino = await self._resolve_dir(parts[:i])
        name = parts[i + 1]
        snap = self._realms.get(dino, {}).get(name)
        if snap is None:
            raise _err(errno.ENOENT, f".snap/{name}")
        snapid = snap["id"]
        try:
            raw = await self.meta_io.read(f"snapmeta.{dino:x}.{snapid}")
        except RadosError:
            raise _err(errno.EIO, "snapshot manifest missing") from None
        node: dict = {"type": "dir", "ino": dino, "mode": 0o755,
                      "mtime": snap["t"], "children": json.loads(raw)}
        for comp in parts[i + 2:]:
            if node["type"] != "dir":
                raise _err(errno.ENOTDIR, comp)
            rec = node.get("children", {}).get(comp)
            if rec is None:
                raise _err(errno.ENOENT, comp)
            node = rec
        return node, snapid

    async def _lookup(self, path: str) -> dict:
        snap = await self._snap_lookup(path)
        if snap is not None:
            rec, snapid = snap
            out = {k: v for k, v in rec.items() if k != "children"}
            out["snapid"] = snapid
            return out
        parts = self._split(path)
        if not parts:
            return {"ino": ROOT_INO, "type": "dir", "mode": 0o755,
                    "mtime": 0}
        pino = await self._resolve_dir(parts[:-1])
        d = await self._dir(pino)
        rec = d["entries"].get(parts[-1])
        if rec is None:
            raise _err(errno.ENOENT, path)
        return rec

    # -- request dispatch (src/mds/Server.cc) --------------------------

    async def _dispatch(self, msg) -> None:
        if isinstance(msg, MClientCaps):
            await self._handle_caps(msg)
            return
        if not isinstance(msg, MClientRequest):
            return
        self._sessions.add(msg.conn)
        args = dict(msg.args)
        reqid = args.pop("_reqid", None)
        with self.tracer.span(
            "mds_req", ctx=msg.trace, op=msg.op,
            reqid=str(reqid or msg.tid),
        ):
            await self._serve_request(msg, args, reqid)

    async def _serve_request(self, msg, args: dict, reqid) -> None:
        import inspect

        handler = getattr(self, f"_op_{msg.op}", None)
        if handler is None:
            reply = MClientReply(msg.tid, -errno.EOPNOTSUPP)
        elif reqid is not None and reqid in self._completed:
            # a retry of a mutation that already landed: original answer
            reply = MClientReply(msg.tid, 0, self._completed[reqid])
        else:
            try:
                # bad client args must NOT be conflated with handler
                # bugs: bind-check here, so a TypeError raised deeper
                # inside the handler surfaces as a logged EIO below
                inspect.signature(handler).bind(**args)
            except TypeError:
                reply = MClientReply(msg.tid, -errno.EINVAL)
            else:
                try:
                    # cap recalls run BEFORE the mutation lock: a
                    # revoked holder's FLUSH needs the lock to journal
                    # its dirty size — recalling inside it would
                    # deadlock (Locker orders lock acquisition the
                    # same way)
                    await self._pre_recall(msg.op, args, msg.conn)
                    # reads serialize with mutations too: _apply awaits
                    # mid-event (dirfrag loads, purges), so an unlocked
                    # read could observe a half-applied rename
                    async with self._mutation_lock:
                        self._cur_reqid = reqid
                        self._cur_conn = msg.conn
                        try:
                            out = await handler(**args)
                        finally:
                            self._cur_reqid = None
                            self._cur_conn = None
                    reply = MClientReply(msg.tid, 0, out or {})
                except FSError as e:
                    reply = MClientReply(msg.tid, -(e.errno or errno.EIO))
                except Exception:
                    log.exception("mds: %s failed", msg.op)
                    reply = MClientReply(msg.tid, -errno.EIO)
        try:
            await msg.conn.send_message(reply)
        except ConnectionError:
            pass

    # -- capabilities (Locker) -----------------------------------------

    async def _handle_caps(self, msg: MClientCaps) -> None:
        if msg.op == MClientCaps.FLUSH:
            # dirty size/mtime from a (soon to be ex-) cap holder: the
            # session must actually hold WR or EXCL on the ino, and
            # the path must still resolve to it — anything else is
            # ignored (the trust hole v1 left open)
            bits = self._cap_holders.get(msg.ino, {}).get(msg.conn, 0)
            if not bits & (CAP_WR | CAP_EXCL):
                log.warning("mds: uncapped flush for ino %x dropped",
                            msg.ino)
                return
            async with self._mutation_lock:
                try:
                    pino, name = await self._resolve_parent(msg.path)
                    d = await self._dir(pino)
                    rec = d["entries"].get(name)
                except FSError:
                    rec = None
                if rec is None or rec.get("ino") != msg.ino:
                    return
                ev = {"op": "setattr", "p": pino, "n": name}
                if msg.size > rec.get("size", 0):
                    # flushes only EXTEND — truncation is an explicit
                    # MDS-executed op, and a stale flush racing a
                    # fresh truncate must not resurrect the old size
                    ev["size"] = msg.size
                if msg.mtime >= 0:
                    ev["mtime"] = msg.mtime
                if len(ev) > 3:
                    await self._journal_and_apply(ev)
        elif msg.op == MClientCaps.ACK:
            fut = self._cap_waiters.get(msg.tid)
            if fut and not fut.done():
                fut.set_result(msg)

    async def _pre_recall(self, op: str, args: dict, conn) -> None:
        """Revoke conflicting caps before the op runs (Locker's
        wrlock/rdlock acquisition order).  EXCL-only recalls flush the
        sole writer's buffered size; full recalls also invalidate
        reader caches (writer arriving / namespace op)."""
        paths: list[tuple[str, bool]] = []  # (path, only_excl)
        if op in ("stat", "readdir"):
            paths = [(args.get("path", ""), True)]
        elif op == "open":
            paths = [(args.get("path", ""),
                      args.get("want", "r") != "w")]
        elif op == "create":
            paths = [(args.get("path", ""), False)]
        elif op in ("setattr", "unlink"):
            paths = [(args.get("path", ""), False)]
        elif op == "rename":
            paths = [(args.get("src", ""), False),
                     (args.get("dst", ""), False)]
        elif op == "snap_create":
            # the freeze must see every holder's buffered size/mtime:
            # recall EXCL across the WHOLE subtree before the manifest
            # is frozen, or snapshot reads silently truncate acked
            # writes (ADVICE r5 #1)
            path = args.get("path", "")
            if path and ".snap" not in path.strip("/").split("/"):
                inos: list[int] = []
                async with self._mutation_lock:
                    try:
                        rec = await self._lookup(path)
                        if rec["type"] == "dir":
                            inos = await self._subtree_inos(rec["ino"])
                    except FSError:
                        inos = []
                for ino in inos:
                    if ino in self._cap_holders:
                        await self._recall(ino, except_conn=None,
                                           only_excl=True)
            return
        for path, only_excl in paths:
            # exact path-component test: only a literal ".snap"
            # component is a snapshot view — a file merely named e.g.
            # "dir/.snapshot" still needs cap coherence
            if not path or ".snap" in path.strip("/").split("/"):
                continue
            async with self._mutation_lock:
                try:
                    ino = (await self._lookup(path))["ino"]
                except FSError:
                    continue
            if ino in self._cap_holders:
                await self._recall(ino, except_conn=conn,
                                   only_excl=only_excl)

    async def _recall(self, ino: int, except_conn=None,
                      only_excl: bool = False) -> None:
        holders = self._cap_holders.get(ino)
        if not holders:
            return
        targets = [
            (c, bits) for c, bits in list(holders.items())
            if c is not except_conn
            and (bits & CAP_EXCL if only_excl else bits)
        ]
        loop = asyncio.get_running_loop()
        for conn, bits in targets:
            keep = (bits & ~CAP_EXCL) if only_excl else 0
            tid = next(self._cap_tids)
            fut: asyncio.Future = loop.create_future()
            self._cap_waiters[tid] = fut
            try:
                await conn.send_message(MClientCaps(
                    tid=tid, op=MClientCaps.REVOKE, ino=ino, caps=keep))
                await asyncio.wait_for(fut, 5.0)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                # dead or unresponsive session forfeits its caps (the
                # reference evicts after session autoclose)
                holders.pop(conn, None)
                continue
            finally:
                self._cap_waiters.pop(tid, None)
            if keep:
                holders[conn] = keep
            else:
                holders.pop(conn, None)
        if not holders:
            self._cap_holders.pop(ino, None)

    def _grant(self, ino: int, conn, bits: int) -> int:
        holders = self._cap_holders.setdefault(ino, {})
        cur = holders.get(conn, 0) | bits
        holders[conn] = cur
        return cur

    def _snapc(self) -> list:
        """[seq, snaps-newest-first] — the data pool's snap context."""
        ids = sorted(
            (s["id"] for realm in self._realms.values()
             for s in realm.values()), reverse=True)
        return [self._snap_seq, ids]

    async def _broadcast_snapc(self) -> None:
        seq, ids = self._snapc()
        for conn in list(self._sessions):
            try:
                await conn.send_message(MClientCaps(
                    op=MClientCaps.SNAPC, snap_seq=seq, snaps=ids))
            except (ConnectionError, OSError):
                self._sessions.discard(conn)

    # mutations --------------------------------------------------------

    async def _op_mkdir(self, path: str, mode: int = 0o755) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        if name in d["entries"]:
            raise _err(errno.EEXIST, path)
        ino = self.ino_next
        self.ino_next += 1
        await self._journal_and_apply({
            "op": "mkdir", "p": pino, "n": name, "ino": ino,
            "mode": mode, "t": time.time(),
        })
        return {"ino": ino}

    async def _op_create(self, path: str, mode: int = 0o644,
                         layout: list | None = None) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        rec = d["entries"].get(name)
        if rec is not None:
            if rec["type"] != "file":
                raise _err(errno.EISDIR, path)
            others = [
                c for c in self._cap_holders.get(rec["ino"], {})
                if c is not self._cur_conn
            ]
            bits = self._grant(
                rec["ino"], self._cur_conn,
                CAP_RD | CAP_WR | (0 if others else CAP_EXCL))
            return {"ino": rec["ino"], "size": rec["size"],
                    "layout": rec["layout"], "existed": True,
                    "caps": bits, "snapc": self._snapc()}
        ino = self.ino_next
        self.ino_next += 1
        lay = list(layout or DEFAULT_LAYOUT)
        await self._journal_and_apply({
            "op": "create", "p": pino, "n": name, "ino": ino,
            "mode": mode, "layout": lay, "t": time.time(),
        })
        bits = self._grant(ino, self._cur_conn,
                           CAP_RD | CAP_WR | CAP_EXCL)
        return {"ino": ino, "size": 0, "layout": lay, "existed": False,
                "caps": bits, "snapc": self._snapc()}

    async def _op_symlink(self, path: str, target: str) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        if name in d["entries"]:
            raise _err(errno.EEXIST, path)
        ino = self.ino_next
        self.ino_next += 1
        await self._journal_and_apply({
            "op": "symlink", "p": pino, "n": name, "ino": ino,
            "target": target, "t": time.time(),
        })
        return {"ino": ino}

    async def _op_unlink(self, path: str) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        rec = d["entries"].get(name)
        if rec is None:
            raise _err(errno.ENOENT, path)
        if rec["type"] == "dir":
            raise _err(errno.EISDIR, path)
        ev = {"op": "unlink", "p": pino, "n": name}
        if rec["type"] == "file":
            ev["purge"] = {"ino": rec["ino"], "size": rec["size"],
                           "layout": rec["layout"]}
        await self._journal_and_apply(ev)
        return {}

    async def _op_rmdir(self, path: str) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        rec = d["entries"].get(name)
        if rec is None:
            raise _err(errno.ENOENT, path)
        if rec["type"] != "dir":
            raise _err(errno.ENOTDIR, path)
        child = await self._dir(rec["ino"])
        if child["entries"]:
            raise _err(errno.ENOTEMPTY, path)
        await self._journal_and_apply({
            "op": "rmdir", "p": pino, "n": name, "ino": rec["ino"],
        })
        return {}

    async def _op_rename(self, src: str, dst: str) -> dict:
        src_parts, dst_parts = self._split(src), self._split(dst)
        # POSIX rename(2): moving a directory into its own subtree
        # orphans it — EINVAL (paths are the namespace here, so a
        # prefix test is exact: no hardlinked dirs exist)
        if dst_parts[:len(src_parts)] == src_parts and src_parts:
            if len(dst_parts) > len(src_parts):
                raise _err(errno.EINVAL, "rename into own subtree")
        sp, sn = await self._resolve_parent(src)
        dp, dn = await self._resolve_parent(dst)
        sd = await self._dir(sp)
        rec = sd["entries"].get(sn)
        if rec is None:
            raise _err(errno.ENOENT, src)
        dd = await self._dir(dp)
        existing = dd["entries"].get(dn)
        ev = {"op": "rename", "sp": sp, "sn": sn, "dp": dp, "dn": dn}
        if existing is not None:
            if existing["ino"] == rec["ino"]:
                return {}
            if existing["type"] == "dir":
                if rec["type"] != "dir":
                    raise _err(errno.EISDIR, dst)
                if (await self._dir(existing["ino"]))["entries"]:
                    raise _err(errno.ENOTEMPTY, dst)
                ev["doom"] = existing["ino"]
            elif rec["type"] == "dir":
                raise _err(errno.ENOTDIR, dst)
            elif existing["type"] == "file":
                ev["purge"] = {"ino": existing["ino"],
                               "size": existing["size"],
                               "layout": existing["layout"]}
        await self._journal_and_apply(ev)
        return {}

    async def _op_setattr(self, path: str, size: int | None = None,
                          mtime: float | None = None,
                          mode: int | None = None) -> dict:
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        rec = d["entries"].get(name)
        if rec is None:
            raise _err(errno.ENOENT, path)
        ev = {"op": "setattr", "p": pino, "n": name}
        if size is not None:
            if rec["type"] != "file":
                raise _err(errno.EINVAL, "size on non-file")
            if size < rec["size"]:
                # journal-first: _apply does the data truncation once
                # the event is durable
                ev["truncate"] = {"ino": rec["ino"], "size": rec["size"],
                                  "layout": rec["layout"]}
            ev["size"] = size
        if mtime is not None:
            ev["mtime"] = mtime
        if mode is not None:
            ev["mode"] = mode
        await self._journal_and_apply(ev)
        return {}

    async def _op_report_size(self, path: str, ino: int, size: int,
                              mtime: float | None = None) -> dict:
        """A writer's size report (the synchronous cousin of the cap
        FLUSH): only sessions holding a write cap on the ino may move
        its size — the MDS, not the client, is the size authority.
        Reports only EXTEND (shrinking goes through setattr/truncate,
        which the MDS executes itself)."""
        bits = self._cap_holders.get(ino, {}).get(self._cur_conn, 0)
        if not bits & (CAP_WR | CAP_EXCL):
            raise _err(errno.EPERM, "no write cap")
        pino, name = await self._resolve_parent(path)
        d = await self._dir(pino)
        rec = d["entries"].get(name)
        if rec is None or rec.get("ino") != ino:
            raise _err(errno.ENOENT, path)
        ev = {"op": "setattr", "p": pino, "n": name}
        if size > rec.get("size", 0):
            ev["size"] = size
        if mtime is not None:
            ev["mtime"] = mtime
        if len(ev) > 3:
            await self._journal_and_apply(ev)
        return {}

    async def _truncate_data(self, rec: dict, new_size: int) -> None:
        """Shrink: drop whole data objects past the end, trim the
        boundary object (Striper::truncate semantics, MDS-driven since
        v1 clients hold no caps)."""
        lay = Layout(*rec["layout"])
        live: dict[int, int] = {}
        if new_size > 0:
            for objectno, obj_off, n in file_to_extents(lay, 0, new_size):
                live[objectno] = max(live.get(objectno, 0), obj_off + n)
        for objectno, _o, _n in file_to_extents(lay, 0, max(rec["size"], 1)):
            oid = f"{rec['ino']:x}.{objectno:08x}"
            try:
                if objectno not in live:
                    await self.data_io.remove(oid)
                else:
                    await self.data_io.truncate(oid, live[objectno])
            except RadosError:
                pass

    # reads ------------------------------------------------------------

    async def _op_stat(self, path: str) -> dict:
        return {"attr": await self._lookup(path)}

    async def _op_open(self, path: str, want: str = "r") -> dict:
        snap = await self._snap_lookup(path)
        if snap is not None:
            if want == "w":
                raise _err(errno.EROFS, path)
            rec, snapid = snap
            if rec["type"] != "file":
                raise _err(errno.EISDIR, path)
            return {"ino": rec["ino"], "size": rec["size"],
                    "layout": rec["layout"], "snapid": snapid,
                    "caps": 0, "snapc": self._snapc()}
        rec = await self._lookup(path)
        if rec["type"] != "file":
            raise _err(errno.EISDIR, path)
        ino = rec["ino"]
        # grant (Locker::issue_caps): a lone writer gets EXCL and may
        # buffer size updates; _pre_recall already stripped conflicts
        others = [
            c for c in self._cap_holders.get(ino, {})
            if c is not self._cur_conn
        ]
        if want == "w":
            bits = CAP_RD | CAP_WR | (0 if others else CAP_EXCL)
        else:
            bits = CAP_RD
        bits = self._grant(ino, self._cur_conn, bits)
        return {"ino": ino, "size": rec["size"],
                "layout": rec["layout"], "caps": bits,
                "snapc": self._snapc()}

    async def _op_readdir(self, path: str) -> dict:
        parts = self._split(path)
        if parts and parts[-1] == ".snap":
            dino = await self._resolve_dir(parts[:-1])
            realm = self._realms.get(dino, {})
            return {"entries": {
                name: {"type": "dir", "ino": dino, "mtime": s["t"],
                       "mode": 0o755, "snapid": s["id"]}
                for name, s in sorted(realm.items())
            }}
        snap = await self._snap_lookup(path)
        if snap is not None:
            rec, _snapid = snap
            if rec["type"] != "dir":
                raise _err(errno.ENOTDIR, path)
            return {"entries": {
                name: {k: v for k, v in r.items() if k != "children"}
                for name, r in sorted(rec.get("children", {}).items())
            }}
        rec = await self._lookup(path)
        if rec["type"] != "dir":
            raise _err(errno.ENOTDIR, path)
        d = await self._dir(rec["ino"])
        return {"entries": {
            name: r for name, r in sorted(d["entries"].items())
        }}

    async def _op_readlink(self, path: str) -> dict:
        rec = await self._lookup(path)
        if rec["type"] != "symlink":
            raise _err(errno.EINVAL, path)
        return {"target": rec["target"]}

    # snapshots (SnapRealm-lite) ---------------------------------------

    async def _freeze(self, ino: int) -> dict:
        """Recursively serialize the subtree's metadata — the frozen
        past the reference keeps as snapid-versioned dentries."""
        d = await self._dir(ino)
        out = {}
        for name, rec in d["entries"].items():
            r = dict(rec)
            if rec["type"] == "dir":
                r["children"] = await self._freeze(rec["ino"])
            out[name] = r
        return out

    async def _subtree_inos(self, ino: int) -> list[int]:
        """Every file/dir ino under directory ``ino`` (recall scope of
        a snapshot freeze)."""
        out: list[int] = []
        d = await self._dir(ino)
        for rec in d["entries"].values():
            out.append(rec["ino"])
            if rec["type"] == "dir":
                out.extend(await self._subtree_inos(rec["ino"]))
        return out

    async def _op_snap_create(self, path: str, name: str) -> dict:
        import json

        if not name or "/" in name or name.startswith("."):
            raise _err(errno.EINVAL, f"bad snap name {name!r}")
        rec = await self._lookup(path)
        if rec["type"] != "dir":
            raise _err(errno.ENOTDIR, path)
        dino = rec["ino"]
        realm = self._realms.get(dino, {})
        if name in realm:
            raise _err(errno.EEXIST, name)
        # data-pool COW pivot first: writes stamped with the new snapc
        # clone; the manifest is written BEFORE the journal event so a
        # replayed snap_create always finds it (an orphan manifest
        # from a crash in between is harmless)
        snapid = await self.data_io.selfmanaged_snap_create()
        manifest = await self._freeze(dino)
        await self.meta_io.write_full(
            f"snapmeta.{dino:x}.{snapid}",
            json.dumps(manifest).encode())
        await self._journal_and_apply({
            "op": "snap_create", "ino": dino, "n": name,
            "snapid": snapid, "t": time.time(),
        })
        await self._broadcast_snapc()
        return {"snapid": snapid, "snapc": self._snapc()}

    async def _op_snap_remove(self, path: str, name: str) -> dict:
        rec = await self._lookup(path)
        if rec["type"] != "dir":
            raise _err(errno.ENOTDIR, path)
        snap = self._realms.get(rec["ino"], {}).get(name)
        if snap is None:
            raise _err(errno.ENOENT, name)
        await self._journal_and_apply({
            "op": "snap_remove", "ino": rec["ino"], "n": name,
            "snapid": snap["id"],
        })
        await self._broadcast_snapc()
        return {"snapc": self._snapc()}

    async def _op_flush(self) -> dict:
        """Admin/test verb: force writeback + journal trim."""
        await self._flush()
        return {}

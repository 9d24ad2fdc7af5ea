"""librados-style client: cluster handle, IoCtx, op targeting.

Twin of the reference client stack (librados IoCtx ->
IoCtxImpl::operate -> Objecter::op_submit, SURVEY.md §3.1): the cluster
handle subscribes to maps from the mon; each op hashes the object name
to a PG (object_locator_to_pg via ceph_str_hash_rjenkins), computes the
acting primary with the same OSDMap pipeline the OSDs use
(Objecter::_calc_target, src/osdc/Objecter.cc:2783), sends an MOSDOp
to it, and resends after a map change when the primary moved or
replied -EAGAIN — the Objecter's resend-on-new-epoch behavior.
"""

from __future__ import annotations

import asyncio
import errno
import itertools
import logging
import os

from ceph_tpu_torch.msg.messages import (
    MConfig,
    MMgrMap,
    MMonCommand,
    MMonCommandAck,
    MMonSubscribe,
    MOSDMap,
    MOSDOp,
    MOSDOpReply,
    MWatchNotify,
    MWatchNotifyAck,
    OP_APPEND,
    OP_CALL,
    OP_CREATE,
    OP_DELETE,
    OP_GETXATTR,
    OP_GETXATTRS,
    OP_OMAP_CLEAR,
    OP_OMAP_GETKEYS,
    OP_OMAP_GETVALS,
    OP_OMAP_GETVALSBYKEYS,
    OP_OMAP_RMKEYS,
    OP_OMAP_SETKEYS,
    OP_READ,
    OP_RMXATTR,
    OP_SETXATTR,
    OP_STAT,
    OP_NOTIFY,
    OP_TRUNCATE,
    OP_UNWATCH,
    OP_WATCH,
    OP_WRITE,
    OP_WRITE_FULL,
    OP_ZERO,
    OSDOp,
)
from ceph_tpu_torch.msg.messenger import Connection, Message, Messenger
from ceph_tpu_torch.osd.daemon import object_to_pg
from ceph_tpu_torch.osd.osdmap import OSDMap

log = logging.getLogger("ceph_tpu_torch.client")

OP_TIMEOUT = 30.0
# resend backoff: exponential with full jitter, bounded (the
# objecter_retry/backoff discipline — fixed sleeps synchronize every
# blocked client into retry storms against a recovering primary)
BACKOFF_BASE = 0.05
BACKOFF_MAX = 1.0


class RadosError(OSError):
    pass


class RadosClient:
    """The cluster handle (librados::Rados)."""

    def __init__(self, client_id: int | None = None, auth=None,
                 handshake_timeout: float | None = None,
                 op_timeout: float = 120.0,
                 trace_sample_rate: float = 1.0, conf=None):
        from ceph_tpu_torch.common import ConfigProxy

        self.id = client_id if client_id is not None else (os.getpid() << 8) | 1
        # per-op wall-clock budget across ALL resends (librados
        # rados_osd_op_timeout role): an op that can't complete within
        # it raises ETIMEDOUT instead of spinning through retries
        self.op_timeout = op_timeout
        # client-side option view (objecter window sizes, batch caps)
        self.conf = conf if conf is not None else ConfigProxy()
        _mkw = {}
        if handshake_timeout is not None:
            _mkw["handshake_timeout"] = handshake_timeout
        self.messenger = Messenger(
            ("client", self.id), self._dispatch, on_reset=self._on_reset,
            auth=auth, **_mkw,
        )
        # cluster-wide tracing root: every submitted op opens a
        # client_op span whose context rides the MOSDOp frame — the
        # Objecter-side jaeger root of the reference's trace chain
        from ceph_tpu_torch.common.tracing import get_tracer

        self.tracer = get_tracer(f"client.{self.id}")
        self.tracer.sample_rate = trace_sample_rate
        self.messenger.tracer = self.tracer
        self.osdmap: OSDMap | None = None
        self._mon_conn: Connection | None = None
        self._tids = itertools.count(1)
        self._op_waiters: dict[int, asyncio.Future] = {}
        self._cmd_waiters: dict[int, asyncio.Future] = {}
        self._map_event = asyncio.Event()
        # watch registrations: cookie -> callback(notify_id, payload)
        # -> optional reply bytes (librados watch2/notify2)
        self._watches: dict[int, object] = {}
        # the async submission engine (client/objecter.py): EVERY op —
        # serial convenience calls included — rides it, so resends,
        # map waits and timeout accounting are per-op by construction
        from ceph_tpu_torch.client.objecter import Objecter

        self.objecter = Objecter(self)

    async def connect(self, mon_host: str, mon_port: int) -> None:
        await self.connect_multi([(mon_host, mon_port)])

    async def connect_multi(self, monmap: list[tuple[str, int]]) -> None:
        """Connect against a monitor quorum: subscribe to the first
        reachable member; commands re-target the leader on ENOTLEADER
        redirects (the MonClient hunting/redirect behavior)."""
        self._mon_addrs = list(monmap)
        if not hasattr(self, "_monmap"):
            self._monmap: dict[int, tuple[str, int]] = {}  # rank -> addr
        new_conn = None
        last: Exception | None = None
        addr_rank = {a: r for r, a in self._monmap.items()}
        for host, port in self._mon_addrs:
            rank = addr_rank.get((host, port))
            if rank is not None:
                # reuse a live session instead of stacking new sockets
                existing = self.messenger.get_connection(("mon", rank))
                if existing is not None and not existing._closed:
                    if new_conn is None:
                        new_conn = existing
                    continue
            try:
                conn = await self.messenger.connect(host, port)
            except (ConnectionError, OSError) as e:
                last = e
                continue
            # the HELLO tells us which rank answers at this address
            self._monmap[conn.peer[1]] = (host, port)
            if new_conn is None:
                new_conn = conn
        if new_conn is None:
            raise RadosError(errno.EHOSTUNREACH, f"no monitor reachable: {last}")
        # swap atomically: concurrent commands never see a None session
        self._mon_conn = new_conn
        await self._mon_conn.send_message(MMonSubscribe(
            start_epoch=self.osdmap.epoch if self.osdmap else 0
        ))
        await self._wait_new_map(0, timeout=10.0)
        if self.osdmap is None:
            raise RadosError(errno.ETIMEDOUT, "no map from mon")

    async def shutdown(self) -> None:
        self._stopping = True
        t = getattr(self, "_hunt_task", None)
        if t:
            t.cancel()
        await self.objecter.shutdown()
        await self.messenger.shutdown()

    async def _on_reset(self, conn) -> None:
        """An OSD session died: fail the attempts in flight on it, so
        each op's driver resends after a map wait (Objecter::
        ms_handle_reset) instead of waiting out ``ATTEMPT_TIMEOUT`` for
        a reply that cannot come.  Our monitor session died: hunt for a
        live quorum member and re-subscribe so maps keep flowing
        (MonClient hunting)."""
        if getattr(self, "_stopping", False):
            return
        if conn.peer is not None and conn.peer[0] == "osd":
            for fut in list(self._op_waiters.values()):
                if getattr(fut, "conn", None) is conn and not fut.done():
                    fut.set_exception(ConnectionError(f"{conn.peer} reset"))
            return
        if conn is not self._mon_conn:
            return

        async def hunt():
            for _ in range(50):
                await asyncio.sleep(0.2)
                if getattr(self, "_stopping", False):
                    return
                try:
                    await self.connect_multi(self._mon_addrs)
                    return
                except (RadosError, ConnectionError, OSError):
                    continue

        self._hunt_task = asyncio.ensure_future(hunt())

    async def _dispatch(self, msg: Message) -> None:
        if isinstance(msg, MOSDMap):
            from ceph_tpu_torch.osd.mapenc import apply_map_message

            # copy-on-write swap: in-flight ops' `om` snapshots stay
            # stable, so _wait_new_map(om.epoch) wakes immediately
            new_map, gap = apply_map_message(self.osdmap, msg.maps, msg.incs)
            if new_map is not None:
                self.osdmap = new_map
            if gap:
                # re-subscribe from our epoch (mon sends the missing
                # incrementals, or a full map)
                try:
                    await self._mon_conn.send_message(MMonSubscribe(
                        start_epoch=self.osdmap.epoch if self.osdmap else 0
                    ))
                except ConnectionError:
                    pass  # hunt will re-subscribe
            ev, self._map_event = self._map_event, asyncio.Event()
            ev.set()  # wake everyone waiting for "a newer map than X"
        elif isinstance(msg, MOSDOpReply):
            fut = self._op_waiters.get(msg.tid)
            if fut and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, MConfig):
            pass  # clients carry no daemon config to apply (yet)
        elif isinstance(msg, MMgrMap):
            # the mon broadcasts the MgrMap to every subscriber; hosts
            # that embed an MgrClient over this session (MDS, the RGW
            # frontend) register a listener for it
            self.mgrmap_msg = msg
            cb = getattr(self, "_mgr_map_cb", None)
            if cb is not None:
                cb(msg)
        elif isinstance(msg, MMonCommandAck):
            fut = self._cmd_waiters.get(msg.tid)
            if fut and not fut.done():
                fut.set_result(msg)
        elif isinstance(msg, MWatchNotify):
            cb = self._watches.get(msg.cookie)
            if cb is None:
                return  # stale/unknown watch handle: no ack (the
                # notifier times this watcher out)
            reply = b""
            try:
                out = cb(msg.notify_id, msg.payload)
                if out:
                    reply = bytes(out)
            except Exception:
                log.exception("watch callback failed")
            try:
                await msg.conn.send_message(MWatchNotifyAck(
                    notify_id=msg.notify_id, cookie=msg.cookie, reply=reply,
                ))
            except ConnectionError:
                pass

    def set_mgr_map_listener(self, cb) -> None:
        """Register a callback for MMgrMap broadcasts on this session
        (late registration replays the latest map immediately)."""
        self._mgr_map_cb = cb
        msg = getattr(self, "mgrmap_msg", None)
        if msg is not None:
            cb(msg)

    async def _wait_new_map(self, than_epoch: int, timeout: float = 10.0) -> None:
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        while self.osdmap is None or self.osdmap.epoch <= than_epoch:
            # snapshot the event BEFORE re-checking: the dispatcher swaps
            # it under us when a map lands
            ev = self._map_event
            if self.osdmap is not None and self.osdmap.epoch > than_epoch:
                return
            remaining = deadline - loop.time()
            if remaining <= 0:
                return
            try:
                # wake at least once a second to RENEW the subscription
                # (MonClient's sub renewal): a subscribe that landed on
                # a mon mid-election can be forgotten, and without the
                # renewal no map would ever arrive
                await asyncio.wait_for(ev.wait(), min(remaining, 1.0))
            except asyncio.TimeoutError:
                if deadline - loop.time() <= 0:
                    return
                try:
                    if self._mon_conn is not None:
                        await self._mon_conn.send_message(MMonSubscribe(
                            start_epoch=(
                                self.osdmap.epoch if self.osdmap else 0)
                        ))
                except (ConnectionError, OSError):
                    pass  # the hunt task is re-homing us

    # -- admin commands ------------------------------------------------

    async def command(self, cmd: dict[str, str]) -> tuple[int, str, bytes]:
        ack = None
        for _redirect in range(6):
            tid = next(self._tids)
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._cmd_waiters[tid] = fut
            try:
                await self._mon_conn.send_message(MMonCommand(tid=tid, cmd=cmd))
                ack: MMonCommandAck = await asyncio.wait_for(fut, OP_TIMEOUT)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                # our monitor died: hunt for a live one (MonClient
                # hunting) and retry after the election settles
                await asyncio.sleep(0.2)
                try:
                    await self.connect_multi(getattr(self, "_mon_addrs", []))
                except (RadosError, ConnectionError, OSError):
                    pass  # whole quorum briefly unreachable; keep trying
                continue
            finally:
                self._cmd_waiters.pop(tid, None)
            if ack.code == -errno.EAGAIN and ack.rs.startswith("ENOTLEADER"):
                leader = int(ack.rs.split()[1])
                addr = getattr(self, "_monmap", {}).get(leader)
                try:
                    if addr is not None:
                        self._mon_conn = await self.messenger.connect_to(
                            ("mon", leader), *addr
                        )
                        await self._mon_conn.send_message(MMonSubscribe())
                        continue
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    pass  # the named leader just died; wait + retry
                await asyncio.sleep(0.2)  # quorum electing; retry
                continue
            return ack.code, ack.rs, ack.data
        if ack is None:
            return -errno.ETIMEDOUT, "command retries exhausted", b""
        return ack.code, ack.rs, ack.data

    async def wait_clean(
        self, timeout: float = 30.0, min_epoch: int = 0,
    ) -> dict:
        """Poll the mon until every PG reports active+clean (the
        qa-helper wait_for_clean contract, reference
        qa/standalone/ceph-helpers.sh) — via the mon's aggregated pg
        stats, not by probing OSDs.  Returns the final status blob.

        ``min_epoch``: additionally require every counted PG report to
        have been computed at that osdmap epoch or later.  A caller
        that just forced a map change (kill + osd out) passes the
        post-change epoch so leftover pre-change active+clean reports
        cannot satisfy the wait (they made recovery look instant)."""
        import json as _json
        import time as _time

        deadline = _time.monotonic() + timeout
        last = {}
        while _time.monotonic() < deadline:
            code, _rs, data = await self.command({"prefix": "status"})
            if code == 0:
                last = _json.loads(data)
                pgs = last.get("pgs", {})
                by_state = pgs.get("by_state", {})
                if (
                    pgs.get("num_pgs", 0) > 0
                    and pgs.get("num_reported", 0) >= pgs["num_pgs"]
                    and set(by_state) == {"active+clean"}
                    and pgs.get("min_reported_epoch", 0) >= min_epoch
                ):
                    return last
            await asyncio.sleep(0.2)
        raise TimeoutError(f"cluster not clean after {timeout}s: {last.get('pgs')}")

    async def pool_create(
        self, name: str, pg_num: int = 8, pool_type: str = "replicated", **kw
    ) -> int:
        import json

        cmd = {
            "prefix": "osd pool create", "name": name,
            "pg_num": str(pg_num), "pool_type": pool_type,
        }
        cmd.update({k: str(v) for k, v in kw.items()})
        code, rs, data = await self.command(cmd)
        if code != 0:
            raise RadosError(-code, rs)
        return json.loads(data)["pool_id"]

    async def ec_profile_set(self, name: str, profile: dict[str, str]) -> None:
        code, rs, _ = await self.command({
            "prefix": "osd erasure-code-profile set", "name": name,
            "profile": " ".join(f"{k}={v}" for k, v in profile.items()),
        })
        if code != 0:
            raise RadosError(-code, rs)

    def ioctx(self, pool_name: str) -> "IoCtx":
        pid = self.osdmap.lookup_pg_pool_name(pool_name)
        if pid < 0:
            raise RadosError(errno.ENOENT, f"no pool {pool_name!r}")
        return IoCtx(self, pid)

    # -- op engine (Objecter) ------------------------------------------

    async def _backoff(self, attempt: int) -> None:
        """Bounded exponential backoff with full jitter before a
        resend.  Jitter decorrelates the resend times of many clients
        whose ops all failed against the same dead/busy primary —
        without it every retry round lands as one synchronized burst."""
        import random

        cap = min(BACKOFF_BASE * (2 ** attempt), BACKOFF_MAX)
        await asyncio.sleep(cap * (0.5 + random.random() / 2))

    async def _submit(self, pool_id: int, op: MOSDOp) -> MOSDOpReply:
        """Serial convenience path: submit through the objecter and
        wait.  The engine owns op_submit/_calc_target/the resend loop
        and the client_op root span (one client op, one cluster-wide
        trace); timeout/backoff accounting is per-op there, so a slow
        op can never charge a neighbor's deadline."""
        comp = await self.objecter.submit(pool_id, op)
        return await comp.wait()

    async def aio_submit(self, pool_id: int, op: MOSDOp):
        """Async path (librados aio_operate): returns a
        :class:`~ceph_tpu_torch.client.objecter.Completion` once the op is
        admitted through the in-flight window — admission is the
        backpressure seam (objecter_inflight_ops/_op_bytes)."""
        return await self.objecter.submit(pool_id, op)


class ObjectOperation:
    """Batched compound op (librados::ObjectWriteOperation /
    ObjectReadOperation): ops accumulate and ship as ONE atomic
    MOSDOp vector via :meth:`IoCtx.operate`."""

    def __init__(self):
        self.ops: list[OSDOp] = []

    # write class
    def write_full(self, data: bytes):
        self.ops.append(OSDOp(OP_WRITE_FULL, data=bytes(data)))
        return self

    def write(self, off: int, data: bytes):
        self.ops.append(OSDOp(OP_WRITE, off=off, data=bytes(data)))
        return self

    def append(self, data: bytes):
        self.ops.append(OSDOp(OP_APPEND, data=bytes(data)))
        return self

    def zero(self, off: int, length: int):
        self.ops.append(OSDOp(OP_ZERO, off=off, length=length))
        return self

    def truncate(self, size: int):
        self.ops.append(OSDOp(OP_TRUNCATE, off=size))
        return self

    def create(self, exclusive: bool = False):
        self.ops.append(OSDOp(OP_CREATE, off=1 if exclusive else 0))
        return self

    def remove(self):
        self.ops.append(OSDOp(OP_DELETE))
        return self

    def setxattr(self, name: str, value: bytes):
        self.ops.append(OSDOp(OP_SETXATTR, name=name, data=bytes(value)))
        return self

    def rmxattr(self, name: str):
        self.ops.append(OSDOp(OP_RMXATTR, name=name))
        return self

    def omap_set(self, kv: dict[str, bytes]):
        self.ops.append(OSDOp(OP_OMAP_SETKEYS, kv=dict(kv)))
        return self

    def omap_rm_keys(self, keys: list[str]):
        self.ops.append(OSDOp(OP_OMAP_RMKEYS, keys=list(keys)))
        return self

    def omap_clear(self):
        self.ops.append(OSDOp(OP_OMAP_CLEAR))
        return self

    def copy_from(self, src_pool: int, src_oid: str):
        """CEPH_OSD_OP_COPY_FROM: fill the target from another object
        (the tiering promote/flush primitive, PrimaryLogPG copy-from)."""
        from ceph_tpu_torch.msg.messages import OP_COPY_FROM

        self.ops.append(OSDOp(OP_COPY_FROM, name=f"{src_pool}:{src_oid}"))
        return self

    def cache_flush(self):
        from ceph_tpu_torch.msg.messages import OP_CACHE_FLUSH

        self.ops.append(OSDOp(OP_CACHE_FLUSH))
        return self

    def cache_evict(self):
        from ceph_tpu_torch.msg.messages import OP_CACHE_EVICT

        self.ops.append(OSDOp(OP_CACHE_EVICT))
        return self

    # read class
    def read(self, off: int = 0, length: int = 0):
        self.ops.append(OSDOp(OP_READ, off=off, length=length))
        return self

    def stat(self):
        self.ops.append(OSDOp(OP_STAT))
        return self

    def getxattr(self, name: str):
        self.ops.append(OSDOp(OP_GETXATTR, name=name))
        return self

    def getxattrs(self):
        self.ops.append(OSDOp(OP_GETXATTRS))
        return self

    def omap_get_keys(self):
        self.ops.append(OSDOp(OP_OMAP_GETKEYS))
        return self

    def omap_get_vals(self):
        self.ops.append(OSDOp(OP_OMAP_GETVALS))
        return self

    def omap_get_vals_by_keys(self, keys: list[str]):
        self.ops.append(OSDOp(OP_OMAP_GETVALSBYKEYS, keys=list(keys)))
        return self


class IoCtx:
    """Per-pool I/O handle (librados::IoCtx).

    Snapshots (librados snap API): :meth:`set_snap_context` attaches a
    self-managed SnapContext to writes (selfmanaged_snap_set_write_ctx);
    :meth:`snap_set_read` points reads at a snap id (NOSNAP = head).
    """

    def __init__(self, client: RadosClient, pool_id: int):
        self.client = client
        self.pool_id = pool_id
        from ceph_tpu_torch.osd.snaps import NOSNAP

        self.snap_seq: int = 0
        self.snaps: list[int] = []
        self.read_snap: int = NOSNAP
        # dmclock tenant tag stamped on every op from this handle (''
        # = the OSD's built-in client class); the load harness sets it
        # per simulated tenant to exercise mClock differentiation
        self.qos_class: str = ""

    def dup(self) -> "IoCtx":
        """An independent handle on the same pool (librados ioctx
        duplication): snap context and read snap are per-handle, so
        e.g. each RBD image carries its own."""
        io = IoCtx(self.client, self.pool_id)
        io.snap_seq, io.snaps = self.snap_seq, list(self.snaps)
        io.read_snap = self.read_snap
        io.qos_class = self.qos_class
        return io

    def set_snap_context(self, seq: int, snaps: list[int]) -> None:
        """selfmanaged_snap_set_write_ctx: snaps newest-first."""
        if snaps and (seq < snaps[0] or sorted(
                snaps, reverse=True) != list(snaps)):
            raise RadosError(22, "invalid snap context")
        self.snap_seq, self.snaps = seq, list(snaps)

    def snap_set_read(self, snapid) -> None:
        from ceph_tpu_torch.osd.snaps import NOSNAP

        self.read_snap = NOSNAP if snapid is None else snapid

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a new self-managed snap id (pool snap_seq bump)."""
        import json as _json

        name = self.client.osdmap.pool_names[self.pool_id]
        code, rs, data = await self.client.command({
            "prefix": "osd pool selfmanaged-snap create", "pool": name,
        })
        if code != 0:
            raise RadosError(-code, rs)
        return _json.loads(data)["snapid"]

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        name = self.client.osdmap.pool_names[self.pool_id]
        code, rs, _ = await self.client.command({
            "prefix": "osd pool selfmanaged-snap rm", "pool": name,
            "snapid": str(snapid),
        })
        if code != 0:
            raise RadosError(-code, rs)

    def _msg(self, oid: str, **kw) -> MOSDOp:
        m = MOSDOp(pool=self.pool_id, oid=oid, **kw)
        m.snap_seq, m.snaps = self.snap_seq, list(self.snaps)
        m.snapid = self.read_snap
        m.qos_class = self.qos_class
        return m

    async def _op1(self, oid: str, what: str, **kw) -> MOSDOpReply:
        reply = await self.client._submit(
            self.pool_id, self._msg(oid, **kw))
        if reply.result != 0:
            raise RadosError(-reply.result, f"{what} {oid!r}")
        return reply

    async def operate(self, oid: str, op: ObjectOperation) -> MOSDOpReply:
        """Submit a compound vector; per-op results in reply.outs."""
        reply = await self.client._submit(
            self.pool_id, self._msg(oid, ops=list(op.ops)))
        if reply.result != 0:
            raise RadosError(-reply.result, f"operate {oid!r}")
        return reply

    # -- async I/O (librados aio_*): completions, not round trips ------

    async def aio_operate(self, oid: str, op: ObjectOperation):
        """Submit a compound vector without waiting for the reply:
        returns a Completion (await ``.wait()`` or attach callbacks).
        The call itself only blocks when the objecter's in-flight
        window is full — the backpressure contract."""
        return await self.client.aio_submit(
            self.pool_id, self._msg(oid, ops=list(op.ops)))

    async def aio_write_full(self, oid: str, data: bytes):
        return await self.client.aio_submit(self.pool_id, self._msg(
            oid, op=OP_WRITE_FULL, data=bytes(data)))

    async def aio_write(self, oid: str, data: bytes, off: int):
        return await self.client.aio_submit(self.pool_id, self._msg(
            oid, op=OP_WRITE, off=off, data=bytes(data)))

    async def aio_append(self, oid: str, data: bytes):
        return await self.client.aio_submit(self.pool_id, self._msg(
            oid, op=OP_APPEND, data=bytes(data)))

    async def aio_read(self, oid: str, off: int = 0, length: int = 0):
        return await self.client.aio_submit(self.pool_id, self._msg(
            oid, op=OP_READ, off=off, length=length))

    async def aio_stat(self, oid: str):
        return await self.client.aio_submit(
            self.pool_id, self._msg(oid, op=OP_STAT))

    async def aio_remove(self, oid: str):
        return await self.client.aio_submit(
            self.pool_id, self._msg(oid, op=OP_DELETE))

    async def rollback(self, oid: str, snapid: int) -> None:
        """selfmanaged_snap_rollback: restore head from snap."""
        from ceph_tpu_torch.msg.messages import OP_ROLLBACK

        await self._op1(oid, "rollback", op=OP_ROLLBACK, off=snapid)

    async def list_snaps(self, oid: str) -> dict:
        """Object SnapSet dump (CEPH_OSD_OP_LIST_SNAPS)."""
        import json as _json

        from ceph_tpu_torch.msg.messages import OP_LIST_SNAPS

        reply = await self._op1(oid, "list_snaps", op=OP_LIST_SNAPS)
        return _json.loads(reply.data)

    async def write_full(self, oid: str, data: bytes) -> None:
        await self._op1(oid, "write_full", op=OP_WRITE_FULL, data=bytes(data))

    async def write(self, oid: str, data: bytes, off: int) -> None:
        await self._op1(oid, "write", op=OP_WRITE, off=off, data=bytes(data))

    async def append(self, oid: str, data: bytes) -> None:
        await self._op1(oid, "append", op=OP_APPEND, data=bytes(data))

    async def zero(self, oid: str, off: int, length: int) -> None:
        await self._op1(oid, "zero", op=OP_ZERO, off=off, length=length)

    async def truncate(self, oid: str, size: int) -> None:
        await self._op1(oid, "truncate", op=OP_TRUNCATE, off=size)

    async def create(self, oid: str, exclusive: bool = False) -> None:
        await self._op1(oid, "create", op=OP_CREATE, off=1 if exclusive else 0)

    async def read(self, oid: str, off: int = 0, length: int = 0) -> bytes:
        reply = await self._op1(oid, "read", op=OP_READ, off=off, length=length)
        return reply.data

    async def stat(self, oid: str) -> int:
        return (await self._op1(oid, "stat", op=OP_STAT)).size

    async def remove(self, oid: str) -> None:
        await self._op1(oid, "remove", op=OP_DELETE)

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        await self.operate(oid, ObjectOperation().setxattr(name, value))

    async def getxattr(self, oid: str, name: str) -> bytes:
        reply = await self.operate(oid, ObjectOperation().getxattr(name))
        return reply.outs[0][1]

    async def getxattrs(self, oid: str) -> dict[str, bytes]:
        reply = await self.operate(oid, ObjectOperation().getxattrs())
        return reply.outs[0][2]

    async def rmxattr(self, oid: str, name: str) -> None:
        await self.operate(oid, ObjectOperation().rmxattr(name))

    async def omap_set(self, oid: str, kv: dict[str, bytes]) -> None:
        await self.operate(oid, ObjectOperation().omap_set(kv))

    async def omap_get(self, oid: str) -> dict[str, bytes]:
        reply = await self.operate(oid, ObjectOperation().omap_get_vals())
        return reply.outs[0][2]

    async def omap_get_keys(self, oid: str) -> list[str]:
        reply = await self.operate(oid, ObjectOperation().omap_get_keys())
        return sorted(reply.outs[0][2])

    async def omap_get_vals_by_keys(
        self, oid: str, keys: list[str]
    ) -> dict[str, bytes]:
        reply = await self.operate(
            oid, ObjectOperation().omap_get_vals_by_keys(keys)
        )
        return reply.outs[0][2]

    async def omap_rm_keys(self, oid: str, keys: list[str]) -> None:
        await self.operate(oid, ObjectOperation().omap_rm_keys(keys))

    # -- object classes (librados exec / cls dispatch) -----------------

    async def execute(
        self, oid: str, cls: str, method: str, indata: bytes = b""
    ) -> bytes:
        """librados exec(): run an object-class method on the primary."""
        reply = await self.client._submit(self.pool_id, MOSDOp(
            pool=self.pool_id, oid=oid,
            ops=[OSDOp(OP_CALL, name=f"{cls}.{method}", data=bytes(indata))],
        ))
        if reply.outs and reply.outs[0][0] < 0:
            raise RadosError(-reply.outs[0][0], f"exec {cls}.{method}")
        if reply.result != 0:
            raise RadosError(-reply.result, f"exec {cls}.{method}")
        return reply.outs[0][1] if reply.outs else reply.data

    # -- watch / notify (librados watch2/notify2) ----------------------

    async def watch(self, oid: str, callback) -> int:
        """Register a watch; returns the cookie.  ``callback(notify_id,
        payload) -> bytes | None`` runs on every notify."""
        cookie = next(self.client._tids)
        # register BEFORE the op lands: a notify can race the watch
        # reply and must find the callback
        self.client._watches[cookie] = callback
        try:
            await self._op1(oid, "watch", op=OP_WATCH, off=cookie)
        except BaseException:
            self.client._watches.pop(cookie, None)
            raise
        return cookie

    async def unwatch(self, oid: str, cookie: int) -> None:
        self.client._watches.pop(cookie, None)
        await self._op1(oid, "unwatch", op=OP_UNWATCH, off=cookie)

    async def notify(
        self, oid: str, payload: bytes = b"", timeout_ms: int = 5000
    ) -> dict:
        """Returns {"acks": [[entity, cookie, reply bytes]...],
        "timeouts": [[entity, cookie]...]}."""
        import base64
        import json

        reply = await self._op1(
            oid, "notify", op=OP_NOTIFY, data=bytes(payload),
            length=timeout_ms,
        )
        out = json.loads(reply.data.decode()) if reply.data else {
            "acks": [], "timeouts": [],
        }
        out["acks"] = [
            [tuple(e), c, base64.b64decode(r)] for e, c, r in out["acks"]
        ]
        out["timeouts"] = [[tuple(e), c] for e, c in out["timeouts"]]
        return out

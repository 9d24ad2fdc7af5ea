"""Objecter: the client's async op-submission engine.

Behavioral twin of the reference Objecter (src/osdc/Objecter.cc): the
librados aio_* surface hands ops to a submission engine that keeps
MANY ops in flight at once instead of round-tripping one at a time.
Three coupled mechanisms:

- **Completions** (:class:`Completion`, the librados AioCompletion
  role): ``submit()`` returns immediately after admission; callers
  ``await comp.wait()`` or attach callbacks, so thousands of logical
  clients pipeline over one handle.

- **Per-OSD coalescing**: targeted ops land in a per-primary send
  queue drained by one writer task, which ships up to
  ``objecter_batch_max_ops`` of them as back-to-back wire frames under
  a single send-lock hold (``Connection.send_messages``) — multiple
  ops to the same primary cost one writer wakeup, with no per-op
  await between frames (the reference's out_q per-session batching).

- **Bounded in-flight window** (the reference's
  ``objecter_inflight_ops`` / ``objecter_inflight_op_bytes``
  Throttles): admission blocks the SUBMITTER once the window fills,
  so an open-loop generator cannot OOM the client or bufferbloat the
  wire; completions release the window and wake parked submitters
  FIFO.

Retries, OSDMap waits, tracing and timeouts all stay **per-op**: each
submitted op gets its own driver coroutine owning its deadline,
attempt counter and jittered backoff (``_drive``), so a slow op in a
batch can neither starve its batchmates' resends nor double-charge
their deadlines — the resend-on-new-epoch behavior of the serial
client, now N-wide.
"""

from __future__ import annotations

import asyncio
import errno
import logging
from collections import deque

from ceph_tpu_torch.common.metrics import get_perf_counters
from ceph_tpu_torch.msg.messages import MOSDOp, MOSDOpReply
from ceph_tpu_torch.osd.daemon import object_to_pg

log = logging.getLogger("ceph_tpu_torch.client")

#: per-attempt reply wait bound (the serial client's OP_TIMEOUT role)
ATTEMPT_TIMEOUT = 30.0


class Completion:
    """librados AioCompletion: resolved with the MOSDOpReply (or a
    RadosError), awaitable, with done-callbacks."""

    __slots__ = ("_fut", "oid", "submitted_at", "completed_at")

    def __init__(self, loop: asyncio.AbstractEventLoop, oid: str):
        self._fut: asyncio.Future = loop.create_future()
        self.oid = oid
        self.submitted_at = loop.time()
        self.completed_at: float | None = None

    def done(self) -> bool:
        return self._fut.done()

    @property
    def latency(self) -> float | None:
        """submit -> completion seconds (None while in flight)."""
        if self.completed_at is None:
            return None
        return self.completed_at - self.submitted_at

    def add_done_callback(self, cb) -> None:
        """``cb(completion)`` once resolved (immediately if already)."""
        self._fut.add_done_callback(lambda _fut: cb(self))

    async def wait(self) -> MOSDOpReply:
        """Await the reply; raises RadosError on failure."""
        return await asyncio.shield(self._fut)

    def result(self) -> MOSDOpReply:
        return self._fut.result()

    def exception(self) -> BaseException | None:
        return self._fut.exception()

    # -- engine side ---------------------------------------------------

    def _resolve(self, loop, reply=None, exc=None) -> None:
        if self._fut.done():
            return
        self.completed_at = loop.time()
        if exc is not None:
            self._fut.set_exception(exc)
        else:
            self._fut.set_result(reply)


class _OpRec:
    """One submitted op's in-flight state (the Objecter's Op struct):
    deadline/attempt/backoff accounting is HERE, per op, never shared
    with batchmates."""

    __slots__ = ("op", "pool_id", "comp", "deadline", "attempt",
                 "cost", "fut", "span")

    def __init__(self, op: MOSDOp, pool_id: int, comp: Completion,
                 deadline: float, cost: int, span):
        self.op = op
        self.pool_id = pool_id
        self.comp = comp
        self.deadline = deadline
        self.attempt = 0
        self.cost = cost
        self.fut: asyncio.Future | None = None  # current attempt's reply
        self.span = span


class Objecter:
    """The submission engine one RadosClient embeds."""

    def __init__(self, client):
        self.client = client
        conf = client.conf
        self.inflight_ops = conf["objecter_inflight_ops"]
        self.inflight_op_bytes = conf["objecter_inflight_op_bytes"]
        self.batch_max = conf["objecter_batch_max_ops"]
        self.perf = get_perf_counters(f"client.{client.id}.objecter")
        self._inflight = 0
        self._inflight_bytes = 0
        self._admit_waiters: deque[asyncio.Future] = deque()
        self._queues: dict[int, deque[_OpRec]] = {}
        self._writers: dict[int, asyncio.Task] = {}
        self._drivers: set[asyncio.Task] = set()
        self._stopping = False

    # -- window accounting ---------------------------------------------

    @staticmethod
    def _op_cost(op: MOSDOp) -> int:
        return sum(len(o.data) for o in op.ops)

    def _window_full(self, cost: int) -> bool:
        if self._inflight == 0:
            # an op larger than the whole byte budget still runs alone
            return False
        return (self._inflight >= self.inflight_ops
                or self._inflight_bytes + cost > self.inflight_op_bytes)

    async def _admit(self, cost: int, loop) -> None:
        first = True
        while self._window_full(cost):
            fut: asyncio.Future = loop.create_future()
            if first:
                self._admit_waiters.append(fut)
                self.perf.inc("backpressure_waits")
                first = False
            else:
                # re-park at the head: a big op that was woken but
                # still doesn't fit must not be starved by smaller
                # late arrivals overtaking it forever
                self._admit_waiters.appendleft(fut)
            await fut
        self._inflight += 1
        self._inflight_bytes += cost
        self.perf.set_gauge("inflight_ops", self._inflight)
        self.perf.set_gauge("inflight_bytes", self._inflight_bytes)

    def _release(self, rec: _OpRec) -> None:
        self._inflight -= 1
        self._inflight_bytes -= rec.cost
        self.perf.set_gauge("inflight_ops", self._inflight)
        self.perf.set_gauge("inflight_bytes", self._inflight_bytes)
        while self._admit_waiters:
            fut = self._admit_waiters.popleft()
            if not fut.done():
                fut.set_result(None)
                break

    # -- submission ----------------------------------------------------

    async def submit(self, pool_id: int, op: MOSDOp) -> Completion:
        """Admit through the in-flight window (may block — that IS the
        backpressure), open the op's cluster-trace root, and hand it
        to its own driver.  Returns the Completion immediately."""
        from ceph_tpu_torch.client.rados import RadosError

        if self._stopping:
            raise RadosError(errno.ESHUTDOWN, "client shutting down")
        client = self.client
        loop = asyncio.get_running_loop()
        if op.is_write() and not op.reqid:
            # stable across resends (osd_reqid_t): the OSD dedups a
            # retried non-idempotent op by this id
            op.reqid = f"client.{client.id}:{next(client._tids)}"
        cost = self._op_cost(op)
        await self._admit(cost, loop)
        comp = Completion(loop, op.oid)
        span = client.tracer.start_span(
            "client_op", oid=op.oid, pool=pool_id,
            write=op.is_write(), reqid=op.reqid or "aio",
        )
        op.trace = client.tracer.ctx_for(span)
        rec = _OpRec(op, pool_id, comp,
                     loop.time() + client.op_timeout, cost, span)
        self.perf.inc("ops_submitted")
        task = asyncio.ensure_future(self._drive(rec))
        self._drivers.add(task)
        task.add_done_callback(self._drivers.discard)
        return comp

    # -- the per-op driver (op_submit/_calc_target/resend loop) --------

    async def _drive(self, rec: _OpRec) -> None:
        from ceph_tpu_torch.client.rados import RadosError

        client = self.client
        loop = asyncio.get_running_loop()
        op = rec.op
        try:
            # no resend budget: like Ceph's Objecter, an op that bounces
            # (EAGAIN, no primary, a lost connection) waits for a newer
            # map or backs off and resends until its own deadline; a
            # count of tries would fail it while a dead OSD is still up
            # in the map, the window recovery needs
            while True:
                if loop.time() >= rec.deadline:
                    raise RadosError(
                        errno.ETIMEDOUT,
                        f"op {op.oid!r} timed out after "
                        f"{client.op_timeout}s ({rec.attempt} sends)")
                om = client.osdmap
                pool = om.get_pg_pool(rec.pool_id)
                if pool is None:
                    raise RadosError(
                        errno.ENOENT, f"pool {rec.pool_id} vanished")
                # cache-tier overlay redirect (Objecter::_calc_target
                # read_tier/write_tier) — recomputed every attempt so a
                # retry after an overlay change re-homes
                tier = pool.extra.get(
                    "write_tier" if op.is_write() else "read_tier")
                if tier is not None:
                    tpool = om.get_pg_pool(int(tier))
                    if tpool is not None:
                        pool = tpool
                op.pool = pool.id
                pg = object_to_pg(pool, op.oid)
                _, _, _, primary = om.pg_to_up_acting_osds(pg)
                addr = om.osd_addrs.get(primary) if primary >= 0 else None
                if primary < 0 or addr is None:
                    rec.attempt += 1
                    await client._wait_new_map(
                        om.epoch, timeout=self._map_wait(rec, loop))
                    continue
                op.tid = next(client._tids)
                op.epoch = om.epoch
                fut: asyncio.Future = loop.create_future()
                client._op_waiters[op.tid] = fut
                rec.fut = fut
                self._enqueue(primary, rec)
                try:
                    reply: MOSDOpReply = await asyncio.wait_for(
                        fut, min(ATTEMPT_TIMEOUT,
                                 max(0.5, rec.deadline - loop.time())))
                except (ConnectionError, OSError,
                        asyncio.TimeoutError) as e:
                    log.debug("objecter: op to osd.%d failed (%r), "
                              "waiting for map", primary, e)
                    rec.attempt += 1
                    await client._wait_new_map(
                        om.epoch, timeout=self._map_wait(rec, loop))
                    if (client.osdmap is not None
                            and client.osdmap.epoch <= om.epoch):
                        # no newer map (e.g. primary dead, unreported):
                        # this op backs off on ITS OWN jittered timer
                        await client._backoff(rec.attempt)
                    continue
                finally:
                    client._op_waiters.pop(op.tid, None)
                    rec.fut = None
                if reply.result == -errno.EAGAIN:
                    # peer had a different map, or the object is
                    # transiently busy: wait for a newer map, else
                    # back off with jitter
                    rec.attempt += 1
                    await client._wait_new_map(
                        min(om.epoch, reply.epoch - 1),
                        timeout=self._map_wait(rec, loop))
                    if client.osdmap.epoch <= om.epoch:
                        await client._backoff(rec.attempt)
                    continue
                rec.span.tag(result=reply.result)
                client.tracer.finish_span(rec.span)
                self.perf.inc("ops_completed")
                rec.comp._resolve(loop, reply=reply)
                return
        except RadosError as e:
            rec.span.tag(error=e.errno)
            client.tracer.finish_span(rec.span)
            self.perf.inc("ops_failed")
            rec.comp._resolve(loop, exc=e)
        except asyncio.CancelledError:
            client.tracer.finish_span(rec.span)
            rec.comp._resolve(loop, exc=RadosError(
                errno.ESHUTDOWN, f"op {op.oid!r} cancelled"))
            raise
        except Exception as e:  # engine bug: surface it, never hang
            log.exception("objecter: driver crashed for %r", op.oid)
            client.tracer.finish_span(rec.span)
            rec.comp._resolve(loop, exc=RadosError(
                errno.EIO, f"op {op.oid!r} driver error: {e!r}"))
        finally:
            self._release(rec)

    @staticmethod
    def _map_wait(rec: _OpRec, loop) -> float:
        """A map wait's bound: never past the op's deadline, so a
        partitioned client fires ETIMEDOUT on time, not after a full
        map-wait round on top of it."""
        return min(10.0, max(0.1, rec.deadline - loop.time()))

    # -- per-OSD coalescing writers ------------------------------------

    def _enqueue(self, osd: int, rec: _OpRec) -> None:
        self._queues.setdefault(osd, deque()).append(rec)
        t = self._writers.get(osd)
        if t is None or t.done():
            self._writers[osd] = asyncio.ensure_future(
                self._writer_loop(osd))

    async def _writer_loop(self, osd: int) -> None:
        """Drain osd's queue in bursts: ops queued while a burst is on
        the wire ride the next one (no barrier — the queue refills
        during the await and the loop re-checks).  Exit when empty;
        single-threaded asyncio makes the empty-check/exit atomic."""
        client = self.client
        q = self._queues[osd]
        try:
            while q:
                # each op with the attempt it was queued for
                batch: list[tuple[_OpRec, asyncio.Future]] = []
                while q and len(batch) < self.batch_max:
                    rec = q.popleft()
                    # an op whose attempt already failed/timed out is
                    # being re-driven; don't send a zombie frame
                    if rec.fut is not None and not rec.fut.done():
                        batch.append((rec, rec.fut))
                if not batch:
                    continue
                try:
                    om = client.osdmap
                    addr = om.osd_addrs.get(osd) if om else None
                    if addr is None:
                        raise ConnectionError(
                            f"osd.{osd} has no address in current map")
                    conn = await client.messenger.connect_to(
                        ("osd", osd), *addr)
                    # the dial may outlast an attempt, whose driver then
                    # gave up on it (and may have queued a new one)
                    batch = [(r, f) for r, f in batch
                             if r.fut is f and not f.done()]
                    if not batch:
                        continue
                    for _, f in batch:
                        # the session the reply must come back on: its
                        # reset fails the attempt (RadosClient._on_reset)
                        f.conn = conn
                    await conn.send_messages([r.op for r, _ in batch])
                except (ConnectionError, OSError) as e:
                    for _, f in batch:
                        if not f.done():
                            f.set_exception(ConnectionError(str(e)))
                    continue
                self.perf.inc("wire_bursts")
                self.perf.inc("ops_sent", len(batch))
                if len(batch) > 1:
                    self.perf.inc("coalesced_ops", len(batch))
        finally:
            self._writers.pop(osd, None)

    # -- reply intake / lifecycle --------------------------------------

    def dump(self) -> dict:
        """Engine introspection (perf counters + live window)."""
        return {
            "inflight_ops": self._inflight,
            "inflight_bytes": self._inflight_bytes,
            "admit_waiters": len(self._admit_waiters),
            "queued": {
                str(osd): len(q)
                for osd, q in self._queues.items() if q
            },
            "perf": self.perf.dump(),
        }

    async def shutdown(self) -> None:
        self._stopping = True
        for t in list(self._writers.values()):
            t.cancel()
        for t in list(self._drivers):
            t.cancel()
        if self._drivers:
            await asyncio.gather(*self._drivers, return_exceptions=True)

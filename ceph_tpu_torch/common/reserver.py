"""AsyncReserver: priority-ordered reservation slots with preemption.

Behavioral twin of the reference's reservation machinery
(src/common/AsyncReserver.h, used by src/osd/PeeringState.cc for
backfill/recovery admission control as described in
doc/dev/osd_internals/backfill_reservation.rst): a fixed number of
slots (``max_allowed``, the osd_max_backfills role) is granted to
requesters in priority order; a waiting request of *higher* priority
may preempt an already-granted holder of *lower* priority (the
reference fires the holder's ``on_preempt`` context; here the grant
handle's ``preempted`` event is set and the holder is expected to back
off and re-request).

Unlike the reference's callback contexts this is asyncio-native: a
request returns a :class:`Reservation` awaitable handle; ``release()``
frees the slot; cancellation while queued removes the request.
"""

from __future__ import annotations

import asyncio
import itertools
from dataclasses import dataclass, field


@dataclass(order=True)
class _Waiter:
    sort_key: tuple = field(init=False, repr=False)
    priority: int
    seq: int
    item: object = field(compare=False)
    fut: asyncio.Future = field(compare=False)
    res: "Reservation" = field(compare=False, default=None)

    def __post_init__(self):
        # higher priority first; FIFO within a priority
        self.sort_key = (-self.priority, self.seq)


class Reservation:
    """A granted (or pending) slot.  ``await res.wait()`` blocks until
    granted; ``res.preempted`` is an :class:`asyncio.Event` set when a
    higher-priority request steals the slot (holder must release and
    re-request, mirroring the reference's on_preempt contract)."""

    def __init__(self, reserver: "AsyncReserver", item, priority: int):
        self._reserver = reserver
        self.item = item
        self.priority = priority
        self.preempted = asyncio.Event()
        self._granted = False
        self._released = False
        self._queued = False
        self._grant_evt: asyncio.Event | None = None

    async def wait(self) -> "Reservation":
        await self._reserver._wait(self)
        return self

    def release(self) -> None:
        if not self._released:
            self._released = True
            self._reserver._release(self)

    async def __aenter__(self) -> "Reservation":
        return await self.wait()

    async def __aexit__(self, *exc) -> None:
        self.release()


class AsyncReserver:
    """Priority reservation gate (src/common/AsyncReserver.h twin)."""

    def __init__(self, max_allowed: int = 1, min_priority: int = 0):
        self.max_allowed = max(1, int(max_allowed))
        self.min_priority = min_priority
        self._granted: dict[object, Reservation] = {}
        # issued-but-not-yet-awaited handles: request() must hand the
        # SAME handle back for an item even before wait() queues or
        # grants it, or two pre-wait request(item) calls yield two
        # reservations and one item holds two slots
        self._issued: dict[object, Reservation] = {}
        self._queue: list[_Waiter] = []
        self._seq = itertools.count()
        # high-water mark of simultaneous grants, for tests/metrics
        self.peak_granted = 0

    # -- public -----------------------------------------------------------

    def request(self, item, priority: int = 0) -> Reservation:
        """Queue a reservation for ``item``; duplicate items reuse the
        outstanding reservation — granted OR still queued — so one
        item can never hold two slots (the reference asserts instead;
        the asyncio shape makes retry-after-preempt race-prone
        without this)."""
        existing = self._granted.get(item)
        if existing is not None and not existing._released:
            return existing
        for w in self._queue:
            if w.item == item:
                return w.res
        pending = self._issued.get(item)
        if pending is not None and not pending._released:
            return pending
        res = Reservation(self, item, priority)
        self._issued[item] = res
        return res

    def try_request(self, item, priority: int = 0) -> Reservation | None:
        """Non-blocking acquire: a slot now or None (the remote-
        reservation REJECT_TOOFULL path — replicas answer immediately
        rather than parking the primary on the wire)."""
        existing = self._granted.get(item)
        if existing is not None and not existing._released:
            return existing
        if len(self._granted) >= self.max_allowed or self._queue:
            return None
        pending = self._issued.get(item)
        if pending is not None and not pending._released:
            res = pending
        else:
            res = Reservation(self, item, priority)
            self._issued[item] = res
        self._grant(res)
        return res

    def cancel(self, item) -> None:
        """Drop a queued or granted reservation for ``item``
        (AsyncReserver::cancel_reservation)."""
        self._issued.pop(item, None)
        res = self._granted.pop(item, None)
        if res is not None:
            res._released = True
            self._kick()
            return
        for w in list(self._queue):
            if w.item == item:
                self._queue.remove(w)
                if not w.fut.done():
                    w.fut.cancel()

    def set_max(self, n: int) -> None:
        """Runtime config change (osd_max_backfills is adjustable via
        ``config set``); growing kicks queued waiters."""
        self.max_allowed = max(1, int(n))
        self._kick()

    @property
    def in_use(self) -> int:
        return len(self._granted)

    def queued(self) -> int:
        return len(self._queue)

    def has_reservation(self, item) -> bool:
        return item in self._granted

    # -- internals --------------------------------------------------------

    async def _wait(self, res: Reservation) -> None:
        while True:
            if res._granted and not res._released:
                return
            if res._queued:
                # a second awaiter of the same queued reservation (the
                # request() dedup path): ride the first one's grant
                await res._grant_evt.wait()
                continue  # granted — or abandoned: re-queue fresh
            if res.priority < self.min_priority:
                raise PermissionError(
                    f"priority {res.priority} below reserver floor "
                    f"{self.min_priority}")
            if len(self._granted) < self.max_allowed:
                self._grant(res)
                return
            break
        # full: queue, possibly preempting a lower-priority holder
        fut = asyncio.get_running_loop().create_future()
        res._queued = True
        res._grant_evt = asyncio.Event()
        w = _Waiter(priority=res.priority, seq=next(self._seq),
                    item=res.item, fut=fut, res=res)
        self._queue.append(w)
        self._queue.sort()
        self._maybe_preempt(res.priority)
        try:
            await fut
        except asyncio.CancelledError:
            if w in self._queue:
                self._queue.remove(w)
            res._queued = False
            res._grant_evt.set()  # wake co-awaiters; they re-queue
            # _kick may have granted the slot before the cancel landed
            if res._granted and not res._released:
                res.release()
            raise

    def _grant(self, res: Reservation) -> None:
        res._granted = True
        res._queued = False
        if res._grant_evt is not None:
            res._grant_evt.set()
        self._granted[res.item] = res
        self.peak_granted = max(self.peak_granted, len(self._granted))

    def _release(self, res: Reservation) -> None:
        cur = self._granted.get(res.item)
        if cur is res:
            del self._granted[res.item]
        if self._issued.get(res.item) is res:
            del self._issued[res.item]
        self._kick()

    def _kick(self) -> None:
        while self._queue and len(self._granted) < self.max_allowed:
            w = self._queue.pop(0)
            if w.fut.done():  # cancelled while queued
                continue
            # take the slot NOW — deferring to the waiter's wakeup
            # would let one release() pop the whole queue over-cap
            self._grant(w.res)
            w.fut.set_result(None)

    def _maybe_preempt(self, priority: int) -> None:
        """A queued request of strictly higher priority preempts the
        lowest-priority current holder (reference preemption semantics:
        high-priority recovery beats low-priority backfill)."""
        if not self._granted:
            return
        victim = min(self._granted.values(), key=lambda r: r.priority)
        if victim.priority < priority and not victim.preempted.is_set():
            victim.preempted.set()

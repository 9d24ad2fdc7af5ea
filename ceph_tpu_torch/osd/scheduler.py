"""Op scheduling: mClock QoS and weighted-priority queues.

Behavioral twin of the reference's pluggable op scheduler
(src/osd/scheduler/: OpScheduler seam, mClockScheduler.h:92 wrapping
the dmclock library src/dmclock/src/dmclock_server.h, and the legacy
WeightedPriorityQueue).  The dmclock algorithm is the dual-tag mClock
of the paper the reference vendored: each client class declares
(reservation, weight, limit); every op gets R/P/L tags

    R_i = max(now, R_{i-1} + cost/r)      (reservation)
    P_i = max(now, P_{i-1} + cost/w)      (proportional/weight)
    L_i = max(now, L_{i-1} + cost/l)      (limit)

and dequeue serves (1) the earliest R tag <= now — guaranteed
reservations first — else (2) the earliest P tag among clients whose L
tag does not exceed now (ready), adjusting P tags so idle clients do
not starve the active ones (dmclock's tag shifting).
"""

from __future__ import annotations

import heapq
import itertools
from dataclasses import dataclass, field


@dataclass
class ClientProfile:
    """QoS parameters of one client class (dmclock ClientInfo):
    reservation = guaranteed ops/s, weight = share of excess capacity,
    limit = max ops/s (0 = unlimited)."""

    reservation: float = 0.0
    weight: float = 1.0
    limit: float = 0.0


@dataclass
class _ClientState:
    profile: ClientProfile
    r_tag: float = 0.0
    p_tag: float = 0.0
    l_tag: float = 0.0
    queue: list = field(default_factory=list)  # FIFO of (item, cost)
    idle: bool = True


class MClockScheduler:
    """Single-queue dmclock server (PullReq model, one shard)."""

    def __init__(self) -> None:
        self._clients: dict[str, _ClientState] = {}

    def set_profile(self, client: str, profile: ClientProfile) -> None:
        st = self._clients.get(client)
        if st is None:
            self._clients[client] = _ClientState(profile)
        else:
            st.profile = profile

    def enqueue(self, client: str, item, cost: float = 1.0, now: float = 0.0) -> None:
        st = self._clients.setdefault(client, _ClientState(ClientProfile()))
        p = st.profile
        if st.idle:
            # idle -> active (dmclock idle handling): reservation/limit
            # tags restart at real `now` (no banked credit), but the
            # proportional tag lives in VIRTUAL time — re-enter at the
            # system's current virtual time (the smallest active P tag)
            # or a lone busy client would lock newcomers out for as
            # long as it had been running
            active_p = [
                c.p_tag for c in self._clients.values()
                if c is not st and not c.idle and c.queue
            ]
            st.r_tag = st.l_tag = now
            st.p_tag = max(now, min(active_p)) if active_p else now
            st.idle = False
        if not st.queue:
            if p.reservation > 0:
                st.r_tag = max(now, st.r_tag + cost / p.reservation)
            else:
                st.r_tag = float("inf")
            st.p_tag = max(now, st.p_tag + cost / max(p.weight, 1e-9))
            if p.limit > 0:
                st.l_tag = max(now, st.l_tag + cost / p.limit)
            else:
                st.l_tag = now
        st.queue.append((item, cost))

    def _advance(self, st: _ClientState, now: float) -> None:
        """After serving the head op, retag for the next queued op."""
        if not st.queue:
            return
        cost = st.queue[0][1]
        p = st.profile
        if p.reservation > 0:
            st.r_tag = max(now, st.r_tag + cost / p.reservation)
        else:
            st.r_tag = float("inf")
        st.p_tag = max(now, st.p_tag + cost / max(p.weight, 1e-9))
        if p.limit > 0:
            st.l_tag = max(now, st.l_tag + cost / p.limit)
        else:
            st.l_tag = now

    def dequeue(self, now: float):
        """Next (client, item) or None if nothing is ready (all queues
        empty, or every waiting client is limit-capped)."""
        best_r = None
        for name, st in self._clients.items():
            if st.queue and st.r_tag <= now:
                if best_r is None or st.r_tag < self._clients[best_r].r_tag:
                    best_r = name
        chosen = best_r
        if chosen is None:
            best_p = None
            for name, st in self._clients.items():
                if st.queue and st.l_tag <= now:
                    if best_p is None or st.p_tag < self._clients[best_p].p_tag:
                        best_p = name
            chosen = best_p
        if chosen is None:
            for st in self._clients.values():
                if not st.queue:
                    st.idle = True
            return None
        st = self._clients[chosen]
        item, _cost = st.queue.pop(0)
        self._advance(st, now)
        if not st.queue:
            st.idle = True
        return chosen, item

    def empty(self) -> bool:
        return all(not st.queue for st in self._clients.values())

    def __len__(self) -> int:
        return sum(len(st.queue) for st in self._clients.values())


class WeightedPriorityQueue:
    """The legacy WPQ scheduler (src/common/WeightedPriorityQueue.h):
    strict priorities above a cutoff, weighted round-robin below."""

    def __init__(self, cutoff: int = 64) -> None:
        self.cutoff = cutoff
        self._strict: list = []           # heap of (-prio, seq, item)
        self._weighted: dict[int, list] = {}
        self._rr_pos = 0
        self._seq = itertools.count()

    def enqueue(self, priority: int, item) -> None:
        if priority >= self.cutoff:
            heapq.heappush(self._strict, (-priority, next(self._seq), item))
        else:
            # weight-0 levels would never win a round-robin slot (and an
            # all-zero queue would have no slots at all): clamp to 1
            self._weighted.setdefault(max(priority, 1), []).append(item)

    def dequeue(self):
        if self._strict:
            return heapq.heappop(self._strict)[2]
        # weighted round robin: each priority level gets slots
        # proportional to its priority value
        levels = sorted(
            (p for p, q in self._weighted.items() if q), reverse=True
        )
        if not levels:
            return None
        total = sum(levels)
        pick = self._rr_pos % total
        self._rr_pos += 1
        acc = 0
        for p in levels:
            acc += p
            if pick < acc:
                return self._weighted[p].pop(0)
        raise AssertionError("pick < sum(levels) must select a level")

    def empty(self) -> bool:
        return not self._strict and all(
            not q for q in self._weighted.values()
        )

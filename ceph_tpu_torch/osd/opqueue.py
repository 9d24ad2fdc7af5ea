"""mClock admission gate: the op-scheduler seam wired into the daemon.

The reference queues every PG work item — client ops, recovery,
scrub — through one pluggable scheduler (src/osd/scheduler/
OpScheduler.h; mClockScheduler.h maps item class -> dmclock
(reservation, weight, limit)).  Here the asyncio twin: ops *admit*
through the gate before executing; while free slots remain admission
is immediate (work-conserving), and once ``max_inflight`` slots are
busy, waiters park inside :class:`MClockScheduler` so that the order
they unpark follows dmclock tags — client ops (high weight) overtake
background recovery (low weight) exactly when the OSD is saturated,
which is the only time ordering matters.

Deadlock rule: only TOP-LEVEL work admits (client MOSDOp, recovery
reconciliations, scrub chunks).  Sub-op service (replica writes, EC
shard reads, pushes) never admits — a held slot can therefore never
wait on a peer's held slot, so the distributed wait graph stays
acyclic (the reference gets the same property from queueing only PG
items, not message service).
"""

from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.osd.scheduler import ClientProfile, MClockScheduler


def parse_qos_profiles(spec: str) -> dict[str, ClientProfile]:
    """Parse the ``osd_mclock_client_profiles`` option: comma-separated
    ``name:weight`` or ``name:reservation/weight/limit`` entries
    (``gold:30,bronze:3`` / ``gold:5/30/0``).  Malformed entries are
    skipped — a bad config line must not take the OSD down."""
    out: dict[str, ClientProfile] = {}
    for entry in (spec or "").split(","):
        entry = entry.strip()
        if not entry or ":" not in entry:
            continue
        name, _, params = entry.partition(":")
        name = name.strip()
        try:
            if "/" in params:
                r, w, lim = (float(x) for x in params.split("/"))
            else:
                r, w, lim = 0.0, float(params), 0.0
        except ValueError:
            continue
        if name and w > 0:
            out[name] = ClientProfile(
                reservation=r, weight=w, limit=lim)
    return out


class MClockGate:
    """Bounded-concurrency admission through dmclock ordering.

    Per-class fairness accounting: every admission counts into
    ``stats`` AND (when a ``perf`` collection is attached) into typed
    ``qos_*`` perf counters — admitted ops, ops that had to park,
    park time in µs, and payload cost served per class.  `perf dump`
    and the prometheus exposition render them directly, which is how
    the load harness proves mClock actually differentiates tenants.

    Tenant classes beyond the built-ins arrive via
    :meth:`ensure_class`: an unknown class inherits the ``client``
    profile unless ``tenant_profiles`` (the parsed
    ``osd_mclock_client_profiles`` option) names its own.
    """

    def __init__(self, max_inflight: int = 0,
                 profiles: dict[str, ClientProfile] | None = None,
                 perf=None,
                 tenant_profiles: dict[str, ClientProfile] | None = None):
        self.max_inflight = int(max_inflight)
        self.sched = MClockScheduler()
        for name, prof in (profiles or {}).items():
            self.sched.set_profile(name, prof)
        self.perf = perf
        self.tenant_profiles = dict(tenant_profiles or {})
        self._inflight = 0
        self._kick_handle = None
        self.stats = {"admitted": {}, "queued": {}, "wait_us": {},
                      "served_cost": {}, "peak_inflight": 0}

    def set_tenant_profiles(
            self, profiles: dict[str, ClientProfile]) -> None:
        """Install/refresh tenant QoS classes (config observer path):
        already-seen classes retag live, new ones apply on first op."""
        self.tenant_profiles = dict(profiles)
        for name, prof in profiles.items():
            if name in self.sched._clients:
                self.sched.set_profile(name, prof)

    def ensure_class(self, klass: str) -> None:
        """First op of an unseen class: give it its configured tenant
        profile, else a copy of the client class's (an untagged-equal
        default — never the weight-1 fallback that would silently
        starve tagged tenants)."""
        if klass in self.sched._clients:
            return
        prof = self.tenant_profiles.get(klass)
        if prof is None:
            base = self.sched._clients.get("client")
            prof = base.profile if base is not None else ClientProfile()
        self.sched.set_profile(klass, prof)

    def qos_dump(self) -> dict:
        """Per-class fairness snapshot (the dump_qos admin command)."""
        return {
            "max_inflight": self.max_inflight,
            "inflight": self._inflight,
            "queued_now": len(self.sched),
            "classes": {
                klass: {
                    "profile": {
                        "reservation": st.profile.reservation,
                        "weight": st.profile.weight,
                        "limit": st.profile.limit,
                    },
                    "admitted": self.stats["admitted"].get(klass, 0),
                    "queued": self.stats["queued"].get(klass, 0),
                    "wait_us": round(
                        self.stats["wait_us"].get(klass, 0.0)),
                    "served_cost": self.stats["served_cost"].get(
                        klass, 0.0),
                }
                for klass, st in sorted(self.sched._clients.items())
            },
        }

    def set_max_inflight(self, n: int) -> None:
        self.max_inflight = int(n)
        if self.max_inflight <= 0:
            # gating switched off: flush every parked waiter, still
            # counting their slots so the outstanding releases balance
            while len(self.sched):
                # now=inf: limit tags never block the flush
                nxt = self.sched.dequeue(float("inf"))
                if nxt is None:
                    break
                _klass, fut = nxt
                if not fut.done():
                    self._inflight += 1
                    fut.set_result(None)
            return
        self._drain()

    def admit(self, klass: str, cost: float = 1.0) -> "_Admission":
        return _Admission(self, klass, cost)

    # -- internals --------------------------------------------------------

    async def _acquire(self, klass: str, cost: float) -> bool:
        """Returns True when a slot was actually taken — the release
        must mirror THAT, not the max_inflight value at release time
        (toggling the config through 0 mid-flight must not corrupt the
        counter)."""
        self.ensure_class(klass)
        self.stats["admitted"][klass] = (
            self.stats["admitted"].get(klass, 0) + 1)
        self.stats["served_cost"][klass] = (
            self.stats["served_cost"].get(klass, 0.0) + cost)
        if self.perf is not None:
            self.perf.inc(f"qos_admitted_{klass}")
            self.perf.inc(f"qos_cost_{klass}", cost)
        if self.max_inflight <= 0:  # gating disabled
            return False
        if self._inflight < self.max_inflight:
            self._inflight += 1
            self.stats["peak_inflight"] = max(
                self.stats["peak_inflight"], self._inflight)
            return True
        self.stats["queued"][klass] = self.stats["queued"].get(klass, 0) + 1
        if self.perf is not None:
            self.perf.inc(f"qos_queued_{klass}")
        t0 = time.monotonic()
        fut = asyncio.get_running_loop().create_future()
        self.sched.enqueue(klass, fut, cost=cost, now=t0)
        try:
            await fut
        except asyncio.CancelledError:
            # the slot may have been handed to us between the grant
            # and the cancel landing; give it back
            if fut.done() and not fut.cancelled():
                self._release()
            raise
        # dmclock park time: the fairness signal — under saturation a
        # low-weight tenant's ops wait here while high-weight ones
        # overtake (summed per class, exported as qos_wait_us_<class>)
        wait_us = (time.monotonic() - t0) * 1e6
        self.stats["wait_us"][klass] = (
            self.stats["wait_us"].get(klass, 0.0) + wait_us)
        if self.perf is not None:
            self.perf.inc(f"qos_wait_us_{klass}", wait_us)
        return True

    def _release(self) -> None:
        self._inflight -= 1
        self._drain()

    def _drain(self) -> None:
        while self._inflight < self.max_inflight:
            nxt = self.sched.dequeue(time.monotonic())
            if nxt is None:
                # non-empty but nothing ready = every waiter is
                # limit-capped; retry when the earliest L tag matures
                if len(self.sched) and self._kick_handle is None:
                    loop = asyncio.get_event_loop()
                    self._kick_handle = loop.call_later(
                        0.005, self._timer_kick)
                return
            _klass, fut = nxt
            if fut.done():  # admission cancelled while queued
                continue
            self._inflight += 1
            self.stats["peak_inflight"] = max(
                self.stats["peak_inflight"], self._inflight)
            fut.set_result(None)

    def _timer_kick(self) -> None:
        self._kick_handle = None
        self._drain()


class _Admission:
    def __init__(self, gate: MClockGate, klass: str, cost: float):
        self.gate, self.klass, self.cost = gate, klass, cost
        self._took_slot = False

    async def __aenter__(self):
        self._took_slot = await self.gate._acquire(self.klass, self.cost)
        return self

    async def __aexit__(self, *exc):
        if self._took_slot:
            self._took_slot = False
            self.gate._release()

"""Deterministic fault injection — the FaultInjector twin.

Behavioral twin of the reference's deterministic injection helper
(src/common/fault_injector.h:28-60: ``FaultInjector<Key>`` with
InjectAbort / InjectError / InjectDelay), complementing the
probabilistic knobs the messenger already exposes
(ms_inject_socket_failures / ms_inject_delay).  Code under test marks
named injection points with :meth:`check`; tests arm specific points
with an error, a delay, or an abort — deterministically, at exactly the
chosen point, which is what makes crash/ordering bugs reproducible
(the reference uses it for rgw/mon paths the thrashers can't steer).

    FAULTS.inject("ec_fan_out", error=errno.EIO, count=1)
    ...
    await FAULTS.check("ec_fan_out")   # raises OSError(EIO) once

Injection points are process-global and default to no-ops; ``count``
bounds how many times a fault fires (None = sticky: fires until
cleared — the persistent-EIO "dying disk" mode).

Beyond raise-at-the-point faults, two DATA faults model what a lying
disk does to bytes rather than to calls (the teuthology
objectstore-tool bit-rot and dmclock torn-write scenarios):

- ``bitflip`` — the store flips one stored bit at rest on the next
  read; BlockStore's checksum-at-rest then surfaces it as EIO, while
  MemStore (no checksums, like any store without csum) serves silently
  corrupted bytes only deep scrub can catch;
- ``torn`` — the next transaction commit tears: data partially
  applied/written but the commit point never reached.

Data faults never fire at :meth:`check` points — the store consumes
them at its data sites via :meth:`data_fault` — so one key (e.g.
``store.read.osd.3``) serves both styles without ambiguity.

Store-layer points use hierarchical keys ``store.<op>[.<domain>]``
(ops: read, write, commit, mount; domain: ``osd.<id>`` set by the
owning daemon, or ``bluefs`` for the co-located KV) — arm the bare key
to hit every store in the process, or the scoped key for one disk:
:func:`store_fault_check` / :func:`store_data_fault` check both.
"""

from __future__ import annotations

import asyncio
import threading


class InjectedError(OSError):
    """Raised by an armed injection point (InjectError role)."""


class InjectedAbort(BaseException):
    """Raised for abort-style injections (InjectAbort role); derives
    from BaseException so ordinary error containment can't swallow it —
    like the reference's ceph_abort it must take the daemon down."""


class FaultInjector:
    def __init__(self):
        self._lock = threading.Lock()
        # key -> {"error": errno|None, "delay": s|None, "abort": bool,
        #         "bitflip": bool, "torn": bool,
        #         "count": int|None, "fired": int}
        self._points: dict[str, dict] = {}

    def inject(
        self, key: str, *, error: int | None = None,
        delay: float | None = None, abort: bool = False,
        bitflip: bool = False, torn: bool = False,
        count: int | None = 1,
    ) -> None:
        """Arm an injection point (InjectError/InjectDelay/InjectAbort,
        plus the bitflip/torn data faults).  ``count=None`` is sticky:
        the point fires on every hit until cleared."""
        with self._lock:
            self._points[key] = {
                "error": error, "delay": delay, "abort": abort,
                "bitflip": bitflip, "torn": torn,
                "count": count, "fired": 0,
            }

    def clear(self, key: str | None = None) -> None:
        with self._lock:
            if key is None:
                self._points.clear()
            else:
                self._points.pop(key, None)

    def fired(self, key: str) -> int:
        with self._lock:
            p = self._points.get(key)
            return p["fired"] if p else 0

    def peek(self, key: str) -> dict | None:
        """Non-consuming view of an armed, non-exhausted point."""
        with self._lock:
            p = self._points.get(key)
            if p is None:
                return None
            if p["count"] is not None and p["fired"] >= p["count"]:
                return None
            return dict(p)

    def dump(self) -> dict[str, dict]:
        """Armed points with their fired counters (the dump_faults
        admin-command payload; exhausted points stay listed so a test
        or operator can see what already fired)."""
        with self._lock:
            return {k: dict(p) for k, p in self._points.items()}

    def _take(self, key: str, *, data: bool = False) -> dict | None:
        """Consume one firing.  ``data`` selects the channel: check
        points take only raise-style specs, data sites take only
        bitflip/torn specs — so a torn-write armed on a key shared
        with an error check can't be eaten by the wrong site."""
        if not self._points:  # fast path: nothing armed anywhere
            return None
        with self._lock:
            p = self._points.get(key)
            if p is None:
                return None
            if (p["bitflip"] or p["torn"]) != data:
                return None
            if p["count"] is not None and p["fired"] >= p["count"]:
                return None
            p["fired"] += 1
            return dict(p)

    def data_fault(self, key: str) -> dict | None:
        """Consume an armed bitflip/torn data fault at a store data
        site; returns the spec or None.  Callers that find nothing to
        corrupt (e.g. an empty object) should use :meth:`peek` first
        so the fault stays armed for the next eligible access."""
        return self._take(key, data=True)

    def _fire(self, p: dict, key: str) -> None:
        if p["abort"]:
            raise InjectedAbort(key)
        if p["error"] is not None:
            raise InjectedError(p["error"], f"injected fault at {key!r}")

    async def check(self, key: str) -> None:
        """Async injection point: delay, then error/abort if armed."""
        p = self._take(key)
        if p is None:
            return
        if p["delay"]:
            await asyncio.sleep(p["delay"])
        self._fire(p, key)

    def check_sync(self, key: str) -> None:
        """Synchronous variant (delay becomes a blocking sleep);
        error/abort/count semantics identical to :meth:`check`."""
        import time

        p = self._take(key)
        if p is None:
            return
        if p["delay"]:
            time.sleep(p["delay"])
        self._fire(p, key)


#: process-global injector (the reference passes FaultInjector instances
#: around; a global keeps marked points zero-cost in production where
#: nothing is armed)
FAULTS = FaultInjector()


# -- store-layer points (hierarchical keys) ----------------------------

def store_fault_check(op: str, domain: str = "") -> None:
    """Raise-style store point: checks ``store.<op>`` then
    ``store.<op>.<domain>`` (both may be armed; the bare key hits every
    store in the process, the scoped key one disk)."""
    if not FAULTS._points:
        return
    FAULTS.check_sync(f"store.{op}")
    if domain:
        FAULTS.check_sync(f"store.{op}.{domain}")


def store_data_fault(op: str, domain: str = "",
                     peek: bool = False) -> dict | None:
    """Data-style store fault (bitflip/torn) for the same key pair;
    scoped key wins.  ``peek`` inspects without consuming (stores use
    it to skip objects with nothing to corrupt)."""
    if not FAULTS._points:
        return None
    for key in ([f"store.{op}.{domain}"] if domain else []) + [f"store.{op}"]:
        p = FAULTS.peek(key) if peek else FAULTS.data_fault(key)
        if p is not None and (p["bitflip"] or p["torn"]):
            return p
    return None


# -- disk-fault observability (mirrors ceph_tpu_torch.chaos's counters/tracer
#    pair; served alongside FAULTS.dump() by the daemons' dump_faults
#    admin command) ----------------------------------------------------

def disk_fault_counters():
    """Process-wide disk-fault perf collection: every medium error a
    daemon absorbs (EIO-as-erasure decode-arounds, read-error-ledger
    entries, escalations) counts here, labelled by kind."""
    from ceph_tpu_torch.common.metrics import BucketCounters

    return BucketCounters("disk_fault")


def disk_fault_tracer():
    """Process-wide disk-fault span ring: each absorbed medium error
    opens a span tagged with osd/pg/oid, dumped via dump_faults."""
    from ceph_tpu_torch.common.tracing import get_tracer

    return get_tracer("disk_fault")

"""Deterministic regression for the control-net stale-map wedge
(chaos-fuzz plane find: CHAOS_r14 sweep, control-net seed 3, minimized
by ``ceph_tpu_torch.fuzz.minimize.minimize_trace`` over 11 live runs from 13
events to the 2-event kernel replayed here).

The mechanism:

1. every OSD subscribes for maps at the first reachable monitor
   (rank 0) and holds that subscription silently;
2. a transient netem partition isolates mon.0; while it is cut off,
   its beacon-liveness sweep (or a peer failure report) mints new map
   epochs, and ``_publish``'s send to each subscriber raises — the
   monitor POPS the subscriber and moves on;
3. the partition heals (ttl expiry / ``netem_clear``); the OSDs'
   connections are fine, their beacons flow again — but nothing
   re-subscribes, no publish will ever reach them, and no catch-up
   path existed for an UP osd holding a stale epoch;
4. the cluster reports every PG active+clean *at the dead epoch*:
   ``check_converged`` waits on ``min_reported_epoch`` forever.

The fix under test (mon/monitor.py beacon dispatch): a beacon whose
``epoch`` lags the current osdmap is answered with the incremental
catch-up payload (``_maps_since``), and — since the beacon proves the
path is healthy again — the OSD is re-registered as a subscriber.
The down-OSD arm of the same defense (soak-chaos-found) is preserved.

The trace below is the minimizer's verbatim output (its sha256 is
pinned): ONE short mon.0 partition plus the trace-end heal.  Before
the fix this wedged the 90s settle window every run; with it the run
settles in seconds.

The port's twin of tests/integration/test_map_catchup_regression.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.chaos.runner import SCENARIOS, run_trace
from ceph_tpu_torch.chaos.schedule import (
    events_from_json,
    trace_hash,
    validate_trace,
)

#: minimize_trace output, verbatim (control-net seed 3's 13-event
#: trace reduced to the failure kernel + the repair wholeness tail)
KERNEL = [
    {"t": 0.308, "kind": "mon_netem",
     "args": {"rank": 0, "mode": "partition",
              "seconds": 0.0219, "ttl": 0.554}},
    {"t": 4.05, "kind": "netem_clear", "args": {}},
]
KERNEL_HASH = (
    "f9924d40dfc5fa8d826209a111cefc71aec2c20bc582153fe047947ae3de60b8"
)


def test_kernel_trace_is_pinned_and_valid():
    events = events_from_json(KERNEL)
    assert trace_hash(events) == KERNEL_HASH
    assert not validate_trace(events, SCENARIOS["control-net"])


def test_stale_osd_catches_up_after_mon_partition():
    sc = SCENARIOS["control-net"]
    events = events_from_json(KERNEL)
    assert trace_hash(events) == KERNEL_HASH

    loop = asyncio.new_event_loop()
    try:
        result = loop.run_until_complete(run_trace(
            sc, events, settle_timeout=45.0, device="cpu"))
    finally:
        loop.close()

    conv = result["invariants"]["converged"]
    assert conv["ok"], conv["violations"]
    # the wedge's signature was a permanently stale min_reported_epoch;
    # the whole verdict must be green, not just convergence
    assert result["ok"], {
        k: v["violations"]
        for k, v in result["invariants"].items() if not v["ok"]
    }


@pytest.mark.slow
def test_original_seed3_trace_green():
    """The unminimized reproducer (control-net seed 3 verbatim) stays
    green end to end — the sweep-level view of the same fix."""
    from ceph_tpu_torch.chaos.schedule import generate_schedule

    sc = SCENARIOS["control-net"]
    events = generate_schedule(3, sc)
    assert trace_hash(events).startswith("6148dbdbf972")
    loop = asyncio.new_event_loop()
    try:
        result = loop.run_until_complete(run_trace(
            sc, events, seed=3, settle_timeout=90.0, device="cpu"))
    finally:
        loop.close()
    assert result["ok"], {
        k: v["violations"]
        for k, v in result["invariants"].items() if not v["ok"]
    }

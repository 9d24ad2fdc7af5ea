"""The chaos runner's scripted mid-backfill kill (``soak-trim-backfill``).

A gated interrupt kill waits for a backfill pass that has the victim as
a member and at least two objects still to start; the victim's revive
then waits for that pass to end, so the pass meets the member down and
ends short, and ``check_backfill`` sees started > completed.  Before
this, the gate read the cluster-wide started/completed counters (a pass
cut short earlier kept them apart for good, and a pass without the
victim completed whatever the kill did) and the revive, already overdue
after the hold, landed at once: the kill missed at seed 4 in 11 of 12
runs on the CPU, and at seed 0 once on the card.
"""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.chaos.runner import ChaosCluster, run_scenario


class _Osd:
    """What the gate reads of an OSD daemon."""

    def __init__(self) -> None:
        self.stopping = False
        self.backfill_passes: dict = {}


def _cluster(osds: list) -> ChaosCluster:
    c = ChaosCluster.__new__(ChaosCluster)
    c.osds = osds
    c.delivery_lag = 0.0
    c._interrupted_passes = {}
    return c


def _pass(members: set[int], left: int) -> dict:
    return {"members": frozenset(members), "left": left}


def test_kill_waits_for_a_pass_of_the_victim_with_objects_left():
    async def go():
        a, b, dying = _Osd(), _Osd(), _Osd()
        dying.stopping = True
        c = _cluster([a, None, b, dying])
        a.backfill_passes["no-victim"] = _pass({0, 2}, 5)
        b.backfill_passes["last-object"] = _pass({1, 2}, 1)
        dying.backfill_passes["stopping"] = _pass({1, 3}, 5)
        kill = asyncio.ensure_future(
            c._await_backfill_inflight(1, timeout=5.0))
        await asyncio.sleep(0.1)
        assert not kill.done()
        b.backfill_passes["mid"] = _pass({1, 2}, 3)
        await asyncio.wait_for(kill, 1.0)
        assert c._interrupted_passes == {1: (b, "mid")}

        revive = asyncio.ensure_future(
            c._await_interrupted_pass(1, timeout=5.0))
        await asyncio.sleep(0.1)
        assert not revive.done()
        del b.backfill_passes["mid"]
        await asyncio.wait_for(revive, 1.0)
        assert c._interrupted_passes == {}
        # both holds shift every later event of the trace
        assert c.delivery_lag >= 0.2

    asyncio.run(go())


def test_gate_timeouts_add_their_hold_and_note_nothing():
    async def go():
        c = _cluster([_Osd()])
        await c._await_backfill_inflight(1, timeout=0.1)
        assert c._interrupted_passes == {}
        lag = c.delivery_lag
        assert lag >= 0.1
        # a revive with no interrupted pass is not held
        await c._await_interrupted_pass(1, timeout=5.0)
        assert c.delivery_lag == lag

    asyncio.run(go())


@pytest.mark.parametrize("seed", [0, 4])
def test_soak_kill_interrupts_a_backfill_pass(seed):
    loop = asyncio.new_event_loop()
    try:
        r = loop.run_until_complete(asyncio.wait_for(
            run_scenario("soak-trim-backfill", seed, device="cpu"), 240))
    finally:
        loop.close()
    assert r["invariants"]["backfill"], r.get("violations")
    assert r["ok"], r["invariants"]

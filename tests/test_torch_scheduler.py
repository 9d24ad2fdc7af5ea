"""mClock/WPQ scheduler tests (reference analogue:
src/test/osd/TestMClockScheduler.cc + dmclock's own test strategy:
simulate a constant-rate server and check the achieved per-client
rates against reservation/weight/limit).

The port's twin of tests/test_scheduler.py: the same cases over
``ceph_tpu_torch``.
"""

from __future__ import annotations

from collections import Counter

from ceph_tpu_torch.osd.scheduler import (
    ClientProfile,
    MClockScheduler,
    WeightedPriorityQueue,
)


def simulate(sched: MClockScheduler, clients, server_rate=100.0, seconds=10.0):
    """Keep every client's queue full; serve at server_rate ops/s."""
    served = Counter()
    dt = 1.0 / server_rate
    now = 0.0
    while now < seconds:
        for c in clients:
            while len(sched._clients.get(c, type("e", (), {"queue": []})()).queue) < 4:
                sched.enqueue(c, object(), now=now)
        got = sched.dequeue(now)
        if got is not None:
            served[got[0]] += 1
        now += dt
    return served


class TestMClock:
    def test_reservations_met_under_overload(self):
        s = MClockScheduler()
        s.set_profile("recovery", ClientProfile(reservation=20, weight=1))
        s.set_profile("client", ClientProfile(reservation=0, weight=10))
        served = simulate(s, ["recovery", "client"], server_rate=100, seconds=10)
        # recovery's 20 ops/s reservation holds despite tiny weight
        assert served["recovery"] >= 0.9 * 20 * 10
        # the rest goes to the weighted client
        assert served["client"] >= 0.7 * 80 * 10

    def test_weights_split_excess_proportionally(self):
        s = MClockScheduler()
        s.set_profile("a", ClientProfile(weight=3))
        s.set_profile("b", ClientProfile(weight=1))
        served = simulate(s, ["a", "b"], server_rate=100, seconds=10)
        ratio = served["a"] / max(served["b"], 1)
        assert 2.2 < ratio < 4.0, (served, ratio)

    def test_limit_caps_throughput(self):
        s = MClockScheduler()
        s.set_profile("capped", ClientProfile(weight=100, limit=10))
        s.set_profile("free", ClientProfile(weight=1))
        served = simulate(s, ["capped", "free"], server_rate=100, seconds=10)
        assert served["capped"] <= 10 * 10 + 5
        assert served["free"] >= 80 * 10

    def test_idle_client_does_not_bank_credit(self):
        s = MClockScheduler()
        s.set_profile("idler", ClientProfile(weight=1))
        s.set_profile("steady", ClientProfile(weight=1))
        # steady runs alone for 5s
        served = simulate(s, ["steady"], server_rate=100, seconds=5)
        assert served["steady"] > 400
        # idler joins at t=5: it must share ~50/50 from here, not claim
        # 5s of back-credit
        served2 = Counter()
        now = 5.0
        for _ in range(500):
            for c in ("idler", "steady"):
                st = s._clients.get(c)
                while st is None or len(st.queue) < 4:
                    s.enqueue(c, object(), now=now)
                    st = s._clients[c]
            got = s.dequeue(now)
            if got:
                served2[got[0]] += 1
            now += 0.01
        assert 0.3 < served2["idler"] / max(served2["steady"], 1) < 3.0

    def test_empty_dequeue_returns_none(self):
        s = MClockScheduler()
        assert s.dequeue(0.0) is None
        s.enqueue("x", "op1", now=0.0)
        assert s.dequeue(10.0) == ("x", "op1")
        assert s.dequeue(10.0) is None


class TestWPQ:
    def test_strict_priority_first(self):
        q = WeightedPriorityQueue(cutoff=64)
        q.enqueue(10, "low")
        q.enqueue(200, "urgent")
        q.enqueue(100, "high")
        assert q.dequeue() == "urgent"
        assert q.dequeue() == "high"
        assert q.dequeue() == "low"
        assert q.empty()

    def test_weighted_share_below_cutoff(self):
        q = WeightedPriorityQueue(cutoff=64)
        for i in range(300):
            q.enqueue(30, ("a", i))
            q.enqueue(10, ("b", i))
        first = [q.dequeue()[0] for _ in range(200)]
        counts = Counter(first)
        assert counts["a"] > counts["b"] > 0

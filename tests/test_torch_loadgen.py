"""Load-harness unit tests: schedule determinism/purity, Zipf +
open-loop arrival shape, payload verifiability, report math, mClock
tenant fairness counters, and the qos_class wire field.

The port's twin of tests/test_loadgen.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio

import numpy as np

from ceph_tpu_torch.loadgen.schedule import (
    OP_KINDS,
    PROFILES,
    generate_load,
    resolve_profile,
    trace_hash,
    zipf_cdf,
    zipf_draw,
)


class TestScheduleDeterminism:
    def test_same_seed_same_trace(self):
        p = resolve_profile("mixed", clients=30, ops_per_client=6)
        a = generate_load(11, p)
        b = generate_load(11, p)
        assert [o.to_json() for o in a] == [o.to_json() for o in b]
        assert trace_hash(a) == trace_hash(b)

    def test_seed_and_profile_change_the_trace(self):
        p = resolve_profile("mixed", clients=30, ops_per_client=6)
        assert trace_hash(generate_load(1, p)) != trace_hash(
            generate_load(2, p))
        q = resolve_profile("rmw_ec", clients=30, ops_per_client=6)
        assert trace_hash(generate_load(1, p)) != trace_hash(
            generate_load(1, q))

    def test_trace_shape(self):
        p = resolve_profile("rados_rw", clients=20, ops_per_client=5)
        ops = generate_load(3, p)
        assert len(ops) == 20 * 5
        # sorted by time; every op kind from the profile's streams
        assert all(a.t <= b.t for a, b in zip(ops, ops[1:]))
        assert {o.kind for o in ops} <= set(p["streams"])
        assert all(o.kind in OP_KINDS for o in ops)
        # tenants partition the client population deterministically
        tenants = {o.client: o.tenant for o in ops}
        assert set(tenants.values()) == set(p["tenants"])

    def test_open_loop_arrivals(self):
        """Per-client times are strictly increasing exponential
        inter-arrivals at the profile rate (statistical bound)."""
        p = resolve_profile("rados_rw", clients=50, ops_per_client=40)
        ops = generate_load(5, p)
        gaps = []
        by_client: dict[int, list] = {}
        for o in ops:
            by_client.setdefault(o.client, []).append(o.t)
        for times in by_client.values():
            assert times == sorted(times)
            gaps.extend(b - a for a, b in zip(times, times[1:]))
        mean_gap = float(np.mean(gaps))
        assert abs(mean_gap - 1.0 / p["arrival_rate"]) < 0.05

    def test_zipf_skew(self):
        """Rank 0 is the hottest object and the head dominates."""
        import random

        rng = random.Random(7)
        cum = zipf_cdf(128, 1.1)
        draws = [zipf_draw(rng, cum) for _ in range(20000)]
        counts = np.bincount(draws, minlength=128)
        assert counts[0] == counts.max()
        assert counts[:8].sum() > 0.35 * len(draws)

    def test_resolve_profile_overrides_and_validation(self):
        p = resolve_profile("mixed", clients=7, ops_per_client=3)
        assert p["clients"] == 7 and p["ops_per_client"] == 3
        assert PROFILES["mixed"]["clients"] != 7  # literal untouched
        import pytest

        bad = dict(PROFILES["mixed"], streams={"warp_drive": 1.0})
        with pytest.raises(ValueError):
            resolve_profile(bad)


class TestSchedulePurity:
    def test_ctlint_determinism_rules_pass_over_loadgen(self):
        """The det-* pass over the port's loadgen/schedule.py: the port's
        determinism rule finds the file in scope (by its path and its
        marker), and clean."""
        import os

        from ceph_tpu_torch.analysis.core import Project, SourceFile
        from ceph_tpu_torch.analysis.rules.determinism import DeterminismRule, _in_scope

        rel = "ceph_tpu_torch/loadgen/schedule.py"
        repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
        with open(os.path.join(repo, rel)) as f:
            sf = SourceFile(rel, f.read())
        assert sf.pure_trace, "the # ctlint: pure-trace marker is gone"
        assert _in_scope(sf)
        findings = DeterminismRule().run(Project(root=repo, files=[sf]))
        assert findings == [], [str(f) for f in findings]


class TestPayloads:
    def test_payload_is_canonical_and_sliceable(self):
        from ceph_tpu_torch.loadgen.driver import payload_for

        a = payload_for("lg-ec-00001", 8192)
        assert a == payload_for("lg-ec-00001", 8192)
        assert a.startswith(b"LG|lg-ec-00001|")
        assert len(a) == 8192
        assert a != payload_for("lg-ec-00002", 8192)
        # a ranged write ships payload[off:off+n]: any interleaving of
        # such writes leaves the object equal to the canonical payload
        assert a[100:300] == payload_for("lg-ec-00001", 8192)[100:300]


class TestReportMath:
    def test_percentile_matches_analytics_convention(self):
        from ceph_tpu_torch.loadgen.report import percentile
        from ceph_tpu_torch.mgr.analytics import analyze_numpy

        rng = np.random.default_rng(9)
        samples = rng.integers(1, 100000, 50).astype(np.int64)
        values = samples.reshape(1, 1, 50)
        valid = np.ones_like(values, bool)
        out = analyze_numpy(values, valid, np.zeros(1, np.int64))
        for i, p in enumerate((50, 95, 99)):
            assert percentile(list(samples), p) == float(
                out["percentiles"][0, i])

    def test_cross_check_agreement(self):
        from ceph_tpu_torch.loadgen.report import cross_check, percentile

        means = [1000 + 7 * i for i in range(40)]
        tail = means[-32:]
        mgr = {f"p{p}": percentile(tail, p) for p in (50, 95, 99)}
        out = cross_check(means, mgr, window=32, tolerance=0.25)
        assert out["agree"]
        # empty-interval reports advance the mgr ring without a valid
        # cell: the client window counts REPORTS and drops the Nones,
        # exactly like the store's valid mask
        log = means[:36] + [None, None] + means[36:] + [None]
        ring_tail = [v for v in log[-32:] if v is not None]
        mgr2 = {f"p{p}": percentile(ring_tail, p) for p in (50, 95, 99)}
        out2 = cross_check(log, mgr2, window=32, tolerance=0.0)
        assert out2["agree"] and out2["shipped_samples"] == 40
        # a garbled digest (e.g. dropped samples) must NOT agree
        bad = {k: v * 3 + 500 for k, v in mgr.items()}
        assert not cross_check(
            means, bad, window=32, tolerance=0.25)["agree"]
        assert not cross_check([], mgr, 32, 0.25)["agree"]
        assert not cross_check(means, None, 32, 0.25)["agree"]


class TestQosCounters:
    def test_parse_qos_profiles(self):
        from ceph_tpu_torch.osd.opqueue import parse_qos_profiles

        out = parse_qos_profiles("gold:30,bronze:3,weird,:9,neg:-1")
        assert set(out) == {"gold", "bronze"}
        assert out["gold"].weight == 30.0
        full = parse_qos_profiles("svc:5/20/100")
        assert full["svc"].reservation == 5.0
        assert full["svc"].weight == 20.0
        assert full["svc"].limit == 100.0

    def test_gate_differentiates_tenants_and_exports_counters(self):
        """Saturate a 1-slot gate with two tenant classes at 10x
        weight spread: the heavy class must be served first more
        often (less park time per op), and the qos_* counters must
        surface through perf dump + the typed prometheus text."""
        from ceph_tpu_torch.common.metrics import (
            PerfCounters,
            prometheus_text,
        )
        from ceph_tpu_torch.osd.opqueue import MClockGate, parse_qos_profiles
        from ceph_tpu_torch.osd.scheduler import ClientProfile

        perf = PerfCounters("test_qos_gate")

        async def main():
            gate = MClockGate(
                max_inflight=1,
                profiles={"client": ClientProfile(weight=10.0)},
                perf=perf,
                tenant_profiles=parse_qos_profiles(
                    "gold:30,bronze:3"),
            )
            order: list[str] = []

            async def one(klass):
                async with gate.admit(klass):
                    order.append(klass)
                    await asyncio.sleep(0.001)

            tasks = []
            # a running op holds the slot so everything below parks
            hold = asyncio.ensure_future(one("client"))
            await asyncio.sleep(0)
            for _ in range(20):
                tasks.append(asyncio.ensure_future(one("bronze")))
                tasks.append(asyncio.ensure_future(one("gold")))
            await asyncio.gather(hold, *tasks)
            return order

        order = asyncio.new_event_loop().run_until_complete(main())
        # dmclock weight 30 vs 3: gold dominates the first dequeues
        first_half = order[1:21]
        assert first_half.count("gold") > first_half.count("bronze")
        dump = perf.dump()
        for key in ("qos_admitted_gold", "qos_admitted_bronze",
                    "qos_queued_gold", "qos_queued_bronze",
                    "qos_wait_us_gold", "qos_wait_us_bronze",
                    "qos_cost_gold", "qos_cost_bronze"):
            assert key in dump, key
        assert dump["qos_admitted_gold"] == 20
        assert dump["qos_admitted_bronze"] == 20
        # bronze parked longer in aggregate than gold (weight 10x)
        assert dump["qos_wait_us_bronze"] > dump["qos_wait_us_gold"]
        text = prometheus_text(
            {"test_qos_gate": perf})
        assert "# TYPE ceph_tpu_test_qos_gate_qos_admitted_gold " \
            "counter" in text
        assert "ceph_tpu_test_qos_gate_qos_wait_us_bronze" in text

    def test_qos_dump_shape(self):
        from ceph_tpu_torch.osd.opqueue import MClockGate
        from ceph_tpu_torch.osd.scheduler import ClientProfile

        gate = MClockGate(
            max_inflight=4,
            profiles={"client": ClientProfile(weight=10.0)})
        gate.ensure_class("tenant-x")  # inherits the client profile
        d = gate.qos_dump()
        assert d["classes"]["tenant-x"]["profile"]["weight"] == 10.0
        assert d["max_inflight"] == 4


class TestQosWire:
    def test_mosdop_carries_qos_class(self):
        from ceph_tpu_torch.msg.messages import MOSDOp
        from ceph_tpu_torch.msg.messenger import decode_message, encode_message

        op = MOSDOp(tid=9, pool=2, oid="o", op=1, data=b"xyz",
                    qos_class="gold")
        segs = encode_message(op, ("client", 1), 1)
        back = decode_message([bytes(s) for s in segs])
        assert back.qos_class == "gold"
        assert back.oid == "o" and back.tid == 9
        # untagged stays untagged (the built-in client class)
        segs = encode_message(
            MOSDOp(tid=1, pool=0, oid="p", op=1), ("client", 1), 2)
        assert decode_message([bytes(s) for s in segs]).qos_class == ""

"""Manager subsystem tests: report protocol round-trip, ring-buffer
wrap/eviction, standby failover re-registration, module lifecycle, and
the batched analytics engine pinned bit-identical to its numpy
reference (the acceptance list of the mgr PR).

The port's twin of tests/test_mgr.py: the same cases over ``ceph_tpu_torch``,
the daemons and the analytics engine on the CPU.  The reference's
``test_mgr_module_exports_event_plane_series`` has no twin: it is red in
the reference (``ROADMAP.md``, reference facts).
"""

from __future__ import annotations

import asyncio
import json

import numpy as np
import pytest

from ceph_tpu_torch.common.metrics import PerfCounters, prometheus_text
from ceph_tpu_torch.common.optracker import (
    HIST_BUCKETS,
    LatencyHistogram,
    OpTracker,
)
from ceph_tpu_torch.msg.messages import (
    MMgrBeacon,
    MMgrConfigure,
    MMgrMap,
    MMgrOpen,
    MMgrReport,
    MMonMgrReport,
)
from ceph_tpu_torch.msg.messenger import decode_message, encode_message


def run(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def _rt(msg):
    return decode_message(encode_message(msg, ("test", 0), 1))


class TestMgrProtocol:
    def test_beacon_roundtrip(self):
        m = _rt(MMgrBeacon(name="x", gid=12345, host="127.0.0.1",
                           port=6800))
        assert (m.name, m.gid, m.host, m.port) == (
            "x", 12345, "127.0.0.1", 6800)

    def test_mgrmap_roundtrip(self):
        blob = json.dumps({"active": {"name": "x"}}).encode()
        m = _rt(MMgrMap(epoch=7, blob=blob))
        assert m.epoch == 7 and json.loads(m.blob)["active"]["name"] == "x"

    def test_open_configure_roundtrip(self):
        m = _rt(MMgrOpen(daemon="osd.3", metadata=b'{"a":1}'))
        assert m.daemon == "osd.3" and m.metadata == b'{"a":1}'
        c = _rt(MMgrConfigure(period=0.25))
        assert c.period == 0.25

    def test_report_roundtrip(self):
        m = _rt(MMgrReport(
            daemon="osd.0",
            counters={"op": 3.5, "op_w": 2.0},
            gauges={"write_lat_us": 812.25},
            histograms={"write": [1, 2, 3] + [0] * (HIST_BUCKETS - 3)},
            status=b'{"read_errors": 0}',
        ))
        assert m.daemon == "osd.0"
        assert m.counters == {"op": 3.5, "op_w": 2.0}
        assert m.gauges == {"write_lat_us": 812.25}
        assert m.histograms["write"][:3] == [1, 2, 3]
        assert len(m.histograms["write"]) == HIST_BUCKETS
        assert json.loads(m.status) == {"read_errors": 0}

    def test_mon_mgr_report_roundtrip(self):
        m = _rt(MMonMgrReport(blob=b'{"osd_perf": {}}'))
        assert json.loads(m.blob) == {"osd_perf": {}}

    def test_float_repr_exact(self):
        """repr-string floats must round-trip doubles exactly."""
        v = 0.1 + 0.2  # not representable prettily
        m = _rt(MMgrReport(daemon="x", gauges={"g": v}))
        assert m.gauges["g"] == v


class TestLatencyHistogram:
    def test_bucket_boundaries(self):
        h = LatencyHistogram()
        assert h.bucket_of(0) == 0
        assert h.bucket_of(1) == 0
        assert h.bucket_of(2) == 1
        assert h.bucket_of(3) == 1
        assert h.bucket_of(1 << 20) == 20
        assert h.bucket_of(1 << 60) == HIST_BUCKETS - 1

    def test_record_and_merge(self):
        a, b = LatencyHistogram(), LatencyHistogram()
        a.record(0.001)   # 1000 us -> bucket 9
        b.record(0.001)
        b.record(0.004)   # 4000 us -> bucket 11
        a.merge(b)
        assert a.total == 3
        assert a.counts[9] == 2
        assert a.counts[11] == 1
        assert a.sum_us == 1000 + 1000 + 4000
        assert a.mean_us() == 2000

    def test_optracker_per_class_histograms(self):
        t = OpTracker()
        op = t.create("write op", op_class="write")
        op.finish()
        t.record_latency("subop_w", 0.002)
        d = t.dump_histograms()
        assert d["bucket_count"] == HIST_BUCKETS
        assert d["histograms"]["write"]["count"] == 1
        assert d["histograms"]["subop_w"]["count"] == 1
        assert sum(d["histograms"]["subop_w"]["buckets"]) == 1


class TestPrometheusExposition:
    def test_type_lines_and_stable_names(self):
        pc = PerfCounters("osd.99")
        pc.inc("op", 3)
        pc.set_gauge("pg_count", 7)
        text = prometheus_text({"osd.99": pc})
        # names unchanged (the r06 bench guard's scrape contract)
        assert "ceph_tpu_osd_99_op 3.0" in text
        assert "ceph_tpu_osd_99_pg_count 7" in text
        assert "# TYPE ceph_tpu_osd_99_op counter" in text
        assert "# TYPE ceph_tpu_osd_99_pg_count gauge" in text

    def test_mgr_module_exports_tracing_and_optracker_counters(self):
        """Satellite of the tracing PR: the mgr prometheus module's
        exposition carries the tracing-plane counters (spans recorded/
        dropped, sampler accept/reject) and the per-daemon slow-op
        count, each with a correct ``# TYPE`` line."""
        from ceph_tpu_torch.mgr.daemon import MgrDaemon

        mgr = MgrDaemon("expo", ("127.0.0.1", 1), device="cpu")
        mgr.sessions["osd.0"] = {
            "counters": {
                "trace_spans_recorded": 12.0,
                "trace_spans_dropped": 0.0,
                "trace_sampler_accept": 9.0,
                "trace_sampler_reject": 3.0,
                "slow_ops_total": 2.0,
            },
            "gauges": {"slow_ops": 2.0, "slow_ops_inflight": 1.0},
            "histograms": {}, "status": {}, "reports": 1,
        }
        text = mgr.modules["prometheus"].text()
        for name, typ in (
            ("trace_spans_recorded", "counter"),
            ("trace_spans_dropped", "counter"),
            ("trace_sampler_accept", "counter"),
            ("trace_sampler_reject", "counter"),
            ("slow_ops_total", "counter"),
            ("slow_ops", "gauge"),
            ("slow_ops_inflight", "gauge"),
        ):
            metric = f"ceph_tpu_osd_0_{name}"
            assert f"# TYPE {metric} {typ}" in text, (name, typ)
            assert f"\n{metric} " in "\n" + text, name

    def test_osd_report_carries_tracing_counters(self):
        """The OSD's _mgr_collect (the MMgrReport raw material) must
        include the tracer's telemetry and the slow-op counts the
        prometheus module exports."""
        from ceph_tpu_torch.common.tracing import Tracer

        # exercise the tracer counter plumbing without booting an OSD
        t = Tracer("osd.77", sample_rate=1.0)
        with t.span("do_op", oid="x"):
            pass
        assert t.counters["spans_recorded"] == 1
        assert t.counters["sampler_accept"] == 1
        # and the exported span is drainable exactly once
        spans = t.drain_export()
        assert len(spans) == 1 and spans[0]["name"] == "do_op"
        assert t.drain_export() == []

    def test_histogram_exposition(self):
        pc = PerfCounters("osd.7")
        h = LatencyHistogram()
        h.record(0.001)
        h.record(0.003)
        pc.register_histogram("write_latency", h)
        text = prometheus_text({"osd.7": pc})
        assert "# TYPE ceph_tpu_osd_7_write_latency histogram" in text
        # cumulative buckets with le in seconds, then +Inf/_sum/_count
        assert 'ceph_tpu_osd_7_write_latency_bucket{le="+Inf"} 2' in text
        assert "ceph_tpu_osd_7_write_latency_count 2" in text
        assert "ceph_tpu_osd_7_write_latency_sum 0.004" in text
        # le bounds are cumulative: the 4096us bucket sees both samples
        assert '_bucket{le="0.004096"} 2' in text


class TestTimeSeriesStore:
    def make(self, d=2, m=3, w=4):
        from ceph_tpu_torch.mgr.daemon import TimeSeriesStore

        return TimeSeriesStore(d, m, w)

    def test_ring_wrap(self):
        ts = self.make(w=4)
        for i in range(6):  # wraps: only the last 4 survive
            ts.ingest("osd.0", {"lat": float(i)}, now=float(i))
        assert ts.series("osd.0", "lat") == [2, 3, 4, 5]

    def test_missing_metric_leaves_invalid_cell(self):
        ts = self.make(w=4)
        ts.ingest("osd.0", {"lat": 5.0, "q": 1.0}, now=0.0)
        ts.ingest("osd.0", {"q": 2.0}, now=1.0)  # no lat this interval
        assert ts.series("osd.0", "lat") == [5]
        assert ts.series("osd.0", "q") == [1, 2]

    def test_daemon_lru_eviction(self):
        ts = self.make(d=2)
        ts.ingest("osd.0", {"lat": 1.0}, now=0.0)
        ts.ingest("osd.1", {"lat": 2.0}, now=1.0)
        ts.ingest("osd.0", {"lat": 3.0}, now=2.0)  # refresh osd.0
        ts.ingest("osd.2", {"lat": 4.0}, now=3.0)  # evicts osd.1 (LRU)
        assert ts.evictions == 1
        assert set(ts.daemons) == {"osd.0", "osd.2"}
        # the evicted slot was CLEARED before reuse
        assert ts.series("osd.2", "lat") == [4]
        assert ts.series("osd.0", "lat") == [1, 3]

    def test_metric_overflow_dropped_and_counted(self):
        ts = self.make(m=2)
        ts.ingest("osd.0", {"a": 1.0, "b": 2.0, "c": 3.0}, now=0.0)
        assert set(ts.metric_names) == {"a", "b"}
        assert ts.dropped_metrics.get("c") == 1

    def test_sample_clamp(self):
        from ceph_tpu_torch.mgr.daemon import SAMPLE_CLAMP

        ts = self.make()
        ts.ingest("osd.0", {"lat": float(1 << 60), "neg": -5.0}, now=0.0)
        assert ts.series("osd.0", "lat") == [SAMPLE_CLAMP]
        assert ts.series("osd.0", "neg") == [0]


class TestAnalytics:
    def _random_store(self, rng, D=5, M=4, W=12):
        vals = rng.integers(0, 1 << 28, size=(D, M, W)).astype(np.int64)
        valid = rng.random((D, M, W)) < rng.uniform(0.2, 0.9)
        cursor = rng.integers(0, W, size=D).astype(np.int64)
        return vals, valid, cursor

    def test_batched_bit_identical_to_numpy(self):
        """THE analytics contract: the jitted batched pass and the
        numpy reference return bit-identical arrays on random data."""
        from ceph_tpu_torch.mgr.analytics import AnalyticsEngine, analyze_numpy

        rng = np.random.default_rng(42)
        eng = AnalyticsEngine(5, 4, 12, backend="cuda", device="cpu")
        assert eng.prewarm() == 1
        for _ in range(3):
            vals, valid, cursor = self._random_store(rng)
            a = eng.analyze(vals, valid, cursor)
            b = analyze_numpy(vals, valid, cursor)
            for key in b:
                assert np.array_equal(a[key], b[key]), key
        assert eng.stats["cold_launches"] == 0
        assert eng.stats["fallbacks"] == 0
        assert eng.stats["prewarmed_shapes"] == 1

    def test_numpy_backend_same_results(self):
        from ceph_tpu_torch.mgr.analytics import AnalyticsEngine, analyze_numpy

        rng = np.random.default_rng(7)
        vals, valid, cursor = self._random_store(rng)
        eng = AnalyticsEngine(5, 4, 12, backend="numpy")
        a = eng.analyze(vals, valid, cursor)
        b = analyze_numpy(vals, valid, cursor)
        for key in b:
            assert np.array_equal(a[key], b[key]), key

    def test_percentile_semantics(self):
        """Nearest-rank on a known series: p50 of 1..100 is 50."""
        from ceph_tpu_torch.mgr.analytics import analyze_numpy

        D, M, W = 1, 1, 100
        vals = np.arange(1, 101, dtype=np.int64).reshape(D, M, W)
        valid = np.ones((D, M, W), bool)
        out = analyze_numpy(vals, valid, np.zeros(D, np.int64))
        assert out["percentiles"][0, 0] == 50   # p50
        assert out["percentiles"][0, 1] == 95   # p95
        assert out["percentiles"][0, 2] == 99   # p99

    def test_outlier_detection(self):
        """One daemon 10x slower than five others is flagged."""
        from ceph_tpu_torch.mgr.analytics import analyze_numpy

        D, M, W = 6, 1, 8
        vals = np.full((D, M, W), 100, np.int64)
        vals[3] = 1000
        valid = np.ones((D, M, W), bool)
        out = analyze_numpy(vals, valid, np.zeros(D, np.int64))
        assert out["outlier"][3, 0]
        assert out["outlier"].sum() == 1

    def test_ewma_tracks_trend(self):
        """EWMA (alpha=1/4) of a step 0->1000 converges toward 1000
        and exceeds the plain mean of the window."""
        from ceph_tpu_torch.mgr.analytics import SCALE_SHIFT, analyze_numpy

        D, M, W = 1, 1, 16
        vals = np.zeros((D, M, W), np.int64)
        vals[0, 0, 8:] = 1000
        valid = np.ones((D, M, W), bool)
        out = analyze_numpy(vals, valid, np.zeros(D, np.int64))
        ewma = out["ewma_scaled"][0, 0] / (1 << SCALE_SHIFT)
        mean = out["mean_scaled"][0, 0] / (1 << SCALE_SHIFT)
        assert 800 < ewma <= 1000
        assert ewma > mean


def _fast_conf(**extra):
    from ceph_tpu_torch.common import ConfigProxy

    return ConfigProxy({
        "mgr_beacon_interval": 0.1,
        "mgr_report_interval": 0.15,
        "mgr_digest_interval": 0.15,
        "mgr_module_tick_interval": 0.1,
        "mon_mgr_beacon_grace": 1.0,
        **extra,
    })


async def _wait_for(pred, timeout=20.0, interval=0.1):
    deadline = asyncio.get_running_loop().time() + timeout
    while asyncio.get_running_loop().time() < deadline:
        if pred():
            return True
        await asyncio.sleep(interval)
    return False


class TestMgrCluster:
    def test_module_enable_disable_lifecycle(self):
        """`ceph mgr module ls/enable/disable`: the enabled set lives
        in the MgrMap and the active mgr reconciles running modules
        against it within a tick."""

        async def go():
            from ceph_tpu_torch.client import RadosClient
            from ceph_tpu_torch.crush import builder as B
            from ceph_tpu_torch.crush.types import CrushMap
            from ceph_tpu_torch.mgr.daemon import MgrDaemon
            from ceph_tpu_torch.mon import Monitor

            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=1)
            mon = Monitor(crush=crush, conf=_fast_conf(), device="cpu")
            await mon.start()
            mgr = MgrDaemon("x", [mon.addr], conf=_fast_conf(), device="cpu")
            await mgr.start()
            client = RadosClient()
            try:
                await client.connect(*mon.addr)
                assert await _wait_for(lambda: mgr.active)
                # defaults run; balancer is off by default
                assert await _wait_for(
                    lambda: mgr.modules["prometheus"].running)
                assert mgr.modules["devicehealth"].running
                assert not mgr.modules["balancer"].running
                code, _rs, data = await client.command(
                    {"prefix": "mgr module ls"})
                assert code == 0
                ls = json.loads(data)
                assert "balancer" in ls["available_modules"]
                assert "balancer" not in ls["enabled_modules"]
                code, _rs, _d = await client.command({
                    "prefix": "mgr module enable", "module": "balancer"})
                assert code == 0
                assert await _wait_for(
                    lambda: mgr.modules["balancer"].running)
                code, _rs, _d = await client.command({
                    "prefix": "mgr module disable", "module": "balancer"})
                assert code == 0
                assert await _wait_for(
                    lambda: not mgr.modules["balancer"].running)
                code, _rs, _d = await client.command({
                    "prefix": "mgr module enable", "module": "nope"})
                assert code != 0
            finally:
                await client.shutdown()
                await mgr.stop()
                await mon.stop()

        run(go())

    def test_standby_failover_reregistration(self):
        """Kill the active mgr: the mon promotes the standby, every
        daemon's MgrClient re-opens against it, and report streams
        resume (the chaos invariant, in miniature)."""

        async def go():
            from ceph_tpu_torch.client import RadosClient
            from ceph_tpu_torch.crush import builder as B
            from ceph_tpu_torch.crush.types import CrushMap
            from ceph_tpu_torch.mgr.daemon import MgrDaemon
            from ceph_tpu_torch.mon import Monitor
            from ceph_tpu_torch.osd.daemon import OSDDaemon

            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=1)
            mon = Monitor(crush=crush, conf=_fast_conf(), device="cpu")
            await mon.start()
            mgr_a = MgrDaemon("a", [mon.addr], conf=_fast_conf(), device="cpu")
            await mgr_a.start()
            mgr_b = MgrDaemon("b", [mon.addr], conf=_fast_conf(), device="cpu")
            await mgr_b.start()
            osd = OSDDaemon(0, mon.addr, conf=_fast_conf(), device="cpu")
            await osd.start()
            client = RadosClient()
            try:
                await client.connect(*mon.addr)
                assert await _wait_for(lambda: mgr_a.active)
                assert not mgr_b.active
                # reports land at the active
                assert await _wait_for(
                    lambda: mgr_a.sessions.get("osd.0", {}).get(
                        "reports", 0) > 0)
                opens_before = osd.mgr_client.opens_sent
                await mgr_a.stop()
                # standby promoted; the osd RE-REGISTERS (fresh
                # MMgrOpen against the new gid) and reports resume
                assert await _wait_for(lambda: mgr_b.active, timeout=30)
                assert await _wait_for(
                    lambda: mgr_b.sessions.get("osd.0", {}).get(
                        "reports", 0) > 0, timeout=30)
                assert osd.mgr_client.opens_sent > opens_before

                async def _stat():
                    _c, _r, data = await client.command(
                        {"prefix": "mgr stat"})
                    return json.loads(data)

                # the mon's digest lags one digest tick behind the new
                # active's sessions: poll until it reflects the resume
                st = await _stat()
                deadline = asyncio.get_running_loop().time() + 20
                while (st.get("active") != "b"
                       or "osd.0" not in st.get("reporting", [])):
                    assert asyncio.get_running_loop().time() < deadline, st
                    await asyncio.sleep(0.2)
                    st = await _stat()
            finally:
                await client.shutdown()
                await osd.stop()
                await mgr_b.stop()
                await mon.stop()

        run(go())

    def test_mgr_map_survives_in_snapshot(self):
        """The enabled-module set is replicated state: a mon state
        snapshot round-trip keeps it (failover/restart safety)."""

        async def go():
            from ceph_tpu_torch.crush.types import CrushMap
            from ceph_tpu_torch.mon import Monitor

            mon = Monitor(crush=CrushMap(), device="cpu")
            await mon.start()
            try:
                await mon._apply_mgr_op({
                    "op": "mgr_module", "module": "balancer",
                    "enable": True})
                await mon._apply_mgr_op({
                    "op": "mgr_beacon", "name": "x", "gid": 1,
                    "addr": ["127.0.0.1", 1234]})
                version, blob = mon._state_snapshot()
                mon._mgr_map = {"epoch": 0, "active": None,
                                "standbys": [], "modules": []}
                await mon._install_snapshot(version, blob, publish=False)
                assert "balancer" in mon._mgr_map["modules"]
                assert mon._mgr_map["active"]["name"] == "x"
            finally:
                await mon.stop()

        run(go())

"""Cluster event plane unit tests: LogClient/MLog wire round-trip,
the mon's replicated cluster log + health history/mute semantics,
crash-dump record/scan/archive, the mgr progress and crash modules,
and the chaos ``check_events`` invariant on hand-built observations
(the acceptance list of the event-plane PR).

The port's twin of tests/test_event_plane.py: the same cases over
``ceph_tpu_torch``, the mon on the CPU.  Three ``TestProgressModule``
cases have no twin, being red in the reference (``ROADMAP.md``,
reference facts); the two ``TestCheckEventsInvariant`` cases wait for
the chaos harness (``chaos/``), which is not ported.
"""

from __future__ import annotations

import asyncio

from ceph_tpu_torch.common import ConfigProxy
from ceph_tpu_torch.common.crash import (
    archive_crash,
    config_fingerprint,
    record_crash,
    scan_crashes,
)
from ceph_tpu_torch.common.logclient import (
    CLOG_ERROR,
    CLOG_WARN,
    LogClient,
    format_entry,
)
from ceph_tpu_torch.msg.messages import MLog, MLogAck
from ceph_tpu_torch.msg.messenger import decode_message, encode_message


def run(coro, timeout=60):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(coro, timeout))
    finally:
        loop.close()


def _rt(msg):
    return decode_message(encode_message(msg, ("test", 0), 1))


class TestWire:
    def test_mlog_roundtrip(self):
        m = _rt(MLog(entity="osd.3", entries=[
            {"seq": 7, "stamp": 1234.5, "channel": "cluster",
             "level": CLOG_WARN, "message": "osd.3 marking self down"},
            {"seq": 8, "stamp": 1235.0, "channel": "audit",
             "level": 1, "message": "cmd dispatch"},
        ]))
        assert m.entity == "osd.3"
        assert len(m.entries) == 2
        assert m.entries[0]["seq"] == 7
        assert m.entries[0]["stamp"] == 1234.5
        assert m.entries[0]["channel"] == "cluster"
        assert m.entries[0]["level"] == CLOG_WARN
        assert m.entries[1]["message"] == "cmd dispatch"

    def test_mlogack_roundtrip(self):
        assert _rt(MLogAck(last_seq=99)).last_seq == 99


class TestLogClient:
    def _client(self, **over):
        return LogClient("osd.0", ConfigProxy(over))

    def test_channels_and_pending(self):
        c = self._client()
        c.cluster.warn("w1")
        c.audit.info("a1")
        assert len(c._pending) == 2
        assert c._pending[0]["channel"] == "cluster"
        assert c._pending[1]["channel"] == "audit"
        # per-entity monotone seqs
        assert [e["seq"] for e in c._pending] == [1, 2]

    def test_ack_drains_prefix(self):
        c = self._client()
        for i in range(4):
            c.cluster.info(f"m{i}")
        c.handle_ack(MLogAck(last_seq=2))
        assert [e["seq"] for e in c._pending] == [3, 4]
        assert c.counters["acked"] == 2

    def test_bounded_pending_drops_oldest(self):
        c = self._client(log_client_max_pending=8,
                         log_client_rate=100)
        for i in range(20):
            c.cluster.info(f"m{i}")
        assert len(c._pending) == 8
        assert c._pending[0]["message"] == "m12"
        assert c.counters["overflow_dropped"] == 12

    def test_rate_limit_drops_and_counts(self):
        c = self._client(log_client_rate=3)
        for i in range(10):
            c.cluster.info(f"m{i}")
        assert len(c._pending) == 3
        assert c.counters["rate_dropped"] == 7
        # tail keeps everything regardless
        assert len(c.tail(20)) == 10

    def test_ship_threshold_vs_tail(self):
        c = self._client(log_client_level=CLOG_ERROR)
        c.cluster.info("below threshold")
        c.cluster.error("ships")
        assert len(c._pending) == 1
        assert c._pending[0]["message"] == "ships"
        assert len(c.tail()) == 2  # crash-dump tail keeps every level

    def test_flush_resends_until_acked(self):
        sent = []

        async def send(msg):
            sent.append(msg)

        async def go():
            c = LogClient("osd.0", ConfigProxy({}), send=send)
            c.cluster.info("one")
            await c.flush()
            await c.flush()  # unacked: resent verbatim
            assert len(sent) == 2
            assert sent[0].entries[0]["seq"] == sent[1].entries[0]["seq"]
            c.handle_ack(MLogAck(last_seq=1))
            await c.flush()
            assert len(sent) == 2  # drained: nothing to ship

        run(go())

    def test_format_entry(self):
        line = format_entry({
            "stamp": 0.0, "channel": "cluster", "level": 3,
            "entity": "osd.1", "message": "boom"})
        assert "ERROR" in line and "osd.1: boom" in line


class TestCrashDumps:
    def test_record_scan_archive(self, tmp_path):
        conf = ConfigProxy({"crash_dir": str(tmp_path)})
        try:
            raise ValueError("induced")
        except ValueError as e:
            cid = record_crash(conf, "osd.2", exc=e,
                              log_tail=[{"message": "tail line"}])
        assert cid and "osd.2" in cid
        metas = scan_crashes(str(tmp_path))
        assert len(metas) == 1
        m = metas[0]
        assert m["entity"] == "osd.2"
        assert "ValueError" in m["exception"]
        assert "induced" in m["traceback"]
        assert m["log_tail"][0]["message"] == "tail line"
        assert m["config_fingerprint"] == config_fingerprint(conf)
        assert not m["archived"]
        assert archive_crash(str(tmp_path), cid) == 1
        assert scan_crashes(str(tmp_path))[0]["archived"]
        # double archive is a no-op
        assert archive_crash(str(tmp_path)) == 0

    def test_disabled_without_crash_dir(self):
        assert record_crash(ConfigProxy({}), "osd.0",
                            reason="x") is None


def _mk_mon():
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor

    return Monitor(crush=CrushMap(), conf=ConfigProxy(
        {"mon_cluster_log_max": 16, "mon_health_history_max": 8}), device="cpu")


class TestMonLogService:
    def test_dedup_ring_bound_and_cursor(self):
        async def go():
            mon = _mk_mon()
            await mon.start()
            try:
                class Conn:
                    async def send_message(self, m):
                        self.last = m

                conn = Conn()
                msg = MLog(entity="osd.0", entries=[
                    {"seq": 1, "stamp": 1.0, "channel": "cluster",
                     "level": 1, "message": "first"},
                    {"seq": 2, "stamp": 2.0, "channel": "cluster",
                     "level": 1, "message": "second"},
                ])
                msg.conn = conn
                await mon._handle_log(msg)
                # the ack carries the highest committed seq
                assert isinstance(conn.last, MLogAck)
                assert conn.last.last_seq == 2
                # a RESEND (mon failover pattern) dedups
                await mon._handle_log(msg)
                out = mon._log_last(10)
                assert [e["message"] for e in out["entries"]] == [
                    "first", "second"]
                assert out["cursor"] == 2
                # ring bound: mon_cluster_log_max=16
                bulk = MLog(entity="osd.0", entries=[
                    {"seq": 2 + i, "stamp": float(i), "channel":
                     "cluster", "level": 1, "message": f"m{i}"}
                    for i in range(1, 21)
                ])
                bulk.conn = conn
                await mon._handle_log(bulk)
                out = mon._log_last(100)
                assert len(out["entries"]) == 16
                assert out["cursor"] == 22
                # follow cursor: only entries after `since`
                tail = mon._log_last(0, since=20)
                assert [e["index"] for e in tail["entries"]] == [21, 22]
                # channel filter
                assert mon._log_last(10, channel="audit")["entries"] == []
            finally:
                await mon.stop()

        run(go())

    def test_health_mute_semantics(self):
        async def go():
            mon = _mk_mon()
            await mon.start()
            try:
                # inject a digest-carried check and mute it
                mon._mgr_digest = {"health": {"RECENT_CRASH": {
                    "severity": "HEALTH_WARN", "summary": "s"}}}
                h = mon._render_health()
                assert h["status"] == "HEALTH_WARN"
                await mon._command({"prefix": "health mute",
                                    "code": "RECENT_CRASH"})
                h = mon._render_health()
                assert h["status"] == "HEALTH_OK"
                assert "RECENT_CRASH" in h["muted"]
                # non-sticky: a CLEAR drops the mute so the next
                # occurrence warns again
                mon._apply_health_history_op({"items": [{
                    "code": "RECENT_CRASH", "event": "cleared",
                    "severity": "HEALTH_WARN", "stamp": 1.0}]})
                assert "RECENT_CRASH" not in mon._health_mutes
                # sticky: survives the clear
                await mon._command({
                    "prefix": "health mute", "code": "RECENT_CRASH",
                    "sticky": "true"})
                mon._apply_health_history_op({"items": [{
                    "code": "RECENT_CRASH", "event": "cleared",
                    "severity": "HEALTH_WARN", "stamp": 2.0}]})
                assert "RECENT_CRASH" in mon._health_mutes
                # unmute
                code, _rs, _d = await mon._command({
                    "prefix": "health unmute", "code": "RECENT_CRASH"})
                assert code == 0
                assert "RECENT_CRASH" not in mon._health_mutes
                # TTL expiry is judged lazily at render time
                await mon._command({
                    "prefix": "health mute", "code": "RECENT_CRASH",
                    "ttl": "0.05"})
                assert "RECENT_CRASH" in mon._render_health()["muted"]
                await asyncio.sleep(0.1)
                assert "RECENT_CRASH" in mon._render_health()["checks"]
            finally:
                await mon.stop()

        run(go())

    def test_health_history_bound_and_raised_codes(self):
        async def go():
            mon = _mk_mon()
            await mon.start()
            try:
                for i in range(5):
                    mon._apply_health_history_op({"items": [
                        {"code": f"C{i}", "event": "raised",
                         "severity": "HEALTH_WARN", "summary": "s",
                         "stamp": float(i)},
                        {"code": f"C{i}", "event": "cleared",
                         "severity": "HEALTH_WARN", "stamp": float(i)},
                    ]})
                # bound: mon_health_history_max=8
                assert len(mon._health_history) == 8
                # derived raised-set: everything cleared
                assert mon._raised_codes() == {}
                mon._apply_health_history_op({"items": [{
                    "code": "OSD_DOWN", "event": "raised",
                    "severity": "HEALTH_WARN", "summary": "s",
                    "stamp": 9.0}]})
                assert mon._raised_codes() == {
                    "OSD_DOWN": "HEALTH_WARN"}
                # audit entries land for write commands
                await mon._command({"prefix": "health mute",
                                    "code": "OSD_DOWN"})
                audit = mon._log_last(10, channel="audit")["entries"]
                assert any("health mute" in e["message"] for e in audit)
            finally:
                await mon.stop()

        run(go())


class _FakeMgr:
    """Just enough mgr surface for module unit tests."""

    def __init__(self, conf=None):
        self.conf = conf or ConfigProxy({})
        self.sessions: dict[str, dict] = {}
        self.clog = LogClient("mgr.t", self.conf)
        self._summary: dict = {}
        from ceph_tpu_torch.mgr.modules import MODULE_REGISTRY

        self.modules = {
            n: cls(self) for n, cls in MODULE_REGISTRY.items()
        }

    def _analytics_summary(self):
        return self._summary

    def _slow_ops_health(self):
        return {}

    def set_degraded(self, per_osd: dict[str, int],
                     metric: str = "pgs_degraded") -> None:
        for d, n in per_osd.items():
            self.sessions.setdefault(d, {"gauges": {}})[
                "gauges"][metric] = float(n)


class TestCrashModule:
    def test_scan_health_and_archive(self, tmp_path):
        async def go():
            conf = ConfigProxy({"crash_dir": str(tmp_path),
                                "mgr_crash_recent_age": 600.0})
            mgr = _FakeMgr(conf)
            crash = mgr.modules["crash"]
            await crash.start()
            record_crash(conf, "osd.1", reason="chaos kill")
            await crash.tick()
            assert len(crash.crashes) == 1
            h = crash.health()
            assert "RECENT_CRASH" in h
            assert "osd.1" in h["RECENT_CRASH"]["summary"]
            s = crash.summary()
            assert s["recent"] == 1 and s["total"] == 1
            # archive acknowledges: warning clears on the next scan
            archive_crash(str(tmp_path))
            await crash.tick()
            assert crash.health() == {}
            assert crash.summary()["recent"] == 0
            assert crash.summary()["total"] == 1  # still listable

        run(go())

    def test_old_crashes_age_out_of_recent(self, tmp_path):
        async def go():
            conf = ConfigProxy({"crash_dir": str(tmp_path),
                                "mgr_crash_recent_age": 0.01})
            mgr = _FakeMgr(conf)
            crash = mgr.modules["crash"]
            await crash.start()
            record_crash(conf, "osd.2", reason="old")
            await asyncio.sleep(0.05)
            await crash.tick()
            assert crash.health() == {}

        run(go())


class TestAnalyticsColumns:
    def test_reserved_columns_fit_and_are_deterministic(self):
        from ceph_tpu_torch.common.config import OPTIONS
        from ceph_tpu_torch.mgr.daemon import ANALYTICS_COLUMNS, TimeSeriesStore

        assert len(ANALYTICS_COLUMNS) <= OPTIONS[
            "mgr_stats_max_metrics"].default
        ts = TimeSeriesStore(2, len(ANALYTICS_COLUMNS), 4)
        ts.reserve(ANALYTICS_COLUMNS)
        assert list(ts.metric_names) == list(ANALYTICS_COLUMNS)
        # the event-plane columns are declared
        assert "pgs_degraded" in ANALYTICS_COLUMNS
        assert "pgs_misplaced" in ANALYTICS_COLUMNS
        # reserving again is idempotent
        ts.reserve(ANALYTICS_COLUMNS)
        assert len(ts.metric_names) == len(ANALYTICS_COLUMNS)

"""Admin socket + OpTracker + dout over live daemons.

Reference surfaces: src/common/admin_socket.h (`ceph daemon <sock>
<cmd>` JSON protocol), src/common/TrackedOp.h:121 (in-flight registry,
historic + slow-op dumps, complaint threshold), src/common/dout.h
(per-subsystem levels honoring live config changes).

The port's twin of tests/integration/test_admin_observability.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin.  ``test_event_plane_cli_and_dashboard`` runs the
port's CLI, ``python -m ceph_tpu_torch.tools.ceph``."""

from __future__ import annotations

import asyncio
import logging

from ceph_tpu_torch.common import ConfigProxy, DoutLogger, OpTracker, admin_command

from tests.test_torch_mini_cluster import Cluster, run


def test_op_tracker_histories():
    t = OpTracker(history_size=3, slow_threshold=0.0)  # everything "slow"
    ops = [t.create(f"op{i}") for i in range(5)]
    assert t.dump_ops_in_flight()["num_ops"] == 5
    for op in ops:
        op.mark_event("stage")
        op.finish()
    assert t.dump_ops_in_flight()["num_ops"] == 0
    hist = t.dump_historic_ops()
    assert hist["num_ops"] == 3  # bounded
    assert [o["description"] for o in hist["ops"]] == ["op2", "op3", "op4"]
    slow = t.dump_historic_slow_ops()
    assert slow["complaints"] == 5
    events = hist["ops"][0]["type_data"]["events"]
    assert [e["event"] for e in events] == ["initiated", "stage", "done"]


def test_dout_levels_live_update(caplog):
    conf = ConfigProxy({"debug_osd": 1})
    d = DoutLogger("osd", conf, name_suffix="t")
    with caplog.at_level(logging.DEBUG, logger="ceph_tpu_torch.osd.t"):
        d.dout(5, "hidden %d", 1)
        d.dout(1, "visible %d", 2)
        conf.apply_changes({"debug_osd": 5})
        d.dout(5, "now visible %d", 3)
        d.derr("always %d", 4)
    msgs = [r.getMessage() for r in caplog.records]
    assert msgs == ["visible 2", "now visible 3", "always 4"]


class TestAdminSocket:
    def test_osd_admin_surface(self, tmp_path):
        async def go():
            sock_dir = str(tmp_path)
            conf = {"admin_socket": sock_dir + "/osd.$id.asok"}
            async with Cluster(n_osds=4, osd_conf=conf) as c:
                await c.client.pool_create("rbd", pg_num=8, size=3)
                io = c.client.ioctx("rbd")
                for i in range(6):
                    await io.write_full(f"o{i}", b"x" * 1000)

                # find a primary that served ops and query its socket
                path = sock_dir + "/osd.0.asok"
                helptext = await admin_command(path, "help")
                assert "dump_ops_in_flight" in helptext
                perf = await admin_command(path, "perf dump")
                assert isinstance(perf, dict)
                cfg = await admin_command(path, "config show")
                assert cfg["osd_op_history_size"] == 20
                status = await admin_command(path, "status")
                assert status["osd"] == 0 and status["up"]

                # some OSD recorded completed client ops
                total_hist = 0
                for i in range(4):
                    h = await admin_command(
                        sock_dir + f"/osd.{i}.asok", "dump_historic_ops"
                    )
                    total_hist += h["num_ops"]
                assert total_hist >= 6
                # in-flight is empty at rest, events recorded
                infl = await admin_command(path, "dump_ops_in_flight")
                assert infl["num_ops"] == 0

                # runtime config change through the socket
                out = await admin_command(path, {
                    "prefix": "config set", "var": "debug_osd", "val": "5",
                })
                assert out["success"] == "debug_osd"
                cfg = await admin_command(path, "config show")
                assert cfg["debug_osd"] == 5
                assert c.osds[0].dlog.level == 5  # observer fired

                unknown = await admin_command(path, "frobnicate")
                assert "error" in unknown

        run(go())

    def test_dump_faults_surface(self, tmp_path):
        """The disk-fault observability plane: armed FAULTS points,
        fired counters, the per-OSD read-error ledger and the
        process-wide disk_fault counters/spans, all served over the
        admin socket's ``dump_faults``."""

        async def go():
            import errno

            from ceph_tpu_torch.common.fault_injector import FAULTS
            from ceph_tpu_torch.osd.daemon import object_to_pg

            sock_dir = str(tmp_path)
            conf = {"admin_socket": sock_dir + "/osd.$id.asok"}
            async with Cluster(n_osds=3, osd_conf=conf) as c:
                await c.client.pool_create("df", pg_num=4, size=2)
                io = c.client.ioctx("df")
                await io.write_full("df-obj", b"z" * 4096)
                om = c.client.osdmap
                pool = om.get_pg_pool(io.pool_id)
                pg = object_to_pg(pool, "df-obj")
                _u, _up, _a, primary = om.pg_to_up_acting_osds(pg)

                helptext = await admin_command(
                    sock_dir + f"/osd.{primary}.asok", "help")
                assert "dump_faults" in helptext
                d = await admin_command(
                    sock_dir + f"/osd.{primary}.asok", "dump_faults")
                assert d["armed"] == {} and d["read_error_ledger"] == {}
                assert not d["escalated"]

                # a transient medium error on the primary: armed point
                # shows fired, the failover counter moves, and the
                # disk_fault span ring records the event
                FAULTS.inject(
                    f"store.read.osd.{primary}", error=errno.EIO, count=1)
                assert await io.read("df-obj") == b"z" * 4096
                d = await admin_command(
                    sock_dir + f"/osd.{primary}.asok", "dump_faults")
                key = f"store.read.osd.{primary}"
                assert d["armed"][key]["fired"] == 1
                assert d["counters"].get("medium_errors", 0) >= 1
                assert d["counters"].get("medium_errors_opread", 0) >= 1
                assert any(
                    sp["tags"].get("oid") == "df-obj"
                    for sp in d["recent"]
                )
                # transient: verification passed, ledger stays empty
                assert d["read_error_ledger"] == {}

        run(go())

    def test_dump_traces_on_every_daemon(self, tmp_path):
        """Satellite of the tracing PR: ``dump_traces`` must be served
        by EVERY daemon's admin socket — OSD, mon, mgr, MDS and the
        RGW frontend (mon/MDS/RGW historically lacked it) — and the
        daemons that served traffic must have recorded spans."""

        async def go():
            from ceph_tpu_torch.common import ConfigProxy
            from ceph_tpu_torch.fs import FSClient, MDSDaemon
            from ceph_tpu_torch.rgw import RGWStore, S3Frontend

            sock_dir = str(tmp_path)
            conf = {"admin_socket": sock_dir + "/ceph-$id.asok"}
            async with Cluster(
                n_osds=3, osd_conf=conf, mon_conf=conf,
                n_mgrs=1, mgr_conf=conf,
            ) as c:
                # pools + one op per plane so every daemon works
                await c.client.pool_create("rbd", pg_num=4, size=2)
                io = c.client.ioctx("rbd")
                await io.write_full("traced-obj", b"t" * 2048)
                await c.client.pool_create("cephfs.meta", pg_num=4, size=2)
                await c.client.pool_create("cephfs.data", pg_num=4, size=2)
                mds = MDSDaemon(0, c.mon.addr, conf=ConfigProxy(conf))
                await mds.start()
                fs = FSClient(mds.addr, c.client.ioctx("cephfs.data"))
                await fs.mount()
                await fs.mkdir("/d")
                await fs.unmount()
                await c.client.pool_create("rgw.meta", pg_num=4, size=2)
                await c.client.pool_create("rgw.data", pg_num=4, size=2)
                store = RGWStore(
                    c.client.ioctx("rgw.meta"),
                    {"default": c.client.ioctx("rgw.data")},
                )
                fe = S3Frontend(store, conf=ConfigProxy(conf))
                await fe.start()
                # one (unauthenticated) request is enough for a span
                import asyncio as _a

                r, w = await _a.open_connection(fe.host, fe.port)
                w.write(b"GET / HTTP/1.1\r\nHost: x\r\n\r\n")
                await w.drain()
                await r.read(64)
                w.close()
                try:
                    socks = {
                        "osd": sock_dir + "/ceph-0.asok",
                        "mon": sock_dir + "/ceph-mon0.asok",
                        "mgr": sock_dir + "/ceph-mgr.mgr0.asok",
                        "mds": sock_dir + "/ceph-mds.0.asok",
                        "rgw": sock_dir + "/ceph-rgw.main.asok",
                    }
                    for kind, path in socks.items():
                        helptext = await admin_command(path, "help")
                        assert "dump_traces" in helptext, (kind, helptext)
                        spans = await admin_command(path, "dump_traces")
                        assert isinstance(spans, list), kind
                    # daemons that served traffic recorded real spans
                    all_osd = []
                    for i in range(3):
                        all_osd += await admin_command(
                            sock_dir + f"/ceph-{i}.asok", "dump_traces")
                    assert any(s["name"] == "do_op" for s in all_osd)
                    # wall + monotonic stamps ride every span dump
                    sp = next(s for s in all_osd if s["name"] == "do_op")
                    assert sp["start"] > 0 and sp["start_mono"] > 0
                    assert sp["end_mono"] is not None
                    assert sp["trace_id"]
                    mds_spans = await admin_command(
                        socks["mds"], "dump_traces")
                    assert any(s["name"] == "mds_req" for s in mds_spans)
                    rgw_spans = await admin_command(
                        socks["rgw"], "dump_traces")
                    assert any(s["name"] == "rgw_req" for s in rgw_spans)
                finally:
                    await fe.stop()
                    await mds.stop()

        run(go())

    def test_trace_ring_max_configurable(self):
        """trace_ring_max replaces the hardcoded 2048-span ring."""
        from ceph_tpu_torch.common.tracing import Tracer

        t = Tracer("ring-test", ring_max=4, sample_rate=0.0,
                   tail_slow_s=None)
        for i in range(10):
            with t.span(f"s{i}"):
                pass
        dump = t.dump()
        assert len(dump) == 4
        assert [d["name"] for d in dump] == ["s6", "s7", "s8", "s9"]
        assert t.counters["spans_recorded"] == 10
        assert t.counters["spans_dropped"] == 6
        assert t.counters["sampler_reject"] == 10

    def test_event_plane_cli_and_dashboard(self, tmp_path):
        """Event-plane satellite: the port's ``ceph status`` renders the
        mgr progress bars + the last cluster-log lines, `log last`
        prints formatted entries, and the dashboard serves /api/logs
        (entries + follow cursor) and /api/progress."""

        async def go():
            import subprocess
            import sys

            from ceph_tpu_torch.mgr.dashboard import Dashboard

            conf = {
                "mgr_beacon_interval": 0.1, "mgr_report_interval": 0.15,
                "mgr_digest_interval": 0.15,
                "mgr_module_tick_interval": 0.1,
                "crash_dir": str(tmp_path),
            }
            async with Cluster(n_osds=3, osd_conf=conf, mon_conf=conf,
                               n_mgrs=1, mgr_conf=conf) as c:
                loop = asyncio.get_running_loop()
                # the mgr logs one scrub verdict per OSD after its first
                # analytics pass; let those land before the pool, so the
                # lines after the pool-create record are only the
                # recovery event's start and end and `status`'s last
                # five still hold that record
                def verdicts():
                    return [e for e in c.mon._log_last(20)["entries"]
                            if "scrub deprioritiz" in e["message"]]

                deadline = loop.time() + 15
                while len(verdicts()) < 3 and loop.time() < deadline:
                    await asyncio.sleep(0.1)
                assert len(verdicts()) == 3, verdicts()
                await c.client.pool_create("ev", pg_num=4, size=2)
                io = c.client.ioctx("ev")
                await io.write_full("o", b"x" * 512)
                # at least one cluster-log entry (the pool-create
                # audit record) must have committed, and the pool's
                # recovery event must have ended
                deadline = loop.time() + 15
                entries = []
                while loop.time() < deadline:
                    out = c.mon._log_last(20)
                    entries = out["entries"]
                    if any("recovery complete" in e["message"] for e in entries):
                        break
                    await asyncio.sleep(0.2)
                assert entries, "no cluster-log entries committed"
                assert out["cursor"] >= len(entries)

                # dashboard endpoints
                from tests.test_torch_dashboard import _get

                dash = Dashboard(c.mon)
                addr = await dash.start()
                try:
                    import json as _json

                    code, body = await _get(addr, "/api/logs")
                    assert code == 200
                    doc = _json.loads(body)
                    assert doc["entries"] and doc["cursor"] >= 1
                    assert any("osd pool create" in e["message"]
                               for e in doc["entries"])
                    code, body = await _get(addr, "/api/progress")
                    assert code == 200
                    assert isinstance(_json.loads(body), dict)
                finally:
                    await dash.stop()

                # the CLI: `status` shows the recent-log block; `log
                # last` renders formatted entries (subprocess — the
                # operator's actual entry point)
                addr_s = f"{c.mon.addr[0]}:{c.mon.addr[1]}"

                def cli(*args):
                    import os

                    return subprocess.run(
                        [sys.executable, "-m", "ceph_tpu_torch.tools.ceph",
                         "-m", addr_s, *args],
                        capture_output=True, text=True, timeout=120,
                        check=False, env=dict(os.environ),
                        cwd=os.path.dirname(os.path.dirname(
                            os.path.abspath(__file__))),
                    )

                res = await asyncio.to_thread(cli, "status")
                assert res.returncode == 0, res.stderr
                # stdout stays pure JSON; the human block (progress
                # bars + recent log lines) rides stderr
                import json as _json2

                _json2.loads(res.stdout)
                assert "recent cluster log" in res.stderr
                assert "osd pool create" in res.stderr
                res = await asyncio.to_thread(cli, "log", "last", "5")
                assert res.returncode == 0, res.stderr
                assert "AUDIT" in res.stdout or "INFO" in res.stdout
                res = await asyncio.to_thread(cli, "progress")
                assert res.returncode == 0, res.stderr

        run(go())

    def test_dump_chaos_surface(self, tmp_path):
        """The chaos engine's observability plane: events applied by
        the runner land in the process-wide ``chaos`` counters and
        span ring, and every daemon's admin socket serves them via
        ``dump_chaos`` (the thrash-forensics role)."""

        async def go():
            sock_dir = str(tmp_path)
            conf = {"admin_socket": sock_dir + "/osd.$id.asok"}
            async with Cluster(n_osds=3, osd_conf=conf) as c:
                from ceph_tpu_torch.chaos import chaos_counters, chaos_tracer
                from ceph_tpu_torch.chaos.netem import Netem

                base = chaos_counters().dump().get(
                    "netem_dropped_sends", 0)
                # emit one traced chaos event + one netem verdict the
                # way the runner does
                with chaos_tracer().span(
                    "chaos_event", kind="osd_kill", osd="2",
                ):
                    chaos_counters().inc("events", kind="osd_kill")
                netem = Netem()
                netem.attach(c.osds[0].messenger)
                netem.drop_oneway(("osd", 0), ("osd", 1))
                conn = await c.osds[0]._osd_conn(1)
                from ceph_tpu_torch.msg.messages import MOSDPing, PING

                await conn.send_message(MOSDPing(op=PING, from_osd=0))
                netem.detach(c.osds[0].messenger)

                helptext = await admin_command(
                    sock_dir + "/osd.0.asok", "help")
                assert "dump_chaos" in helptext
                d = await admin_command(sock_dir + "/osd.0.asok",
                                        "dump_chaos")
                assert d["counters"].get("events", 0) >= 1
                assert d["counters"].get("events_kindosd_kill", 0) >= 1
                assert d["counters"].get(
                    "netem_dropped_sends", 0) >= base + 1
                assert any(
                    sp["tags"].get("kind") == "osd_kill"
                    for sp in d["recent_events"]
                )

        run(go())

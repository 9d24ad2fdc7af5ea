"""The event-plane integration proof (acceptance criterion of the
cluster-event-plane PR): a chaos-style run with an injected daemon
crash and a 1-OSD-down recovery must yield

(a) ``ceph log last`` showing the markdown/crash/recovery entries
    AFTER a mon failover (the log is paxos-replicated, the follow
    cursor survives the leader),
(b) ``ceph progress`` reaching 100% with a finite ETA mid-recovery,
(c) ``ceph crash ls`` + RECENT_CRASH raised, then muted via
    ``ceph health mute``,

with ``cold_launches == 0`` on the mgr analytics digest throughout.

The port's twin of tests/integration/test_event_plane.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import json

from tests.test_torch_mini_cluster import run


async def _poll(fn, timeout=30.0, interval=0.1):
    deadline = asyncio.get_running_loop().time() + timeout
    last = None
    while asyncio.get_running_loop().time() < deadline:
        last = await fn()
        if last:
            return last
        await asyncio.sleep(interval)
    return last


class TestEventPlane:
    def test_crash_recovery_failover_proof(self, tmp_path):
        async def go():
            from ceph_tpu_torch.client import RadosClient
            from ceph_tpu_torch.common import ConfigProxy
            from ceph_tpu_torch.crush import builder as B
            from ceph_tpu_torch.crush.types import CrushMap
            from ceph_tpu_torch.mgr.daemon import MgrDaemon
            from ceph_tpu_torch.mon import Monitor
            from ceph_tpu_torch.osd.daemon import OSDDaemon

            over = {
                "mgr_beacon_interval": 0.1,
                "mgr_report_interval": 0.15,
                "mgr_digest_interval": 0.15,
                "mgr_module_tick_interval": 0.1,
                "mon_mgr_beacon_grace": 3.0,
                "mon_health_tick_interval": 0.2,
                "crash_dir": str(tmp_path),
                "mgr_progress_complete_grace": 1.5,
                "log_client_flush_interval": 0.1,
                # pace recovery (one reconciliation at a time, a
                # sleep between each) so the mid-recovery ETA
                # observation has a wide deterministic window instead
                # of racing an instant heal
                "osd_recovery_sleep": 0.35,
                "osd_recovery_max_active": 1,
            }
            conf = lambda: ConfigProxy(dict(over))  # noqa: E731
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
            n_mons = 3
            mons = [
                Monitor(crush=crush.copy(), rank=r, n_mons=n_mons,
                        conf=conf(), device="cpu")
                for r in range(n_mons)
            ]
            for m in mons:
                await m.start()
            monmap = [m.addr for m in mons]
            for m in mons:
                await m.open_quorum(list(monmap))
            for m in mons:
                await m.wait_stable()
            mgr = MgrDaemon("x", list(monmap), conf=conf(), device="cpu")
            await mgr.start()
            osds = [None] * 4
            for i in range(4):
                osds[i] = OSDDaemon(i, list(monmap), conf=conf(), device="cpu")
                await osds[i].start()
            client = RadosClient()
            await client.connect_multi(list(monmap))
            try:
                await client.pool_create("ep", pg_num=8, size=3)
                io = client.ioctx("ep")
                for i in range(16):
                    await io.write_full(f"o{i}", b"e" * 4096)
                await client.wait_clean(timeout=40)

                # -- the injected daemon crash + 1-OSD-down recovery --
                osds[3].record_crash(
                    reason="chaos: injected daemon kill")
                await osds[3].stop()
                osds[3] = None
                await client.command(
                    {"prefix": "osd down", "id": "3"})

                # the recovery progress event opens while the osd is
                # down (degraded PGs, fraction 0, no decline yet)
                async def event_open():
                    _c, _r, data = await client.command(
                        {"prefix": "progress"})
                    evs = json.loads(data).get("events", [])
                    return [e for e in evs
                            if e["kind"] == "recovery"] or None

                assert await _poll(event_open, timeout=20.0), \
                    "recovery progress event never opened"

                # revive: PACED recovery drains the degraded count —
                # (b) sample mid-recovery: fraction < 1 with a finite
                # ETA (rate = the device-computed EWMA's decline)
                osds[3] = OSDDaemon(3, list(monmap), conf=conf(), device="cpu")
                await osds[3].start()

                async def mid_progress():
                    _c, _r, data = await client.command(
                        {"prefix": "progress"})
                    for ev in json.loads(data).get("events", []):
                        if (ev["kind"] == "recovery"
                                and ev["fraction"] < 1.0
                                and ev.get("eta_s") not in (None, 0.0)):
                            return ev
                    return None

                mid = await _poll(mid_progress, timeout=30.0,
                                  interval=0.03)
                assert mid is not None, \
                    "no mid-recovery progress event with a finite ETA"
                assert 0.0 <= mid["fraction"] < 1.0
                assert mid["eta_s"] > 0.0

                async def completed():
                    _c, _r, data = await client.command(
                        {"prefix": "progress"})
                    doc = json.loads(data)
                    done = [ev for ev in doc.get("completed", [])
                            if ev["kind"] == "recovery"]
                    return done or None

                done = await _poll(completed, timeout=45.0)
                assert done, "recovery progress never completed+reaped"
                assert done[-1]["fraction"] == 1.0

                # (c) crash ls + RECENT_CRASH raised ...
                async def crash_listed():
                    _c, _r, data = await client.command(
                        {"prefix": "crash ls"})
                    cl = json.loads(data)
                    return [m for m in cl.get("crashes", [])
                            if m["entity"] == "osd.3"] or None

                crashes = await _poll(crash_listed, timeout=20.0)
                assert crashes, "injected crash never collected"
                cid = crashes[-1]["crash_id"]
                _c, _r, data = await client.command(
                    {"prefix": "crash info", "id": cid})
                meta = json.loads(data)
                assert meta["reason"].startswith("chaos:")
                assert meta["config_fingerprint"]

                async def warned():
                    _c, _r, data = await client.command(
                        {"prefix": "health"})
                    h = json.loads(data)
                    return "RECENT_CRASH" in h.get("checks", {}) or None

                assert await _poll(warned, timeout=20.0), \
                    "RECENT_CRASH never raised"
                # ... then muted
                code, rs, _d = await client.command({
                    "prefix": "health mute", "code": "RECENT_CRASH"})
                assert code == 0, rs
                _c, _r, data = await client.command({"prefix": "health"})
                h = json.loads(data)
                assert "RECENT_CRASH" not in h["checks"]
                assert "RECENT_CRASH" in h["muted"]

                # -- (a) mon FAILOVER: kill the leader, the replicated
                # log must survive and keep serving -------------------
                leader = mons[0].paxos.leader
                assert leader is not None
                await mons[leader].stop()
                mons[leader] = None
                survivors = [m for m in mons if m is not None]
                for m in survivors:
                    try:
                        await m.paxos.start_election()
                    except (ConnectionError, OSError):
                        pass

                async def new_leader():
                    for m in survivors:
                        if m.paxos.stable.is_set() and m.is_leader:
                            return m
                    return None

                assert await _poll(new_leader, timeout=20.0), \
                    "quorum never re-formed after leader loss"

                async def log_after_failover():
                    try:
                        _c, _r, data = await client.command(
                            {"prefix": "log last", "n": "200"})
                    except (OSError, ConnectionError):
                        return None
                    entries = json.loads(data).get("entries", [])
                    msgs = " | ".join(e["message"] for e in entries)
                    ok = ("marking self down" in msgs
                          or "recovery started" in msgs)
                    return entries if ok else None

                entries = await _poll(log_after_failover, timeout=25.0)
                assert entries, \
                    "cluster log lost across the mon failover"
                msgs = " | ".join(e["message"] for e in entries)
                # recovery entries (progress milestones)
                assert "recovery started" in msgs
                assert "recovery complete" in msgs
                # audit entries for the admin writes
                audit = [e for e in entries if e["channel"] == "audit"]
                assert any("osd down" in e["message"] for e in audit)
                assert any("health mute" in e["message"] for e in audit)
                # the mute survived the failover too (replicated)
                _c, _r, data = await client.command({"prefix": "health"})
                assert "RECENT_CRASH" not in json.loads(
                    data)["checks"]
                # health history recorded transitions (replicated)
                _c, _r, data = await client.command(
                    {"prefix": "health history"})
                hist = json.loads(data)["history"]
                assert any(r["code"] == "RECENT_CRASH"
                           and r["event"] == "raised" for r in hist)

                # analytics digest discipline held throughout
                assert mgr.engine.stats.get("cold_launches", 0) == 0
            finally:
                await client.shutdown()
                for o in osds:
                    if o is not None:
                        await o.stop()
                await mgr.stop()
                for m in mons:
                    if m is not None:
                        await m.stop()

        run(go())

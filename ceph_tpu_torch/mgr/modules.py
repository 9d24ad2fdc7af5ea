"""Mgr module framework + the three initial modules.

The src/pybind/mgr role: the active mgr hosts pluggable modules whose
enable/disable set lives in the MgrMap (mon-replicated, so it survives
failover — ``ceph mgr module ls/enable/disable``).  Modules run ONLY
on the active mgr; a promoted standby reconciles its running set
against the map within one module tick.

- :class:`PrometheusModule` — cluster-aggregated exposition over HTTP:
  every reporting daemon's counters/gauges/histograms plus the
  analytics engine's cluster percentiles, replacing per-process-only
  scraping (reference src/pybind/mgr/prometheus);
- :class:`DeviceHealthModule` — consumes the OSDs' read-error-ledger
  and self-markdown telemetry into per-device health states + life
  expectancy buckets and health warnings (reference
  src/pybind/mgr/devicehealth);
- :class:`BalancerModule` — periodic automated upmap rounds through
  the mon's ``osd balance`` verb (wrapping osd/balancer.py's
  UpmapBalancer); **off by default** like any rebalancer that moves
  data without being asked;
- :class:`ProgressModule` — turns the OSDs' PG-state deltas (report
  side channel + the analytics engine's device-computed EWMA columns)
  into recovery/rebalance progress events with completion fraction and
  ETA (``ceph progress``; reference src/pybind/mgr/progress);
- :class:`CrashModule` — collects the crash dumps daemons persist on
  unhandled exit / induced death (``ceph crash ls/info/archive``) and
  raises the RECENT_CRASH health warning (reference
  src/pybind/mgr/crash).
"""

from __future__ import annotations

import asyncio
import logging
import time

log = logging.getLogger("ceph_tpu_torch.mgr")

#: name -> module class (the available-modules registry)
MODULE_REGISTRY: dict[str, type] = {}

#: modules enabled in a fresh MgrMap (balancer is opt-in)
DEFAULT_MODULES = ("crash", "devicehealth", "progress", "prometheus")


def register(cls):
    MODULE_REGISTRY[cls.NAME] = cls
    return cls


class MgrModule:
    """Base module: subclass, set NAME, override start/stop/tick/
    health as needed.  ``tick`` runs every mgr_module_tick_interval
    while the module is enabled on the active mgr."""

    NAME = ""

    def __init__(self, mgr):
        self.mgr = mgr
        self.running = False

    async def start(self) -> None:
        self.running = True

    async def stop(self) -> None:
        self.running = False

    async def tick(self) -> None:
        pass

    def health(self) -> dict:
        """Health checks this module contributes to the mgr digest
        ({CHECK_NAME: {"severity", "summary", "detail"}})."""
        return {}


@register
class PrometheusModule(MgrModule):
    """Cluster-aggregated /metrics endpoint on the active mgr."""

    NAME = "prometheus"

    def __init__(self, mgr):
        super().__init__(mgr)
        self._server = None
        self.addr: tuple[str, int] | None = None

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._handle, "127.0.0.1", 0)
        self.addr = self._server.sockets[0].getsockname()[:2]
        await super().start()

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
            self._server = None
        self.addr = None
        await super().stop()

    def text(self) -> str:
        """The cluster exposition: per-daemon series under
        ``ceph_tpu_<daemon>_*`` (typed), per-daemon histograms with
        proper ``le`` buckets, and the analytics summary under
        ``ceph_tpu_cluster_*``."""
        from ceph_tpu_torch.common.metrics import _sanitize, histogram_text

        out: list[str] = []
        for daemon, sess in sorted(self.mgr.sessions.items()):
            base = f"ceph_tpu_{_sanitize(daemon)}"
            for key, val in sorted(sess.get("counters", {}).items()):
                metric = f"{base}_{_sanitize(key)}"
                out.append(f"# TYPE {metric} counter")
                out.append(f"{metric} {val}")
            for key, val in sorted(sess.get("gauges", {}).items()):
                metric = f"{base}_{_sanitize(key)}"
                out.append(f"# TYPE {metric} gauge")
                out.append(f"{metric} {val}")
            for cls, h in sorted(sess.get("histograms", {}).items()):
                counts = list(h)
                # cumulative sum/count are not on the wire per bucket;
                # derive count, approximate sum from bucket mids is
                # dishonest — use the daemon's reported mean gauge
                total = int(sum(counts))
                mean = sess.get("gauges", {}).get(f"{cls}_lat_us", 0.0)
                out.extend(histogram_text(
                    f"{base}_{_sanitize(cls)}_latency", counts,
                    int(mean * total), total))
        for line in self.mgr.cluster_metric_lines():
            out.append(line)
        out.extend(self._event_plane_lines())
        return "\n".join(out) + "\n"

    def _event_plane_lines(self) -> list[str]:
        """Health-check states, progress completion fractions and
        crash counts as typed series — the event plane's scrape
        surface (each state a 0/1 gauge; the mgr only exports the
        checks IT derives: module health + SLOW_OPS; map-level checks
        like OSD_DOWN are the mon's)."""
        from ceph_tpu_torch.common.metrics import _sanitize

        out: list[str] = []
        checks: dict[str, dict] = {}
        for mod in self.mgr.modules.values():
            if mod.running:
                checks.update(mod.health())
        checks.update(self.mgr._slow_ops_health())
        sev_val = {"HEALTH_WARN": 1, "HEALTH_ERR": 2}
        for code, chk in sorted(checks.items()):
            name = f"ceph_tpu_health_{_sanitize(code.lower())}"
            out.append(f"# TYPE {name} gauge")
            out.append(
                f"{name} {sev_val.get(chk.get('severity'), 1)}")
        out.append("# TYPE ceph_tpu_health_checks_active gauge")
        out.append(f"ceph_tpu_health_checks_active {len(checks)}")
        prog = self.mgr.modules.get("progress")
        if prog is not None and prog.running:
            out.append("# TYPE ceph_tpu_progress_events_active gauge")
            out.append(
                f"ceph_tpu_progress_events_active {len(prog.events)}")
            for ev in prog.public_events():
                name = ("ceph_tpu_progress_"
                        f"{_sanitize(ev['kind'])}_fraction")
                out.append(f"# TYPE {name} gauge")
                out.append(f"{name} {ev['fraction']}")
        crash = self.mgr.modules.get("crash")
        if crash is not None and crash.running:
            out.append("# TYPE ceph_tpu_crash_reports_total counter")
            out.append(
                f"ceph_tpu_crash_reports_total {len(crash.crashes)}")
            out.append("# TYPE ceph_tpu_crash_recent gauge")
            out.append(
                f"ceph_tpu_crash_recent {len(crash.recent())}")
        return out

    async def _handle(self, reader, writer) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), 5)
            while True:
                line = await asyncio.wait_for(reader.readline(), 5)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = req.split(b" ")[1].decode() if b" " in req else "/"
            if path == "/metrics":
                body, status = self.text().encode(), b"200 OK"
            else:
                body, status = b"see /metrics\n", b"404 Not Found"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n" + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, IndexError):
            pass
        finally:
            writer.close()


@register
class DeviceHealthModule(MgrModule):
    """Per-device health from real error telemetry: each OSD's report
    status carries its read-error ledger size and self-markdown flag;
    the module folds them into device states + a health warning."""

    NAME = "devicehealth"

    def __init__(self, mgr):
        super().__init__(mgr)
        #: daemon -> {"errors", "state", "life_expectancy"}
        self.devices: dict[str, dict] = {}

    async def tick(self) -> None:
        warn_at = self.mgr.conf["mgr_devicehealth_warn_errors"]
        max_err = max(warn_at, 1)
        for daemon, sess in self.mgr.sessions.items():
            if not daemon.startswith("osd."):
                continue
            st = sess.get("status") or {}
            errors = int(st.get("read_errors", 0))
            escalated = bool(st.get("disk_escalated", False))
            if escalated:
                state, life = "failed", "expired"
            elif errors >= max_err * 2:
                state, life = "failing", "imminent"
            elif errors >= warn_at:
                state, life = "warning", "reduced"
            else:
                state, life = "good", "normal"
            self.devices[daemon] = {
                "errors": errors,
                "escalated": escalated,
                "state": state,
                "life_expectancy": life,
            }

    def health(self) -> dict:
        bad = {d: v for d, v in self.devices.items()
               if v["state"] != "good"}
        if not bad:
            return {}
        return {
            "DEVICE_HEALTH": {
                "severity": "HEALTH_WARN",
                "summary": f"{len(bad)} device(s) with degraded health",
                "detail": [
                    f"{d}: {v['state']} ({v['errors']} verified read "
                    f"errors, life expectancy {v['life_expectancy']})"
                    for d, v in sorted(bad.items())
                ],
            }
        }


@register
class BalancerModule(MgrModule):
    """Automated upmap rounds (off by default): every
    mgr_balancer_interval the module asks the mon to run one
    ``osd balance`` pass (UpmapBalancer under the hood)."""

    NAME = "balancer"
    DEFAULT_OFF = True

    def __init__(self, mgr):
        super().__init__(mgr)
        self._last_run = 0.0
        self.rounds = 0
        self.last_swaps = -1

    async def tick(self) -> None:
        interval = self.mgr.conf["mgr_balancer_interval"]
        now = time.monotonic()
        if now - self._last_run < interval:
            return
        self._last_run = now
        try:
            code, _rs, data = await self.mgr.mon_command({
                "prefix": "osd balance", "max_swaps": "16"})
        except (ConnectionError, OSError, asyncio.TimeoutError):
            return
        if code == 0:
            import json

            self.rounds += 1
            try:
                self.last_swaps = json.loads(data).get("swaps", -1)
            except ValueError:
                self.last_swaps = -1


@register
class ProgressModule(MgrModule):
    """Recovery/rebalance progress events with completion fraction and
    device-computed ETA (the src/pybind/mgr/progress role).

    Source material: every OSD's report carries ``pgs_degraded`` /
    ``pgs_misplaced`` gauges for the PGs it leads (the PG-state side
    channel).  When a cluster-wide count leaves zero the module opens
    an event; the completion fraction is monotone non-decreasing
    (``1 - current/peak``, pinned at its maximum so transient
    re-degradation never makes a progress bar walk backwards), reaches
    1.0 when the count returns to zero, and the event is reaped after
    ``mgr_progress_complete_grace`` into a bounded completed history.

    The ETA divides the current count by the decline rate of the
    analytics engine's EWMA column for the metric — the integer-exact
    EWMA computed in the mgr's ONE batched device launch per digest
    (mgr/analytics.py), which is what smooths report jitter out of the
    estimate."""

    NAME = "progress"

    #: event kind -> the per-OSD gauge (analytics column) it follows
    KINDS = (("recovery", "pgs_degraded", "degraded"),
             ("rebalance", "pgs_misplaced", "misplaced"))

    def __init__(self, mgr):
        super().__init__(mgr)
        self.events: dict[str, dict] = {}     # kind -> active event
        self.completed: list[dict] = []       # bounded history
        self._n = 0

    def _cluster_count(self, metric: str) -> int:
        # a session that stopped reporting (daemon killed, link cut)
        # keeps its LAST gauges forever; summing those would pin the
        # cluster count at its peak and the event could never complete
        # — count only sessions fresh within a few report periods
        stale_after = 4.0 * self.mgr.conf["mgr_report_interval"]
        now = time.monotonic()
        total = 0
        for daemon, sess in self.mgr.sessions.items():
            if not daemon.startswith("osd."):
                continue
            last = sess.get("last_report")
            if last is None or now - last > stale_after:
                continue
            total += int(sess.get("gauges", {}).get(metric, 0))
        return total

    def _ewma_count(self, metric: str) -> float | None:
        """Cluster-wide EWMA of the metric from the analytics digest
        (device-computed; None before the first analytics pass)."""
        row = self.mgr._analytics_summary().get(
            "series", {}).get(metric)
        if not row:
            return None
        return float(sum(v["ewma"] for v in row.values()))

    @staticmethod
    def _public(ev: dict) -> dict:
        return {k: v for k, v in ev.items() if not k.startswith("_")}

    def public_events(self) -> list[dict]:
        return [self._public(ev) for _k, ev in sorted(self.events.items())]

    def public_completed(self) -> list[dict]:
        return [dict(ev) for ev in self.completed]

    async def tick(self) -> None:
        now = time.monotonic()
        grace = self.mgr.conf["mgr_progress_complete_grace"]
        for kind, metric, noun in self.KINDS:
            cur = self._cluster_count(metric)
            ev = self.events.get(kind)
            if ev is None:
                if cur <= 0:
                    continue
                self._n += 1
                ev = self.events[kind] = {
                    "id": f"{kind}-{self._n}", "kind": kind,
                    "message": f"{kind}: {cur} pgs {noun}",
                    "started_at": time.time(), "fraction": 0.0,
                    "eta_s": None, "peak": cur,
                    "_t0": now, "_prev": None,
                }
                self.mgr.clog.cluster.info(
                    f"{kind} started: {cur} pgs {noun}")
            if ev.get("_done_at") is not None and cur > 0:
                # re-degraded after completion but before the reap:
                # close this event now so a FRESH one (with a fresh
                # monotone fraction) opens next tick
                self._reap(kind, ev, now)
                continue
            ev["peak"] = max(ev["peak"], cur)
            frac = 1.0 - (cur / ev["peak"]) if ev["peak"] else 1.0
            ev["fraction"] = max(ev["fraction"], round(frac, 4))
            ev["message"] = f"{kind}: {cur}/{ev['peak']} pgs {noun}"
            # ETA from the EWMA column's decline rate (falls back to
            # the raw count before the first analytics pass)
            val = self._ewma_count(metric)
            if val is None:
                val = float(cur)
            prev = ev.get("_prev")
            if prev is not None and now > prev[0]:
                rate = (prev[1] - val) / (now - prev[0])
                if rate > 1e-6 and cur > 0:
                    ev["eta_s"] = round(cur / rate, 1)
            ev["_prev"] = (now, val)
            if cur == 0:
                ev["fraction"] = 1.0
                ev["eta_s"] = 0.0
                ev["message"] = f"{kind}: complete"
                if ev.get("_done_at") is None:
                    ev["_done_at"] = now
                if now - ev["_done_at"] >= grace:
                    self._reap(kind, ev, now)
            else:
                ev.pop("_done_at", None)

    def _reap(self, kind: str, ev: dict, now: float) -> None:
        self.events.pop(kind, None)
        done = self._public(ev)
        done["duration_s"] = round(now - ev["_t0"], 2)
        self.completed.append(done)
        del self.completed[:-16]
        self.mgr.clog.cluster.info(
            f"{kind} complete ({done['duration_s']}s, "
            f"peak {ev['peak']} pgs)")


@register
class CrashModule(MgrModule):
    """Crash-dump collector (the src/pybind/mgr/crash role): scans the
    shared ``crash_dir`` each tick for the dumps daemons persist on
    unhandled exit / fault-injector-induced death (common/crash.py),
    serves ``ceph crash ls/info`` through the mgr digest, and raises
    RECENT_CRASH while any unarchived dump is younger than
    ``mgr_crash_recent_age`` (``ceph crash archive`` acknowledges)."""

    NAME = "crash"

    def __init__(self, mgr):
        super().__init__(mgr)
        self.crashes: dict[str, dict] = {}
        self.scans = 0

    async def tick(self) -> None:
        d = self.mgr.conf["crash_dir"]
        if not d:
            return
        from ceph_tpu_torch.common.crash import scan_crashes

        metas = await asyncio.to_thread(scan_crashes, d)
        self.crashes = {m["crash_id"]: m for m in metas}
        self.scans += 1

    def recent(self) -> list[dict]:
        age = self.mgr.conf["mgr_crash_recent_age"]
        now = time.time()
        return [
            m for m in self.crashes.values()
            if not m.get("archived")
            and now - float(m.get("timestamp", 0.0)) < age
        ]

    def health(self) -> dict:
        rec = self.recent()
        if not rec:
            return {}
        ents = sorted({m.get("entity", "?") for m in rec})
        return {
            "RECENT_CRASH": {
                "severity": "HEALTH_WARN",
                "summary": f"{len(rec)} recent crash(es): "
                           + ", ".join(ents),
                "detail": [
                    f"{m['crash_id']}: {m.get('reason', '')}"
                    for m in sorted(
                        rec, key=lambda m: m.get("timestamp", 0.0))
                ],
            }
        }

    def summary(self) -> dict:
        """The digest block `ceph crash ls/info` serves from."""
        metas = sorted(self.crashes.values(),
                       key=lambda m: m.get("timestamp", 0.0))
        return {"crashes": metas[-32:], "recent": len(self.recent()),
                "total": len(metas)}

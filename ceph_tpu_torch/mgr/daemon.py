"""MgrDaemon: the manager process (ceph-mgr twin).

A real daemon with its own messenger: it beacons into the mon
(MMgrBeacon), the mon's MgrMonitor decides active vs standby and
publishes the MgrMap (MMgrMap) to every subscriber; the ACTIVE mgr
runs the DaemonServer plane — every daemon's MgrClient opens a session
(MMgrOpen -> MMgrConfigure) and streams MMgrReport telemetry, which
lands in a fixed-shape ``(daemons x metrics x window)`` ring-buffer
time-series store.  Each digest tick the analytics engine
(mgr/analytics.py) reduces the WHOLE store in one launch of
``mgr_analytics.cu`` — cluster percentiles, EWMA trends, outlier OSDs —
and the result goes back to the mon as an MMonMgrReport digest (`ceph
osd perf`, the dashboard's mgr views, health checks).

Standby failover: standbys beacon too; when the active's beacons stop
the mon promotes the first standby, the new MgrMap reaches every
daemon, and each MgrClient re-opens its session against the new
active — report streams resume without operator action.  The mgr is
never in the data path, so its death costs observability only.

Modules (mgr/modules.py) run on the active mgr; the enabled set lives
in the MgrMap so it survives failover.

Counterpart of ``ceph_tpu/mgr/daemon.py`` with the same names, messages
and digest JSON.  Where the port differs, on purpose:

- ``MgrDaemon(..., device=None)`` runs its analytics engine on the card
  unless the caller passes ``device="cpu"``;
- a digest pass that raises is logged, as in the reference, and also
  counted in ``digest_failures`` (shown by ``dump_analytics``); the
  engine answers no pass from the host path when its backend is
  ``cuda`` (a device failure raises);
- a failed prewarm is logged and kept in ``warmup_failures``; the
  digest still waits for the prewarm to land, so ``cold_launches``
  stays 0;
- no transfer guard is armed (``osd_transfer_guard`` is read by nothing
  here);
- ``stop()`` returns once its cancelled loops and any pass or prewarm
  still on its thread have finished;
- the declared analytics columns are the port's own copy,
  :data:`ANALYTICS_COLUMNS` (the reference's lives in its lint package).
"""

from __future__ import annotations

import asyncio
import itertools
import json
import logging
import time

import numpy as np

from ceph_tpu_torch.mgr.analytics import PCTS, SCALE_SHIFT
from ceph_tpu_torch.msg.messages import (
    MLogAck,
    MMgrBeacon,
    MMgrConfigure,
    MMgrMap,
    MMgrOpen,
    MMgrReport,
    MMonCommand,
    MMonCommandAck,
    MMonMgrReport,
    MMonSubscribe,
)
from ceph_tpu_torch.msg.messenger import Connection, Message, Messenger
from ceph_tpu_torch.ops.rs_kernels import resolve_device

log = logging.getLogger("ceph_tpu_torch.mgr")

#: metric slots the mgr reserves in its store at start, in this order
#: (``TimeSeriesStore.reserve``), so a declared digest column can never
#: be overflow-dropped by transient metrics racing for slots;
#: ``mgr_stats_max_metrics`` must stay >= its length.  The reference's
#: ``ceph_tpu/analysis/prewarm_registry.py`` ``ANALYTICS_COLUMNS``.
ANALYTICS_COLUMNS: tuple[str, ...] = (
    "read_lat_us",
    "write_lat_us",
    "subop_w_lat_us",
    "num_pgs",
    "inflight_ops",
    "slow_ops",
    "slow_ops_inflight",
    # the event plane's degraded/misplaced PG counts (progress ETAs)
    "pgs_degraded",
    "pgs_misplaced",
    # the load harness's interval-mean op latency
    "load_lat_us",
)

#: ring samples are clamped here so the int64 reductions can never
#: overflow (a sum over D*W clamped samples stays far below 2**63)
SAMPLE_CLAMP = 1 << 40


class TimeSeriesStore:
    """Fixed-shape per-(daemon, metric) ring buffers.

    The whole store is three dense arrays — ``values`` (D, M, W) int64,
    ``valid`` (D, M, W) bool, ``cursor`` (D,) — so the analytics engine
    reduces it in one launch with a shape known at mgr start (the
    prewarm contract).  Daemon slots are LRU-evicted when full; metric
    slots are first-come with overflow counted and dropped (never a
    silent resize, which would change the launch shape)."""

    def __init__(self, max_daemons: int, max_metrics: int, window: int):
        self.shape = (max_daemons, max_metrics, window)
        self.values = np.zeros(self.shape, np.int64)
        self.valid = np.zeros(self.shape, bool)
        self.cursor = np.zeros(max_daemons, np.int64)
        self.daemons: dict[str, int] = {}
        self.metric_names: dict[str, int] = {}
        self.last_seen: dict[str, float] = {}
        self.dropped_metrics: dict[str, int] = {}
        self.evictions = 0

    def _daemon_slot(self, daemon: str) -> int:
        slot = self.daemons.get(daemon)
        if slot is not None:
            return slot
        D = self.shape[0]
        if len(self.daemons) < D:
            used = set(self.daemons.values())
            slot = next(i for i in range(D) if i not in used)
        else:
            victim = min(self.last_seen, key=self.last_seen.get)
            slot = self.daemons.pop(victim)
            self.last_seen.pop(victim, None)
            self.evictions += 1
        self.daemons[daemon] = slot
        self.values[slot] = 0
        self.valid[slot] = False
        self.cursor[slot] = 0
        return slot

    def _metric_slot(self, name: str) -> int | None:
        slot = self.metric_names.get(name)
        if slot is not None:
            return slot
        if len(self.metric_names) >= self.shape[1]:
            self.dropped_metrics[name] = self.dropped_metrics.get(name, 0) + 1
            return None
        slot = len(self.metric_names)
        self.metric_names[name] = slot
        return slot

    def ingest(self, daemon: str, samples: dict[str, float], now: float) -> None:
        """One report: every sample lands in the same window column (one
        column a report), then the cursor advances — samples absent from
        this report leave an invalid cell, so means and percentiles never
        see stale values."""
        d = self._daemon_slot(daemon)
        c = int(self.cursor[d])
        self.values[d, :, c] = 0
        self.valid[d, :, c] = False
        for name, v in samples.items():
            m = self._metric_slot(name)
            if m is None:
                continue
            q = int(np.rint(v))
            self.values[d, m, c] = min(max(q, 0), SAMPLE_CLAMP)
            self.valid[d, m, c] = True
        self.cursor[d] = (c + 1) % self.shape[2]
        self.last_seen[daemon] = now

    def series(self, daemon: str, metric: str) -> list[int]:
        """Time-ordered valid samples of one (daemon, metric) — the
        dashboard's and the tests' view; analytics never walks it."""
        d = self.daemons.get(daemon)
        m = self.metric_names.get(metric)
        if d is None or m is None:
            return []
        W = self.shape[2]
        c = int(self.cursor[d])
        out = []
        for t in range(W):
            i = (c + t) % W
            if self.valid[d, m, i]:
                out.append(int(self.values[d, m, i]))
        return out

    def reserve(self, names) -> None:
        """Pre-assign metric slots (in order) so declared analytics
        columns get deterministic positions and are never dropped by
        transient metrics racing for slots."""
        for name in names:
            self._metric_slot(name)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.values.copy(), self.valid.copy(), self.cursor.copy()


def analytics_summary(store: TimeSeriesStore, result: dict | None) -> dict:
    """The analytics result keyed back to daemon and metric names:
    percentiles of each metric with samples, each reporting daemon's
    mean, EWMA and outlier flag by metric, and the outlier daemons of
    each metric (sorted).  ``{}`` before the first pass."""
    a = result
    if a is None:
        return {}
    names = {i: n for n, i in store.metric_names.items()}
    daemons = {i: n for n, i in store.daemons.items()}
    pct = {}
    for m, name in names.items():
        if int(a["n_samples"][m]) == 0:
            continue
        pct[name] = {f"p{p}": int(a["percentiles"][m, i]) for i, p in enumerate(PCTS)}
        pct[name]["n"] = int(a["n_samples"][m])
    outliers = {}
    means = {}
    for m, mname in names.items():
        row = {}
        for d, dname in daemons.items():
            if int(a["count"][d, m]) > 0:
                row[dname] = {
                    "mean": int(a["mean_scaled"][d, m]) / (1 << SCALE_SHIFT),
                    "ewma": int(a["ewma_scaled"][d, m]) / (1 << SCALE_SHIFT),
                    "outlier": bool(a["outlier"][d, m]),
                }
        if row:
            means[mname] = row
            out = sorted(d for d, v in row.items() if v["outlier"])
            if out:
                outliers[mname] = out
    return {"percentiles": pct, "series": means, "outliers": outliers}


class MgrDaemon:
    """One manager daemon (active or standby is the mon's call).  Its
    analytics engine runs on ``device``: the card unless the caller
    asks for the CPU."""

    def __init__(self, name: str, mon_addr, conf=None, device=None):
        from ceph_tpu_torch.common import ConfigProxy, get_perf_counters
        from ceph_tpu_torch.common.tracing import Tracer
        from ceph_tpu_torch.mgr.analytics import AnalyticsEngine
        from ceph_tpu_torch.mgr.modules import MODULE_REGISTRY
        from ceph_tpu_torch.mgr.tracer import TraceCollector

        self.name = name
        self.mon_addrs: list[tuple[str, int]] = (
            list(mon_addr) if isinstance(mon_addr, list) else [mon_addr]
        )
        self.conf = conf if conf is not None else ConfigProxy()
        self.device = resolve_device(device)
        # fresh per start: the mon tells a restart from a replay
        self.gid = time.time_ns()
        self.messenger = Messenger(("mgr", self.gid), self._dispatch)
        self.perf = get_perf_counters(f"mgr.{name}")
        self.tracer = Tracer(
            f"mgr.{name}",
            ring_max=self.conf["trace_ring_max"],
            sample_rate=self.conf["trace_sample_rate"],
            tail_slow_s=(self.conf["trace_tail_slow_s"] or None),
        )
        self.messenger.tracer = self.tracer
        # the jaeger-collector role: spans shipped on MMgrReport land
        # here; `ceph trace ls/show` serves from its assemblies
        self.trace_collector = TraceCollector(
            max_traces=self.conf["mgr_trace_max_traces"],
            slow_history=self.conf["mgr_trace_slow_history"],
            slow_s=self.conf["trace_tail_slow_s"] or 1.0,
        )
        # SLOW_OPS bookkeeping: daemon -> {"count", "grew_at",
        # "inflight"} from each report's status side channel
        self._slow_ops: dict[str, dict] = {}
        # last scrub-deprioritize verdict pushed per daemon (the
        # outlier -> MMgrConfigure feedback loop)
        self._deprioritized: dict[str, bool] = {}
        self.store = TimeSeriesStore(
            self.conf["mgr_stats_max_daemons"],
            self.conf["mgr_stats_max_metrics"],
            self.conf["mgr_stats_window"],
        )
        # declared analytics columns claim their slots up front (the
        # event plane's degraded/misplaced EWMA columns included)
        self.store.reserve(ANALYTICS_COLUMNS)
        # cluster-log channel: SLOW_OPS raise/clear, scrub-
        # deprioritize verdicts and progress milestones all land in
        # the mon's replicated log through it
        from ceph_tpu_torch.common.logclient import LogClient

        self.clog = LogClient(
            f"mgr.{name}", self.conf, send=self._send_mon)
        self.engine = AnalyticsEngine(
            *self.store.shape,
            backend=self.conf["mgr_analytics_backend"],
            device=self.device,
        )
        #: daemon name -> {"conn", "counters", "gauges", "histograms",
        #: "status", "reports", "last_report", "opened_at"}
        self.sessions: dict[str, dict] = {}
        self.mgrmap: dict = {}
        self.active = False
        self.modules = {
            name_: cls(self) for name_, cls in MODULE_REGISTRY.items()
        }
        self.last_analytics: dict | None = None
        self.digests_sent = 0
        #: digest passes that raised (logged and counted; the loop
        #: goes on, so a stale digest shows here, not as silence)
        self.digest_failures = 0
        #: (what, exception) of a prewarm that raised
        self.warmup_failures: list[tuple[str, BaseException]] = []
        self.addr: tuple[str, int] | None = None
        self._mon_conn: Connection | None = None
        self._tids = itertools.count(1)
        self._cmd_waiters: dict[int, asyncio.Future] = {}
        self._beacon_task: asyncio.Task | None = None
        self._digest_task: asyncio.Task | None = None
        self._module_task: asyncio.Task | None = None
        self._warm_task = None
        self._admin = None
        self.stopping = False

    # -- lifecycle -----------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0
                    ) -> tuple[str, int]:
        self.addr = await self.messenger.bind(host, port)
        sock_path = self.conf["admin_socket"]
        if sock_path:
            from ceph_tpu_torch.common import AdminSocket

            self._admin = AdminSocket(
                sock_path.replace("$id", f"mgr.{self.name}"))
            self._register_admin_commands(self._admin)
            await self._admin.start()
        # prewarm the analytics shape NOW (off the loop): the digest
        # path must never meet a first launch — cold_launches stays 0
        # for the daemon's whole life (the decode/scrub batcher
        # discipline).  A failure is logged and kept, not raised.
        def _warm() -> None:
            try:
                self.engine.prewarm()
            except Exception as e:
                log.exception("mgr.%s: analytics prewarm failed", self.name)
                self.warmup_failures.append(("analytics", e))

        self._warm_task = asyncio.ensure_future(asyncio.to_thread(_warm))
        await self._mon_hunt()
        self.clog.start()
        self._beacon_task = asyncio.ensure_future(self._beacon_loop())
        self._digest_task = asyncio.ensure_future(self._digest_loop())
        self._module_task = asyncio.ensure_future(self._module_loop())
        return self.addr

    async def stop(self) -> None:
        self.stopping = True
        await self.clog.stop()
        tasks = [t for t in (self._beacon_task, self._digest_task,
                             self._module_task, self._warm_task) if t]
        for t in tasks:
            t.cancel()
        for mod in self.modules.values():
            if mod.running:
                await mod.stop()
        if self._admin is not None:
            await self._admin.stop()
        await self.messenger.shutdown()
        # leave nothing pending: the cancelled loops unwind, and a pass
        # or prewarm on its thread (which cannot be cancelled) finishes
        pending = [t for t in tasks if t is not asyncio.current_task() and not t.done()]
        if pending:
            await asyncio.wait(pending)

    async def _send_mon(self, msg: Message) -> None:
        if self._mon_conn is None:
            raise ConnectionError("no monitor session")
        await self._mon_conn.send_message(msg)

    def record_crash(self, reason: str = "",
                     exc: BaseException | None = None) -> str | None:
        """Persist a crash dump for this mgr (unhandled death / chaos
        kill); the crash module on the surviving active collects it."""
        from ceph_tpu_torch.common.crash import record_crash

        return record_crash(self.conf, f"mgr.{self.name}", exc=exc,
                            reason=reason, log_tail=self.clog.tail())

    def _register_admin_commands(self, sock) -> None:
        sock.register(
            "status", "mgr daemon status",
            lambda cmd: {
                "name": self.name, "gid": self.gid,
                "active": self.active,
                "sessions": sorted(self.sessions),
                "modules_running": sorted(
                    n for n, m in self.modules.items() if m.running),
            },
        )
        sock.register(
            "perf dump", "dump perf counters",
            lambda cmd: self.perf.dump(),
        )
        sock.register(
            "dump_traces", "recent spans of this mgr's tracer "
            "(blkin/otel role)",
            lambda cmd: self.tracer.dump(),
        )
        sock.register(
            "dump_trace_collector", "cross-daemon trace collector: "
            "summaries, slow-trace ids, ingest stats, recent "
            "device-launch profiling spans",
            lambda cmd: {
                "ls": self.trace_collector.ls(32),
                "device_recent":
                    self.trace_collector.device_launches(32),
                **self.trace_collector.dump(),
            },
        )
        sock.register(
            "trace show", "assemble one collected trace "
            "({'trace_id': N})",
            lambda cmd: (
                self.trace_collector.assemble(int(cmd["trace_id"]))
                or {"error": "unknown trace_id"}
            ),
        )
        sock.register(
            "dump_analytics", "analytics engine stats (launches, "
            "cold_launches, prewarmed shapes, fallbacks) + the last "
            "cluster summary",
            lambda cmd: {
                "stats": dict(self.engine.stats),
                "shape": list(self.engine.shape),
                "digest_failures": self.digest_failures,
                "warmup_failures": [
                    f"{what}: {type(e).__name__}: {e}"
                    for what, e in self.warmup_failures],
                "summary": self._analytics_summary(),
            },
        )

    async def _mon_hunt(self) -> None:
        last: Exception | None = None
        for mhost, mport in self.mon_addrs:
            try:
                conn = await self.messenger.connect(mhost, mport)
                # subscribe so MgrMap changes reach us like any daemon
                await conn.send_message(MMonSubscribe(start_epoch=0))
                self._mon_conn = conn
                return
            except (ConnectionError, OSError) as e:
                last = e
        raise ConnectionError(
            f"mgr.{self.name}: no monitor reachable: {last}")

    async def _beacon_loop(self) -> None:
        interval = self.conf["mgr_beacon_interval"]
        while not self.stopping:
            try:
                await self._mon_conn.send_message(MMgrBeacon(
                    name=self.name, gid=self.gid,
                    host=self.addr[0], port=self.addr[1],
                ))
            except (ConnectionError, OSError, AttributeError):
                try:
                    await self._mon_hunt()
                    continue
                except (ConnectionError, OSError):
                    pass
            await asyncio.sleep(interval)

    # -- dispatch ------------------------------------------------------

    async def _dispatch(self, msg: Message) -> None:
        try:
            if isinstance(msg, MMgrMap):
                await self._handle_mgr_map(msg)
            elif isinstance(msg, MMgrOpen):
                await self._handle_open(msg)
            elif isinstance(msg, MMgrReport):
                self._handle_report(msg)
            elif isinstance(msg, MLogAck):
                self.clog.handle_ack(msg)
            elif isinstance(msg, MMonCommandAck):
                fut = self._cmd_waiters.get(msg.tid)
                if fut and not fut.done():
                    fut.set_result(msg)
        except Exception:
            log.exception("mgr.%s: dispatch failed for %r",
                          self.name, msg)

    async def _handle_mgr_map(self, msg: MMgrMap) -> None:
        try:
            self.mgrmap = json.loads(msg.blob or b"{}")
        except ValueError:
            return
        act = self.mgrmap.get("active") or {}
        was = self.active
        self.active = act.get("gid") == self.gid
        if self.active and not was:
            log.info("mgr.%s: promoted to ACTIVE (map epoch %d)",
                     self.name, self.mgrmap.get("epoch", 0))
            self.perf.inc("promotions")
        elif was and not self.active:
            log.info("mgr.%s: demoted to standby", self.name)
            self.sessions.clear()
            for mod in self.modules.values():
                if mod.running:
                    await mod.stop()

    async def _handle_open(self, msg: MMgrOpen) -> None:
        sess = self.sessions.setdefault(msg.daemon, {
            "counters": {}, "gauges": {}, "histograms": {},
            "status": {}, "reports": 0,
        })
        sess["conn"] = msg.conn
        sess["opened_at"] = time.monotonic()
        self.perf.inc("session_opens")
        await msg.conn.send_message(MMgrConfigure(
            period=self.conf["mgr_report_interval"]))

    def _handle_report(self, msg: MMgrReport) -> None:
        sess = self.sessions.setdefault(msg.daemon, {
            "counters": {}, "gauges": {}, "histograms": {},
            "status": {}, "reports": 0,
        })
        for k, d in msg.counters.items():
            sess["counters"][k] = sess["counters"].get(k, 0.0) + d
        sess["gauges"].update(msg.gauges)
        sess["histograms"].update(msg.histograms)
        if msg.status:
            try:
                sess["status"] = json.loads(msg.status)
            except ValueError:
                pass
        sess["reports"] += 1
        sess["last_report"] = time.monotonic()
        self.perf.inc("reports_rx")
        if msg.spans:
            try:
                spans = json.loads(msg.spans)
            except ValueError:
                spans = []
            if spans:
                self.trace_collector.ingest(msg.daemon, spans)
                self.perf.inc("trace_spans_rx", len(spans))
        # SLOW_OPS bookkeeping: remember when each daemon's complaint
        # counter last GREW — the health check clears once no daemon
        # grew within mgr_slow_ops_warn_window and nothing slow is
        # still in flight
        st = sess.get("status") or {}
        if "slow_ops" in st:
            rec = self._slow_ops.setdefault(
                msg.daemon, {"count": 0, "grew_at": 0.0, "inflight": 0})
            count = int(st.get("slow_ops", 0))
            if count > rec["count"]:
                rec["grew_at"] = time.monotonic()
            rec["count"] = count
            rec["inflight"] = int(st.get("slow_ops_inflight", 0))
        # numeric gauges are the ring-buffer samples (latency means,
        # queue depths, ...) — one column per report
        self.store.ingest(msg.daemon, msg.gauges, time.monotonic())

    # -- the analytics/digest plane ------------------------------------

    async def _digest_loop(self) -> None:
        interval = self.conf["mgr_digest_interval"]
        while not self.stopping:
            await asyncio.sleep(interval)
            if not self.active:
                continue
            try:
                await self._digest_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                self.digest_failures += 1
                self.perf.inc("digest_failures")
                log.exception("mgr.%s: digest pass failed", self.name)

    async def _digest_once(self) -> None:
        if self._warm_task is not None and not self._warm_task.done():
            # NEVER analyze before prewarm lands: the first pass would
            # win the compile race and count as a cold launch — the
            # exact in-path compile the prewarm discipline forbids
            return
        values, valid, cursor = self.store.snapshot()
        # the pass runs off the event loop: even a warm launch must
        # not stall report ingestion
        self.last_analytics = await asyncio.to_thread(
            self.engine.analyze, values, valid, cursor)
        await self._push_scrub_flags()
        digest = self._build_digest()
        # SLOW_OPS raise/clear lands in the cluster log at its signal
        # site (the mon's health tick only logs its own map-derived
        # checks, so these lines never double up)
        slow = digest["health"].get("SLOW_OPS")
        if (slow is not None) != getattr(self, "_slow_ops_flag", False):
            self._slow_ops_flag = slow is not None
            if slow is not None:
                self.clog.cluster.warn(
                    f"Health check failed: {slow['summary']} (SLOW_OPS)")
            else:
                self.clog.cluster.info("Health check cleared: SLOW_OPS")
        try:
            await self._mon_conn.send_message(MMonMgrReport(
                blob=json.dumps(digest).encode()))
            self.digests_sent += 1
            self.perf.inc("digests_tx")
        except (ConnectionError, OSError, AttributeError):
            pass  # beacon loop re-homes the mon session

    def _analytics_summary(self) -> dict:
        """The analytics result keyed back to daemon/metric NAMES."""
        return analytics_summary(self.store, self.last_analytics)

    def cluster_metric_lines(self) -> list[str]:
        """Cluster-level exposition lines for the prometheus module."""
        from ceph_tpu_torch.common.metrics import _sanitize

        out = []
        summary = self._analytics_summary()
        for metric, row in sorted(summary.get("percentiles", {}).items()):
            for p, v in sorted(row.items()):
                if p == "n":
                    continue
                name = f"ceph_tpu_cluster_{_sanitize(metric)}_{p}"
                out.append(f"# TYPE {name} gauge")
                out.append(f"{name} {v}")
        return out

    def _outlier_daemons(self) -> set[str]:
        """OSD daemons the analytics pass flags as latency outliers on
        ANY metric (the slow-OSD detection feeding scrub scheduling)."""
        out: set[str] = set()
        for names in self._analytics_summary().get(
                "outliers", {}).values():
            out.update(n for n in names if n.startswith("osd."))
        return out

    async def _push_scrub_flags(self) -> None:
        """Close the analytics loop: tell outlier OSDs to deprioritize
        background scrubs (MMgrConfigure scrub_deprioritize), and
        un-flag recovered ones.  Sent only on verdict CHANGES."""
        outliers = self._outlier_daemons()
        for daemon, sess in list(self.sessions.items()):
            if not daemon.startswith("osd."):
                continue
            want = daemon in outliers
            if self._deprioritized.get(daemon) == want:
                continue
            conn = sess.get("conn")
            if conn is None:
                continue
            try:
                await conn.send_message(MMgrConfigure(
                    period=self.conf["mgr_report_interval"],
                    scrub_deprioritize=want))
                self._deprioritized[daemon] = want
                self.perf.inc("scrub_deprioritize_pushes")
                self.clog.cluster.info(
                    f"{daemon} scrub deprioritized (latency outlier)"
                    if want else
                    f"{daemon} scrub deprioritization lifted")
            except (ConnectionError, OSError):
                pass  # daemon gone; next session re-opens clean

    def _slow_ops_health(self) -> dict:
        """The SLOW_OPS health check (reference `ceph health` SLOW_OPS
        raised by the mgr's DaemonServer): raised while any daemon has
        slow ops IN FLIGHT or its complaint counter grew within
        mgr_slow_ops_warn_window; clears a full quiet window after the
        last slow op."""
        window = self.conf["mgr_slow_ops_warn_window"]
        now = time.monotonic()
        noisy: dict[str, dict] = {}
        for daemon, rec in self._slow_ops.items():
            if rec["inflight"] > 0 or (
                rec["grew_at"] and now - rec["grew_at"] < window
            ):
                noisy[daemon] = rec
        if not noisy:
            return {}
        total = sum(r["count"] for r in noisy.values())
        return {
            "SLOW_OPS": {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{total} slow ops, oldest daemons: "
                    + ", ".join(sorted(noisy))
                ),
                "detail": [
                    f"{d}: {r['count']} slow ops total, "
                    f"{r['inflight']} in flight over the complaint "
                    "threshold"
                    for d, r in sorted(noisy.items())
                ],
            }
        }

    def _digest_traces(self) -> dict:
        """The trace block of the digest: summaries for `ceph trace
        ls` + assembled trees (recent + slow) for `ceph trace show` —
        bounded so the digest stays small."""
        col = self.trace_collector
        ls = col.ls(16)
        trees: dict[str, dict] = {}
        want = [t["trace_id"] for t in ls[:6]]
        want += [int(t) for t in list(col.slow)[-6:]]
        for tid in want:
            if str(tid) in trees:
                continue
            a = col.assemble(tid)
            if a is not None:
                trees[str(tid)] = a
        return {"ls": ls, "trees": trees, "stats": col.dump()}

    def _top_slow_osds(self, metric: str = "write_lat_us",
                       n: int = 3) -> list[list]:
        summary = self._analytics_summary()
        row = summary.get("series", {}).get(metric, {})
        ranked = sorted(
            ((d, v["mean"]) for d, v in row.items()
             if d.startswith("osd.")),
            key=lambda kv: -kv[1])
        return [[d, round(v, 1)] for d, v in ranked[:n]]

    def _build_digest(self) -> dict:
        summary = self._analytics_summary()
        osd_perf = {}
        for daemon, sess in self.sessions.items():
            if not daemon.startswith("osd."):
                continue
            row = {}
            for key, out in (("write_lat_us", "commit_latency_ms"),
                             ("subop_w_lat_us", "apply_latency_ms")):
                series = summary.get("series", {}).get(key, {})
                v = series.get(daemon)
                row[out] = round(v["mean"] / 1000.0, 3) if v else 0.0
            osd_perf[daemon.split(".", 1)[1]] = row
        health = {}
        for mod in self.modules.values():
            if mod.running:
                health.update(mod.health())
        health.update(self._slow_ops_health())
        digest = {
            "ts": time.time(),
            "active": self.name,
            "gid": self.gid,
            "daemons": sorted(self.sessions),
            "reports_rx": int(self.perf.dump().get("reports_rx", 0)),
            "osd_perf": osd_perf,
            "top_slow_osds": self._top_slow_osds(),
            "slow_osds": sorted(self._outlier_daemons()),
            "analytics": {
                "percentiles": summary.get("percentiles", {}),
                "outliers": summary.get("outliers", {}),
            },
            "traces": self._digest_traces(),
            "health": health,
            "engine": {
                "cold_launches": int(
                    self.engine.stats.get("cold_launches", 0)),
                "launches": int(self.engine.stats.get("launches", 0)),
                "prewarmed_shapes": int(
                    self.engine.stats.get("prewarmed_shapes", 0)),
                "fallbacks": int(self.engine.stats.get("fallbacks", 0)),
            },
        }
        load_clients = {}
        for daemon, sess in self.sessions.items():
            # load-harness telemetry sessions (loadgen/driver.py):
            # surfaced in the digest so `mgr digest` serves the
            # ingested client-side view back for cross-checking
            if not daemon.startswith("loadgen."):
                continue
            load_clients[daemon] = {
                "reports": sess.get("reports", 0),
                "gauges": {k: round(float(v), 1)
                           for k, v in sess.get("gauges", {}).items()},
                "counters": {k: float(v) for k, v in
                             sess.get("counters", {}).items()},
            }
        if load_clients:
            digest["load_clients"] = load_clients
        prom = self.modules.get("prometheus")
        if prom is not None and prom.running:
            digest["prometheus"] = prom.text()
            if prom.addr:
                digest["prometheus_addr"] = list(prom.addr)
        prog = self.modules.get("progress")
        if prog is not None and prog.running:
            digest["progress"] = {
                "events": prog.public_events(),
                "completed": prog.public_completed(),
            }
        crash = self.modules.get("crash")
        if crash is not None and crash.running:
            digest["crash"] = crash.summary()
        return digest

    # -- modules -------------------------------------------------------

    def enabled_modules(self) -> set[str]:
        return set(self.mgrmap.get("modules") or [])

    async def _module_loop(self) -> None:
        interval = self.conf["mgr_module_tick_interval"]
        while not self.stopping:
            await asyncio.sleep(interval)
            try:
                await self._reconcile_modules()
                if self.active:
                    for name in sorted(self.enabled_modules()):
                        mod = self.modules.get(name)
                        if mod is not None and mod.running:
                            await mod.tick()
            except asyncio.CancelledError:
                raise
            except Exception:
                log.exception("mgr.%s: module tick failed", self.name)

    async def _reconcile_modules(self) -> None:
        want = self.enabled_modules() if self.active else set()
        for name, mod in self.modules.items():
            if name in want and not mod.running:
                await mod.start()
                self.perf.inc("module_starts")
            elif name not in want and mod.running:
                await mod.stop()

    # -- mon command client (for the balancer module) ------------------

    async def mon_command(self, cmd: dict) -> tuple[int, str, bytes]:
        tid = next(self._tids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._cmd_waiters[tid] = fut
        try:
            await self._mon_conn.send_message(MMonCommand(
                tid=tid, cmd=cmd))
            ack = await asyncio.wait_for(fut, 10.0)
            return ack.code, ack.rs, ack.data
        finally:
            self._cmd_waiters.pop(tid, None)

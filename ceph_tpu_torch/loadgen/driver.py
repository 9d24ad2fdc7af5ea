"""Load driver: replay a generated trace against a live cluster.

Thousands of simulated clients multiplex over a small pool of async
``RadosClient`` handles (``loadgen_handles``): each logical client is
one coroutine replaying its slice of the trace open-loop — it sleeps
until an op's scheduled instant and SUBMITS without awaiting the
previous op's completion (the objecter's completions + in-flight
window carry the concurrency; backpressure, when the window fills, is
itself part of the measured behavior).  S3/RBD/FS ops, whose client
stacks are await-style, run as detached tasks under a bounded
semaphore so they too never serialize the arrival process.

Self-describing payloads make every acked write verifiable: each
object's content is a pure function of its name (:func:`payload_for`),
and ranged writes ship exactly the slice that belongs at that range —
so NO interleaving of concurrent writers can produce a state other
than the canonical payload, while the OSD still executes the full
write/RMW path.  The post-run sweep re-reads a sample and any
mismatch is a lost or corrupt acked write.

Telemetry closes the loop: the driver streams its interval-mean op
latency to the active mgr as a ``loadgen.0`` daemon (MgrClient over
handle 0's messenger), and the report cross-checks its own series
against the digest the mon serves back (``mgr digest``).

Counterpart of ``ceph_tpu/loadgen/driver.py``: the same traces, payloads
and report.  ``LoadHarness(..., device=None)`` and :func:`run_profile`
take the embedded daemons' device (the card unless the caller passes
``device="cpu"``; in external mode the cluster's), whose batchers the
cold-launch check reads; the EC pool uses the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import hashlib
import json
import logging
import time

import numpy as np

from ceph_tpu_torch.loadgen.schedule import generate_load, trace_hash
from ceph_tpu_torch.loadgen import report as R

log = logging.getLogger("ceph_tpu_torch.loadgen")

#: pool names the harness owns on the target cluster
POOL_REP = "lg-rep"
POOL_EC = "lg-ec"
POOL_RBD = "lg-rbd"

#: op kinds servable against an EXTERNAL cluster (no local RGW/MDS)
RADOS_KINDS = ("rados_write", "rados_read", "ec_write", "ec_read")


def payload_for(name: str, size: int) -> bytes:
    """The canonical content of object ``name``: a self-describing
    header + name-keyed fill.  Any acked write leaves the object
    bit-identical to this, so verification is exact."""
    header = f"LG|{name}|".encode()
    need = max(size - len(header), 0)
    seed = hashlib.sha256(name.encode()).digest()
    fill = (seed * (need // len(seed) + 1))[:need]
    return (header + fill)[:size]


def _cold_snapshot(device) -> dict:
    """cold_launches + transfer-guard violations, delta-checked over
    the run (the chaos engine's steady-state discipline: a load run
    must never launch cold or trip an implicit transfer mid-flight)."""
    from ceph_tpu_torch.chaos.runner import _cold_launch_snapshot

    return _cold_launch_snapshot(device)


class LoadHarness:
    """One (profile, seed) load run end to end."""

    def __init__(self, profile: dict, seed: int, *,
                 time_scale: float = 1.0, monmap=None, conf=None,
                 qos_osds=None, device=None):
        from ceph_tpu_torch.common import ConfigProxy
        from ceph_tpu_torch.ops.rs_kernels import resolve_device

        self.profile = profile
        self.seed = seed
        self.time_scale = time_scale
        self.external_monmap = list(monmap) if monmap else None
        self.conf = conf if conf is not None else ConfigProxy()
        #: the embedded daemons' device, and the one whose batchers the
        #: cold-launch snapshot reads: the card unless the caller
        #: passes ``device="cpu"`` (in external mode, the cluster's)
        self.device = resolve_device(device)
        # external-attach mode (chaos x load composition): the caller's
        # in-process OSD daemons, for the qos fairness rows only —
        # NEVER owned, never stopped here.  The list is shared and may
        # mutate (thrash kills/revives) while we read it.
        self.qos_osds = qos_osds
        # set once prefill + warmup finish and the trace replay is
        # about to start — the chaos runner gates its thrash on this
        self.prefill_done = asyncio.Event()
        self.handles: list = []
        self.mons: list = []
        self.mgrs: list = []
        self.osds: list = []
        self.mds = None
        self.fs = None
        self.s3 = None
        self._s3_frontend = None
        self.images: list = []
        self._fs_locks: dict[int, asyncio.Lock] = {}
        self._io_rep = []            # one per handle
        self._io_ec = []
        # completed-op records: (kind, tenant, latency_s, ok)
        self.records: list[tuple] = []
        self._pending: set = set()
        self._interval: list[float] = []   # latencies since last report
        # one entry PER REPORT, mean or None — the mgr ring advances a
        # column for every report (an empty one leaves an invalid
        # cell), so the cross-check window must be counted in reports,
        # not in shipped means, or the two sides window different
        # time spans
        self.report_log: list[int | None] = []
        self.mgr_client = None
        self._sync_sem = asyncio.Semaphore(64)
        self._sync_tasks: set = set()
        self.errors: list[str] = []

    # -- cluster --------------------------------------------------------

    def _kinds(self) -> set:
        return set(self.profile["streams"])

    async def start(self) -> None:
        if self.external_monmap is None:
            await self._boot_cluster()
            monmap = self.monmap
        else:
            bad = sorted(self._kinds() - set(RADOS_KINDS))
            if bad:
                raise ValueError(
                    f"profile kinds {bad} need the embedded cluster "
                    "(RGW/RBD/FS planes); drop --mon or use a "
                    "rados/ec-only profile")
            monmap = self.external_monmap
        from ceph_tpu_torch.client import RadosClient

        n_handles = self.conf["loadgen_handles"]
        for i in range(n_handles):
            # generous per-op deadline: an open-loop run at 10x the
            # cluster's capacity is SUPPOSED to accumulate queueing
            # latency — the harness measures it, it must not time out
            h = RadosClient(client_id=9000 + i, conf=self.conf,
                            op_timeout=600.0)
            await h.connect_multi(list(monmap))
            self.handles.append(h)
        await self._create_pools()
        for h in self.handles:
            self._io_rep.append(h.ioctx(POOL_REP))
            self._io_ec.append(h.ioctx(POOL_EC))
        await self._setup_planes()
        self._start_mgr_stream()

    async def _boot_cluster(self) -> None:
        """The embedded vstart twin: mon + mgr + OSDs in-process."""
        from ceph_tpu_torch.crush import builder as B
        from ceph_tpu_torch.crush.types import CrushMap
        from ceph_tpu_torch.mgr.daemon import MgrDaemon
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.osd.daemon import OSDDaemon

        n_osds = int(self.profile.get("n_osds", 5))
        crush = CrushMap()
        B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
        mon = Monitor(crush=crush, conf=self._daemon_conf(),
                      device=self.device)
        await mon.start()
        self.mons = [mon]
        self.monmap = [mon.addr]
        mgr = MgrDaemon("lg", list(self.monmap),
                        conf=self._daemon_conf(), device=self.device)
        await mgr.start()
        self.mgrs = [mgr]
        for i in range(n_osds):
            osd = OSDDaemon(i, list(self.monmap),
                            conf=self._daemon_conf(), device=self.device)
            await osd.start()
            self.osds.append(osd)

    def _daemon_conf(self):
        """Fresh ConfigProxy per daemon (observers must not cross),
        with the harness's QoS + telemetry overrides applied."""
        from ceph_tpu_torch.common import ConfigProxy

        tenants = self.profile.get("tenants", {})
        # 10x dmclock weight spread across tenant classes, hottest
        # first — what the fairness counters differentiate
        weights = []
        w = 10.0 * max(len(tenants), 1)
        for name in tenants:
            weights.append(f"{name}:{w}")
            w = max(w / 10.0, 1.0)
        return ConfigProxy({
            "osd_mclock_client_profiles": ",".join(weights),
            # loadgen + osd gauge columns must all fit the analytics
            # shape (load_lat_us is slot-RESERVED via the prewarm
            # registry; headroom for the osd metrics around it)
            "mgr_stats_max_metrics": 24,
            "mgr_report_interval": 0.25,
            "mgr_digest_interval": 0.25,
        })

    async def _create_pools(self) -> None:
        from ceph_tpu_torch.client.rados import RadosError

        h = self.handles[0]

        async def _ensure(name, **kw):
            try:
                await h.pool_create(name, **kw)
            except RadosError as e:
                import errno as _errno

                if e.errno != _errno.EEXIST:
                    raise

        await _ensure(POOL_REP, pg_num=8, size=2)
        try:
            await h.ec_profile_set(
                "lg-ec", {"plugin": "cuda", "k": "2", "m": "1"})
        except RadosError:
            pass  # profile exists on a reused cluster
        await _ensure(POOL_EC, pg_num=4, pool_type="erasure",
                      erasure_code_profile="lg-ec")
        kinds = self._kinds()
        if kinds & {"rbd_write", "rbd_read"}:
            await _ensure(POOL_RBD, pg_num=4, size=2)
        if kinds & {"s3_put", "s3_get"}:
            await _ensure("rgw.meta", pg_num=4, size=2)
            await _ensure("rgw.data", pg_num=4, size=2)
        if kinds & {"fs_write", "fs_read"}:
            await _ensure("cephfs.meta", pg_num=4, size=2)
            await _ensure("cephfs.data", pg_num=4, size=2)

    async def _setup_planes(self) -> None:
        kinds = self._kinds()
        h = self.handles[0]
        if kinds & {"rbd_write", "rbd_read"}:
            from ceph_tpu_torch.rbd import RBD

            rbd = RBD(h.ioctx(POOL_RBD), h.ioctx(POOL_REP))
            n = int(self.profile.get("rbd_images", 4))
            size = int(self.profile["object_size"]) * 16
            for i in range(n):
                await rbd.create(f"lg-img-{i}", size, order=16)
                self.images.append(await rbd.open(f"lg-img-{i}"))
        if kinds & {"s3_put", "s3_get"}:
            from ceph_tpu_torch.rgw import RGWStore, S3Frontend

            store = RGWStore(
                h.ioctx("rgw.meta"),
                {"default": h.ioctx("rgw.data")},
                chunk_size=256 * 1024,
            )
            await store.create_user(
                "loadgen", "Load Harness",
                access_key="AKIDLOAD", secret_key="lg-secret")
            self._s3_frontend = S3Frontend(store)
            await self._s3_frontend.start()
            self.s3 = _S3Mini(
                self._s3_frontend.host, self._s3_frontend.port,
                "AKIDLOAD", "lg-secret")
            st, _ = await self.s3.request("PUT", "/lg")
            if st not in (200, 409):
                raise RuntimeError(f"bucket create failed: {st}")
        if kinds & {"fs_write", "fs_read"}:
            from ceph_tpu_torch.fs import FSClient, MDSDaemon

            self.mds = MDSDaemon(0, self.monmap[0])
            await self.mds.start()
            self.fs = FSClient(self.mds.addr, h.ioctx("cephfs.data"))
            await self.fs.mount()
            await self.fs.mkdir("/load")

    def _start_mgr_stream(self) -> None:
        """Ship the driver's own telemetry to the active mgr as a
        ``loadgen.0`` daemon — the 'mgr ingests loadgen stats' leg the
        cross-check verifies end to end."""
        from ceph_tpu_torch.mgr.client import MgrClient

        h = self.handles[0]
        self.mgr_client = MgrClient(
            "loadgen.0", h.messenger, self.conf, self._mgr_collect)
        h.set_mgr_map_listener(self.mgr_client.handle_mgr_map)
        self.mgr_client.start()

    def _mgr_collect(self) -> dict:
        done = len(self.records)
        out = {"counters": {"ops_done": float(done)}, "gauges": {}}
        if self._interval:
            mean_us = float(np.mean(self._interval)) * 1e6
            self._interval.clear()
            # remember EXACTLY what the store will ingest (int64 rint)
            self.report_log.append(int(np.rint(mean_us)))
            out["gauges"]["load_lat_us"] = mean_us
        else:
            self.report_log.append(None)
        return out

    async def stop(self) -> None:
        if self.mgr_client is not None:
            await self.mgr_client.stop()
        if self.fs is not None:
            await self.fs.unmount()
        if self.mds is not None:
            await self.mds.stop()
        if self._s3_frontend is not None:
            await self._s3_frontend.stop()
        for h in self.handles:
            await h.shutdown()
        for o in self.osds:
            await o.stop()
        for g in self.mgrs:
            await g.stop()
        for m in self.mons:
            await m.stop()

    # -- naming / payloads ---------------------------------------------

    @staticmethod
    def obj_name(kind: str, obj: int) -> str:
        plane = kind.split("_", 1)[0]
        return f"lg-{plane}-{obj:05d}"

    def _payload_slice(self, name: str, total: int, off: int,
                       size: int) -> bytes:
        return payload_for(name, total)[off:off + size]

    # -- prefill --------------------------------------------------------

    async def prefill(self) -> int:
        """Write every object in every active namespace once (whole
        canonical payload), so reads hit and ranged writes RMW into
        known content.  Uses the aio window for the RADOS planes."""
        kinds = self._kinds()
        obj_size = int(self.profile["object_size"])
        nz = int(self.profile["zipf_objects"])
        comps = []
        n = 0
        if kinds & {"rados_write", "rados_read"}:
            for i in range(nz):
                name = self.obj_name("rados_x", i)
                io = self._io_rep[i % len(self._io_rep)]
                comps.append(await io.aio_write_full(
                    name, payload_for(name, obj_size)))
                n += 1
        if kinds & {"ec_write", "ec_read"}:
            for i in range(nz):
                name = self.obj_name("ec_x", i)
                io = self._io_ec[i % len(self._io_ec)]
                comps.append(await io.aio_write_full(
                    name, payload_for(name, obj_size)))
                n += 1
        for c in comps:
            await c.wait()
        if self.s3 is not None:
            for i in range(int(self.profile.get("s3_objects", 32))):
                name = self.obj_name("s3_x", i)
                body = payload_for(name, max(
                    int(self.profile.get("small_sizes", (1024,))[0]),
                    512))
                st, _ = await self.s3.request(
                    "PUT", f"/lg/{name}", body=body)
                if st != 200:
                    raise RuntimeError(f"s3 prefill failed: {st}")
                n += 1
        if self.images:
            for img in self.images:
                base = payload_for(img.name, img.size())
                await img.write(0, base)
                n += 1
        if self.fs is not None:
            for i in range(int(self.profile.get("fs_files", 16))):
                name = self.obj_name("fs_x", i)
                f = await self.fs.create(f"/load/{name}")
                await f.write(0, payload_for(name, obj_size))
                await f.close()
                self._fs_locks[i] = asyncio.Lock()
                n += 1
        return n

    async def await_warmup(self, timeout: float = 60.0) -> None:
        """Embedded mode: wait out every daemon's EC/analytics prewarm
        so the run's cold-launch delta judges steady state only."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(not o._warm_tasks for o in self.osds) and all(
                    g._warm_task is None or g._warm_task.done()
                    for g in self.mgrs):
                return
            await asyncio.sleep(0.05)

    # -- op execution ----------------------------------------------------

    def _record(self, kind: str, tenant: str, lat: float,
                ok: bool) -> None:
        self.records.append((kind, tenant, lat, ok))
        if ok:
            self._interval.append(lat)

    def _aio_done(self, kind, tenant, comp) -> None:
        self._pending.discard(comp)
        exc = comp.exception()
        ok = exc is None and comp.result().result == 0
        if exc is not None and len(self.errors) < 32:
            self.errors.append(f"{kind}: {exc!r}")
        self._record(kind, tenant, comp.latency or 0.0, ok)

    async def _issue(self, op) -> None:
        """Dispatch one trace op.  RADOS planes submit through the
        objecter and return at admission; other planes detach."""
        kind = op.kind
        h = op.client % len(self.handles)
        obj_size = int(self.profile["object_size"])
        if kind in RADOS_KINDS:
            io = (self._io_rep if kind.startswith("rados")
                  else self._io_ec)[h]
            io.qos_class = op.tenant
            name = self.obj_name(kind, op.obj)
            if kind == "rados_write":
                comp = await io.aio_write_full(
                    name, payload_for(name, obj_size))
            elif kind == "rados_read":
                comp = await io.aio_read(name)
            elif kind == "ec_write":
                comp = await io.aio_write(
                    name,
                    self._payload_slice(name, obj_size, op.off, op.size),
                    op.off)
            else:
                comp = await io.aio_read(name, op.off, op.size)
            self._pending.add(comp)
            comp.add_done_callback(
                lambda c, k=kind, t=op.tenant: self._aio_done(k, t, c))
            return
        # await-style planes: detached under the bounded semaphore so
        # the arrival process stays open-loop
        task = asyncio.ensure_future(self._sync_op(op))
        self._sync_tasks.add(task)
        task.add_done_callback(self._sync_tasks.discard)

    async def _sync_op(self, op) -> None:
        loop = asyncio.get_running_loop()
        obj_size = int(self.profile["object_size"])
        kind = op.kind
        async with self._sync_sem:
            t0 = loop.time()
            ok = True
            try:
                if kind in ("s3_put", "s3_get"):
                    name = self.obj_name(kind, op.obj)
                    if kind == "s3_put":
                        st, _ = await self.s3.request(
                            "PUT", f"/lg/{name}",
                            body=payload_for(name, max(op.size, 512)))
                    else:
                        st, _ = await self.s3.request(
                            "GET", f"/lg/{name}")
                    ok = st == 200
                elif kind in ("rbd_write", "rbd_read"):
                    img = self.images[op.obj % len(self.images)]
                    off = op.off % max(img.size() - op.size, 1)
                    if kind == "rbd_write":
                        await img.write(off, self._payload_slice(
                            img.name, img.size(), off, op.size))
                    else:
                        await img.read(off, op.size)
                elif kind in ("fs_write", "fs_read"):
                    idx = op.obj % max(len(self._fs_locks), 1)
                    name = self.obj_name("fs_x", idx)
                    async with self._fs_locks[idx]:
                        f = await self.fs.open(f"/load/{name}")
                        try:
                            if kind == "fs_write":
                                await f.write(
                                    op.off, self._payload_slice(
                                        name, obj_size, op.off,
                                        op.size))
                            else:
                                await f.read(op.off, op.size)
                        finally:
                            await f.close()
            except Exception as e:
                ok = False
                if len(self.errors) < 32:
                    self.errors.append(f"{kind}: {e!r}")
            self._record(kind, op.tenant, loop.time() - t0, ok)

    # -- the run ---------------------------------------------------------

    async def run(self) -> dict:
        ops = generate_load(self.seed, self.profile)
        th = trace_hash(ops)
        prefilled = await self.prefill()
        await self.await_warmup()
        cold_before = _cold_snapshot(self.device)
        self.prefill_done.set()
        by_client: dict[int, list] = {}
        for op in ops:
            by_client.setdefault(op.client, []).append(op)
        loop = asyncio.get_running_loop()
        t_start = loop.time()

        async def _client(client_ops) -> None:
            for op in client_ops:
                delay = (t_start + op.t * self.time_scale
                         - loop.time())
                if delay > 0:
                    await asyncio.sleep(delay)
                await self._issue(op)

        await asyncio.gather(
            *(_client(v) for v in by_client.values()))
        # drain: every aio completion + detached plane task
        deadline = loop.time() + 120.0
        while (self._pending or self._sync_tasks) \
                and loop.time() < deadline:
            await asyncio.sleep(0.05)
        duration = loop.time() - t_start
        undrained = len(self._pending) + len(self._sync_tasks)
        # settle: let the report stream ship the tail and the digest
        # tick over it before cross-checking
        await asyncio.sleep(4 * self.conf["mgr_report_interval"]
                            + 2 * self.conf["mgr_digest_interval"])
        digest = await self._fetch_digest()
        health = await self._fetch_health()
        verify = await self._verify_sweep()
        cold_after = _cold_snapshot(self.device)
        cold_delta = {
            k: cold_after.get(k, 0) - cold_before.get(k, 0)
            for k in cold_after
        }
        summary = R.summarize_latencies(self.records)
        xc = R.cross_check(
            self.report_log,
            (digest.get("analytics", {}) or {}).get(
                "percentiles", {}).get("load_lat_us"),
            window=self.conf["mgr_stats_window"],
            tolerance=self.conf["loadgen_latency_tolerance"],
        )
        host_transfers = cold_delta.pop(
            "transfer_guard_host_transfers", 0)
        cold_launches = sum(cold_delta.values())
        ok = (
            summary["errors"] == 0
            and undrained == 0
            and verify["mismatches"] == 0 and verify["lost"] == 0
            and xc["agree"]
            and cold_launches == 0
            and host_transfers == 0
        )
        return {
            "profile": self.profile["name"],
            "seed": self.seed,
            "clients": int(self.profile["clients"]),
            "ops_per_client": int(self.profile["ops_per_client"]),
            "ops_scheduled": len(ops),
            "ops_completed": len(self.records),
            "prefilled": prefilled,
            "trace_hash": th,
            "duration_s": round(duration, 3),
            "throughput_ops_s": round(
                len(self.records) / max(duration, 1e-9), 1),
            "latency": summary,
            "client_vs_mgr": xc,
            "plausibility": R.plausibility(
                summary, digest.get("osd_perf", {})),
            "health_at_end": sorted(health),
            "qos": self._qos_rows(),
            "verify": verify,
            "cold_launches": cold_launches,
            "host_transfers": host_transfers,
            "undrained": undrained,
            "error_samples": self.errors[:8],
            "ok": ok,
        }

    async def _fetch_digest(self) -> dict:
        """The mgr digest as the MON serves it (`mgr digest`) — the
        cross-check rides the full report->digest->mon wire path."""
        for _ in range(40):
            try:
                code, _rs, data = await self.handles[0].command(
                    {"prefix": "mgr digest"})
                if code == 0 and data:
                    d = json.loads(data)
                    pct = (d.get("analytics", {}) or {}).get(
                        "percentiles", {})
                    if "load_lat_us" in pct:
                        return d
            except (OSError, ValueError):
                pass
            await asyncio.sleep(0.25)
        return {}

    async def _fetch_health(self) -> list:
        try:
            code, _rs, data = await self.handles[0].command(
                {"prefix": "health"})
            if code == 0 and data:
                return sorted(json.loads(data).get("checks") or {})
        except (OSError, ValueError):
            pass
        return []

    def _qos_rows(self) -> dict:
        """Aggregate per-class mClock fairness across the embedded
        OSDs — or, in composed chaos mode, the attached cluster's
        daemons (empty against truly external clusters)."""
        agg: dict[str, dict] = {}
        osds = list(self.osds) + [
            o for o in (self.qos_osds or []) if o is not None]
        for o in osds:
            for klass, row in o.op_gate.qos_dump()["classes"].items():
                a = agg.setdefault(klass, {
                    "admitted": 0, "queued": 0, "wait_us": 0,
                    "served_cost": 0.0, "weight": row["profile"]["weight"],
                })
                a["admitted"] += row["admitted"]
                a["queued"] += row["queued"]
                a["wait_us"] += row["wait_us"]
                a["served_cost"] += row["served_cost"]
        return agg

    async def _verify_sweep(self) -> dict:
        """Re-read a sample of every RADOS-plane namespace and demand
        the canonical payload — the zero lost/corrupt acked writes
        proof."""
        sample = self.conf["loadgen_verify_sample"]
        obj_size = int(self.profile["object_size"])
        nz = int(self.profile["zipf_objects"])
        kinds = self._kinds()
        checked = mismatches = lost = 0
        for plane, ios in (("rados", self._io_rep),
                           ("ec", self._io_ec)):
            if not (kinds & {f"{plane}_write", f"{plane}_read"}):
                continue
            for i in range(min(nz, max(sample, 0))):
                name = self.obj_name(f"{plane}_x", i)
                try:
                    data = await ios[i % len(ios)].read(name)
                except OSError:
                    lost += 1
                    continue
                checked += 1
                if data != payload_for(name, obj_size):
                    mismatches += 1
        return {"checked": checked, "mismatches": mismatches,
                "lost": lost}


class _S3Mini:
    """Minimal SigV4 HTTP client for the S3 plane (header auth; one
    connection per request — the harness bounds concurrency)."""

    def __init__(self, host: str, port: int, access: str, secret: str):
        self.host, self.port = host, port
        self.access, self.secret = access, secret

    async def request(self, method: str, path: str,
                      body: bytes = b"") -> tuple[int, bytes]:
        from ceph_tpu_torch.rgw.frontend import s3_request

        status, _, resp_body = await s3_request(
            self.host, self.port, method, path, self.access, self.secret,
            body)
        return status, resp_body


async def run_profile(profile: dict, seed: int, *,
                      time_scale: float = 1.0, monmap=None,
                      conf=None, device=None) -> dict:
    """One load run end to end (boot/connect, replay, report,
    teardown) on ``device`` (the card unless the caller passes
    ``device="cpu"``); returns the artifact run record."""
    h = LoadHarness(profile, seed, time_scale=time_scale,
                    monmap=monmap, conf=conf, device=device)
    try:
        await h.start()
        return await h.run()
    finally:
        await h.stop()

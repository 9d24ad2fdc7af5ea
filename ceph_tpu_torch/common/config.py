"""Typed configuration system.

Every option keeps the JAX package's name, type, level, bounds and enum
(ceph_tpu/common/config.py), so a deployment's ceph.conf and its
``CEPH_TPU_<OPTION>`` environment variables mean the same to both
packages.  Two defaults name the port's engines instead:
``osd_erasure_code_plugins`` preloads ``cuda`` where the reference
preloads ``jax``, and ``mgr_analytics_backend`` is ``cuda`` (enum
``cuda``, ``numpy``: mgr/analytics.py ``BACKENDS``).

Behavioral twin of the reference's option framework
(src/common/options/*.yaml.in declarations -> md_config_t,
src/common/config.h): options are declared once with type, default,
level, bounds and description; values merge from sources with fixed
precedence (compiled defaults < conf file < mon store < env < cli <
runtime override, mirroring the reference's merge order); and live
updates notify registered observers (md_config_obs_t::handle_conf_change)
via :meth:`ConfigProxy.apply_changes`.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Any, Callable

LEVEL_BASIC = "basic"
LEVEL_ADVANCED = "advanced"
LEVEL_DEV = "dev"

# source precedence, low to high (config.h CONF_* levels)
SOURCES = ("default", "file", "mon", "env", "cmdline", "override")


@dataclass(frozen=True)
class Option:
    name: str
    type: type
    default: Any
    level: str = LEVEL_ADVANCED
    desc: str = ""
    min: float | None = None
    max: float | None = None
    see_also: tuple[str, ...] = ()
    enum: tuple[str, ...] = ()

    def cast(self, value: Any) -> Any:
        if self.enum and value not in self.enum:
            raise ValueError(f"{self.name}: {value!r} not in {self.enum}")
        if self.type is bool and isinstance(value, str):
            v = value.strip().lower()
            if v in ("true", "1", "yes", "on"):
                return True
            if v in ("false", "0", "no", "off"):
                return False
            raise ValueError(f"{self.name}: not a bool: {value!r}")
        out = self.type(value)
        if self.min is not None and out < self.min:
            raise ValueError(f"{self.name}: {out} < min {self.min}")
        if self.max is not None and out > self.max:
            raise ValueError(f"{self.name}: {out} > max {self.max}")
        return out


#: the option schema (the options/*.yaml.in analogue).  Add options
#: here as subsystems grow; unknown names are rejected like the
#: reference's strict mode.
OPTIONS: dict[str, Option] = {}


def declare(*options: Option) -> None:
    for o in options:
        OPTIONS[o.name] = o


declare(
    Option("osd_pool_default_size", int, 3, LEVEL_BASIC,
           "default replica count for replicated pools", min=1),
    Option("osd_pool_default_pg_num", int, 8, LEVEL_BASIC,
           "default pg_num for new pools", min=1),
    Option("osd_beacon_report_interval", float, 1.0, LEVEL_ADVANCED,
           "seconds between osd->mon liveness beacons", min=0.0),
    Option("mon_osd_beacon_grace", float, 0.0, LEVEL_ADVANCED,
           "seconds without a beacon before an osd is marked down "
           "(0 disables the sweep)"),
    Option("mon_osd_down_out_interval", float, 0.0, LEVEL_ADVANCED,
           "seconds down before an osd is marked out (0 disables)"),
    Option("osd_heartbeat_interval", float, 1.0, LEVEL_ADVANCED,
           "seconds between osd<->osd liveness pings (0 disables; "
           "the reference's osd_heartbeat_interval, OSD.cc:5735)",
           min=0.0),
    Option("osd_heartbeat_grace", float, 20.0, LEVEL_ADVANCED,
           "seconds without a ping reply before a peer is reported "
           "failed to the mon", min=0.1),
    Option("mon_osd_min_down_reporters", int, 1, LEVEL_ADVANCED,
           "distinct failure reporters required before the mon marks "
           "an osd down", min=1),
    Option("admin_socket", str, "", LEVEL_ADVANCED,
           "unix socket path for daemon admin commands ('' disables; "
           "the reference's admin_socket option)"),
    Option("osd_op_complaint_time", float, 30.0, LEVEL_ADVANCED,
           "ops slower than this land in the slow-op history "
           "(reference osd_op_complaint_time)", min=0.0),
    Option("osd_op_history_size", int, 20, LEVEL_ADVANCED,
           "completed ops kept for dump_historic_ops", min=0),
    Option("osd_min_pg_log_entries", int, 128, LEVEL_ADVANCED,
           "pg log entries kept per shard after a trim (the trim-to "
           "floor; reference osd_min_pg_log_entries)", min=1,
           see_also=("osd_max_pg_log_entries",)),
    Option("osd_max_pg_log_entries", int, 512, LEVEL_ADVANCED,
           "pg log length that triggers a trim back down to "
           "osd_min_pg_log_entries (reference osd_max_pg_log_entries; "
           "low values force the backfill path on any lagging peer)",
           min=1, see_also=("osd_min_pg_log_entries",)),
    Option("osd_recovery_max_active", int, 4, LEVEL_ADVANCED,
           "concurrent recovery reconciliations per osd", min=1),
    Option("ms_connection_ready_timeout", float, 10.0, LEVEL_ADVANCED,
           "seconds allowed for the banner/HELLO/auth handshake per "
           "connection (reference ms_connection_ready_timeout); raise "
           "on deployments whose event loops stall for seconds (many "
           "daemons + kernel builds on few cores) or false handshake "
           "timeouts cascade into false failure reports", min=0.1),
    Option("mon_osd_nearfull_ratio", float, 0.85, LEVEL_ADVANCED,
           "store usage ratio at which an osd is flagged nearfull "
           "(health warning only; reference "
           "src/mon/OSDMonitor.cc:669-671)", min=0.0, max=1.0,
           see_also=("mon_osd_backfillfull_ratio", "mon_osd_full_ratio")),
    Option("mon_osd_backfillfull_ratio", float, 0.90, LEVEL_ADVANCED,
           "store usage ratio at which an osd refuses new backfill "
           "reservations (REJECT_TOOFULL)", min=0.0, max=1.0),
    Option("mon_osd_full_ratio", float, 0.95, LEVEL_ADVANCED,
           "store usage ratio at which client writes to PGs touching "
           "the osd bounce with ENOSPC (reference "
           "src/osd/OSD.cc:773 recalc_full_state / :890 _check_full)",
           min=0.0, max=1.0),
    Option("osd_failsafe_full_ratio", float, 0.97, LEVEL_ADVANCED,
           "local hard stop: the osd itself rejects writes past this "
           "usage even before the mon reacts (reference "
           "osd_failsafe_full_ratio)", min=0.0, max=1.0),
    Option("osd_max_backfills", int, 1, LEVEL_ADVANCED,
           "concurrent PG backfills this osd will participate in, as "
           "primary (local reservation) or replica (remote "
           "reservation) — the reference's osd_max_backfills gating "
           "AsyncReserver slots", min=1),
    Option("osd_recovery_sleep", float, 0.0, LEVEL_ADVANCED,
           "pause injected between recovery object reconciliations so "
           "client I/O breathes (reference osd_recovery_sleep)",
           min=0.0),
    Option("osd_backfill_retry_interval", float, 1.0, LEVEL_ADVANCED,
           "seconds before retrying a PG whose remote backfill "
           "reservation was rejected (reference "
           "osd_backfill_retry_interval, default 30s there — shorter "
           "here to match mini-cluster timescales)", min=0.0),
    Option("osd_backfill_grant_timeout", float, 60.0, LEVEL_ADVANCED,
           "seconds a remote backfill GRANT may sit unreleased before "
           "the reserver-death sweep reclaims the slot (0 disables the "
           "age check; grants whose requester the map says is down are "
           "always swept) — a primary that dies mid-backfill can never "
           "send its RELEASE", min=0.0,
           see_also=("osd_backfill_retry_interval",
                     "osd_max_backfills")),
    Option("osd_op_queue_max_inflight", int, 128, LEVEL_ADVANCED,
           "top-level ops admitted concurrently through the mClock "
           "gate; 0 disables admission control (every op runs "
           "immediately).  The osd_op_num_shards*threads capacity "
           "role — under saturation dequeue order follows dmclock "
           "tags so client ops outrank recovery", min=0),
    Option("osd_mclock_scheduler_client_wgt", float, 10.0, LEVEL_ADVANCED,
           "dmclock weight of the client op class (reference "
           "osd_mclock_scheduler_client_wgt)", min=0.001),
    Option("osd_mclock_scheduler_background_recovery_wgt", float, 1.0,
           LEVEL_ADVANCED,
           "dmclock weight of recovery/backfill work (reference "
           "osd_mclock_scheduler_background_recovery_wgt)", min=0.001),
    Option("osd_mclock_scheduler_background_best_effort_wgt", float, 1.0,
           LEVEL_ADVANCED,
           "dmclock weight of scrub/trim background work (reference "
           "osd_mclock_scheduler_background_best_effort_wgt)",
           min=0.001),
    Option("mon_target_pg_per_osd", int, 100, LEVEL_ADVANCED,
           "target PG replicas per OSD driving pg_autoscaler "
           "recommendations (reference mon_target_pg_per_osd)", min=1),
    Option("osd_tier_agent_interval", float, 1.0, LEVEL_ADVANCED,
           "seconds between cache-tier agent passes (flush dirty /"
           " evict cold under target_max_bytes pressure, the reference"
           " TierAgent cadence); 0 disables", min=0.0),
    Option("mon_pg_autoscale_interval", float, 0.0, LEVEL_ADVANCED,
           "seconds between pg_autoscaler acting passes on pools with "
           "pg_autoscale_mode=on (reference pg_autoscaler sleep "
           "interval); 0 disables the acting loop", min=0.0),
    Option("osd_ec_extent_cache_bytes", int, 32 * 1024 * 1024, LEVEL_ADVANCED,
           "primary-side cache of recently written EC stripe ranges so "
           "hot RMW overwrites skip the shard read (ExtentCache role, "
           "reference src/osd/ExtentCache.h; 0 disables)", min=0),
    Option("osd_scrub_interval", float, 86400.0, LEVEL_ADVANCED,
           "seconds between scheduled shallow scrubs per PG (0 "
           "disables background scrub; reference osd_scrub_min_interval "
           "role)", min=0.0),
    Option("osd_deep_scrub_interval", float, 7 * 86400.0, LEVEL_ADVANCED,
           "seconds between scheduled deep scrubs per PG (reference "
           "osd_deep_scrub_interval)", min=0.0),
    Option("osd_scrub_chunk_max", int, 25, LEVEL_ADVANCED,
           "objects verified per scrub chunk before yielding to client "
           "I/O (reference osd_scrub_chunk_max)", min=1),
    Option("osd_scrub_sleep", float, 0.0, LEVEL_ADVANCED,
           "pause between scrub chunks (reference osd_scrub_sleep)",
           min=0.0),
    Option("osd_erasure_code_plugins", str, "cuda jerasure isa clay shec lrc",
           LEVEL_ADVANCED, "plugins preloaded at osd start"),
    Option("ms_compress_mode", str, "none", LEVEL_ADVANCED,
           "on-wire compression policy (reference ms_osd_compress_mode: "
           "none = never, force = negotiate on every connection)",
           enum=("none", "force")),
    Option("ms_compress_algorithm", str, "zlib", LEVEL_ADVANCED,
           "preferred on-wire compression algorithm (reference "
           "ms_osd_compression_algorithm)"),
    Option("ms_compress_min_size", int, 1024, LEVEL_ADVANCED,
           "smallest message eligible for on-wire compression "
           "(reference ms_osd_compress_min_size)", min=0),
    Option("ms_inject_socket_failures", int, 0, LEVEL_DEV,
           "inject a connection reset every N sent frames (0 = off); "
           "the reference's ms_inject_socket_failures "
           "(src/common/options/global.yaml.in:1242)"),
    Option("osd_ec_encode_farm", str, "auto", LEVEL_ADVANCED,
           "route EC encode/decode matmuls through the process encode "
           "service (ceph_tpu_torch/parallel/encode_service.py) on the "
           "OSD's device: auto = when that device is a card, on = on any "
           "device, off = never",
           enum=("auto", "on", "off")),
    Option("osd_ec_farm_min_bytes", int, 32768, LEVEL_ADVANCED,
           "payloads below this stay on the single-device path even "
           "when the farm is active", min=0),
    Option("osd_recovery_decode_batch", str, "on", LEVEL_ADVANCED,
           "coalesce concurrent recovery decodes sharing an erasure "
           "signature into fixed-shape batched launches "
           "(ceph_tpu/parallel/decode_batcher.py)",
           enum=("on", "off")),
    Option("osd_recovery_decode_batch_window", float, 0.002,
           LEVEL_ADVANCED,
           "coalescing window (s) the decode aggregator waits to "
           "collect concurrent per-object recovery decodes", min=0.0),
    Option("osd_scrub_verify_batch", str, "on", LEVEL_ADVANCED,
           "coalesce concurrent deep-scrub shard verifications (crc32c "
           "+ parity re-encode) across objects and PGs into fixed-shape "
           "batched launches (ceph_tpu/parallel/scrub_batcher.py)",
           enum=("on", "off")),
    Option("osd_scrub_verify_batch_window", float, 0.002,
           LEVEL_ADVANCED,
           "coalescing window (s) the scrub verifier waits to collect "
           "concurrent per-object verification chunks", min=0.0),
    Option("osd_ec_warmup", str, "on", LEVEL_ADVANCED,
           "compile the fixed-bucket batched encode/decode shapes of "
           "each EC profile at map-install time so no kernel build "
           "happens inside the I/O path", enum=("on", "off")),
    Option("osd_max_object_read_errors", int, 3, LEVEL_ADVANCED,
           "distinct objects with local medium errors (checksum-at-rest "
           "EIO) before the osd marks ITSELF failed so peering "
           "re-places its data — the reference's "
           "osd_max_object_read_errors / EIO-suicide escalation "
           "(BlueStore 'osd failure on EIO'); 0 disables escalation",
           min=0),
    Option("osd_read_error_repair", bool, True, LEVEL_ADVANCED,
           "quarantine a shard whose local read returned a medium "
           "error and requeue a background repair so the damage is "
           "rebuilt from the surviving members (the reference's "
           "rep_repair_primary_object read-error repair path)"),
    Option("debug_osd", int, 1, LEVEL_DEV, "osd log verbosity", min=0, max=5),
    Option("debug_mon", int, 1, LEVEL_DEV, "mon log verbosity", min=0, max=5),
    # -- distributed tracing (common/tracing.py + mgr/tracer.py) --------
    Option("trace_sample_rate", float, 1.0, LEVEL_ADVANCED,
           "head-sampling probability for new traces started at this "
           "daemon (the reference's jaeger sampler rate); joined "
           "traces inherit the root's verdict; slow spans export "
           "regardless (tail capture, see trace_tail_slow_s)",
           min=0.0, max=1.0),
    Option("trace_ring_max", int, 2048, LEVEL_ADVANCED,
           "finished spans kept in each daemon's dump_traces ring "
           "(was a hardcoded 2048)", min=16),
    Option("trace_tail_slow_s", float, 1.0, LEVEL_ADVANCED,
           "tail capture: spans slower than this export to the mgr "
           "trace collector even when their trace lost the head-"
           "sampling draw (0 disables tail capture)", min=0.0),
    Option("mgr_trace_max_traces", int, 256, LEVEL_ADVANCED,
           "distinct trace_ids the mgr trace collector keeps "
           "(LRU-evicted)", min=8),
    Option("mgr_trace_slow_history", int, 32, LEVEL_ADVANCED,
           "assembled slow traces kept in the collector's bounded "
           "history (the dump_historic_slow_ops analogue, but "
           "cluster-wide)", min=1),
    Option("mgr_slow_ops_warn_window", float, 30.0, LEVEL_ADVANCED,
           "SLOW_OPS health: a daemon whose slow-op complaint counter "
           "grew within this many seconds keeps the warning raised; "
           "no growth for a full window clears it (the reference's "
           "mon-aggregated SLOW_OPS behavior)", min=0.5),
    Option("osd_scrub_deprioritize_factor", float, 4.0, LEVEL_ADVANCED,
           "slow-OSD-aware scrub scheduling: while the mgr's outlier "
           "detection flags this OSD slow, background scrubs wait "
           "this multiple of the normal interval before scheduling "
           "(1.0 disables the deferral)", min=1.0),
    # -- manager daemon (ceph_tpu/mgr/) --------------------------------
    Option("mgr_beacon_interval", float, 0.5, LEVEL_ADVANCED,
           "seconds between mgr -> mon beacons (reference "
           "mgr_beacon_period; shorter here to match mini-cluster "
           "timescales)", min=0.05),
    Option("mon_mgr_beacon_grace", float, 3.0, LEVEL_ADVANCED,
           "seconds without a beacon before the mon drops a mgr from "
           "the MgrMap and promotes a standby (reference "
           "mon_mgr_beacon_grace; 0 disables the sweep)", min=0.0),
    Option("mgr_report_interval", float, 0.5, LEVEL_ADVANCED,
           "seconds between each daemon's MgrClient MMgrReport sends "
           "(reference mgr_stats_period)", min=0.05),
    Option("mgr_digest_interval", float, 0.5, LEVEL_ADVANCED,
           "seconds between the active mgr's analytics pass + "
           "MMonMgrReport digests back to the mon (reference "
           "mgr_digest_period role)", min=0.05),
    Option("mgr_stats_window", int, 32, LEVEL_ADVANCED,
           "ring-buffer window per (daemon, metric) series in the "
           "mgr's fixed-shape time-series store; part of the "
           "prewarmed analytics shape — changing it at runtime would "
           "mint an in-path kernel build, so it is read at mgr start",
           min=4),
    Option("mgr_stats_max_daemons", int, 16, LEVEL_ADVANCED,
           "daemon slots in the mgr time-series store (LRU-evicted); "
           "part of the prewarmed analytics shape", min=1),
    Option("mgr_stats_max_metrics", int, 16, LEVEL_ADVANCED,
           "metric slots in the mgr time-series store (overflow "
           "metrics are counted + dropped, never resized mid-run); "
           "part of the prewarmed analytics shape", min=1),
    Option("mgr_analytics_backend", str, "cuda", LEVEL_ADVANCED,
           "cluster analytics engine: cuda = one mgr_analytics.cu "
           "launch over the whole (daemons x metrics x window) array "
           "(prewarmed, cold_launches==0 discipline), numpy = host "
           "reference (bit-identical results)", enum=("cuda", "numpy")),
    Option("mgr_module_tick_interval", float, 0.5, LEVEL_ADVANCED,
           "seconds between enabled-module tick() calls on the active "
           "mgr", min=0.05),
    Option("mgr_balancer_interval", float, 2.0, LEVEL_ADVANCED,
           "seconds between automated upmap balancer rounds when the "
           "balancer module is enabled (reference balancer sleep "
           "interval)", min=0.1),
    Option("mgr_devicehealth_warn_errors", int, 1, LEVEL_ADVANCED,
           "verified-damaged-object count at which the devicehealth "
           "module raises a per-device warning (see "
           "osd_max_object_read_errors for the osd's own suicide "
           "threshold)", min=1),
    # -- cluster event plane (common/logclient.py, mon/log_service.py,
    # mgr progress/crash modules) --------------------------------------
    Option("mon_cluster_log_max", int, 512, LEVEL_ADVANCED,
           "cluster-log entries the mon keeps in its paxos-replicated "
           "ring (`ceph log last`; reference mon_log_max / "
           "LogMonitor's bounded log)", min=16),
    Option("mon_health_history_max", int, 128, LEVEL_ADVANCED,
           "health-check transitions (raise/clear) kept in the mon's "
           "replicated history ring (`ceph health history`)", min=8),
    Option("mon_health_tick_interval", float, 0.5, LEVEL_ADVANCED,
           "seconds between the leader's health-transition sweeps "
           "(diffing current checks against the replicated history to "
           "mint raise/clear events; 0 disables)", min=0.0),
    Option("mon_health_mute_ttl_default", float, 0.0, LEVEL_ADVANCED,
           "default seconds a `ceph health mute <code>` lasts when no "
           "ttl is given (0 = until unmuted)", min=0.0),
    Option("log_client_flush_interval", float, 0.25, LEVEL_ADVANCED,
           "seconds between a daemon's LogClient MLog flushes to the "
           "mon (reference LogClient's log_flush cadence)", min=0.05),
    Option("log_client_max_pending", int, 256, LEVEL_ADVANCED,
           "unacked cluster-log entries a daemon buffers before "
           "dropping the oldest (counted; survives mon failover by "
           "resend-until-acked)", min=8),
    Option("log_client_rate", int, 64, LEVEL_ADVANCED,
           "cluster-log entries one daemon may emit per flush "
           "interval; beyond it entries are dropped and counted (the "
           "reference's clog rate limiting role)", min=1),
    Option("log_client_level", int, 1, LEVEL_ADVANCED,
           "minimum severity shipped to the mon cluster log "
           "(0=debug 1=info 2=warn 3=error 4=sec); the daemon-local "
           "tail ring keeps every level for crash dumps", min=0, max=4),
    Option("crash_dir", str, "", LEVEL_ADVANCED,
           "directory daemons persist crash dumps into on unhandled "
           "exit or fault-injector-induced death ('' disables; the "
           "reference's /var/lib/ceph/crash + ceph-crash agent role)"),
    Option("mgr_crash_recent_age", float, 600.0, LEVEL_ADVANCED,
           "an unarchived crash younger than this keeps the "
           "RECENT_CRASH health warning raised (reference "
           "mgr/crash/warn_recent_interval, scaled to mini-cluster "
           "timescales)", min=0.0),
    Option("mgr_progress_complete_grace", float, 2.0, LEVEL_ADVANCED,
           "seconds a completed progress event stays visible in "
           "`ceph progress` before the mgr progress module reaps it",
           min=0.0),
    # -- transfer discipline (ctlint transfer rules + runtime guard,
    # common/transfer_guard.py) ----------------------------------------
    Option("osd_transfer_guard", str, "auto", LEVEL_ADVANCED,
           "runtime host<->device transfer guard around steady-state "
           "batched launches (decode/scrub/encode/analytics): auto = "
           "arm after EC map-install warmup, on = armed immediately, "
           "off = never; violations are counted in "
           "BucketCounters('transfer_guard').host_transfers and "
           "fail the launch (nothing answers from the host)",
           enum=("auto", "on", "off")),
    Option("osd_transfer_guard_window", float, 0.0, LEVEL_ADVANCED,
           "seconds after EC warmup completes before the transfer "
           "guard engages (grace window for straggling lazy "
           "first-use uploads; 0 = immediately)", min=0.0),
    Option("ctlint_transfer_max_depth", int, 6, LEVEL_DEV,
           "interprocedural propagation depth of ctlint's dataflow "
           "engine (summary fixpoint rounds; call chains deeper than "
           "this widen to unknown) — consumed by the analyzer via "
           "CEPH_TPU_CTLINT_TRANSFER_MAX_DEPTH", min=1),
    Option("ctlint_transfer_max_states", int, 4096, LEVEL_DEV,
           "per-function tainted-name cap in ctlint's dataflow "
           "engine (widening valve) — consumed by the analyzer via "
           "CEPH_TPU_CTLINT_TRANSFER_MAX_STATES", min=16),
    # -- async client plane (client/objecter.py) ------------------------
    Option("objecter_inflight_ops", int, 1024, LEVEL_ADVANCED,
           "ops a client keeps in flight before aio submission "
           "backpressures the submitter (the reference "
           "objecter_inflight_ops throttle, src/osdc/Objecter.h)",
           min=1),
    Option("objecter_inflight_op_bytes", int, 100 << 20, LEVEL_ADVANCED,
           "payload bytes a client keeps in flight before aio "
           "submission backpressures (reference "
           "objecter_inflight_op_bytes; an op larger than the whole "
           "budget still runs alone)", min=1),
    Option("objecter_batch_max_ops", int, 64, LEVEL_ADVANCED,
           "ops to the same primary OSD coalesced into one wire burst "
           "(back-to-back frames under a single send-lock hold) by "
           "the objecter's per-OSD writer", min=1),
    # -- mClock tenant classes (osd/opqueue.py) -------------------------
    Option("osd_mclock_client_profiles", str, "", LEVEL_ADVANCED,
           "extra dmclock client classes for tenant-tagged ops "
           "(MOSDOp.qos_class): 'name:weight' or "
           "'name:reservation/weight/limit' entries, comma-separated "
           "(e.g. 'gold:30,bronze:3'); untagged ops ride the built-in "
           "client class, unknown tags inherit its profile"),
    # -- load harness (ceph_tpu/loadgen/) -------------------------------
    Option("loadgen_handles", int, 8, LEVEL_ADVANCED,
           "RadosClient handles the load driver shares among its "
           "simulated clients (each handle is one messenger + mon "
           "session; thousands of logical clients multiplex over "
           "them)", min=1),
    Option("loadgen_latency_tolerance", float, 0.25, LEVEL_ADVANCED,
           "relative tolerance for the client-vs-mgr latency "
           "cross-check: the load report's percentile over its own "
           "interval means must agree with the mgr digest's "
           "percentile of the same ingested series within this "
           "fraction (plus the 1µs ingest quantization)",
           min=0.0),
    Option("loadgen_verify_sample", int, 64, LEVEL_ADVANCED,
           "objects re-read and payload-verified after a load run "
           "(self-describing headers catch corrupt/cross-object "
           "acked writes); 0 disables the sweep", min=0),
)


class ConfigProxy:
    """Per-daemon view of the option set (md_config_t + ConfigProxy)."""

    def __init__(self, overrides: dict[str, Any] | None = None):
        self._values: dict[str, dict[str, Any]] = {}  # name -> source -> val
        self._observers: list[tuple[tuple[str, ...], Callable]] = []
        # env source: CEPH_TPU_<OPTION_IN_CAPS>
        for name, opt in OPTIONS.items():
            env = os.environ.get("CEPH_TPU_" + name.upper())
            if env is not None:
                self._values.setdefault(name, {})["env"] = opt.cast(env)
        for k, v in (overrides or {}).items():
            self.set(k, v, source="cmdline")

    def get(self, name: str) -> Any:
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        layers = self._values.get(name, {})
        for source in reversed(SOURCES):
            if source in layers:
                return layers[source]
        return opt.default

    def __getitem__(self, name: str) -> Any:
        return self.get(name)

    def set(self, name: str, value: Any, source: str = "override") -> None:
        opt = OPTIONS.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name!r}")
        if source not in SOURCES:
            raise ValueError(f"unknown source {source!r}")
        self._values.setdefault(name, {})[source] = opt.cast(value)

    def rm(self, name: str, source: str = "override") -> None:
        self._values.get(name, {}).pop(source, None)

    def load_file(self, kv: dict[str, Any]) -> None:
        """Apply a conf-file dict (the ceph.conf parse result)."""
        for k, v in kv.items():
            self.set(k, v, source="file")

    # -- observers (md_config_obs_t) -----------------------------------

    def add_observer(
        self, keys: tuple[str, ...] | list[str], cb: Callable[[dict], None]
    ) -> None:
        self._observers.append((tuple(keys), cb))

    def apply_changes(self, changed: dict[str, Any], source: str = "override") -> None:
        """Set + notify observers watching any changed key — the
        reference's apply_changes/live-update path (e.g. the mClock
        scheduler re-reading its knobs)."""
        for k, v in changed.items():
            self.set(k, v, source=source)
        names = set(changed)
        for keys, cb in self._observers:
            hit = names & set(keys)
            if hit:
                cb({k: self.get(k) for k in hit})

    def show(self, level: str | None = None) -> dict[str, Any]:
        """`config show`: effective values (optionally one level)."""
        return {
            name: self.get(name)
            for name, opt in sorted(OPTIONS.items())
            if level is None or opt.level == level
        }

"""Chaos runner: replay a generated schedule against a live cluster.

The teuthology-thrasher role (qa/tasks/thrasher.py do_thrash loop),
inverted for determinism: the schedule is generated up front
(ceph_tpu/chaos/schedule.py), the runner boots a mini-cluster, starts
the recording workload, applies each event at its virtual time, then
settles the cluster and judges every durability invariant
(ceph_tpu/chaos/invariants.py):

1. workload history clean (no lost/stale/corrupt read),
2. final + snap reads return the acked content,
3. cluster converges back to active+clean within the bound,
4. every monitor agrees on one leader and one map epoch,
5. post-thrash deep scrub over every PG reports zero inconsistencies,
6. (disk-fault scenarios) every store's at-rest fsck sweep is clean —
   injected rot was healed or its OSD re-placed,
7. the decode/scrub batchers minted ZERO cold launches — chaos
   must exercise the prewarmed recovery path, not warm up mid-flight.

Every applied event opens a ``chaos`` tracer span and counts into the
``chaos`` perf collection (dumped by the daemons' ``dump_chaos``
admin-socket command).

Counterpart of ``ceph_tpu/chaos/runner.py`` with the same scenarios,
traces and verdicts.  Where the port differs, on purpose:

- ``ChaosCluster(scenario, time_scale, device=None)``,
  :func:`run_scenario`, :func:`run_trace` and :func:`run_sweep` take the
  device every daemon runs on (its EC plugins, batchers, encode service
  and analytics): the card unless the caller passes ``device="cpu"``;
- EC pools use the ``cuda`` plugin (the reference's ``jax``), with the
  same ``k``, ``m`` and failure domain;
- :func:`_cold_launch_snapshot` reads the batchers of the device it is
  given (``shared(device)`` holds one a process);
- a run record also keeps ``cold_launch_deltas`` and the
  ``guard_windows`` the run opened.
"""

from __future__ import annotations

import asyncio
import logging
import time

from ceph_tpu_torch.chaos import chaos_counters, chaos_tracer
from ceph_tpu_torch.chaos.netem import Netem
from ceph_tpu_torch.chaos.schedule import generate_schedule, trace_hash
from ceph_tpu_torch.chaos.workload import Workload
from ceph_tpu_torch.chaos import invariants as inv

log = logging.getLogger("ceph_tpu_torch.chaos")


#: built-in scenario configs (the qa/suites role).  Each is a plain
#: dict so CLI users can ship their own as JSON.
SCENARIOS: dict[str, dict] = {
    # the classic OSDThrasher: kill/revive, out/in, reweight, repair
    # and balancer runs against replicated + EC pools.  A mgr rides
    # along so the EVENT-PLANE invariant (check_events) can watch
    # progress events open/complete/reap and crash dumps land for
    # every injected kill.  (n_mgrs/watch_events/conf do not feed the
    # schedule generator's draws — trace hashes are unchanged.)
    "osd_thrash": {
        "name": "osd_thrash",
        "n_osds": 5, "n_mons": 1, "n_mgrs": 1,
        "watch_events": True,
        "duration": 3.0, "n_events": 9,
        "mix": {"osd_kill": 3.0, "osd_out": 2.0, "reweight": 1.0,
                "scrub": 0.5, "repair": 0.5, "balance": 0.5},
        "conf": {
            # fast mgr cadences so short degraded windows are observed
            "mgr_report_interval": 0.2, "mgr_digest_interval": 0.2,
            "mgr_module_tick_interval": 0.15,
            "mgr_progress_complete_grace": 1.0,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1, "snaps": True},
        ],
        "workload": {"objects": 3, "rounds": 3, "object_size": 8192},
    },
    # deterministic network faults: partitions, one-way drops, delay,
    # bounded reordering — the netem shim's beat
    "netem_storm": {
        "name": "netem_storm",
        "n_osds": 4, "n_mons": 1,
        "duration": 3.0, "n_events": 10,
        "mix": {"partition": 2.0, "drop_oneway": 2.0, "delay": 2.0,
                "reorder": 2.0, "netem_clear": 0.5},
        "max_partitions": 1,
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1, "snaps": True},
        ],
        "workload": {"objects": 3, "rounds": 3, "object_size": 8192},
    },
    # disk-fault chaos: the store layer lies — one-shot EIOs, at-rest
    # bit flips, torn commits and a sticky-dead disk, against OSDs on
    # REAL BlockStore devices (checksum-at-rest + BlueFS-lite), so
    # injected rot surfaces exactly as production media errors do.
    # Exercises EIO-as-erasure decode-around, replicated read
    # failover, the read-error ledger's self-markdown escalation, and
    # quarantine + background repair; self_heal runs a repair sweep
    # before the deep-scrub verdict and fsck proves the platters are
    # clean at rest.
    "disk-fault": {
        "name": "disk-fault",
        "n_osds": 5, "n_mons": 1, "n_mgrs": 1,
        "watch_events": True,
        # ledger damage outlives the run on surviving daemons: the
        # devicehealth warning at settle is EXPECTED, not debris
        "settle_allowed_health": ["DEVICE_HEALTH"],
        "store": "blockstore",
        "self_heal": True,
        "duration": 3.0, "n_events": 10,
        "mix": {"eio": 2.5, "bitflip": 2.0, "torn_write": 1.5,
                "disk_dead": 0.5, "osd_kill": 0.5,
                "deep_scrub": 0.5, "repair": 0.5},
        "max_dead": 1,
        "conf": {
            "mgr_report_interval": 0.2, "mgr_digest_interval": 0.2,
            "mgr_module_tick_interval": 0.15,
            "mgr_progress_complete_grace": 1.0,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        "workload": {"objects": 3, "rounds": 3, "object_size": 8192},
    },
    # mgr-plane chaos: kill/revive manager daemons (active AND
    # standby) under client load.  Invariants: report streams resume
    # after every failover (an active mgr exists, every live OSD
    # re-registers, the digest is fresh), the analytics engine mints
    # zero cold launches, and — because the mgr is never in the
    # data path — the client workload invariants are untouched.
    "mgr-failover": {
        "name": "mgr-failover",
        "n_osds": 4, "n_mons": 1, "n_mgrs": 2,
        "duration": 3.0, "n_events": 8,
        "mix": {"mgr_kill": 3.0, "osd_kill": 1.0, "scrub": 0.5,
                "balance": 0.5},
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        "workload": {"objects": 3, "rounds": 3, "object_size": 8192},
    },
    # degraded-disk chaos: one OSD's store goes SLOW (sticky injected
    # commit latency — the disk still answers, late), under client
    # load with a live mgr.  The detection/feedback chain under test:
    # slow commits -> op-tracker complaints -> SLOW_OPS health warning
    # (mgr digest -> `ceph health`); slow subop_w latency -> mgr
    # analytics outlier detection -> MMgrConfigure scrub_deprioritize
    # -> the victim's scrub scheduler defers background scrubs.  The
    # slow_osd invariant requires all of it observed AND the warning
    # CLEARED after the disk heals (the ROADMAP item-(e) loop).
    "degraded-disk": {
        "name": "degraded-disk",
        "n_osds": 5, "n_mons": 1, "n_mgrs": 1,
        "duration": 6.0, "n_events": 6,
        "slow_disk_at": 0.3, "slow_disk_delay": 0.5,
        "watch_slow_osd": True,
        "mix": {"scrub": 1.0, "deep_scrub": 0.5, "reweight": 0.5},
        "conf": {
            # complaint threshold under the injected delay so slow
            # writes COUNT, and short windows so raise/clear both fit
            # the run
            "osd_op_complaint_time": 0.25,
            "mgr_slow_ops_warn_window": 3.0,
            # frequent background scrubs so the deprioritization has
            # scheduling decisions to defer inside the run
            "osd_scrub_interval": 1.0,
            "osd_deep_scrub_interval": 3600.0,
            "osd_scrub_deprioritize_factor": 8.0,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        # paced writers (write_gap) so the write stream SPANS the
        # slow window: complaints and latency samples must keep
        # flowing while the mgr's report/analytics/digest pipeline
        # observes the slow disk
        "workload": {"objects": 4, "rounds": 6, "object_size": 8192,
                     "write_gap": 0.7},
    },
    # client-plane netem: the async objecter (PR 10: per-op deadline/
    # backoff/map-wait drivers, coalesced bursts, bounded windows)
    # joins the blast radius for the first time — the workload client's
    # messenger wears the shim, and the schedule cuts/drops/delays
    # CLIENT<->OSD links (mon links stay up: the command plane is the
    # observer).  One early client partition is pinned per trace
    # (client_partition_at) so the ack oracle always has a partition
    # that verifiably fired; drops run in BOTH directions — vanished
    # requests drive the deadline/backoff beat, vanished ACKS of
    # applied writes drive resend-dedup-by-reqid.  check_client_netem
    # + the history/final-read oracles judge it: a partitioned client
    # may see ETIMEDOUT or resend-duplicates, never a lost or
    # rolled-back acked write.
    "client-netem": {
        "name": "client-netem",
        "n_osds": 4, "n_mons": 1,
        "client_netem": True,
        "client_partition_at": 0.3,
        "duration": 4.0, "n_events": 10,
        "max_client_cuts": 1,
        "mix": {"client_partition": 2.5, "client_drop": 2.0,
                "client_delay": 1.5, "osd_kill": 0.5, "scrub": 0.5},
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1, "snaps": True},
        ],
        # paced writers so the write stream SPANS the cut windows —
        # acks must be earned through partitions, not before them
        "workload": {"objects": 3, "rounds": 4, "object_size": 8192,
                     "write_gap": 0.3},
    },
    # fullness-pressure: small-capacity BlockStore OSDs driven up the
    # whole gating ladder WHILE recovery runs.  The scripted skeleton
    # (schedule.py fullness_script) fills to nearfull, then
    # backfillfull, THEN outs an osd so the triggered backfill meets
    # REJECT_TOOFULL live (recovery.py backfillfull gate), then fills
    # to full (client writes must bounce ENOSPC against the map's
    # FULL bit), then drains.  The ratios are widened via conf so the
    # ladder is robust to CRUSH imbalance on tiny stores — the
    # SEMANTICS under test (statfs -> mon bits -> health/gating ->
    # heal) are ratio-independent.  check_fullness demands every rung
    # observed, the failsafe never breached, and the ladder CLEARED.
    "fullness-pressure": {
        "name": "fullness-pressure",
        "n_osds": 5, "n_mons": 1,
        "store": "blockstore",
        "capacity_bytes": 4 << 20,
        "ballast_size": 128 * 1024,
        "ballast_pool": "rep",
        "fullness_script": True,
        "nearfull_fill": 0.50, "backfillfull_fill": 0.62,
        "full_fill": 0.82,
        "duration": 3.0, "n_events": 2,
        "mix": {"scrub": 1.0, "deep_scrub": 1.0},
        "conf": {
            "mon_osd_nearfull_ratio": 0.45,
            "mon_osd_backfillfull_ratio": 0.55,
            "mon_osd_full_ratio": 0.80,
            "osd_beacon_report_interval": 0.2,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 8,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        "workload": {"objects": 2, "rounds": 2, "object_size": 8192},
    },
    # chaos x loadgen composition: a deterministic LOAD trace
    # (ceph_tpu/loadgen) replayed THROUGH a thrash trace in one run —
    # production is both at once.  The load harness attaches to the
    # chaos cluster in external mode (rados/ec planes), streams its
    # telemetry to the chaos mgr, and its full gate set — the
    # self-verifying payload sweep, per-tenant qos_* fairness
    # counters, SLO percentiles, client-vs-mgr cross-check,
    # cold_launches == 0 and host_transfers == 0 — is judged TOGETHER
    # with the chaos invariants (check_load + converged/quorum/scrub).
    "compose_load": {
        "name": "compose_load",
        "n_osds": 4, "n_mons": 1, "n_mgrs": 1,
        "duration": 4.0, "n_events": 8,
        "mix": {"osd_kill": 2.0, "osd_out": 1.0, "delay": 1.5,
                "reorder": 1.0, "scrub": 0.5, "balance": 0.5},
        "load_profile": {"profile": "compose_smoke"},
        "conf": {
            "mgr_report_interval": 0.25, "mgr_digest_interval": 0.25,
            "mgr_stats_max_metrics": 24,
            "osd_mclock_client_profiles": "gold:20.0,bronze:2.0",
        },
        # the harness's own pools, pre-created here so the thrash
        # events (scrub/repair/balance) target what the load hits
        "pools": [
            {"name": "lg-rep", "type": "replicated", "pg_num": 8,
             "size": 2},
            {"name": "lg-ec", "type": "erasure", "pg_num": 4,
             "k": 2, "m": 1},
        ],
    },
    # monitor-plane chaos: restarts + osd kills over a 3-mon quorum,
    # plus pg_num splitting mid-storm
    "quorum_thrash": {
        "name": "quorum_thrash",
        "n_osds": 4, "n_mons": 3,
        "duration": 3.0, "n_events": 8,
        "mix": {"mon_restart": 2.0, "osd_kill": 1.0, "pg_split": 1.0,
                "scrub": 0.5, "balance": 0.5},
        "max_splits": 1,
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 2,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        "workload": {"objects": 3, "rounds": 3, "object_size": 8192},
    },
    # rack-scale correlated failure: a real CRUSH topology (4 racks x
    # 1 host x 2 osds) with rack failure-domain rules on BOTH pool
    # types — the replicated pool rides the pre-registered
    # chaos_rack_rule, the EC pool's profile carries
    # crush-failure-domain=rack — and the scripted skeleton kills a
    # WHOLE rack at once, dwells, revives, then kills one host in a
    # different rack.  check_domains proves (pre-kill) that CRUSH put
    # at most one shard of any PG in any rack and that every PG
    # retained >= k shards / >= 1 replica through whole-rack loss;
    # the history/final-read oracles prove every acked write survived.
    "rack-loss": {
        "name": "rack-loss",
        "n_osds": 8, "n_mons": 1, "n_mgrs": 1,
        "watch_events": True,
        "topology": {"racks": 4, "hosts_per_rack": 1,
                     "osds_per_host": 2},
        "rack_script": True,
        "host_kill_after": True,
        "rack_dwell": 1.6,
        "duration": 5.0, "n_events": 5,
        "mix": {"scrub": 1.0, "deep_scrub": 0.5, "delay": 0.5},
        "conf": {
            "mgr_report_interval": 0.2, "mgr_digest_interval": 0.2,
            "mgr_module_tick_interval": 0.15,
            "mgr_progress_complete_grace": 1.0,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 3, "failure_domain": "rack", "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1, "failure_domain": "rack"},
        ],
        # paced writers so acks are earned THROUGH the rack outage,
        # not banked before it
        "workload": {"objects": 3, "rounds": 6, "object_size": 8192,
                     "write_gap": 0.5},
    },
    # control-plane blast radius: mon/mgr/mds links wear netem rules
    # (delay/partition/drop toward the osd plane) while the data-plane
    # workload runs.  The scripted skeleton guarantees one beat per
    # plane; the mix draws more.  The oracle: the data plane is
    # UNTOUCHED (history/final reads clean), the cluster converges,
    # and mgr report streams resume.
    "control-net": {
        "name": "control-net",
        "n_osds": 4, "n_mons": 3, "n_mgrs": 1,
        "control_netem": True,
        "duration": 4.0, "n_events": 8,
        "mix": {"mon_netem": 2.0, "mgr_netem": 1.5, "mds_netem": 0.5,
                "osd_kill": 0.5, "scrub": 0.5},
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 4,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        "workload": {"objects": 3, "rounds": 4, "object_size": 8192,
                     "write_gap": 0.3},
    },
    # long-soak log-trim chaos: aggressive osd_min/max_pg_log_entries
    # keep every pg log tiny while paced writers churn well past the
    # trim horizon during a LONG scripted outage — so the revived
    # member genuinely predates every surviving log tail and recovery
    # MUST take the backfill path (not the log delta).  A second kill
    # then lands while that backfill runs (osd_recovery_sleep paces
    # the pass so the interrupt verifiably catches it mid-transfer);
    # check_backfill demands the backfill_started/backfill_completed
    # counter pair prove backfill ran, was interrupted, and still
    # converged — with zero lost/stale reads and cold_launches == 0.
    "soak-trim-backfill": {
        "name": "soak-trim-backfill",
        "n_osds": 5, "n_mons": 1, "n_mgrs": 1,
        "watch_events": True,
        "soak_script": True,
        "soak_interrupt": "target",
        "soak_outage": 5.0,
        "duration": 10.0, "n_events": 4,
        "mix": {"scrub": 1.0, "deep_scrub": 0.5},
        "conf": {
            "osd_min_pg_log_entries": 8,
            "osd_max_pg_log_entries": 16,
            # serialize reconciles and pace each one: pushes then land
            # every 0.3s across the pass, so the gated interrupt kill
            # reliably strikes BETWEEN pushes and fails the remainder
            # (max_active 4 would finish every push in the first few
            # ms and leave only sleeps for the kill to hit)
            "osd_recovery_sleep": 0.3,
            "osd_recovery_max_active": 1,
            "mgr_report_interval": 0.2, "mgr_digest_interval": 0.2,
            "mgr_module_tick_interval": 0.15,
            "mgr_progress_complete_grace": 1.0,
        },
        "pools": [
            {"name": "rep", "type": "replicated", "pg_num": 2,
             "size": 2, "snaps": True},
            {"name": "ec", "type": "erasure", "pg_num": 2,
             "k": 2, "m": 1},
        ],
        # many paced writers: the stream must SPAN the whole outage so
        # the trim horizon provably passes the down member's log
        "workload": {"objects": 8, "rounds": 24, "object_size": 4096,
                     "write_gap": 0.33},
    },
    # cache-tier chaos: a replicated writeback tier over an EC base
    # pool (osd tier add / cache-mode / set-overlay), with the trace
    # driving the PrimaryLogPG tier machinery live — CACHE_FLUSH and
    # CACHE_EVICT against the hot pool, promote-on-miss reads via the
    # base — while paced writers keep minting new dirty versions
    # through the overlay.  The oracle is the interleave-fuzz one
    # (tests/test_interleave_fuzz.py): last-write-wins must hold
    # through every redirect/flush/evict/promote interleaving, so the
    # versioned history/final-read checks judge it with no new
    # invariant.  Evicting a dirty object is EBUSY and a flush racing
    # a promote may bounce — refused events are chaos, recorded in
    # event_errors, never violations.
    "cache-tier": {
        "name": "cache-tier",
        "n_osds": 5, "n_mons": 1,
        "duration": 4.0, "n_events": 10,
        "tier": {"base": "base", "hot": "hot", "mode": "writeback"},
        "mix": {"tier_flush": 2.0, "tier_evict": 2.0,
                "tier_promote": 2.0, "osd_kill": 1.0, "scrub": 0.5,
                "delay": 0.5},
        "pools": [
            {"name": "base", "type": "erasure", "pg_num": 4,
             "k": 2, "m": 1},
            # the hot pool is the tier, not a workload target: the
            # workload reaches it THROUGH the base pool's overlay
            {"name": "hot", "type": "replicated", "pg_num": 4,
             "size": 2, "workload": False},
        ],
        # paced writers so flush/evict/promote events interleave a
        # LIVE dirty stream, not a settled corpus
        "workload": {"objects": 3, "rounds": 4, "object_size": 8192,
                     "write_gap": 0.3},
    },
}


def _cold_launch_snapshot(device) -> dict:
    """cold_launches on the process-wide batchers of ``device`` (the
    cluster's: ``shared()`` holds one batcher a process and raises when
    asked for another device, so the caller names it; delta-checked:
    the collections are process-global and other work may have warmed
    them before this run).  The mgr analytics engine follows the same
    discipline — its prewarm at mgr start cancels the counter, so any
    growth here is a first launch on the digest path."""
    from ceph_tpu_torch.common.metrics import get_perf_counters
    from ceph_tpu_torch.common.transfer_guard import snapshot as tg_snapshot
    from ceph_tpu_torch.parallel import decode_batcher, scrub_batcher

    return {
        "decode_batch": int(
            decode_batcher.shared(device).stats.get("cold_launches", 0)),
        "scrub_verify_batch": int(
            scrub_batcher.shared(device).stats.get("cold_launches", 0)),
        "mgr_analytics": int(get_perf_counters(
            "mgr_analytics").dump().get("cold_launches", 0)),
        # the transfer guard's violation counter rides the same
        # delta-checked snapshot: chaos that provokes an implicit
        # host<->device transfer inside a guarded steady-state launch
        # fails exactly like an in-path cold launch would
        "transfer_guard_host_transfers": tg_snapshot()["host_transfers"],
    }


class ChaosCluster:
    """Mini-cluster under chaos: mons + OSDs + recording client, every
    messenger wearing one shared netem shim."""

    def __init__(self, scenario: dict, time_scale: float = 1.0,
                 device=None):
        from ceph_tpu_torch.ops.rs_kernels import resolve_device

        self.scenario = scenario
        self.time_scale = time_scale
        #: every daemon of the run (its EC plugins, batchers, encode
        #: service and analytics) runs here: the card unless the
        #: caller passes ``device="cpu"``
        self.device = resolve_device(device)
        self.netem = Netem()
        self.mons: list = []
        self.monmap: list[tuple[str, int]] = []
        self.osds: list = []
        self.mgrs: list = []
        self.client = None
        self._crush_template = None
        self._heal_tasks: set = set()
        self.event_errors: list[dict] = []
        self.events_applied = 0
        self._store_dir: str | None = None
        self._stores: dict[int, object] = {}  # osd id -> mounted store
        # entity -> injected-death count (kills + self-escalations);
        # the check_events invariant demands a crash dump for each
        self.deaths: dict[str, int] = {}
        # composed-mode load harness (run_scenario sets it; teardown
        # must stop it before the daemons go away)
        self.load_harness = None
        # fullness-pressure state: ballast object names written by
        # fill events (drain deletes them) + the watcher/fill
        # observation record check_fullness judges
        self._ballast_names: list[str] = []
        # failure-domain placement snapshots: one record per
        # rack/host kill, taken BEFORE the kill lands (check_domains
        # judges that CRUSH separated shards across domains while the
        # doomed rack was still up, and that every PG retained enough
        # shards to survive whole-rack loss)
        self.domains_obs: list[dict] = []
        # seconds that gated events were held past their trace time;
        # the event loop delays every later event by as much
        self.delivery_lag = 0.0
        # osd id -> (primary daemon, pass key) of the backfill pass a
        # gated kill of that osd interrupted; its revive waits for it
        self._interrupted_passes: dict[int, tuple] = {}
        self.fullness: dict = {
            "nearfull_raised": False, "backfillfull_raised": False,
            "full_raised": False, "enospc_bounced": False,
            "backfill_rejects": 0.0, "failsafe_peak": 0.0,
            "ladder_cleared": False,
        }
        import tempfile

        # run-scoped crash_dir: every daemon persists dumps here and
        # the mgr crash module collects them (`ceph crash ls`)
        self.crash_dir = tempfile.mkdtemp(prefix="chaos-crash-")

    def _conf(self):
        """Per-daemon ConfigProxy carrying the scenario's overrides +
        the run-scoped crash_dir (fresh per daemon: config observers
        must not cross daemons)."""
        from ceph_tpu_torch.common import ConfigProxy

        overrides = dict(self.scenario.get("conf") or {})
        overrides.setdefault("crash_dir", self.crash_dir)
        return ConfigProxy(overrides)

    def _note_death(self, entity: str) -> None:
        self.deaths[entity] = self.deaths.get(entity, 0) + 1

    def _make_store(self, osd_id: int):
        """Per-scenario store engine: 'blockstore' puts each OSD on a
        real BlockStore device (checksum-at-rest + BlueFS-lite KV) in
        a run-scoped tempdir — the disk-fault scenario needs a store
        whose bit rot surfaces as EIO, like production media."""
        if self.scenario.get("store") != "blockstore":
            return None
        import os
        import tempfile

        from ceph_tpu_torch.store.blockstore import BlockStore

        if self._store_dir is None:
            self._store_dir = tempfile.mkdtemp(prefix="chaos-disk-")
        store = BlockStore(
            os.path.join(self._store_dir, f"osd{osd_id}"),
            capacity_bytes=int(
                self.scenario.get("capacity_bytes", 1 << 40)))
        store.mount()
        self._stores[osd_id] = store
        return store

    # -- lifecycle -----------------------------------------------------

    async def start(self) -> None:
        from ceph_tpu_torch.client import RadosClient
        from ceph_tpu_torch.crush import builder as B
        from ceph_tpu_torch.crush.types import CrushMap
        from ceph_tpu_torch.mon import Monitor
        from ceph_tpu_torch.osd.daemon import OSDDaemon

        sc = self.scenario
        crush = CrushMap()
        topo = sc.get("topology")
        if topo:
            # rack-scale failure domains: root -> rack -> host -> osd,
            # with a pre-registered rack-separated replicated rule the
            # mon's pool-create honors by name (EC pools get their
            # failure domain through the profile's
            # crush-failure-domain key instead)
            per_host = int(topo.get("osds_per_host", 1))
            hosts_per_rack = int(topo.get("hosts_per_rack", 1))
            n_racks = int(topo["racks"])
            if n_racks * hosts_per_rack * per_host != sc["n_osds"]:
                raise ValueError(
                    f"topology {topo} does not cover n_osds="
                    f"{sc['n_osds']}")
            root = B.build_rack_hierarchy(
                crush, osds_per_host=per_host,
                hosts_per_rack=hosts_per_rack, n_racks=n_racks)
            rid = B.add_simple_rule(
                crush, root.id, crush.type_id(
                    topo.get("failure_domain", "rack")))
            crush.rule_names["chaos_rack_rule"] = rid
        else:
            B.build_hierarchy(
                crush, osds_per_host=1, n_hosts=sc["n_osds"])
        self._crush_template = crush
        n_mons = sc.get("n_mons", 1)
        self.mons = [
            Monitor(crush=crush.copy(), rank=r, n_mons=n_mons,
                    conf=self._conf(), device=self.device)
            for r in range(n_mons)
        ]
        for m in self.mons:
            self.netem.attach(m.messenger)
            await m.start()
        self.monmap = [m.addr for m in self.mons]
        if n_mons > 1:
            for m in self.mons:
                await m.open_quorum(list(self.monmap))
            for m in self.mons:
                await m.wait_stable()
        self.mgrs = []
        if sc.get("n_mgrs"):
            from ceph_tpu_torch.mgr.daemon import MgrDaemon

            for i in range(sc["n_mgrs"]):
                mgr = MgrDaemon(self._mgr_name(i), list(self.monmap),
                                conf=self._conf(), device=self.device)
                self.netem.attach(mgr.messenger)
                await mgr.start()
                self.mgrs.append(mgr)
        self.osds = []
        for i in range(sc["n_osds"]):
            osd = OSDDaemon(i, list(self.monmap),
                            store=self._make_store(i), conf=self._conf(),
                            device=self.device)
            self.netem.attach(osd.messenger)
            await osd.start()
            self.osds.append(osd)
        self.client = RadosClient(client_id=8080)
        # the workload's acks are the oracle.  Classically the client
        # stays OUTSIDE the blast radius; client-netem scenarios flip
        # that — the client messenger wears the shim too, and the
        # schedule's client_* verbs cut its OSD links (never its mon
        # links: the command plane stays the observer)
        if sc.get("client_netem"):
            self.netem.attach(self.client.messenger)
        await self.client.connect_multi(list(self.monmap))
        for pool in sc.get("pools", []):
            if pool.get("type") == "erasure":
                prof = f"chaos-{pool['name']}"
                profile = {
                    "plugin": "cuda", "k": str(pool.get("k", 2)),
                    "m": str(pool.get("m", 1)),
                }
                if pool.get("failure_domain"):
                    # the profile drives create_ec_rule: one shard
                    # per rack/host, the rack-loss scenario's proof
                    profile["crush-failure-domain"] = (
                        pool["failure_domain"])
                await self.client.ec_profile_set(prof, profile)
                await self.client.pool_create(
                    pool["name"], pg_num=pool.get("pg_num", 2),
                    pool_type="erasure", erasure_code_profile=prof)
            elif pool.get("failure_domain"):
                # replicated pools ride the pre-registered rack rule
                await self.client.pool_create(
                    pool["name"], pg_num=pool.get("pg_num", 4),
                    size=pool.get("size", 2), rule="chaos_rack_rule")
            else:
                await self.client.pool_create(
                    pool["name"], pg_num=pool.get("pg_num", 4),
                    size=pool.get("size", 2))
        tier = sc.get("tier")
        if tier:
            # writeback cache tier: hot over base, overlay on — the
            # same mon verbs operators run (OSDMonitor tier commands)
            for cmd in (
                {"prefix": "osd tier add", "pool": tier["base"],
                 "tierpool": tier["hot"]},
                {"prefix": "osd tier cache-mode", "pool": tier["hot"],
                 "mode": tier.get("mode", "writeback")},
                {"prefix": "osd tier set-overlay",
                 "pool": tier["base"], "tierpool": tier["hot"]},
            ):
                code, rs, _ = await self.client.command(cmd)
                if code != 0:
                    raise RuntimeError(f"tier setup {cmd} -> {rs}")
            if tier.get("target_max_bytes"):
                await self.client.command({
                    "prefix": "osd pool set", "pool": tier["hot"],
                    "var": "target_max_bytes",
                    "val": str(tier["target_max_bytes"])})
            # the overlay must be IN the client's map before the
            # workload writes, or early writes skip the tier
            await self.client._wait_new_map(
                self.client.osdmap.epoch - 1, timeout=10)
        await self._await_warmup()

    async def _await_warmup(self, timeout: float = 30.0) -> None:
        """Wait for every daemon's EC-profile warmup to finish: the
        cold_launches==0 invariant judges the steady state, and a kill
        landing mid-warmup would blame chaos for a boot-time cold
        launch."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if all(not osd._warm_tasks for osd in self.osds if osd) \
                    and all(m._warm_task is None or m._warm_task.done()
                            for m in self.mgrs if m):
                return
            await asyncio.sleep(0.05)

    async def stop(self) -> None:
        from ceph_tpu_torch.common.fault_injector import FAULTS

        # disarm every store fault before teardown: umount/checkpoint
        # must not trip a leftover injection, and the next seed's run
        # must start clean (points are process-global)
        FAULTS.clear()
        for t in list(self._heal_tasks):
            t.cancel()
        if self.client is not None:
            await self.client.shutdown()
        for osd in self.osds:
            if osd is not None:
                await osd.stop()
        for g in self.mgrs:
            if g is not None:
                await g.stop()
        for m in self.mons:
            if m is not None:
                await m.stop()
        for store in self._stores.values():
            try:
                store.umount()
            except OSError:
                log.exception("chaos: store umount failed")
        import shutil

        if self._store_dir is not None:
            shutil.rmtree(self._store_dir, ignore_errors=True)
        shutil.rmtree(self.crash_dir, ignore_errors=True)

    # -- event application ---------------------------------------------

    async def apply_event(self, ev) -> None:
        counters = chaos_counters()
        counters.inc("events", kind=ev.kind)
        with chaos_tracer().span(
            "chaos_event", kind=ev.kind, t=ev.t,
            **{k: str(v) for k, v in ev.args.items()},
        ) as sp:
            try:
                await self._apply(ev)
                self.events_applied += 1
            except Exception as e:
                # a refused event (no primary mid-thrash, EAGAIN storm)
                # is part of chaos, not a failure of the harness — but
                # it is recorded and counted
                sp.tag(error=type(e).__name__)
                counters.inc("event_errors", kind=ev.kind)
                self.event_errors.append({
                    "kind": ev.kind, "args": dict(ev.args),
                    "error": f"{type(e).__name__}: {e}",
                })

    async def _kill_osd(self, osd_id: int) -> None:
        osd = self.osds[osd_id]
        if osd is not None:
            # an injected kill IS an unclean death: the daemon
            # persists a crash dump the way a SIGKILL'd reference
            # daemon leaves one for ceph-crash to post
            if not osd.stopping:
                osd.record_crash(
                    reason="chaos: injected daemon kill")
                self._note_death(f"osd.{osd_id}")
            # keep the store: revive is a daemon restart (the
            # reference thrasher's revive keeps the disk too).
            # Wiping here would let TWO sequential kills destroy
            # more shards than m — the second kill lands before the
            # first revive's rebuild finishes, and that is operator
            # data loss, not a cluster bug
            self._stashed_stores = getattr(self, "_stashed_stores", {})
            self._stashed_stores[osd_id] = osd.store
            await osd.stop()
            self.osds[osd_id] = None

    async def _revive_osd(self, osd_id: int) -> None:
        cur = self.osds[osd_id]
        if cur is not None and cur.stopping:
            # the daemon died on its own (read-error-ledger disk
            # escalation — its _escalate path already wrote the
            # crash dump): stash its store and treat it as killed
            # so the revive below restarts it
            self._note_death(f"osd.{osd_id}")
            self._stashed_stores = getattr(self, "_stashed_stores", {})
            self._stashed_stores[osd_id] = cur.store
            self.osds[osd_id] = None
        if self.osds[osd_id] is None:
            from ceph_tpu_torch.osd.daemon import OSDDaemon

            store = getattr(self, "_stashed_stores", {}).pop(
                osd_id, None)
            osd = OSDDaemon(osd_id, list(self.monmap), store=store,
                            conf=self._conf(), device=self.device)
            self.netem.attach(osd.messenger)
            await osd.start()
            self.osds[osd_id] = osd
            # missed-write catch-up recovery (log replay / decode
            # toward the restarted member) runs from the new map;
            # data-LOSS rebuilds are exercised by osd_out remaps
            # (backfill + EC decode onto fresh members)

    async def _apply(self, ev) -> None:
        a = ev.args
        kind = ev.kind
        if kind == "osd_kill":
            if a.get("await_backfill"):
                await self._await_backfill_inflight(a["osd"])
            await self._kill_osd(a["osd"])
        elif kind == "osd_revive":
            await self._await_interrupted_pass(a["osd"])
            await self._revive_osd(a["osd"])
        elif kind in ("rack_kill", "host_kill"):
            # correlated loss: every member of one failure domain dies
            # in the same beat.  check_domains snapshots the acting
            # sets FIRST — the proof CRUSH separated shards across
            # domains must predate the kill it survives
            if self.scenario.get("topology"):
                self.domains_obs.append(self._domains_snapshot(
                    killed=list(a["osds"]), kind=kind))
            for o in a["osds"]:
                await self._kill_osd(o)
        elif kind == "rack_revive":
            for o in a["osds"]:
                await self._revive_osd(o)
        elif kind in ("mon_netem", "mgr_netem", "mds_netem"):
            ent = {
                "mon_netem": ("mon", a.get("rank", 0)),
                "mgr_netem": ("mgr", a.get("mgr", 0)),
                "mds_netem": ("mds", a.get("mds", 0)),
            }[kind]
            wild = ("osd", None)
            mode = a.get("mode", "delay")
            if mode == "partition":
                self.netem.partition(ent, wild)
                self._schedule_heal(
                    a.get("ttl"),
                    lambda: self.netem.heal_partition(ent, wild))
            elif mode == "drop":
                self.netem.drop_oneway(wild, ent)
                self._schedule_heal(
                    a.get("ttl"),
                    lambda: self.netem.heal_oneway(wild, ent))
            else:
                # both directions: slow outbound AND inbound links
                links = ((ent, wild), (wild, ent))
                for s_, d_ in links:
                    self.netem.delay(s_, d_, a.get("seconds", 0.02))
                self._schedule_heal(
                    a.get("ttl"),
                    lambda: [self.netem.heal_delay(s_, d_)
                             for s_, d_ in links])
        elif kind == "osd_out":
            await self._command({"prefix": "osd out", "id": str(a["osd"])})
        elif kind == "osd_in":
            await self._command({"prefix": "osd in", "id": str(a["osd"])})
        elif kind == "reweight":
            await self._command({
                "prefix": "osd crush reweight",
                "name": f"osd.{a['osd']}", "weight": str(a["weight"]),
            })
        elif kind == "mon_restart":
            await self._mon_restart(a["rank"])
        elif kind == "pg_split":
            om = self.client.osdmap
            pid = om.lookup_pg_pool_name(a["pool"])
            if pid >= 0:
                cur = om.pools[pid].pg_num
                await self._command({
                    "prefix": "osd pool set", "pool": a["pool"],
                    "var": "pg_num", "val": str(min(cur * 2, 16)),
                })
        elif kind in ("scrub", "deep_scrub", "repair"):
            om = self.client.osdmap
            pid = om.lookup_pg_pool_name(a["pool"])
            if pid >= 0:
                ps = int(ev.t * 1000) % max(1, om.pools[pid].pg_num)
                prefix = {
                    "scrub": "pg scrub", "deep_scrub": "pg deep-scrub",
                    "repair": "pg repair",
                }[kind]
                await self._command({
                    "prefix": prefix, "pgid": f"{pid}.{ps}"})
        elif kind == "balance":
            await self._command({
                "prefix": "osd balance",
                "max_swaps": str(a.get("max_swaps", 8)),
            })
        elif kind == "partition":
            self.netem.partition(tuple(a["a"]), tuple(a["b"]))
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_partition(
                    tuple(a["a"]), tuple(a["b"])))
        elif kind == "heal_partition":
            self.netem.heal_partition(tuple(a["a"]), tuple(a["b"]))
        elif kind == "drop_oneway":
            self.netem.drop_oneway(tuple(a["src"]), tuple(a["dst"]))
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_oneway(
                    tuple(a["src"]), tuple(a["dst"])))
        elif kind == "heal_oneway":
            self.netem.heal_oneway(tuple(a["src"]), tuple(a["dst"]))
        elif kind == "delay":
            self.netem.delay(
                tuple(a["src"]), tuple(a["dst"]), a["seconds"])
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_delay(
                    tuple(a["src"]), tuple(a["dst"])))
        elif kind == "reorder":
            self.netem.reorder(
                tuple(a["src"]), tuple(a["dst"]),
                every=a.get("every", 3), hold=a.get("hold", 0.01))
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_reorder(
                    tuple(a["src"]), tuple(a["dst"])))
        elif kind == "client_partition":
            peer = tuple(a["peer"])
            self.netem.partition(("client", None), peer)
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_partition(
                    ("client", None), peer))
        elif kind == "heal_client_partition":
            self.netem.heal_partition(("client", None), tuple(a["peer"]))
        elif kind == "client_drop":
            src, dst = ("client", None), tuple(a["peer"])
            if a.get("to_client"):
                src, dst = dst, src
            self.netem.drop_oneway(src, dst)
            self._schedule_heal(
                a.get("ttl"),
                lambda: self.netem.heal_oneway(src, dst))
        elif kind == "heal_client_drop":
            src, dst = ("client", None), tuple(a["peer"])
            if a.get("to_client"):
                src, dst = dst, src
            self.netem.heal_oneway(src, dst)
        elif kind == "client_delay":
            # both directions: slow requests out AND slow acks back
            links = ((("client", None), tuple(a["peer"])),
                     (tuple(a["peer"]), ("client", None)))
            for s_, d_ in links:
                self.netem.delay(s_, d_, a["seconds"])
            self._schedule_heal(
                a.get("ttl"),
                lambda: [self.netem.heal_delay(s_, d_)
                         for s_, d_ in links])
        elif kind == "fill":
            await self._apply_fill(a["level"], float(a["ratio"]))
        elif kind == "drain":
            await self._apply_drain()
        elif kind == "netem_clear":
            self.netem.clear()
        elif kind in ("eio", "bitflip", "torn_write", "disk_dead",
                      "slow_disk", "disk_heal"):
            self._apply_disk_fault(kind, a["osd"],
                                   delay=a.get("delay"))
        elif kind == "mgr_kill":
            mgr = self.mgrs[a["mgr"]]
            if mgr is not None:
                mgr.record_crash(reason="chaos: injected mgr kill")
                self._note_death(f"mgr.{mgr.name}")
                await mgr.stop()
                self.mgrs[a["mgr"]] = None
        elif kind in ("tier_flush", "tier_evict", "tier_promote"):
            from ceph_tpu_torch.client.rados import ObjectOperation

            if kind == "tier_promote":
                # a read via the BASE pool: overlay redirect, and if
                # the object was evicted, the promote-on-miss path
                await self.client.ioctx(a["base"]).read(a["oid"])
            else:
                op = ObjectOperation()
                if kind == "tier_flush":
                    op.cache_flush()
                else:
                    # evicting a dirty object is EBUSY by design —
                    # apply_event records the refusal as chaos
                    op.cache_evict()
                await self.client.ioctx(a["hot"]).operate(a["oid"], op)
        elif kind == "mgr_revive":
            if self.mgrs[a["mgr"]] is None:
                from ceph_tpu_torch.mgr.daemon import MgrDaemon

                mgr = MgrDaemon(self._mgr_name(a["mgr"]),
                                list(self.monmap), conf=self._conf(),
                                device=self.device)
                self.netem.attach(mgr.messenger)
                await mgr.start()
                self.mgrs[a["mgr"]] = mgr
        else:
            raise ValueError(f"unknown chaos event kind {kind!r}")

    @staticmethod
    def _mgr_name(i: int) -> str:
        return chr(ord("x") + i)

    #: FAULTS keys a disk-fault event may arm on one osd's store
    _DISK_FAULT_OPS = ("read", "write", "commit", "mount", "latency")

    def _apply_disk_fault(self, kind: str, osd_id: int,
                          delay: float | None = None) -> None:
        """Arm (or clear) store-level FAULTS points for one OSD's
        disk.  One key per (op, osd); a later event on the same osd
        re-arms the key (latest fault wins — a disk does not queue its
        lies)."""
        import errno as _errno

        from ceph_tpu_torch.common.fault_injector import FAULTS

        if kind == "eio":
            FAULTS.inject(
                f"store.read.osd.{osd_id}", error=_errno.EIO, count=1)
        elif kind == "bitflip":
            FAULTS.inject(f"store.read.osd.{osd_id}", bitflip=True, count=1)
        elif kind == "torn_write":
            FAULTS.inject(f"store.write.osd.{osd_id}", torn=True, count=1)
        elif kind == "disk_dead":
            # the dying-disk mode: EVERY read and commit fails until
            # healed; the victim's read-error ledger escalates it to
            # self-markdown and peering re-places its data
            FAULTS.inject(
                f"store.read.osd.{osd_id}", error=_errno.EIO, count=None)
            FAULTS.inject(
                f"store.write.osd.{osd_id}", error=_errno.EIO, count=None)
        elif kind == "slow_disk":
            # a disk that still works but has gone SLOW: sticky async
            # latency on every store commit of this osd (the OSD's
            # _store_latency_gate — an event-loop sleep, so ONE slow
            # disk slows only its own commits in-process)
            FAULTS.inject(
                f"store.latency.osd.{osd_id}",
                delay=float(delay or 0.5), count=None)
        elif kind == "disk_heal":
            for op in self._DISK_FAULT_OPS:
                FAULTS.clear(f"store.{op}.osd.{osd_id}")

    # -- backfill-interrupt machinery -----------------------------------

    async def _await_backfill_inflight(
        self, osd_id: int, timeout: float = 10.0,
    ) -> None:
        """Hold a scripted interrupt kill of ``osd_id`` until a backfill
        pass with that OSD as a member is MID-TRANSFER: some live
        primary lists it in ``backfill_passes`` with at least two
        objects not yet started (the next may start while the daemon
        is still stopping; the one after cannot).  The pass is noted
        so the revive of ``osd_id`` waits for its end
        (``_await_interrupted_pass``): its remaining objects meet the
        member down, so it ends short, whatever other passes hold the
        recovery slots meanwhile.  The cluster-wide started/completed
        counters cannot tell any of this: a pass cut short earlier
        leaves started > completed for good, and a pass that does not
        touch ``osd_id`` completes whatever the kill does.

        This gates DELIVERY of trace events on cluster state — the
        trace itself (times, kinds, args, hash) stays pure in (seed,
        scenario).  Every hold is added to ``delivery_lag``, which
        shifts each later event by as much, so the revive still comes
        no sooner than its scripted dwell after the kill.  On timeout
        the kill proceeds anyway and check_backfill reports the miss
        honestly."""
        loop = asyncio.get_running_loop()
        start = loop.time()
        try:
            while loop.time() < start + timeout:
                for osd in self.osds:
                    if osd is None or osd.stopping:
                        continue
                    for token, p in list(osd.backfill_passes.items()):
                        if osd_id in p["members"] and p["left"] >= 2:
                            self._interrupted_passes[osd_id] = (osd, token)
                            return
                await asyncio.sleep(0.02)
        finally:
            self.delivery_lag += loop.time() - start
        log.warning("await_backfill: no pass with osd.%d in flight after "
                    "%.1fs — killing anyway", osd_id, timeout)

    async def _await_interrupted_pass(
        self, osd_id: int, timeout: float = 10.0,
    ) -> None:
        """Hold the revive of ``osd_id`` until the backfill pass its
        gated kill interrupted has ended (or ``timeout``)."""
        held = self._interrupted_passes.pop(osd_id, None)
        if held is None:
            return
        osd, token = held
        loop = asyncio.get_running_loop()
        start = loop.time()
        try:
            while (token in osd.backfill_passes
                   and loop.time() < start + timeout):
                await asyncio.sleep(0.02)
        finally:
            self.delivery_lag += loop.time() - start

    # -- failure-domain machinery ---------------------------------------

    def _rack_of(self, osd_id: int) -> int:
        """Topology scenarios place osd ids densely: rack r holds
        osds [r*per_rack, (r+1)*per_rack)."""
        topo = self.scenario["topology"]
        per_rack = (int(topo.get("osds_per_host", 1))
                    * int(topo.get("hosts_per_rack", 1)))
        return osd_id // per_rack

    def _domains_snapshot(self, killed: list[int],
                          kind: str = "rack_kill") -> dict:
        """Pre-kill placement evidence for check_domains: for every
        rack-failure-domain pool, how CRUSH spread each PG's acting
        set across racks, and how many shards survive once the doomed
        rack goes dark."""
        from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
        from ceph_tpu_torch.osd.types import pg_t

        om = self.client.osdmap
        killed_racks = sorted({self._rack_of(o) for o in killed})
        rec: dict = {
            "kind": kind, "killed_osds": sorted(killed),
            "killed_racks": killed_racks, "pools": {},
        }
        for pool in self.scenario.get("pools", []):
            if pool.get("failure_domain") != "rack":
                continue
            pid = om.lookup_pg_pool_name(pool["name"])
            if pid < 0:
                continue
            pl = om.pools[pid]
            need = (pool.get("k", 2)
                    if pool.get("type") == "erasure" else 1)
            worst = 0
            min_surviving = None
            for ps in range(pl.pg_num):
                _u, _up, acting, _pri = om.pg_to_up_acting_osds(
                    pg_t(pid, ps), folded=True)
                members = [o for o in acting if o != CRUSH_ITEM_NONE]
                per: dict[int, int] = {}
                for o in members:
                    r = self._rack_of(o)
                    per[r] = per.get(r, 0) + 1
                if per:
                    worst = max(worst, max(per.values()))
                surv = sum(1 for o in members
                           if self._rack_of(o) not in killed_racks)
                min_surviving = (surv if min_surviving is None
                                 else min(min_surviving, surv))
            rec["pools"][pool["name"]] = {
                "type": pool.get("type", "replicated"),
                "pg_num": pl.pg_num,
                "max_shards_per_domain": worst,
                "min_surviving_shards": min_surviving,
                "need": need,
            }
        return rec

    # -- fullness-pressure machinery -----------------------------------

    def _store_ratios(self, in_only: bool = False) -> dict[int, float]:
        """Live used/total per OSD store (dead daemons skipped; the
        scripted ladder never kills).  ``in_only`` restricts to up+in
        members — the set backfill reservations can target."""
        om = self.client.osdmap if self.client else None
        out: dict[int, float] = {}
        for osd in self.osds:
            if osd is None:
                continue
            if in_only and om is not None and (
                not om.is_up(osd.id) or om.is_out(osd.id)
            ):
                continue
            try:
                sf = osd.store.statfs()
            except (OSError, NotImplementedError):
                continue
            total = sf.get("total", 0)
            out[osd.id] = (sf.get("used", 0) / total) if total else 0.0
        return out

    async def _fullness_check_raised(self, check: str,
                                     timeout: float = 12.0) -> bool:
        """Poll `ceph health` until ``check`` appears (statfs beacons
        -> mon full bits -> health is an async chain)."""
        import json as _json

        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            try:
                code, _rs, data = await self.client.command(
                    {"prefix": "health"})
                if code == 0 and data:
                    if check in (_json.loads(data).get("checks") or {}):
                        return True
            except (OSError, ValueError, ConnectionError,
                    asyncio.TimeoutError):
                pass
            await asyncio.sleep(0.15)
        return False

    def _ballast_candidates(self, pool_name: str, target: int):
        """Yield unwritten ballast names whose PG acting set contains
        ``target`` (placement computed client-side — fills STEER, so
        tiny stores cross their thresholds without CRUSH-imbalance
        overshooting any one of them)."""
        from ceph_tpu_torch.osd.daemon import object_to_pg

        om = self.client.osdmap
        pid = om.lookup_pg_pool_name(pool_name)
        pl = om.get_pg_pool(pid) if pid >= 0 else None
        if pl is None:
            return
        have = set(self._ballast_names)
        for i in range(4096):
            name = f"ballast-{i:05d}"
            if name in have:
                continue
            pg = object_to_pg(pl, name)
            _u, _up, acting, _pri = om.pg_to_up_acting_osds(pg)
            if target in acting:
                yield name

    async def _apply_fill(self, level: str, ratio: float) -> None:
        """Closed-loop ballast writer: push store usage until the
        level's target is observed.  nearfull/full push the MOST-full
        store over the line (one over-threshold osd raises the check
        and gates writes); backfillfull pushes the LEAST-full store
        up until EVERY up+in member is past the reservation gate.
        Each write is aimed at a PG holding the chosen osd, so the
        ladder is driven precisely — the TRACE stays pure, only this
        application loop is adaptive (like wait_clean)."""
        import errno as _errno

        sc = self.scenario
        pool = sc.get("ballast_pool", "rep")
        size = int(sc.get("ballast_size", 128 * 1024))
        # never push any store near the local failsafe: the ladder is
        # proven against the widened conf ratios, with the failsafe
        # margin held in reserve (check_fullness asserts the peak)
        cap = float(sc.get("full_fill", 0.82)) + 0.06
        io = self.client.ioctx(pool)
        obs = self.fullness
        for _ in range(400):
            ratios = self._store_ratios(in_only=True)
            if not ratios or max(ratios.values()) >= cap:
                break
            if level == "backfillfull":
                if min(ratios.values()) >= ratio:
                    break
                target = min(ratios, key=ratios.get)
            else:
                if max(ratios.values()) >= ratio:
                    break
                target = max(ratios, key=ratios.get)
            name = next(
                self._ballast_candidates(pool, target), None)
            if name is None:
                break  # namespace exhausted for this placement
            try:
                await io.write_full(name, b"\xba" * size)
                self._ballast_names.append(name)
            except OSError as e:
                if e.errno == _errno.ENOSPC:
                    obs["enospc_bounced"] = True
                    break
                raise
        check = {"nearfull": "OSD_NEARFULL",
                 "backfillfull": "OSD_BACKFILLFULL",
                 "full": "OSD_FULL"}[level]
        if await self._fullness_check_raised(check):
            obs[f"{level}_raised"] = True
        if level == "full" and not obs["enospc_bounced"]:
            await self._probe_enospc(io, pool, size)

    async def _probe_enospc(self, io, pool_name: str,
                            size: int) -> None:
        """The ENOSPC proof: aim writes at PGs whose acting set
        contains a map-FULL osd and require the bounce.  A write may
        race the bit onto an OSD whose map lags one beacon — retry
        over fresh candidates with a short grace."""
        import errno as _errno

        from ceph_tpu_torch.osd.daemon import object_to_pg

        om = self.client.osdmap
        pid = om.lookup_pg_pool_name(pool_name)
        pl = om.get_pg_pool(pid) if pid >= 0 else None
        if pl is None:
            return
        full = {o for o in range(om.max_osd)
                if om.exists(o) and om.is_full(o)}
        if not full:
            return
        attempts = 0
        for i in range(512):
            name = f"ballast-probe-{i:03d}"
            pg = object_to_pg(pl, name)
            _u, _up, acting, _pri = om.pg_to_up_acting_osds(pg)
            if not (full & set(acting)):
                continue
            try:
                await io.write_full(name, b"\xbb" * size)
                # raced the bit on the OSD's older map: the write
                # landed — track it for the drain, grace, retry
                self._ballast_names.append(name)
            except OSError as e:
                if e.errno == _errno.ENOSPC:
                    self.fullness["enospc_bounced"] = True
                return
            attempts += 1
            if attempts >= 8:
                return
            await asyncio.sleep(0.25)

    async def _apply_drain(self) -> None:
        """Delete every ballast object (deletes pass the full gate —
        they are how an operator digs out) and let usage fall; the
        settle phase then requires the ladder to CLEAR."""
        sc = self.scenario
        io = self.client.ioctx(sc.get("ballast_pool", "rep"))
        import errno as _errno

        for name in self._ballast_names:
            try:
                await io.remove(name)
            except OSError as e:
                if e.errno != _errno.ENOENT:
                    log.warning("chaos: drain of %s failed: %s",
                                name, e)
        self._ballast_names = []

    def _schedule_heal(self, ttl, heal) -> None:
        if not ttl:
            return

        async def _later():
            await asyncio.sleep(ttl * self.time_scale)
            heal()

        t = asyncio.ensure_future(_later())
        self._heal_tasks.add(t)
        t.add_done_callback(self._heal_tasks.discard)

    async def _command(self, cmd: dict) -> tuple[int, str, bytes]:
        code, rs, data = await self.client.command(cmd)
        if code != 0:
            raise OSError(-code, f"{cmd.get('prefix')}: {rs}")
        return code, rs, data

    async def _mon_restart(self, rank: int) -> None:
        from ceph_tpu_torch.mon import Monitor

        old = self.mons[rank]
        if old is None:
            return
        host, port = old.addr
        await old.stop()
        m = Monitor(
            crush=self._crush_template.copy(), rank=rank,
            n_mons=len(self.mons), device=self.device,
        )
        self.netem.attach(m.messenger)
        await m.start(host, port)
        self.mons[rank] = m
        await m.open_quorum(list(self.monmap))

    # -- post-thrash verification ---------------------------------------

    def mon_views(self) -> list[dict]:
        return [
            {
                "rank": m.rank,
                "stable": m.paxos.stable.is_set(),
                "leader": m.paxos.leader,
                "epoch": m.osdmap.epoch,
            }
            for m in self.mons if m is not None
        ]

    async def await_quorum_agreement(self, timeout: float = 30.0) -> list:
        """Poll until every mon agrees (one leader, one epoch); returns
        the surviving violations (empty = invariant holds)."""
        deadline = time.monotonic() + timeout
        views = self.mon_views()
        while time.monotonic() < deadline:
            views = self.mon_views()
            if not inv.check_quorum(views):
                return []
            await asyncio.sleep(0.2)
        return inv.check_quorum(views)

    async def await_mgr_reports(self, timeout: float = 30.0) -> list:
        """Poll `mgr stat` until the report plane has healed (an
        active mgr, every OSD re-registered, fresh digest); returns
        surviving check_mgr violations (empty = invariant holds).
        Scenario-trace end revives every killed daemon, so EVERY osd
        is expected to report."""
        import json as _json

        expected = [f"osd.{i}" for i in range(self.scenario["n_osds"])]
        deadline = time.monotonic() + timeout
        stat: dict = {}
        while time.monotonic() < deadline:
            try:
                code, _rs, data = await self.client.command(
                    {"prefix": "mgr stat"})
                stat = _json.loads(data) if code == 0 and data else {}
            except (OSError, ValueError):
                stat = {}
            if not inv.check_mgr(stat, expected):
                return []
            await asyncio.sleep(0.3)
        return inv.check_mgr(stat, expected)

    async def deep_scrub_sweep(self, retries: int = 6) -> list[dict]:
        """Deep scrub every PG of every scenario pool; returns reports."""
        import json as _json

        reports: list[dict] = []
        om = self.client.osdmap
        for pool in self.scenario.get("pools", []):
            pid = om.lookup_pg_pool_name(pool["name"])
            if pid < 0:
                continue
            for ps in range(om.pools[pid].pg_num):
                rep = None
                for attempt in range(retries):
                    code, _rs, data = await self.client.command({
                        "prefix": "pg deep-scrub",
                        "pgid": f"{pid}.{ps}",
                    })
                    if code == 0:
                        rep = _json.loads(data)
                        break
                    await asyncio.sleep(0.3 * (attempt + 1))
                reports.append(rep if rep is not None else {
                    "pg": f"{pid}.{ps}",
                    "error": "deep scrub never reached a primary",
                })
        return reports

    async def repair_sweep(self, retries: int = 6) -> None:
        """`pg repair` over every PG of every scenario pool — the
        disk-fault scenario's heal pass: scrub-detected damage (rotten
        shards quarantined to holes, divergent members of torn
        commits) is rebuilt from the authoritative copies before the
        deep-scrub verdict."""
        om = self.client.osdmap
        for pool in self.scenario.get("pools", []):
            pid = om.lookup_pg_pool_name(pool["name"])
            if pid < 0:
                continue
            for ps in range(om.pools[pid].pg_num):
                for attempt in range(retries):
                    code, _rs, _data = await self.client.command({
                        "prefix": "pg repair", "pgid": f"{pid}.{ps}",
                    })
                    if code == 0:
                        break
                    await asyncio.sleep(0.3 * (attempt + 1))

    def fsck_sweep(self) -> list[dict]:
        """At-rest verification of every OSD's store (live daemons and
        stashed stores of dead ones): any blob whose checksum no
        longer verifies is damage the run failed to heal.  Stores
        without an fsck (MemStore) contribute nothing."""
        out: list[dict] = []
        seen: set[int] = set()
        stores: list[tuple[int, object]] = []
        for osd in self.osds:
            if osd is not None:
                stores.append((osd.id, osd.store))
                seen.add(osd.id)
        for osd_id, store in getattr(self, "_stashed_stores", {}).items():
            if osd_id not in seen:
                stores.append((osd_id, store))
        for osd_id, store in stores:
            fsck = getattr(store, "fsck", None)
            if not callable(fsck):
                continue
            try:
                bad = fsck()
            except (OSError, ValueError) as e:
                bad = [{"error": f"{type(e).__name__}: {e}"}]
            out.append({"osd": osd_id, "bad": bad})
        return out


async def _watch_slow_osd(cluster, targets, obs, perf_base) -> None:
    """Degraded-disk observer: while the thrash runs, record whether
    the SLOW_OPS warning surfaced in `ceph health`, whether the mgr's
    outlier detection flagged a slowed osd, and whether the victim's
    scrub scheduler learned + acted on the deprioritization verdict."""
    import json as _json

    tnames = {f"osd.{t}" for t in targets}
    while True:
        try:
            code, _rs, data = await cluster.client.command(
                {"prefix": "health"})
            if code == 0 and data:
                h = _json.loads(data)
                if "SLOW_OPS" in (h.get("checks") or {}):
                    obs["slow_ops_raised"] = True
        except (OSError, ValueError, ConnectionError,
                asyncio.TimeoutError):
            pass
        for g in cluster.mgrs:
            if g is not None and g.active \
                    and tnames & g._outlier_daemons():
                obs["outlier_flagged"] = True
        om = cluster.client.osdmap
        for t in targets:
            osd = cluster.osds[t]
            if osd is None:
                continue
            if osd.mgr_client.scrub_deprioritized:
                obs["scrub_deprioritized"] = True
            deferred = (osd.perf.dump().get("scrub_deferred_slow", 0.0)
                        - perf_base.get(t, 0.0))
            if deferred > 0:
                obs["scrub_deferred"] = deferred
            if om is not None and not obs.get("target_leads_pg"):
                from ceph_tpu_torch.osd.types import pg_t as _pg_t

                for pid, pool in om.pools.items():
                    for ps in range(pool.pg_num):
                        _u, _up, _a, pri = om.pg_to_up_acting_osds(
                            _pg_t(pid, ps), folded=True)
                        if pri == t:
                            obs["target_leads_pg"] = True
                            break
                    if obs.get("target_leads_pg"):
                        break
        await asyncio.sleep(0.25)


async def _watch_fullness(cluster, obs, perf_base) -> None:
    """Fullness observer: while the ladder is driven, record the
    peak usage ratio any store reaches (the failsafe-never-breached
    proof), the REJECT_TOOFULL reservation count growing on the
    backfillfull members (recovery.py backfill_reject_toofull — the
    backfill-actually-paused proof), and any health rung the fill
    handler's own bounded wait might have missed."""
    import json as _json

    while True:
        ratios = cluster._store_ratios()
        if ratios:
            obs["failsafe_peak"] = max(
                obs["failsafe_peak"], max(ratios.values()))
        rejects = 0.0
        for osd in cluster.osds:
            if osd is None:
                continue
            rejects += (
                osd.perf.dump().get("backfill_reject_toofull", 0.0)
                - perf_base.get(osd.id, 0.0))
        if rejects > obs["backfill_rejects"]:
            obs["backfill_rejects"] = rejects
        try:
            code, _rs, data = await cluster.client.command(
                {"prefix": "health"})
            if code == 0 and data:
                checks = _json.loads(data).get("checks") or {}
                for level, check in (
                    ("nearfull", "OSD_NEARFULL"),
                    ("backfillfull", "OSD_BACKFILLFULL"),
                    ("full", "OSD_FULL"),
                ):
                    if check in checks:
                        obs[f"{level}_raised"] = True
        except (OSError, ValueError, ConnectionError,
                asyncio.TimeoutError):
            pass
        await asyncio.sleep(0.15)


def _dump_wedge_state(cluster) -> None:
    """Convergence timed out: snapshot every live OSD's recovery-side
    state so a wedge is diagnosable from the run log alone — which pg
    each daemon still considers unclean, who holds reservation slots,
    and where the recovery task is parked (a silent reservation
    livelock leaves NO log lines; this is the only witness)."""
    from ceph_tpu_torch.osd.pgutil import pg_t

    for osd in cluster.osds:
        if osd is None:
            continue
        task = getattr(osd, "_recovery_task", None)
        frames: list[str] = []
        state = "none"
        if task is not None:
            if not task.done():
                state = "running"
                for f in task.get_stack(limit=6):
                    frames.append(
                        f"{f.f_code.co_filename.rsplit('/', 1)[-1]}:"
                        f"{f.f_lineno}:{f.f_code.co_name}")
            elif task.cancelled():
                state = "cancelled"
            elif task.exception() is not None:
                state = f"raised:{task.exception()!r}"
            else:
                state = "done"
        prim: list[str] = []
        om = osd.osdmap
        if om is not None:
            for pid, pool in om.pools.items():
                for ps in range(pool.pg_num):
                    _, _, acting, p = om.pg_to_up_acting_osds(
                        pg_t(pid, ps), folded=True)
                    prim.append(f"{pid}.{ps}:p{p}a{acting}")
        log.error(
            "wedge osd.%d: epoch=%d recovering=%s clean_epoch=%s "
            "local_slots=%s remote_slots=%s remote_grants=%s "
            "recovery_task=%s stack=%s map=%s",
            osd.id, osd.epoch, sorted(osd._recovering_pgs),
            dict(osd._clean_epoch),
            getattr(osd.local_reserver, "in_use", "?"),
            getattr(osd.remote_reserver, "in_use", "?"),
            sorted(osd._remote_grants),
            state,
            " <- ".join(frames) or "-",
            " ".join(prim),
        )


async def _settle_fullness(cluster, obs, time_scale: float) -> None:
    """Post-drain verification: the whole ladder must CLEAR — no
    fullness health check may survive the drain and settle."""
    import json as _json

    fullness_checks = {"OSD_NEARFULL", "OSD_BACKFILLFULL", "OSD_FULL"}
    deadline = time.monotonic() + 30.0 * time_scale
    checks: list = []
    while time.monotonic() < deadline:
        try:
            code, _rs, data = await cluster.client.command(
                {"prefix": "health"})
            if code == 0 and data:
                checks = sorted(_json.loads(data).get("checks") or {})
                if not (set(checks) & fullness_checks):
                    obs["ladder_cleared"] = True
                    return
        except (OSError, ValueError, ConnectionError,
                asyncio.TimeoutError):
            pass
        await asyncio.sleep(0.3)
    obs["checks_at_settle"] = checks


async def _watch_events(cluster, obs) -> None:
    """Event-plane observer: sample the active mgr's progress module
    while the thrash runs, recording each event's fraction sequence
    (monotonicity is judged over THESE samples), final fraction, and
    whether it was reaped into the completed history."""
    while True:
        try:
            _sample_progress(cluster, obs)
        except Exception:  # a sampler must never die mid-thrash
            log.exception("chaos: event watcher sample failed")
        await asyncio.sleep(0.2)


def _sample_progress(cluster, obs) -> None:
    for g in cluster.mgrs:
        if g is None:
            continue
        prog = g.modules.get("progress")
        if prog is None:
            continue
        if g.active and prog.running:
            for ev in prog.public_events():
                rec = obs["progress_events"].setdefault(ev["id"], {
                    "kind": ev["kind"], "fractions": [],
                    "final": 0.0, "reaped": False,
                })
                fr = float(ev.get("fraction") or 0.0)
                if not rec["fractions"] or rec["fractions"][-1] != fr:
                    rec["fractions"].append(fr)
                rec["final"] = max(rec["final"], fr)
        # completed history is ground truth for reap/final even when
        # the sampler missed the active window (module state persists
        # on the daemon object)
        for done in prog.public_completed():
            rec = obs["progress_events"].setdefault(done["id"], {
                "kind": done["kind"], "fractions": [],
                "final": 0.0, "reaped": False,
            })
            rec["final"] = max(
                rec["final"], float(done.get("fraction") or 0.0))
            rec["reaped"] = True


async def _settle_events(cluster, obs, time_scale: float) -> None:
    """Post-settle event-plane verification: wait for active progress
    events to complete + reap, require a crash dump per injected
    death, mute the EXPECTED RECENT_CRASH, and record what health
    codes remain unmuted."""
    import json as _json

    # 1. progress events must finish and reap (completion grace +
    # slack for the module tick cadence)
    deadline = time.monotonic() + 20.0 * time_scale
    while time.monotonic() < deadline:
        live = [
            g for g in cluster.mgrs
            if g is not None and g.active
            and g.modules.get("progress") is not None
            and g.modules["progress"].running
        ]
        if live and all(not g.modules["progress"].events for g in live):
            break
        await asyncio.sleep(0.3)
    # final authoritative sample: the watcher is a 0.2s poller and can
    # race the module's reap; the module's own state cannot
    _sample_progress(cluster, obs)
    # 2. every injected death must have a collected crash dump —
    # judged through `ceph crash ls` (mon <- digest <- crash module),
    # proving the full collection chain, not just the files on disk
    expected = {e for e, n in cluster.deaths.items() if n > 0}
    deadline = time.monotonic() + 15.0
    seen: set = set()
    while time.monotonic() < deadline:
        try:
            code, _rs, data = await cluster.client.command(
                {"prefix": "crash ls"})
            if code == 0 and data:
                seen = {
                    m.get("entity")
                    for m in _json.loads(data).get("crashes", [])
                }
        except (OSError, ValueError, ConnectionError,
                asyncio.TimeoutError):
            pass
        if expected <= seen:
            break
        await asyncio.sleep(0.4)
    obs["crash_entities"] = seen
    obs["deaths"] = dict(cluster.deaths)
    # 3. mute the crash warning the runner itself caused, then the
    # remaining UNMUTED checks must be the allowed set only
    if expected:
        try:
            await cluster.client.command({
                "prefix": "health mute", "code": "RECENT_CRASH"})
        except (OSError, ConnectionError, asyncio.TimeoutError):
            pass
    allowed = set(obs.get("allowed_checks") or [])
    deadline = time.monotonic() + 12.0
    checks: list = []
    while time.monotonic() < deadline:
        try:
            code, _rs, data = await cluster.client.command(
                {"prefix": "health"})
            if code == 0 and data:
                checks = sorted(_json.loads(data).get("checks") or {})
        except (OSError, ValueError, ConnectionError,
                asyncio.TimeoutError):
            pass
        if not (set(checks) - allowed):
            break
        await asyncio.sleep(0.4)
    obs["unmuted_checks"] = checks


def _perf_totals(n_osds: int) -> dict:
    """Cluster-wide perf-counter sums (osd.* + mgr_analytics.*) for
    the per-run coverage export.  Counters are process-global and
    restart-proof (a revived daemon re-attaches), so before/after
    deltas attribute movement to THIS run."""
    from ceph_tpu_torch.common.metrics import get_perf_counters

    tot: dict[str, float] = {}
    for i in range(n_osds):
        for k, v in get_perf_counters(f"osd.{i}").dump().items():
            if isinstance(v, (int, float)):
                tot[k] = tot.get(k, 0.0) + v
    for k, v in get_perf_counters("mgr_analytics").dump().items():
        if isinstance(v, (int, float)):
            key = f"mgr_analytics.{k}"
            tot[key] = tot.get(key, 0.0) + v
    return tot


async def run_scenario(
    scenario: dict | str, seed: int, *, time_scale: float = 1.0,
    settle_timeout: float = 90.0, device=None,
) -> dict:
    """One (scenario, seed) chaos run end to end on ``device`` (the
    card unless the caller passes ``device="cpu"``); returns the
    result record that lands in the chaos artifact."""
    if isinstance(scenario, str):
        scenario = SCENARIOS[scenario]
    events = generate_schedule(seed, scenario)
    return await run_trace(
        scenario, events, seed=seed, time_scale=time_scale,
        settle_timeout=settle_timeout, device=device)


async def run_trace(
    scenario: dict, events: list, *, seed: int = 0,
    time_scale: float = 1.0, settle_timeout: float = 90.0,
    device=None,
) -> dict:
    """Replay a RAW event trace against a fresh cluster — the fuzz
    plane's entry point: :func:`run_scenario` is the (seed, scenario)
    special case, mutant traces come straight from the corpus.  The
    trace must pass ``schedule.validate_trace`` (mutants are repaired
    before they get here); the result record carries the same
    invariant verdicts as a scenario run plus a ``coverage`` block
    (which counter families moved, which event kinds fired, which
    daemons died) for the fingerprint."""
    th = trace_hash(events)
    counters = chaos_counters()
    counters.inc("runs")
    t_wall = time.monotonic()
    cluster = ChaosCluster(scenario, time_scale=time_scale, device=device)
    result: dict = {
        "scenario": scenario["name"], "seed": seed,
        "trace_hash": th, "n_events": len(events),
    }
    watch_task: asyncio.Task | None = None
    events_watch_task: asyncio.Task | None = None
    fullness_watch_task: asyncio.Task | None = None
    try:
        await cluster.start()
        cold_before = _cold_launch_snapshot(cluster.device)
        from ceph_tpu_torch.common.transfer_guard import snapshot as tg_snapshot

        windows_before = tg_snapshot()["guard_windows"]
        perf_before = _perf_totals(scenario["n_osds"])
        from ceph_tpu_torch.common.fault_injector import disk_fault_counters

        df_before = dict(disk_fault_counters().dump())
        backfill_base: dict | None = None
        if scenario.get("soak_script"):
            # perf collections are process-global (a revived daemon
            # re-attaches to the same counters), so delta-checking
            # across the run is restart-proof
            from ceph_tpu_torch.common.metrics import get_perf_counters

            backfill_base = {
                name: sum(
                    get_perf_counters(f"osd.{i}").dump().get(name, 0.0)
                    for i in range(scenario["n_osds"]))
                for name in ("backfill_started", "backfill_completed")
            }
        workload = None
        wl_task = None
        load_task = None
        if scenario.get("load_profile"):
            # chaos x loadgen composition: the deterministic LOAD
            # trace IS the workload — the harness attaches to this
            # cluster in external mode and the thrash replays through
            # its open-loop arrival process
            from ceph_tpu_torch.loadgen.driver import LoadHarness
            from ceph_tpu_torch.loadgen.schedule import resolve_profile

            lp = dict(scenario["load_profile"])
            profile = resolve_profile(
                lp.get("profile", "compose_smoke"),
                clients=lp.get("clients"),
                ops_per_client=lp.get("ops_per_client"))
            load_harness = cluster.load_harness = LoadHarness(
                profile, seed, time_scale=time_scale,
                monmap=list(cluster.monmap), conf=cluster._conf(),
                qos_osds=cluster.osds, device=cluster.device)
            await load_harness.start()
            load_task = asyncio.ensure_future(load_harness.run())
            # thrash begins once the namespaces are prefilled: setup
            # is not the production window under test
            await load_harness.prefill_done.wait()
        else:
            wl_conf = scenario.get("workload", {})
            # tiered scenarios exclude the hot pool from direct I/O:
            # the workload reaches it through the base pool's overlay
            workload = Workload(
                cluster.client,
                [p for p in scenario.get("pools", [])
                 if p.get("workload", True)],
                objects=wl_conf.get("objects", 3),
                rounds=wl_conf.get("rounds", 3),
                object_size=wl_conf.get("object_size", 8192),
                write_gap=wl_conf.get("write_gap", 0.0) * time_scale,
            )
            wl_task = asyncio.ensure_future(workload.run())

        if scenario.get("fullness_script"):
            perf_base = {
                osd.id: osd.perf.dump().get(
                    "backfill_reject_toofull", 0.0)
                for osd in cluster.osds if osd is not None
            }
            fullness_watch_task = asyncio.ensure_future(
                _watch_fullness(cluster, cluster.fullness, perf_base))

        slow_obs: dict | None = None
        if scenario.get("watch_slow_osd"):
            targets = [
                e.args["osd"] for e in events if e.kind == "slow_disk"]
            slow_obs = {
                "targets": targets, "slow_ops_raised": False,
                "outlier_flagged": False, "scrub_deprioritized": False,
                "scrub_deferred": 0.0, "slow_ops_cleared": False,
            }
            perf_base = {
                t: cluster.osds[t].perf.dump().get(
                    "scrub_deferred_slow", 0.0)
                for t in targets if cluster.osds[t] is not None
            }
            watch_task = asyncio.ensure_future(
                _watch_slow_osd(cluster, targets, slow_obs, perf_base))

        events_obs: dict | None = None
        if scenario.get("watch_events"):
            degrading = {"osd_kill", "osd_out", "disk_dead"}
            events_obs = {
                # only traces that actually degraded the cluster are
                # required to produce progress events (deterministic
                # per (seed, scenario) — it derives from the trace)
                "expect_progress": any(
                    e.kind in degrading for e in events),
                "progress_events": {},
                "allowed_checks": list(
                    scenario.get("settle_allowed_health", [])),
            }
            events_watch_task = asyncio.ensure_future(
                _watch_events(cluster, events_obs))

        loop = asyncio.get_running_loop()
        t0 = loop.time()
        for ev in events:
            delay = (t0 + cluster.delivery_lag + ev.t * time_scale
                     - loop.time())
            if delay > 0:
                await asyncio.sleep(delay)
            await cluster.apply_event(ev)
        history = None
        load_rec = None
        if wl_task is not None:
            history = await wl_task
        if load_task is not None:
            load_rec = await load_task

        if scenario.get("self_heal"):
            # drain in-flight disk-fault escalations before capturing
            # the settle epoch: a self-markdown landing just AFTER the
            # capture would let pre-death active+clean reports satisfy
            # the convergence wait while re-peering is still running
            await asyncio.sleep(1.5 * time_scale)

        # settle: converge back to active+clean under the final map
        violations: dict[str, list] = {}
        settle_epoch = cluster.client.osdmap.epoch
        try:
            status = await cluster.client.wait_clean(
                timeout=settle_timeout, min_epoch=settle_epoch)
            violations["converged"] = inv.check_converged(status)
        except TimeoutError as e:
            violations["converged"] = [{
                "invariant": "not_converged", "detail": str(e)}]
            _dump_wedge_state(cluster)
        violations["quorum"] = await cluster.await_quorum_agreement()
        if workload is not None:
            violations["history"] = inv.check_history(history)
            final = await workload.final_reads()
            violations["final_reads"] = inv.check_final_reads(
                history, final)
        if load_rec is not None:
            expected_tenants = sorted(
                cluster.load_harness.profile.get("tenants") or {})
            violations["load"] = inv.check_load(
                load_rec, expected_tenants)
            result["load"] = load_rec
        reports = await cluster.deep_scrub_sweep()
        if scenario.get("self_heal") and inv.check_scrub_reports(reports):
            # disk-fault mode: injected rot the run hasn't absorbed yet
            # (e.g. a flipped shard nothing read) is healed by `pg
            # repair` — the same authoritative-copy machinery operators
            # invoke — then deep scrub must come back clean.  Bounded
            # retries give in-flight quarantine/repair tasks time.
            for _round in range(4):
                await cluster.repair_sweep()
                await asyncio.sleep(0.5 * time_scale)
                reports = await cluster.deep_scrub_sweep()
                if not inv.check_scrub_reports(reports):
                    break
        violations["scrub"] = inv.check_scrub_reports(reports)
        fsck_reports = []
        if scenario.get("store") == "blockstore":
            for _round in range(4):
                fsck_reports = cluster.fsck_sweep()
                if not inv.check_disk_faults(fsck_reports):
                    break
                # damage still referenced at rest: background repairs
                # may be in flight, or a clone needs one more pass
                await cluster.repair_sweep()
                if workload is not None:
                    await workload.final_reads()
                await asyncio.sleep(0.5 * time_scale)
                fsck_reports = cluster.fsck_sweep()
                if not inv.check_disk_faults(fsck_reports):
                    break
        violations["disk_faults"] = inv.check_disk_faults(fsck_reports)
        if scenario.get("n_mgrs"):
            # report streams must RESUME after mgr failover (the mgr
            # itself is never in the data path — every other invariant
            # above already judged the client workload untouched)
            violations["mgr"] = await cluster.await_mgr_reports()
        if slow_obs is not None:
            # the warning must CLEAR after the heal: poll `ceph
            # health` until the mgr's quiet window elapses and the
            # digest drops SLOW_OPS
            import json as _json

            deadline = time.monotonic() + 25.0
            while time.monotonic() < deadline:
                try:
                    code, _rs, data = await cluster.client.command(
                        {"prefix": "health"})
                    if code == 0 and data:
                        h = _json.loads(data)
                        if "SLOW_OPS" not in (h.get("checks") or {}):
                            slow_obs["slow_ops_cleared"] = True
                            break
                except (OSError, ValueError, ConnectionError,
                        asyncio.TimeoutError):
                    pass
                await asyncio.sleep(0.4)
            if watch_task is not None:
                watch_task.cancel()
            violations["slow_osd"] = inv.check_slow_osd(slow_obs)
            result["slow_osd_obs"] = dict(slow_obs)
        if events_obs is not None:
            # the event plane: progress completion/reap, crash dumps
            # per injected death, no unmuted debris at settle
            await _settle_events(cluster, events_obs, time_scale)
            if events_watch_task is not None:
                events_watch_task.cancel()
            violations["events"] = inv.check_events(events_obs)
            result["events_obs"] = {
                "expect_progress": events_obs["expect_progress"],
                "events": {
                    eid: {"kind": rec["kind"], "final": rec["final"],
                          "reaped": rec["reaped"],
                          "samples": len(rec["fractions"])}
                    for eid, rec in sorted(
                        events_obs["progress_events"].items())
                },
                "deaths": events_obs.get("deaths", {}),
                "crash_entities": sorted(
                    e for e in events_obs.get("crash_entities", ())
                    if e),
                "unmuted_checks": events_obs.get("unmuted_checks", []),
            }
        if scenario.get("client_netem"):
            # the client-netem ack oracle: a partition verifiably bit
            # a client send, every failed write carries a legal errno
            # — while check_history/check_final_reads above already
            # judged no acked write lost or rolled back
            client_kinds = ("client_partition", "client_drop",
                            "client_delay")
            errored = [w for w in history.writes
                       if w.get("error") is not None]
            violations["client_netem"] = inv.check_client_netem({
                "client_events": sum(
                    1 for e in events if e.kind in client_kinds),
                "netem": dict(cluster.netem.stats),
                "errored_writes": errored,
            })
            import errno as _errno

            result["client_netem_obs"] = {
                "client_partitioned_sends": cluster.netem.stats[
                    "client_partitioned_sends"],
                "client_dropped_sends": cluster.netem.stats[
                    "client_dropped_sends"],
                "client_delayed_sends": cluster.netem.stats[
                    "client_delayed_sends"],
                "errored_writes": len(errored),
                "timeouts": sum(
                    1 for w in errored
                    if w.get("errno") == _errno.ETIMEDOUT),
            }
        if scenario.get("fullness_script"):
            await _settle_fullness(cluster, cluster.fullness,
                                   time_scale)
            if fullness_watch_task is not None:
                fullness_watch_task.cancel()
            cluster.fullness["failsafe_ratio"] = cluster._conf()[
                "osd_failsafe_full_ratio"]
            violations["fullness"] = inv.check_fullness(
                cluster.fullness)
            result["fullness_obs"] = dict(cluster.fullness)
        if scenario.get("topology"):
            # rack-scale failure domains: the pre-kill placement
            # snapshots must prove CRUSH separated shards across
            # racks AND that every PG retained enough shards to
            # survive the whole-rack loss it was about to take
            violations["domains"] = inv.check_domains(
                cluster.domains_obs,
                expect_kill=bool(scenario.get("rack_script")))
            result["domains_obs"] = list(cluster.domains_obs)
        if backfill_base is not None:
            from ceph_tpu_torch.common.metrics import get_perf_counters

            backfill_obs = {
                name: sum(
                    get_perf_counters(f"osd.{i}").dump().get(name, 0.0)
                    for i in range(scenario["n_osds"]))
                - backfill_base[name]
                for name in ("backfill_started", "backfill_completed")
            }
            backfill_obs["interrupt_scripted"] = bool(
                scenario.get("soak_interrupt", "target"))
            if events_obs is not None:
                backfill_obs["progress_events"] = len(
                    events_obs.get("progress_events") or {})
            violations["backfill"] = inv.check_backfill(backfill_obs)
            result["backfill_obs"] = dict(backfill_obs)
        cold_after = _cold_launch_snapshot(cluster.device)
        violations["cold_launches"] = inv.check_cold_launches(
            cold_before, cold_after)
        # the port's record also keeps the snapshot's deltas and the
        # guard windows the run opened (the evidence the guard was live)
        result["cold_launch_deltas"] = {
            k: cold_after[k] - cold_before[k] for k in cold_before}
        result["guard_windows"] = (
            tg_snapshot()["guard_windows"] - windows_before)

        ok = not any(violations.values())
        counters.inc("runs_green" if ok else "runs_red")
        for name, vs in violations.items():
            if vs:
                counters.inc("violations", invariant=name, by=len(vs))
        df_after = disk_fault_counters().dump()
        perf_after = _perf_totals(scenario["n_osds"])
        result["coverage"] = {
            "event_kinds": sorted({e.kind for e in events}),
            "perf_deltas": {
                k: round(perf_after[k] - perf_before.get(k, 0.0), 6)
                for k in sorted(perf_after)
                if perf_after[k] - perf_before.get(k, 0.0)
            },
            "netem_moved": sorted(
                k for k, v in cluster.netem.stats.items() if v),
            "deaths": dict(sorted(cluster.deaths.items())),
        }
        result.update({
            "ok": ok,
            "events_applied": cluster.events_applied,
            "event_errors": len(cluster.event_errors),
            "workload": (
                history.summary() if history is not None else {
                    "load_ops": load_rec.get("ops_completed", 0)
                    if load_rec else 0,
                }),
            "netem": dict(cluster.netem.stats),
            "disk_faults": {
                k: v - df_before.get(k, 0)
                for k, v in df_after.items()
                if v - df_before.get(k, 0)
            },
            "invariants": {
                name: {"ok": not vs, "violations": vs}
                for name, vs in violations.items()
            },
            "wall_s": round(time.monotonic() - t_wall, 2),
        })
        return result
    finally:
        if watch_task is not None:
            watch_task.cancel()
        if events_watch_task is not None:
            events_watch_task.cancel()
        if fullness_watch_task is not None:
            fullness_watch_task.cancel()
        if cluster.load_harness is not None:
            try:
                await cluster.load_harness.stop()
            except Exception:
                log.exception("chaos: load harness teardown failed")
        await cluster.stop()


def run_sweep(
    scenario_names: list[str], seeds, *, time_scale: float = 1.0,
    scenarios: dict[str, dict] | None = None, device=None,
) -> dict:
    """Synchronous driver for CLI/tests: every scenario x every seed,
    each on a fresh event loop (daemon state never leaks across runs).
    Raises nothing — red runs land in the artifact with their
    violations."""
    book = scenarios or SCENARIOS
    runs: list[dict] = []
    for name in scenario_names:
        for seed in seeds:
            loop = asyncio.new_event_loop()
            try:
                runs.append(loop.run_until_complete(
                    run_scenario(book[name], seed, time_scale=time_scale,
                                 device=device)
                ))
            except Exception as e:  # harness crash: record, keep going
                log.exception("chaos run %s/%s crashed", name, seed)
                runs.append({
                    "scenario": name, "seed": seed, "ok": False,
                    "crash": f"{type(e).__name__}: {e}",
                })
            finally:
                loop.close()
    green = sum(1 for r in runs if r.get("ok"))
    return {
        "schema": "ceph_tpu.chaos/v1",
        "scenarios": list(scenario_names),
        "seeds": list(seeds),
        "runs": runs,
        "summary": {
            "total": len(runs), "green": green,
            "red": len(runs) - green,
            "all_green": green == len(runs),
        },
    }

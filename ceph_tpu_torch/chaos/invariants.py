"""Durability invariant checkers over a chaos run.

Pure functions over recorded state — each returns a list of violation
dicts (empty = invariant holds), so they are unit-testable on
hand-built violating histories without booting a cluster (the
``ceph_test_rados`` history-check role, src/test/osd/RadosModel.h
``update_object_version``/``check_ref``):

- :func:`check_history` — read-your-writes over the live run: every
  read returns a whole payload of a version between the newest write
  acked before the read began (no stale/lost reads) and the newest
  write started before it ended (no time travel);
- :func:`check_final_reads` — post-thrash: every head read returns the
  last acked version (or a later, indeterminate-fate write), every
  snap read returns exactly the version frozen at snap creation;
- :func:`check_converged` — the cluster reports every PG active+clean;
- :func:`check_quorum` — every monitor settled on the SAME leader and
  map epoch (split-brain detector — the seed-66 bug class);
- :func:`check_scrub_reports` — zero deep-scrub inconsistencies after
  the thrash;
- :func:`check_disk_faults` — at-rest fsck sweeps report zero bad
  blobs: every injected disk fault (EIO / bit rot / torn commit) was
  healed by the repair chain or its OSD re-placed;
- :func:`check_cold_launches` — the decode/scrub batchers minted ZERO
  cold launches during chaos (recovery under failure must run on
  prewarmed shapes; a first launch in the I/O path is a perf regression
  the thrash would otherwise hide);
- :func:`check_domains` — CRUSH actually separated shards across
  failure domains: pre-kill snapshots show no PG of a rack-domain
  pool mapped two shards into one rack, and whole-rack loss left
  every PG >= k data shards / >= 1 replica to serve from;
- :func:`check_backfill` — the soak run genuinely exercised the
  backfill path: the ``backfill_started``/``backfill_completed``
  perf-counter pair moved, and when an interrupt was scripted at
  least one pass was cut short and re-run to completion.

Counterpart of ``ceph_tpu/chaos/invariants.py``: the same verdicts on the same records.
"""

from __future__ import annotations

import errno


def _write_bounds(writes: list[dict]) -> dict:
    """Per (pool, oid): sorted write records."""
    by_obj: dict[tuple, list[dict]] = {}
    for w in writes:
        by_obj.setdefault((w["pool"], w["oid"]), []).append(w)
    for recs in by_obj.values():
        recs.sort(key=lambda w: w["start"])
    return by_obj


def check_history(history) -> list[dict]:
    """Read-your-writes / no-lost-ack over the recorded live run."""
    out: list[dict] = []
    by_obj = _write_bounds(history.writes)
    for r in history.reads:
        key = (r["pool"], r["oid"])
        writes = by_obj.get(key, [])
        acked_before = [
            w["version"] for w in writes
            if w["ack"] is not None and w["ack"] < r["start"]
        ]
        started_before = [
            w["version"] for w in writes if w["start"] < r["end"]
        ]
        lo = max(acked_before, default=0)
        hi = max(started_before, default=0)
        if r.get("error") is not None:
            # availability errors are not durability violations —
            # EXCEPT ENOENT: an object with an acked write must exist
            if lo >= 1 and f"errno={errno.ENOENT}" in r["error"]:
                out.append({
                    "invariant": "acked_write_lost", **r,
                    "detail": f"ENOENT but v{lo} was acked before read",
                })
            continue
        if r["version"] is None or not r.get("valid"):
            out.append({
                "invariant": "corrupt_read", **r,
                "detail": "payload is not a whole write of any version",
            })
        elif r["version"] < lo:
            out.append({
                "invariant": "stale_read", **r,
                "detail": f"returned v{r['version']} < acked v{lo}",
            })
        elif r["version"] > hi:
            out.append({
                "invariant": "phantom_read", **r,
                "detail": f"returned v{r['version']} > newest started v{hi}",
            })
    return out


def check_final_reads(history, final_reads: list[dict]) -> list[dict]:
    """Post-thrash verification: last acked version (or newer
    indeterminate write) on every head; exact frozen version on every
    snap read."""
    out: list[dict] = []
    by_obj = _write_bounds(history.writes)
    for r in final_reads:
        key = (r["pool"], r["oid"])
        writes = by_obj.get(key, [])
        lo = max((w["version"] for w in writes if w["ack"] is not None),
                 default=0)
        hi = max((w["version"] for w in writes), default=0)
        if r.get("kind") == "snap":
            if r.get("error") is not None or r.get("version") is None:
                out.append({
                    "invariant": "snap_lost", **r,
                    "detail": "snap read failed or returned garbage",
                })
            elif r["version"] != r["expect_version"]:
                out.append({
                    "invariant": "snap_moved", **r,
                    "detail": (
                        f"snap {r['snapid']} froze v{r['expect_version']}"
                        f" but reads v{r['version']}"
                    ),
                })
            continue
        if r.get("error") is not None:
            if lo >= 1:
                out.append({
                    "invariant": "acked_write_lost", **r,
                    "detail": f"final read failed but v{lo} was acked",
                })
            continue
        if r.get("version") is None or not r.get("valid"):
            out.append({
                "invariant": "corrupt_read", **r,
                "detail": "final payload is not a whole write",
            })
        elif r["version"] < lo:
            out.append({
                "invariant": "acked_write_lost", **r,
                "detail": f"final v{r['version']} < last acked v{lo}",
            })
        elif r["version"] > hi:
            out.append({
                "invariant": "phantom_read", **r,
                "detail": f"final v{r['version']} > newest started v{hi}",
            })
    return out


def check_converged(status: dict) -> list[dict]:
    """The mon's aggregated pg summary must be all active+clean."""
    pgs = (status or {}).get("pgs", {})
    by_state = pgs.get("by_state", {})
    ok = (
        pgs.get("num_pgs", 0) > 0
        and pgs.get("num_reported", 0) >= pgs.get("num_pgs", 0)
        and set(by_state) == {"active+clean"}
    )
    if ok:
        return []
    return [{
        "invariant": "not_converged",
        "detail": f"pg summary {pgs!r} not all active+clean",
    }]


def check_quorum(mon_views: list[dict]) -> list[dict]:
    """``mon_views``: one snapshot per monitor — {"rank", "stable",
    "leader", "epoch"}.  All must be stable on ONE leader who claims
    leadership, at ONE osdmap epoch."""
    out: list[dict] = []
    unstable = [v["rank"] for v in mon_views if not v.get("stable")]
    if unstable:
        out.append({
            "invariant": "quorum_unstable",
            "detail": f"mons {unstable} not settled",
        })
        return out
    leaders = {v.get("leader") for v in mon_views}
    if len(leaders) != 1 or None in leaders:
        out.append({
            "invariant": "split_brain",
            "detail": "disagreeing leader views "
            + str({v['rank']: v.get('leader') for v in mon_views}),
        })
    else:
        leader = leaders.pop()
        if not any(
            v["rank"] == leader and v.get("leader") == leader
            for v in mon_views
        ):
            out.append({
                "invariant": "leaderless_quorum",
                "detail": f"agreed leader mon.{leader} view missing or "
                "doesn't claim leadership",
            })
    epochs = {v.get("epoch") for v in mon_views}
    if len(epochs) != 1:
        out.append({
            "invariant": "map_epoch_skew",
            "detail": "osdmap epochs "
            + str({v['rank']: v.get('epoch') for v in mon_views}),
        })
    return out


def check_scrub_reports(reports: list[dict]) -> list[dict]:
    """Post-thrash deep scrub must find nothing."""
    out: list[dict] = []
    for rep in reports:
        if rep.get("error"):
            out.append({
                "invariant": "scrub_failed", "pg": rep.get("pg"),
                "detail": str(rep["error"]),
            })
        elif rep.get("inconsistencies"):
            out.append({
                "invariant": "scrub_inconsistency", "pg": rep.get("pg"),
                "detail": rep["inconsistencies"],
            })
    return out


def check_cold_launches(before: dict, after: dict) -> list[dict]:
    """``before``/``after``: {counter_name: count} snapshots around
    the run (per-batcher cold_launches plus the transfer guard's
    host_transfers); any growth means chaos minted a first launch —
    or an implicit host<->device transfer — inside the I/O path."""
    out: list[dict] = []
    for name, b in before.items():
        a = after.get(name, b)
        if a > b:
            out.append({
                "invariant": "cold_launch", "batcher": name,
                "detail": f"{name} grew {b} -> {a} during chaos",
            })
    return out


def check_mgr(mgr_stat: dict, expected_daemons: list[str]) -> list[dict]:
    """``mgr_stat``: the mon's `mgr stat` blob after the cluster
    settled.  The mgr is never in the data path, so the only mgr
    invariants are (a) an ACTIVE mgr exists again after the thrash,
    (b) its report streams RESUMED — every expected live daemon shows
    in the digest's reporting set with a fresh digest — and (c) its
    analytics engine minted no cold launches mid-chaos (checked
    separately via check_cold_launches over the mgr_analytics
    counters)."""
    out: list[dict] = []
    if not mgr_stat.get("active"):
        out.append({
            "invariant": "no_active_mgr",
            "detail": f"MgrMap has no active mgr: {mgr_stat!r}",
        })
        return out
    age = mgr_stat.get("digest_age")
    if age is None or age > 10.0:
        out.append({
            "invariant": "mgr_digest_stale",
            "detail": f"last digest {age!r}s old — report stream "
            "never resumed after failover",
        })
    reporting = set(mgr_stat.get("reporting") or [])
    missing = sorted(set(expected_daemons) - reporting)
    if missing:
        out.append({
            "invariant": "mgr_reports_missing",
            "detail": f"daemons {missing} never re-registered with "
            f"the active mgr (reporting: {sorted(reporting)})",
        })
    return out


def check_slow_osd(obs: dict) -> list[dict]:
    """``obs``: the degraded-disk watcher's observations —
    {"targets": [osd ids], "slow_ops_raised", "outlier_flagged",
    "scrub_deprioritized", "scrub_deferred", "slow_ops_cleared"}.

    The detection/feedback loop must have CLOSED end to end: slow
    commits raised the mon-visible SLOW_OPS warning, the mgr's
    analytics flagged the slowed OSD as an outlier, the OSD learned
    the verdict (MMgrConfigure scrub_deprioritize) and deferred at
    least one background scrub, and after the heal the warning
    CLEARED (a stuck warning is as bad as none)."""
    out: list[dict] = []
    if not obs.get("targets"):
        out.append({
            "invariant": "no_slow_disk_scheduled",
            "detail": "scenario expected a slow_disk event, trace has "
                      "none",
        })
        return out
    if not obs.get("slow_ops_raised"):
        out.append({
            "invariant": "slow_ops_never_raised",
            "detail": "SLOW_OPS never appeared in `ceph health` while "
                      f"osd(s) {obs['targets']} were slowed",
        })
    if not obs.get("outlier_flagged"):
        out.append({
            "invariant": "outlier_never_flagged",
            "detail": "mgr analytics never flagged the slowed osd as "
                      "a latency outlier",
        })
    if not obs.get("scrub_deprioritized"):
        out.append({
            "invariant": "scrub_never_deprioritized",
            "detail": "the slowed osd never received the mgr's "
                      "scrub_deprioritize verdict",
        })
    if not obs.get("scrub_deferred") and obs.get("target_leads_pg"):
        # only judged when the victim LED a pg (the scheduler only
        # schedules pgs this osd leads — no pg, nothing to defer)
        out.append({
            "invariant": "scrub_never_deferred",
            "detail": "the slowed osd led pgs but its scrub scheduler "
                      "never deferred a due scrub while flagged",
        })
    if not obs.get("slow_ops_cleared"):
        out.append({
            "invariant": "slow_ops_never_cleared",
            "detail": "SLOW_OPS still raised after the disk healed "
                      "and the cluster settled",
        })
    return out


def check_disk_faults(fsck_reports: list[dict]) -> list[dict]:
    """``fsck_reports``: per-OSD at-rest verification sweeps
    ({"osd": id, "bad": [...]}).  Any blob still failing its checksum
    after the run settled is injected damage the fault-tolerance chain
    (EIO-as-erasure decode-around, quarantine + background repair, pg
    repair) failed to heal."""
    out: list[dict] = []
    for rep in fsck_reports or []:
        if rep.get("bad"):
            out.append({
                "invariant": "unhealed_disk_damage", "osd": rep.get("osd"),
                "detail": rep["bad"],
            })
    return out


def check_events(obs: dict) -> list[dict]:
    """The cluster event plane under chaos (``obs`` is the runner's
    event-watcher record):

    - when the trace degraded the cluster (kills/outs/disk deaths),
      the mgr progress module must have OBSERVED it: at least one
      progress event, whose completion fraction is monotone
      non-decreasing, reaches 1.0, and is reaped post-settle;
    - every injected daemon death left a crash dump the crash module
      collected (``ceph crash ls``);
    - at settle — after the runner muted the EXPECTED codes
      (RECENT_CRASH for its own injected deaths) — zero UNMUTED
      unexpected health checks remain: chaos debris must not leave the
      operator staring at a warning nobody can explain.
    """
    out: list[dict] = []
    events: dict[str, dict] = obs.get("progress_events") or {}
    if obs.get("expect_progress") and not events:
        out.append({
            "invariant": "progress_never_observed",
            "detail": "the trace degraded the cluster but the mgr "
            "progress module never opened an event",
        })
    for eid, rec in sorted(events.items()):
        fr = rec.get("fractions") or []
        if any(b < a for a, b in zip(fr, fr[1:])):
            out.append({
                "invariant": "progress_regressed", "event": eid,
                "detail": f"completion fractions walked backwards: {fr}",
            })
        if rec.get("final", 0.0) < 1.0:
            out.append({
                "invariant": "progress_incomplete", "event": eid,
                "detail": f"never reached 1.0 (final "
                f"{rec.get('final')}, fractions {fr[-5:]})",
            })
        if not rec.get("reaped"):
            out.append({
                "invariant": "progress_not_reaped", "event": eid,
                "detail": "event still active after settle + grace",
            })
    crash_entities = obs.get("crash_entities") or set()
    for entity, n in sorted((obs.get("deaths") or {}).items()):
        if n > 0 and entity not in crash_entities:
            out.append({
                "invariant": "crash_missing", "entity": entity,
                "detail": f"{n} injected death(s) but no crash dump "
                "collected for it",
            })
    unexpected = sorted(
        set(obs.get("unmuted_checks") or [])
        - set(obs.get("allowed_checks") or []))
    if unexpected:
        out.append({
            "invariant": "unexpected_health_at_settle",
            "detail": f"unmuted health checks at settle: {unexpected}",
        })
    return out


#: write-error codes a partitioned client may legally observe: a
#: deadline firing (ETIMEDOUT), a transient bounce (EAGAIN), or the
#: resend budget exhausting (EIO).  Anything else — and any HANG,
#: which simply never records an error — is an objecter bug.
LEGAL_PARTITION_ERRNOS = frozenset(
    {errno.ETIMEDOUT, errno.EAGAIN, errno.EIO})


def check_client_netem(obs: dict) -> list[dict]:
    """The client-netem ack oracle (``obs`` is the runner's record):

    - the trace must have scheduled client-link faults AND at least
      one partition verdict must have actually BITTEN a client send
      (``client_partitioned_sends`` — an armed rule nothing hit proves
      nothing);
    - every write the objecter FAILED must carry a legal partition-
      facing errno (deadline ETIMEDOUT / EAGAIN / resend-budget EIO)
      — a silent hang records no error and no ack, and is caught by
      the workload never completing; an unexpected errno here is the
      driver misclassifying a partition;
    - zero lost/rolled-back ACKED writes is judged by check_history /
      check_final_reads over the same run (ETIMEDOUT and resend-
      duplicates are legal outcomes; silent loss is not).
    """
    out: list[dict] = []
    if not obs.get("client_events"):
        out.append({
            "invariant": "no_client_event_scheduled",
            "detail": "scenario expected client-link netem events, "
                      "trace has none",
        })
        return out
    stats = obs.get("netem") or {}
    if not stats.get("client_partitioned_sends"):
        out.append({
            "invariant": "client_partition_never_fired",
            "detail": "no client send ever hit an armed client-link "
                      f"partition (netem: {stats})",
        })
    for w in obs.get("errored_writes") or []:
        if w.get("errno") not in LEGAL_PARTITION_ERRNOS:
            out.append({
                "invariant": "illegal_client_error",
                "detail": f"write {w.get('pool')}/{w.get('oid')} "
                          f"v{w.get('version')} failed with errno="
                          f"{w.get('errno')} ({w.get('error')}); legal"
                          " under partition: ETIMEDOUT/EAGAIN/EIO",
            })
    return out


def check_fullness(obs: dict) -> list[dict]:
    """The fullness-pressure gating ladder (``obs`` is the fullness
    watcher's record).  Every rung must have been OBSERVED live and
    the whole ladder must clear after the drain:

    - OSD_NEARFULL and OSD_BACKFILLFULL health raised (mon statfs
      ingestion -> map bits -> health checks);
    - backfill actually PAUSED at backfillfull: a remote reservation
      answered REJECT_TOOFULL on the fullness branch
      (recovery.py ``backfill_reject_toofull`` counter grew);
    - OSD_FULL raised and a client write BOUNCED with ENOSPC while
      the map carried the FULL bit;
    - the local failsafe was never breached: no store's observed
      usage ratio reached osd_failsafe_full_ratio (the gate exists so
      the mon's full bit always engages first);
    - after the drain the entire ladder CLEARED and the cluster
      converged (convergence itself is check_converged's verdict).
    """
    out: list[dict] = []
    for key, name in (
        ("nearfull_raised", "OSD_NEARFULL"),
        ("backfillfull_raised", "OSD_BACKFILLFULL"),
        ("full_raised", "OSD_FULL"),
    ):
        if not obs.get(key):
            out.append({
                "invariant": "fullness_check_never_raised",
                "detail": f"{name} never appeared in `ceph health` "
                          "while the ladder was driven",
            })
    if not obs.get("backfill_rejects"):
        out.append({
            "invariant": "backfill_never_paused",
            "detail": "no REJECT_TOOFULL reservation was observed "
                      "while a backfillfull osd was a backfill target",
        })
    if not obs.get("enospc_bounced"):
        out.append({
            "invariant": "enospc_never_bounced",
            "detail": "no client write bounced ENOSPC while the map "
                      "carried a FULL bit",
        })
    peak = float(obs.get("failsafe_peak") or 0.0)
    failsafe = float(obs.get("failsafe_ratio") or 1.0)
    if peak >= failsafe:
        out.append({
            "invariant": "failsafe_breached",
            "detail": f"observed usage ratio {peak:.3f} >= "
                      f"osd_failsafe_full_ratio {failsafe:.3f}",
        })
    if not obs.get("ladder_cleared"):
        out.append({
            "invariant": "fullness_never_cleared",
            "detail": "fullness health checks still raised after the "
                      "drain and settle "
                      f"(remaining: {obs.get('checks_at_settle')})",
        })
    return out


def check_load(rec: dict, expected_tenants: list[str]) -> list[dict]:
    """The composed chaos x load verdict (``rec`` is the load
    harness's run record).  Production is thrash AND traffic at once,
    so the harness's whole gate set must hold THROUGH the thrash:

    - zero op errors and a fully-drained in-flight set (the objecter
      retried every op through the cuts/kills to completion);
    - the self-verifying payload sweep found zero lost/corrupt acked
      writes;
    - SLO percentiles present (client-side p50/p95/p99 computed over
      real completions);
    - the client-vs-mgr latency cross-check AGREES (the report plane
      survived the thrash too);
    - per-tenant ``qos_*`` fairness counters present for every
      profile tenant (the mClock gate differentiated under pressure);
    - cold_launches == 0 and host_transfers == 0 (also delta-checked
      cluster-wide by check_cold_launches).
    """
    out: list[dict] = []
    lat = (rec.get("latency") or {})
    if lat.get("errors"):
        out.append({
            "invariant": "load_op_errors",
            "detail": f"{lat['errors']} ops failed "
                      f"(samples: {rec.get('error_samples')})",
        })
    if rec.get("undrained"):
        out.append({
            "invariant": "load_undrained",
            "detail": f"{rec['undrained']} ops never completed",
        })
    v = rec.get("verify") or {}
    if v.get("mismatches") or v.get("lost"):
        out.append({
            "invariant": "load_acked_write_lost",
            "detail": f"payload sweep: {v}",
        })
    overall = lat.get("overall") or {}
    if not all(overall.get(k, 0) > 0
               for k in ("p50_us", "p95_us", "p99_us")):
        out.append({
            "invariant": "load_percentiles_missing",
            "detail": f"latency overall row: {overall}",
        })
    if not (rec.get("client_vs_mgr") or {}).get("agree"):
        out.append({
            "invariant": "load_mgr_crosscheck_failed",
            "detail": f"client_vs_mgr: {rec.get('client_vs_mgr')}",
        })
    qos = rec.get("qos") or {}
    missing = [t for t in expected_tenants
               if not (qos.get(t) or {}).get("admitted")]
    if missing:
        out.append({
            "invariant": "load_qos_rows_missing",
            "detail": f"tenants {missing} have no admitted ops in "
                      f"the qos fairness rows ({sorted(qos)})",
        })
    if rec.get("cold_launches"):
        out.append({
            "invariant": "load_cold_launches",
            "detail": f"{rec['cold_launches']} cold launches mid-load",
        })
    if rec.get("host_transfers"):
        out.append({
            "invariant": "load_host_transfers",
            "detail": f"{rec['host_transfers']} implicit transfers",
        })
    return out


def check_domains(obs: list[dict], expect_kill: bool = True) -> list[dict]:
    """Judge the failure-domain snapshots taken before correlated kills.

    Each record is a :meth:`ChaosCluster._domains_snapshot` — taken at
    the instant a rack/host kill fires, BEFORE the members die, so the
    placement it captures is the one the acked writes relied on.  Two
    claims per rack-domain pool:

    - separation: CRUSH put at most ONE shard/replica of any PG into
      any single rack (``max_shards_per_domain <= 1``) — otherwise a
      whole-rack loss could take out two shards of the same stripe and
      the durability story is fiction;
    - survivability: after deleting every OSD of the killed rack(s),
      every PG still holds >= ``need`` shards (k for EC, 1 replica for
      replicated), so every acked write stays readable through the
      correlated loss.
    """
    out: list[dict] = []
    if expect_kill and not obs:
        out.append({
            "invariant": "domains_no_kill_observed",
            "detail": "rack_script scenario recorded no rack/host kill "
                      "snapshots — the correlated-failure beat never fired",
        })
    for rec in obs:
        for name, p in (rec.get("pools") or {}).items():
            if p.get("max_shards_per_domain", 0) > 1:
                out.append({
                    "invariant": "domains_not_separated",
                    "detail": f"pool {name}: {p['max_shards_per_domain']} "
                              f"shards of one PG share a rack "
                              f"(kill={rec.get('killed_racks')})",
                })
            surv = p.get("min_surviving_shards")
            if surv is not None and surv < p.get("need", 1):
                out.append({
                    "invariant": "domains_insufficient_survivors",
                    "detail": f"pool {name}: only {surv} shard(s) survive "
                              f"rack loss {rec.get('killed_racks')}, "
                              f"need {p.get('need', 1)}",
                })
    return out


def check_backfill(obs: dict) -> list[dict]:
    """Judge a soak run's backfill evidence.

    ``obs`` is a cluster-wide delta of the ``backfill_started`` /
    ``backfill_completed`` perf counters across the run (the counters
    are process-global, so daemon restarts do not reset them).  A
    soak run exists to force the backfill path — trim pressure must
    have pushed the log tail past the revived member — so:

    - ``backfill_started > 0``: recovery actually took the backfill
      branch (if log-delta recovery sufficed, the trim pressure or
      outage length is miscalibrated and the scenario proves nothing);
    - ``backfill_completed > 0``: at least one pass converged;
    - with an interrupt scripted, ``started > completed``: the
      mid-transfer kill landed inside a pass (the cut-short pass
      starts but never completes; the re-run after revive does both).
    """
    out: list[dict] = []
    started = obs.get("backfill_started", 0)
    completed = obs.get("backfill_completed", 0)
    if started <= 0:
        out.append({
            "invariant": "backfill_never_ran",
            "detail": "backfill_started delta == 0: recovery never took "
                      "the backfill path despite soak trim pressure",
        })
    if completed <= 0:
        out.append({
            "invariant": "backfill_never_completed",
            "detail": f"backfill_completed delta == 0 "
                      f"(started={started}): no pass converged",
        })
    if obs.get("interrupt_scripted") and started <= completed:
        out.append({
            "invariant": "backfill_never_interrupted",
            "detail": f"started={started} <= completed={completed}: the "
                      f"scripted mid-transfer kill missed every pass",
        })
    return out


#: checker registry: name -> callable, for reporting
ALL_INVARIANTS = (
    "history", "final_reads", "converged", "quorum", "scrub",
    "disk_faults", "cold_launches", "mgr", "slow_osd", "events",
    "client_netem", "fullness", "load", "domains", "backfill",
)


def touched_checkers(result: dict) -> list[str]:
    """Which checkers a finished run gave NONZERO WORK — the fuzz
    plane's coverage signal (a checker that merely ran against an
    empty observation record proves nothing was exercised).  Judged
    from the run's result record alone so committed artifacts replay
    the same answer; a checker that was judged at all counts only
    when its domain shows evidence: writes for the history oracles,
    injected deltas for disk faults, observed sends for netem, raised
    rungs for fullness, and so on."""
    judged = set(result.get("invariants") or ())
    wl = result.get("workload") or {}
    cov = result.get("coverage") or {}
    deltas = cov.get("perf_deltas") or {}
    out: set[str] = set()
    if wl.get("writes", 0) or wl.get("load_ops", 0):
        out |= {"history", "final_reads"} & judged
    if result.get("events_applied", 0):
        out |= {"converged", "quorum", "scrub"} & judged
    if result.get("disk_faults"):
        out.add("disk_faults")
    if "cold_launches" in judged:
        out.add("cold_launches")
    if "mgr" in judged and (
            any(k.startswith("mgr.")
                for k in (cov.get("deaths") or {}))
            or any(k.startswith("mgr_analytics.") and v
                   for k, v in deltas.items())):
        # a failover the report plane absorbed, or analytics that
        # verifiably digested this run's reports
        out.add("mgr")
    slow = result.get("slow_osd_obs") or {}
    if slow.get("slow_ops_raised"):
        out.add("slow_osd")
    ev = result.get("events_obs") or {}
    if ev.get("events") or ev.get("deaths") or ev.get(
            "crash_entities"):
        out.add("events")
    cn = result.get("client_netem_obs") or {}
    if (cn.get("client_partitioned_sends")
            or cn.get("client_dropped_sends")
            or cn.get("client_delayed_sends")):
        out.add("client_netem")
    fl = result.get("fullness_obs") or {}
    if (fl.get("nearfull_raised") or fl.get("backfillfull_raised")
            or fl.get("full_raised")):
        out.add("fullness")
    if result.get("load"):
        out.add("load")
    if result.get("domains_obs"):
        out.add("domains")
    bf = result.get("backfill_obs") or {}
    if bf.get("backfill_started", 0) > 0:
        out.add("backfill")
    elif "backfill" not in judged and (
            deltas.get("backfill_started", 0) > 0):
        # cross-bred traces run backfill in scenarios that never
        # judged check_backfill: the counter movement IS the touch
        out.add("backfill")
    if any(k.startswith("tier_") and v for k, v in deltas.items()):
        # tier machinery moved: the history oracles judged redirects
        out.add("tier")
    return sorted(out)

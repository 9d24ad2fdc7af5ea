"""chaos_run — drive chaos scenarios over seed sweeps, emit the artifact.

Twin of the JAX package's ``tools/chaos_run.py``, over the port's chaos
engine (``ceph_tpu_torch/chaos/``): each (scenario, seed) run boots a
fresh mini-cluster, replays the seed's deterministic event trace under
a recording workload, and judges every durability invariant; the
aggregate is the same ``ceph_tpu.chaos/v1`` JSON document.

    python -m ceph_tpu_torch.tools.chaos_run \
        --scenarios osd_thrash,netem_storm,quorum_thrash --seeds 8 --out chaos.json

Replay a single failing seed with full logging:

    python -m ceph_tpu_torch.tools.chaos_run --scenarios netem_storm --seed 5 -v

Long-soak mode — stretch the soak scenarios into minutes-long paced
traces (trim pressure + long outage force the backfill path):

    python -m ceph_tpu_torch.tools.chaos_run --soak --seeds 4

``--device`` (default ``cuda``) is the daemons' device; ``--device cpu``
runs the whole matrix on the CPU.  ``--lint`` first runs the port's
ctlint (``python -m ceph_tpu_torch.tools.lint``) in a subprocess and
aborts the sweep with its exit code unless it is clean.
"""

from __future__ import annotations

import argparse
import json
import logging
import subprocess
import sys

#: the preflight's lint command (run from the repository root)
LINT_COMMAND = [sys.executable, "-m", "ceph_tpu_torch.tools.lint"]


def lint_preflight() -> int:
    """Run the port's lint in a subprocess; its exit code (0 = clean:
    no new finding, no stale or dead baseline entry)."""
    from ceph_tpu_torch.tools import REPO_ROOT, child_env

    return subprocess.run(LINT_COMMAND, cwd=REPO_ROOT, env=child_env()).returncode


def main(argv=None) -> int:
    from ceph_tpu_torch.chaos.runner import SCENARIOS, run_sweep
    from ceph_tpu_torch.chaos.schedule import generate_schedule, trace_hash
    from ceph_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--scenarios", default="all",
        help="comma-separated scenario names, or 'all' "
        f"(known: {','.join(sorted(SCENARIOS))})")
    ap.add_argument(
        "--seeds", type=int, default=8,
        help="sweep seeds 0..N-1 per scenario (default 8)")
    ap.add_argument(
        "--seed", type=int, default=None,
        help="run exactly ONE seed instead of a sweep (replay mode)")
    ap.add_argument(
        "--time-scale", type=float, default=1.0,
        help="stretch/compress the virtual event timeline")
    ap.add_argument(
        "--soak", nargs="?", type=float, const=6.0, default=None,
        metavar="SCALE",
        help="long-soak mode: select the soak_script scenarios (when "
        "--scenarios is 'all') and stretch BOTH the event timeline and "
        "the paced workload by SCALE (default 6x -> minutes-long runs) "
        "so revived members provably fall behind the trim horizon and "
        "recovery must take the backfill path; trace hashes are "
        "unchanged (replay pacing only)")
    ap.add_argument(
        "--profile", default=None,
        help="chaos x load COMPOSITION: replay these loadgen "
        "profile(s) (comma-separated) THROUGH the thrash trace of "
        "each scenario/seed in one run; --out then writes a "
        "loadgen-schema artifact whose runs carry a chaos block "
        "(default scenario: compose_load)")
    ap.add_argument(
        "--clients", type=int, default=None,
        help="with --profile: override the profile's client count")
    ap.add_argument(
        "--ops", type=int, default=None,
        help="with --profile: override ops per client")
    ap.add_argument(
        "--out", default=None,
        help="write the aggregate artifact JSON here")
    ap.add_argument(
        "--trace-only", action="store_true",
        help="print each (scenario, seed) trace hash and event list "
        "without touching a cluster (pure replay check)")
    ap.add_argument(
        "--lint", action="store_true",
        help="ctlint preflight: abort the sweep unless the port's lint "
        "(python -m ceph_tpu_torch.tools.lint) is clean (no new "
        "findings, no stale/dead baseline entries) "
        "— chaos evidence is only meaningful for a tree that honors "
        "the static invariants it claims")
    ap.add_argument(
        "--device", default="cuda",
        help="the daemons' device (default cuda; cpu runs on the host)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    if args.lint:
        rc = lint_preflight()
        if rc != 0:
            print(f"chaos_run: ctlint preflight failed (exit {rc}) — "
                  f"fix/baseline findings before sweeping", file=sys.stderr)
            return rc

    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    if args.profile is not None:
        return _run_composed(args)

    names = (
        sorted(SCENARIOS) if args.scenarios == "all"
        else [s for s in args.scenarios.split(",") if s]
    )
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenarios {unknown}; known: {sorted(SCENARIOS)}")
    seeds = [args.seed] if args.seed is not None else list(range(args.seeds))

    overrides = None
    if args.soak is not None:
        scale = max(1.0, args.soak)
        if args.scenarios == "all":
            names = [n for n in names if SCENARIOS[n].get("soak_script")]
        if not any(SCENARIOS[n].get("soak_script") for n in names):
            ap.error("--soak needs at least one soak_script scenario "
                     "(e.g. soak-trim-backfill)")
        args.time_scale *= scale
        # stretch the paced writers to keep spanning the (now longer)
        # outage — rounds scale, write_gap stays, so the trim horizon
        # still provably overtakes the down member's log tail; the
        # workload is not part of the trace, so hashes are unchanged
        overrides = {}
        for n in names:
            sc = dict(SCENARIOS[n])
            if sc.get("soak_script") and sc.get("workload"):
                wl = dict(sc["workload"])
                wl["rounds"] = int(wl.get("rounds", 3) * scale)
                sc["workload"] = wl
            overrides[n] = sc

    if args.trace_only:
        for name in names:
            for seed in seeds:
                ev = generate_schedule(seed, SCENARIOS[name])
                print(f"{name} seed={seed} events={len(ev)} "
                      f"trace={trace_hash(ev)}")
                if args.verbose:
                    for e in ev:
                        print(f"  t={e.t:<7} {e.kind} {e.args}")
        return 0

    artifact = run_sweep(names, seeds, time_scale=args.time_scale,
                         scenarios=overrides,
                         device=resolve_device(args.device))
    for run in artifact["runs"]:
        status = "green" if run.get("ok") else "RED"
        print(f"{run['scenario']:<16} seed={run['seed']:<3} {status:<6} "
              f"events={run.get('events_applied', '?')} "
              f"trace={str(run.get('trace_hash', ''))[:12]} "
              f"wall={run.get('wall_s', '?')}s")
        if not run.get("ok"):
            bad = run.get("crash") or {
                k: v["violations"]
                for k, v in run.get("invariants", {}).items()
                if not v["ok"]
            }
            print(f"  -> {json.dumps(bad, default=str)[:500]}")
    s = artifact["summary"]
    print(f"\n{s['green']}/{s['total']} runs green")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if s["all_green"] else 1


def _run_composed(args) -> int:
    """chaos x load composition: for each profile x seed, run the
    composed scenario (its thrash trace + the profile's load trace in
    ONE run) and emit a loadgen-schema artifact whose runs carry the
    chaos verdicts — the production-is-both-at-once proof."""
    from ceph_tpu_torch.chaos.runner import SCENARIOS, run_sweep
    from ceph_tpu_torch.loadgen.report import build_artifact
    from ceph_tpu_torch.tools import resolve_device

    base_name = (args.scenarios if args.scenarios != "all"
                 else "compose_load")
    if "," in base_name or base_name not in SCENARIOS:
        print(f"chaos_run: --profile needs ONE composed scenario "
              f"(got {base_name!r})", file=sys.stderr)
        return 2
    seeds = ([args.seed] if args.seed is not None
             else list(range(args.seeds)))
    load_recs = []
    for prof in [p for p in args.profile.split(",") if p]:
        sc = dict(SCENARIOS[base_name])
        sc["load_profile"] = {
            "profile": prof, "clients": args.clients,
            "ops_per_client": args.ops,
        }
        art = run_sweep([base_name], seeds, time_scale=args.time_scale,
                        scenarios={base_name: sc},
                        device=resolve_device(args.device))
        for run in art["runs"]:
            rec = run.get("load")
            if rec is None:
                rec = {"profile": prof, "seed": run["seed"],
                       "ok": False,
                       "error": run.get("crash", "no load record")}
            else:
                rec = dict(rec)
            rec["chaos"] = {
                "scenario": run["scenario"],
                "trace_hash": run.get("trace_hash"),
                "events_applied": run.get("events_applied"),
                "invariants_ok": run.get("ok", False),
                "netem": run.get("netem", {}),
            }
            # a composed run is green only when BOTH planes are
            rec["ok"] = bool(rec.get("ok")) and bool(run.get("ok"))
            load_recs.append(rec)
            lat = (rec.get("latency") or {}).get("overall", {})
            print(f"{prof:<14} seed={rec['seed']:<3} "
                  f"{'green' if rec['ok'] else 'RED':<6} "
                  f"ops={rec.get('ops_completed', '?')} "
                  f"p99={lat.get('p99_us', '?')}us "
                  f"chaos_events={rec['chaos']['events_applied']} "
                  f"trace={str(rec['chaos']['trace_hash'])[:12]}")
            if not rec["ok"] and not run.get("ok"):
                bad = run.get("crash") or {
                    k: v["violations"]
                    for k, v in run.get("invariants", {}).items()
                    if not v["ok"]
                }
                print(f"  -> {json.dumps(bad, default=str)[:400]}")
    doc = build_artifact(load_recs)
    green = doc["summary"]["green"]
    print(f"\n{green}/{doc['summary']['total']} composed runs green")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if doc["summary"]["all_green"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

"""chaos_fuzz — coverage-guided fuzzing over chaos event traces.

Twin of the JAX package's ``tools/chaos_fuzz.py``, over the port's fuzz
plane (``ceph_tpu_torch/fuzz/``).  The campaign seeds its corpus with
every scenario's deterministic seed-0 trace, then spends a bounded
mutant budget: pick a corpus parent, derive a mutant from
``(parent_trace_hash, mutation_seed)`` (``fuzz/mutate.py``), replay it on
a fresh mini-cluster, and admit it iff its coverage fingerprint
(checkers touched, perf-counter families moved, lifecycle edges —
``fuzz/coverage.py``) shows a feature no corpus entry has produced.  The
whole campaign is deterministic given ``--seed``; the aggregate is the
same ``ceph_tpu.fuzz/v1`` JSON document, written where ``--out`` says,
every trace re-derivable from its recorded lineage.

    python -m ceph_tpu_torch.tools.chaos_fuzz --seed 0 --budget 16 --out fuzz.json

Quick smoke (one scenario, two mutants):

    python -m ceph_tpu_torch.tools.chaos_fuzz --scenarios osd_thrash --budget 2

Resume a prior campaign's corpus (its traces are NOT re-run):

    python -m ceph_tpu_torch.tools.chaos_fuzz --corpus fuzz.json --budget 8

``--device`` (default ``cuda``) is the daemons' device; ``--device cpu``
runs the campaign on the host.
"""

from __future__ import annotations

import argparse
import json
import logging


def main(argv=None) -> int:
    from ceph_tpu_torch.chaos.runner import SCENARIOS
    from ceph_tpu_torch.fuzz.runner import run_campaign
    from ceph_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument(
        "--seed", type=int, default=0,
        help="campaign seed: parent selection + mutation seeds derive "
        "from it alone (default 0)")
    ap.add_argument(
        "--budget", type=int, default=16,
        help="mutant runs to spend after seeding (default 16)")
    ap.add_argument(
        "--scenarios", default="all",
        help="comma-separated scenario names to seed from, or 'all' "
        f"(known: {','.join(sorted(SCENARIOS))})")
    ap.add_argument(
        "--corpus", default=None,
        help="resume from a prior FUZZ artifact's corpus (path); its "
        "traces keep their slots and fingerprints, only NEW mutants run")
    ap.add_argument(
        "--time-scale", type=float, default=1.0,
        help="stretch/compress the virtual event timeline")
    ap.add_argument(
        "--settle-timeout", type=float, default=90.0,
        help="post-trace convergence deadline per run (default 90s)")
    ap.add_argument(
        "--out", default=None,
        help="write the campaign artifact JSON here")
    ap.add_argument(
        "--device", default="cuda",
        help="the daemons' device (default cuda; cpu runs on the host)")
    ap.add_argument("-v", "--verbose", action="store_true")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")

    names = (
        sorted(SCENARIOS) if args.scenarios == "all"
        else [s for s in args.scenarios.split(",") if s]
    )
    unknown = [n for n in names if n not in SCENARIOS]
    if unknown:
        ap.error(f"unknown scenarios {unknown}; known: {sorted(SCENARIOS)}")
    # compose_load needs a loadgen profile wired in; the fuzzer drives
    # plain chaos traces, so it seeds from every OTHER scenario
    names = [n for n in names if n != "compose_load"]

    corpus_in = None
    if args.corpus:
        with open(args.corpus) as f:
            corpus_in = json.load(f)["corpus"]
        print(f"resuming corpus: {len(corpus_in)} entries "
              f"from {args.corpus}")

    artifact = run_campaign(
        seed=args.seed, budget=args.budget, scenario_names=names,
        time_scale=args.time_scale, settle_timeout=args.settle_timeout,
        corpus_in=corpus_in, device=device)

    for run in artifact["runs"]:
        status = "green" if run.get("ok") else "RED"
        print(f"{run['scenario']:<18} {status:<6} "
              f"events={run.get('n_events', '?')} "
              f"trace={str(run.get('trace_hash', ''))[:12]} "
              f"wall={run.get('wall_s', '?')}s")
    for red in artifact["reds"]:
        print(f"  RED {red['scenario']} trace={red['trace_hash'][:12]} "
              f"via {red['mutation_kind']}: "
              f"{json.dumps(red.get('crash') or red['violations'], default=str)[:300]}")
    s = artifact["summary"]
    print(f"\n{s['green']}/{s['runs']} runs green | corpus "
          f"{s['corpus_size']} ({s['corpus_seeds']} seeds + "
          f"{s['corpus_mutants']} mutants) | {s['features']} features | "
          f"mutations {artifact['mutation_stats']}")
    demo = artifact["minimize_demo"]
    print(f"minimize demo: {demo['input_events']} events -> kernel "
          f"{demo['kernel_kinds']} (exact={demo['found_exact_kernel']})")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1, sort_keys=True, default=str)
            f.write("\n")
        print(f"wrote {args.out}")
    return 0 if s["all_green"] else 1


if __name__ == "__main__":
    raise SystemExit(main())

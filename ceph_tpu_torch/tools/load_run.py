"""load_run: drive the million-user load harness (``ceph_tpu_torch/loadgen/``).

Twin of the JAX package's ``tools/load_run.py``.  Boots an embedded
vstart-twin cluster (or connects to a running one with -m for
rados/ec-only profiles), replays the deterministic (seed, profile)
trace open-loop, and reports client-side p50/p95/p99 + throughput
cross-checked against the mgr analytics digest.

  python -m ceph_tpu_torch.tools.load_run --profile mixed --clients 2000 --seed 1
  python -m ceph_tpu_torch.tools.load_run --profile mixed,rmw_ec --seed 1 --out load.json
  python -m ceph_tpu_torch.tools.load_run --profile rados_rw -m 127.0.0.1:6789

``--device`` (default ``cuda``) is the embedded daemons' device and the
one whose batchers the cold-launch check reads; ``--device cpu`` runs
on the host.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def _parse_mon(spec: str) -> list[tuple[str, int]]:
    out = []
    for part in spec.split(","):
        host, _, port = part.strip().rpartition(":")
        out.append((host or "127.0.0.1", int(port)))
    return out


def main(argv=None) -> int:
    from ceph_tpu_torch.loadgen import resolve_profile
    from ceph_tpu_torch.loadgen.driver import run_profile
    from ceph_tpu_torch.loadgen.report import build_artifact
    from ceph_tpu_torch.tools import resolve_device

    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--profile", default="mixed",
                    help="profile name(s), comma-separated "
                         "(mixed, rmw_ec, rados_rw)")
    ap.add_argument("--clients", type=int, default=None,
                    help="override the profile's simulated-client "
                         "count")
    ap.add_argument("--ops", type=int, default=None,
                    help="override ops per client")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--time-scale", type=float, default=1.0,
                    help="stretch (>1) or compress (<1) the trace's "
                         "virtual timeline")
    ap.add_argument("-m", "--mon", default="",
                    help="connect to a running cluster "
                         "(host:port[,host:port]) instead of booting "
                         "one; rados/ec profiles only")
    ap.add_argument("--out", default="",
                    help="write the artifact JSON here")
    ap.add_argument("--device", default="cuda",
                    help="the daemons' device (default cuda; cpu runs "
                         "on the host)")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    monmap = _parse_mon(args.mon) if args.mon else None
    runs = []
    for name in args.profile.split(","):
        profile = resolve_profile(
            name.strip(), clients=args.clients,
            ops_per_client=args.ops)
        print(f"load_run: profile={profile['name']} "
              f"clients={profile['clients']} seed={args.seed}",
              flush=True)
        loop = asyncio.new_event_loop()
        try:
            rec = loop.run_until_complete(run_profile(
                profile, args.seed, time_scale=args.time_scale,
                monmap=monmap, device=device))
        finally:
            loop.close()
        runs.append(rec)
        lat = rec["latency"]["overall"]
        print(
            f"  {'OK' if rec['ok'] else 'RED'}  "
            f"{rec['ops_completed']}/{rec['ops_scheduled']} ops, "
            f"{rec['throughput_ops_s']} ops/s, "
            f"p50={lat['p50_us']}us p95={lat['p95_us']}us "
            f"p99={lat['p99_us']}us, errors={rec['latency']['errors']}, "
            f"mgr-agree={rec['client_vs_mgr']['agree']}, "
            f"cold={rec['cold_launches']} "
            f"transfers={rec['host_transfers']}",
            flush=True)
    doc = build_artifact(runs)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"load_run: artifact -> {args.out}", flush=True)
    return 0 if doc["summary"]["all_green"] else 1


if __name__ == "__main__":
    sys.exit(main())

"""Where a ``compose_load`` chaos run's seconds go, on the CPU.

    JAX_PLATFORMS=cpu python tests/compose_load_pace.py [--runs N] [--seed S]

Each run is ``chaos_run --scenarios compose_load --seed S --device cpu``'s
run (the port's ``run_scenario``), in a process of its own, with timers
wrapped around it from outside; nothing in the package changes.  One
JSON line a run:

- ``wall_s``, ``ok``, ``trace_hash``: the run's own record;
- ``start_s``: ``ChaosCluster.start`` (boot, pools, the wait for every
  daemon's EC warmup), and ``await_warmup_s``, the last of these;
- ``warm_s``: for each OSD, the seconds each of its map-time EC warmup
  threads ran (``OSDDaemon._warm_ec_profiles``: one a map that brings a
  new profile, and one again in a revived daemon), and ``warm_end_s``,
  when each ended, counted from the start of ``ChaosCluster.start``;
- ``prewarm_s``: the summed seconds of the decode aggregator's, the
  scrub verifier's and the encode service's ``prewarm`` over all OSDs
  (threads run at once, so the sum may exceed the wall);
- ``after_start_s``: the trace, the settle and the checks
  (``wall_s - start_s``).

A last line gives the median and the largest of ``wall_s``,
``start_s`` and ``after_start_s``.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import statistics
import subprocess
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _one(seed: int) -> dict:
    from ceph_tpu_torch.chaos import runner
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.parallel import decode_batcher, encode_service, scrub_batcher

    clock = time.monotonic
    times: dict = {"warm_s": {}, "warm_end_s": {}, "prewarm_s": {}}
    lock = threading.Lock()
    t_start = [0.0]

    start, await_warmup = runner.ChaosCluster.start, runner.ChaosCluster._await_warmup

    async def timed_start(self):
        t_start[0] = t0 = clock()
        try:
            await start(self)
        finally:
            times["start_s"] = clock() - t0

    async def timed_await_warmup(self, *a, **kw):
        t0 = clock()
        try:
            await await_warmup(self, *a, **kw)
        finally:
            times["await_warmup_s"] = clock() - t0

    warm = OSDDaemon._warm_ec_profiles

    def timed_warm(self):
        before = set(self._warm_tasks)
        warm(self)
        for task in set(self._warm_tasks) - before:
            t0 = clock()

            def done(_t, osd=self.id, t0=t0):
                now = clock()
                times["warm_s"].setdefault(f"osd.{osd}", []).append(round(now - t0, 3))
                times["warm_end_s"].setdefault(f"osd.{osd}", []).append(
                    round(now - t_start[0], 3))

            task.add_done_callback(done)

    def timed_prewarm(cls, label):
        orig = cls.prewarm

        def prewarm(self, *a, **kw):
            t0 = clock()
            try:
                return orig(self, *a, **kw)
            finally:
                with lock:
                    times["prewarm_s"][label] = times["prewarm_s"].get(label, 0.0) + clock() - t0

        cls.prewarm = prewarm

    runner.ChaosCluster.start = timed_start
    runner.ChaosCluster._await_warmup = timed_await_warmup
    OSDDaemon._warm_ec_profiles = timed_warm
    timed_prewarm(decode_batcher.DecodeAggregator, "decode_aggregator")
    timed_prewarm(scrub_batcher.ScrubVerifier, "scrub_verifier")
    timed_prewarm(encode_service.EncodeService, "encode_service")

    res = asyncio.run(runner.run_scenario("compose_load", seed, device="cpu"))
    times["prewarm_s"] = {k: round(v, 3) for k, v in times["prewarm_s"].items()}
    return {"seed": seed, "ok": res["ok"], "trace_hash": res["trace_hash"],
            "wall_s": res["wall_s"], "start_s": round(times.get("start_s", 0.0), 3),
            "await_warmup_s": round(times.get("await_warmup_s", 0.0), 3),
            "after_start_s": round(res["wall_s"] - times.get("start_s", 0.0), 3),
            **{k: times[k] for k in ("warm_s", "warm_end_s", "prewarm_s")}}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--one", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.one:
        sys.path.insert(0, ROOT)
        print(json.dumps(_one(args.seed)), flush=True)
        return 0
    lines = []
    for _ in range(args.runs):
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--one",
                              "--seed", str(args.seed)],
                             cwd=ROOT, check=True, capture_output=True, text=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        lines.append(line)
    print(json.dumps({k: {"median": statistics.median(ln[k] for ln in lines),
                          "max": max(ln[k] for ln in lines)}
                      for k in ("wall_s", "start_s", "after_start_s")}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Replay ``osd_thrash`` seed 0 on the CPU with a stall planted before the
first EC decode of the process: the test-only injection that reproduces,
in either package, the acked-write loss the H100 shows when that scenario
is a process's first chaos run (ROADMAP Queue 3).

    python tests/thrash_stall.py --package port --mode block --stall 30
    python tests/thrash_stall.py --package ref --mode async --stall 30

``--mode block`` stalls the event loop itself (every daemon of the
process waits: heartbeats lapse, peers are reported failed and re-boot);
``--mode async`` stalls only the decoding op (the others run on). The
stall is planted by wrapping the OSD's degraded-read decode
(``OSDDaemon._ecu_decode_concat``) and the recovery decode
(``ecutil.decode_shards_async``) of the chosen package, so no program
code changes. One line a run: the verdict, the wall seconds and each red
invariant's violations.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import sys
import threading
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def plant(package: str, mode: str, seconds: float) -> threading.Event:
    """Wrap the package's two EC decode entry points so the first call
    in the process stalls for ``seconds``; returns the event set when it
    did."""
    daemon = importlib.import_module(f"{package}.osd.daemon")
    ecutil = importlib.import_module(f"{package}.osd.ecutil")
    fired = threading.Event()

    async def stall() -> None:
        if fired.is_set():
            return
        fired.set()
        if mode == "async":
            await asyncio.sleep(seconds)
        else:
            time.sleep(seconds)

    concat = daemon.OSDDaemon._ecu_decode_concat

    async def decode_concat(self, *args, **kwargs):
        await stall()
        return await concat(self, *args, **kwargs)

    shards = ecutil.decode_shards_async

    async def decode_shards(*args, **kwargs):
        await stall()
        return await shards(*args, **kwargs)

    daemon.OSDDaemon._ecu_decode_concat = decode_concat
    ecutil.decode_shards_async = decode_shards
    return fired


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--package", choices=("port", "ref"), default="port")
    ap.add_argument("--mode", choices=("block", "async"), default="block")
    ap.add_argument("--stall", type=float, default=30.0, help="seconds")
    ap.add_argument("--scenario", default="osd_thrash")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    sys.path.insert(0, ROOT)
    package = "ceph_tpu_torch" if args.package == "port" else "ceph_tpu"
    fired = plant(package, args.mode, args.stall)
    runner = importlib.import_module(f"{package}.chaos.runner")
    kw = {"device": "cpu"} if args.package == "port" else {}
    t0 = time.perf_counter()
    res = asyncio.run(runner.run_scenario(args.scenario, args.seed, **kw))
    red = {k: v.get("violations") for k, v in (res.get("invariants") or {}).items()
           if not v["ok"]}
    print(json.dumps({"package": package, "scenario": args.scenario, "seed": args.seed,
                      "mode": args.mode, "stall_s": args.stall, "stalled": fired.is_set(),
                      "ok": bool(res.get("ok")), "seconds": time.perf_counter() - t0,
                      "trace_hash": res.get("trace_hash"), "red": red}))
    return 0 if res.get("ok") else 1


if __name__ == "__main__":
    sys.exit(main())

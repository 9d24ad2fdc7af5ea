"""ceph_erasure_code_benchmark: the EC plugin timing harness.

Twin of the JAX package's ``tools/ec_benchmark.py`` (Ceph's
src/test/erasure-code/ceph_erasure_code_benchmark.cc flag surface;
qa/workunits/erasure-code/bench.sh computes GiB/s from the
"seconds<TAB>KiB" output):

  python -m ceph_tpu_torch.tools.ec_benchmark --plugin cuda --workload encode \\
      --size 1048576 --iterations 64 --parameter k=8 --parameter m=3

  python -m ceph_tpu_torch.tools.ec_benchmark --plugin jerasure --workload decode \\
      --erasures 2 --erasures-generation exhaustive --size 65536 --iterations 16 \\
      --parameter k=4 --parameter m=2 --parameter technique=reed_sol_van

``--device`` (default ``cuda``) is the plugin's device; ``--device cpu``
runs the CPU path.  Prints "<seconds>\\t<KiB processed>" exactly like the
reference, plus a GB/s line on stderr for humans.  An exhaustive decode
asserts that every decoded chunk equals the encoded one.
"""

from __future__ import annotations

import argparse
import itertools
import random
import sys
import time

import numpy as np

from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.tools import resolve_device


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--plugin", "-p", default="cuda")
    ap.add_argument("--workload", "-w", default="encode", choices=("encode", "decode"))
    ap.add_argument("--size", "-s", type=int, default=1 << 20,
                    help="buffer size per iteration")
    ap.add_argument("--iterations", "-i", type=int, default=16)
    ap.add_argument("--erasures", "-e", type=int, default=1)
    ap.add_argument("--erasures-generation", "-E", default="random",
                    choices=("random", "exhaustive"))
    ap.add_argument("--parameter", "-P", action="append", default=[],
                    help="k=V / m=V / technique=V ... (repeatable)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    profile = {"plugin": args.plugin}
    for p in args.parameter:
        k, _, v = p.partition("=")
        profile[k] = v
    ec = registry.factory(args.plugin, profile, device=device)
    k = ec.get_data_chunk_count()
    n = ec.get_chunk_count()

    rng = np.random.default_rng(0)
    data = rng.integers(0, 256, args.size, dtype=np.uint8).tobytes()

    if args.workload == "encode":
        total = 0
        t0 = time.perf_counter()
        for _ in range(args.iterations):
            ec.encode(set(range(n)), data)
            total += args.size
        dt = time.perf_counter() - t0
    else:
        encoded = ec.encode(set(range(n)), data)
        if args.erasures_generation == "exhaustive":
            patterns = list(itertools.combinations(range(n), args.erasures))
        else:
            rnd = random.Random(42)
            patterns = [tuple(rnd.sample(range(n), args.erasures))
                        for _ in range(args.iterations)]
        total = 0
        t0 = time.perf_counter()
        for i in range(args.iterations):
            lost = patterns[i % len(patterns)]
            avail = {s: c for s, c in encoded.items() if s not in lost}
            decoded = ec.decode(set(lost), avail)
            total += args.size
            if args.erasures_generation == "exhaustive":
                for s in lost:
                    if not np.array_equal(decoded[s], encoded[s]):
                        raise AssertionError(f"round-trip mismatch on {lost}")
        dt = time.perf_counter() - t0

    print(f"{dt:.6f}\t{total // 1024}", flush=True)
    print(f"# {args.plugin} {args.workload} k={k} m={n - k} on {device}: "
          f"{total / dt / 1e9:.3f} GB/s", file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

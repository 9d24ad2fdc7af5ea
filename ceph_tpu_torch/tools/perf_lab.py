"""Kernel perf lab: where the RS-encode time goes on the card.

Twin of the JAX package's ``tools/perf_lab.py``.  Run on the card:

    python -m ceph_tpu_torch.tools.perf_lab [--device cuda] [--calls 10] [--reps 3]

Each line is ``name  ms  GB/s``: the best over ``--reps`` of the mean
time of ``--calls`` calls.  The encode lines count the k data rows' bytes
(as the reference does); the two copy lines count read plus write
traffic.  ``--device cpu`` runs the plain versions (use small
``--cols``); its times are the CPU's, not the card's.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import lab_kernels as lk
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.tools import MiB, int_list, random_bytes, resolve_device, sync

K, M = 8, 3


def _line(name: str, seconds: float, nbytes: int) -> float:
    gbs = nbytes / seconds / 1e9
    print(f"{name:44s} {seconds * 1e3:10.4f} ms  {gbs:9.2f} GB/s", flush=True)
    return gbs


def timed_calls(name, fn, data, device, n=10, reps=3, nbytes=None) -> float:
    """Time ``fn(data)`` dispatched n times back to back (no dependency)."""
    fn(data)
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        outs = [fn(data) for _ in range(n)]
        sync(device)
        best = min(best, (time.perf_counter() - t0) / n)
        del outs
    return _line(name, best, data.numel() if nbytes is None else nbytes)


def timed_chain(name, body_fn, data, device, n=10, reps=3) -> float:
    """Time n calls of ``body_fn(d)``, each updating ``d`` in place (a
    dependency chain; the reference's ``fori_loop``), on a copy of
    ``data``."""
    d = data.clone()
    body_fn(d)
    sync(device)
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            body_fn(d)
        d[0, :8].cpu()
        best = min(best, (time.perf_counter() - t0) / n)
    return _line(name, best, data.numel())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cols", type=int, default=64 * MiB, help="S, bytes a data row")
    ap.add_argument("--tile", type=int, default=262144)
    ap.add_argument("--tiles", type=int_list, default=[65536, 131072, 262144])
    ap.add_argument("--fat-rows", type=int, default=1024)
    ap.add_argument("--fat-keep", type=int, default=384)
    ap.add_argument("--fat-cols", type=int, default=2 ** 19)
    ap.add_argument("--calls", type=int, default=10)
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, reps, s = args.calls, args.reps, args.cols

    codec = rk.BitmatrixCodec(isa_cauchy_matrix(K, M), device=device)
    bits = codec.encode_bits
    data = random_bytes((K, s), 0, device)
    big = random_bytes((args.fat_rows, args.fat_cols), 1, device)
    sync(device)

    def enc(d):
        return rk.gf_bitmatmul_pallas(bits, d, tile_s=args.tile)

    def fold(d):
        d[0:1].bitwise_xor_(d[1:2])

    def enc_fold(d):
        d[0:1].bitwise_xor_(enc(d)[0:1])

    def enc_fold_128(d):
        d[0:1, 0:128].bitwise_xor_(enc(d)[0:1, 0:128])

    # 1. chain overhead only: xor-fold with a slice of d itself (no kernel)
    timed_chain("chain xor-fold only (no kernel)", fold, data, device, n, reps)
    # 2. bare copy kernel, independent dispatches (read + write traffic)
    timed_calls("copy kernel, no chain (r+w traffic GB/s)", lambda d: lk.row_copy(d, M),
                data, device, n, reps, nbytes=2 * M * s)
    # 3. bare encode kernel, independent dispatches
    timed_calls("encode pallas, no chain", enc, data, device, n, reps)
    # 4. encode + chain (bench.py's loop before the acc kernel)
    timed_chain("encode pallas + xor-fold chain (bench.py)", enc_fold, data, device, n, reps)
    # 5. cheap chain: fold only 128 lanes
    timed_chain("encode pallas + 128-lane fold chain", enc_fold_128, data, device, n, reps)
    # 6. the batched (XLA in the reference) entry point
    timed_calls("encode XLA path, no chain", lambda d: rk.gf_bitmatmul(bits, d),
                data, device, min(n, 3), reps)
    # 7. fat-shape copy roofline: the first fat_keep rows of (fat_rows, fat_cols)
    timed_calls(f"fat copy ({args.fat_keep}x{args.fat_cols} r+w traffic GB/s)",
                lambda d: lk.row_copy(d, args.fat_keep), big, device, n, reps,
                nbytes=2 * args.fat_keep * args.fat_cols)
    # 8. tile sweep on encode (on the card the tile is only S's divisor)
    for tile in args.tiles:
        timed_calls(f"encode pallas tile={tile}",
                    lambda d, t=tile: rk.gf_bitmatmul_pallas(bits, d, tile_s=t),
                    data, device, max(1, n // 2), reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())

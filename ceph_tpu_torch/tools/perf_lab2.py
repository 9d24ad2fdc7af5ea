"""Perf lab 2: the RS encode cut stage by stage, and dispatch shapes swept.

Twin of the JAX package's ``tools/perf_lab2.py``.  Run on the card:

    python -m ceph_tpu_torch.tools.perf_lab2 [--device cuda] [--calls 16] [--reps 4]

Sections: the dispatch-size x calls-in-flight sweep (``--sizes`` rows of
``--unit`` bytes, ``--ns`` calls, at most ``--window`` results in
flight), grouped against ungrouped launches, the four-stage ablation of
the encode kernel (``rs_kernels.gf_stage_cut``: load, extract, matmul,
full), and the repeat variant (``lab_kernels.repeat_variant``) at three
tiles (on the card a tile only has to divide S).  Each
timed line is ``name  ms  GB/s`` of the k data rows' bytes.  The last
lines hold the repeat variant against the host GF(2^8) encode, as the
reference's check does: it is not the encode (its ``pltpu.repeat`` tiles
the rows), so that line prints False; the next holds it against its own
folded product.
"""

from __future__ import annotations

import argparse
import sys
import time

import torch

from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import lab_kernels as lk
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.ops.gf256 import gf_matmul
from ceph_tpu_torch.tools import (MiB, int_list, random_bytes, resolve_device, size_label,
                                  sync)

K, M = 8, 3
STAGES = ("load", "extract", "matmul", "full")


def timed(name, fn, data, device, n=16, reps=4, bytes_per=None, window=6) -> float:
    """Pipelined dispatch of n calls with at most ``window`` results in
    flight: the oldest is waited for (its CUDA event) before the next
    call once ``window`` are queued."""
    fn(data)
    sync(device)
    cuda = device.type == "cuda"
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        pending = []
        for _ in range(n):
            out = fn(data)
            if cuda:
                ev = torch.cuda.Event()
                ev.record()
                pending.append((ev, out))
            if len(pending) > window:
                pending.pop(0)[0].synchronize()
        sync(device)
        del pending
        best = min(best, (time.perf_counter() - t0) / n)
    bp = data.numel() if bytes_per is None else bytes_per
    print(f"{name:52s} {best * 1e3:10.4f} ms  {bp / best / 1e9:9.2f} GB/s", flush=True)
    return bp / best / 1e9


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--sizes", type=int_list, default=[16, 64, 256],
                    help="rows of the dispatch sweep, in --unit bytes")
    ap.add_argument("--ns", type=int_list, default=[1, 4, 16])
    ap.add_argument("--cols", type=int, default=64 * MiB,
                    help="S of the other sections, bytes a row")
    ap.add_argument("--tile", type=int, default=262144)
    ap.add_argument("--groups", default="262144:1,131072:2,262144:2,65536:2",
                    help="tile:groups pairs of the grouped section")
    ap.add_argument("--repeat-tiles", type=int_list, default=[262144, 131072, 524288])
    ap.add_argument("--check-cols", type=int, default=MiB)
    ap.add_argument("--calls", type=int, default=16)
    ap.add_argument("--reps", type=int, default=4)
    ap.add_argument("--window", type=int, default=6)
    ap.add_argument("--unit", type=int, default=MiB, help="bytes of a --sizes unit")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    n, reps, w = args.calls, args.reps, args.window
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(K, M), device=device)
    bits = codec.encode_bits

    print("== dispatch-size x pipeline sweep (ungrouped) ==", flush=True)
    for i, size in enumerate(args.sizes):
        data = random_bytes((K, size * args.unit), 10 + i, device)
        for calls in args.ns:
            timed(f"S={size_label(size * args.unit)}/row n={calls}",
                  lambda d: rk.gf_bitmatmul_pallas(bits, d, tile_s=args.tile),
                  data, device, calls, reps, window=w)
        del data

    data = random_bytes((K, args.cols), 1, device)
    print(f"== grouped vs ungrouped (S={size_label(args.cols)}/row, n={n}) ==", flush=True)
    for pair in args.groups.split(","):
        tile, g = (int(v) for v in pair.split(":"))
        if g == 1:
            fn = lambda d, t=tile: rk.gf_bitmatmul_pallas(bits, d, tile_s=t)  # noqa: E731
        else:
            fn = lambda d, t=tile, g=g: rk.gf_bitmatmul_pallas_grouped(  # noqa: E731
                bits, d, tile_s=t, groups=g)
        timed(f"tile={tile} g={g}", fn, data, device, n, reps, window=w)

    print(f"== kernel stage ablation (ungrouped, n={n}) ==", flush=True)
    for stage in STAGES:
        timed(f"ablate:{stage}", lambda d, st=stage: rk.gf_stage_cut(bits, d, st),
              data, device, n, reps, window=w)

    print(f"== extraction variants (n={n}) ==", flush=True)
    for tile in args.repeat_tiles:
        timed(f"repeat-variant tile={tile}",
              lambda d, t=tile: lk.repeat_variant(bits, d, tile_s=t),
              data, device, n, reps, window=w)

    # the reference's check: the repeat variant against the host encode
    small = data[:, :args.check_cols].contiguous()
    out = lk.repeat_variant(bits, small).cpu().numpy()
    host = small.cpu().numpy()
    print("repeat variant bit-exact:", bool((out == gf_matmul(codec.C, host)).all()), flush=True)
    folded = lk.fold_repeat_matrix(bits, K)
    want = rk.gf_bitmatmul_plain(torch.from_numpy(folded), torch.from_numpy(host)).numpy()
    print("repeat variant equals the folded product:", bool((out == want).all()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

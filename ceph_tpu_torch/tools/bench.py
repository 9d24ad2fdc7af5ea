"""North-star benchmark: RS(k=8, m=3) erasure encode GB/s on one card.

Twin of the JAX package's ``bench.py``.  Run on the card:

    python -m ceph_tpu_torch.tools.bench [--device cuda]

The encode is checked against the host GF(2^8) encode on a (k, 1 MiB)
slice, and the loop harness's fold on a (k, 256 KiB) one.  Then the
timed loop: ``--iters`` launches of ``carry ^= encode(data ^ i)``
(``rs_kernels.gf_bitmatmul_pallas_acc``, the loop body of the
reference) on one (k, ``--cols``) buffer made on the device, ``--rounds``
samples ``--pause`` seconds apart, each ended by a host read of the
carry; the best sample is the value.

Prints ONE JSON line:
  {"metric", "value" (GB/s of data bytes), "unit", "vs_baseline",
   "samples_gb_s", "median_gb_s", "min_gb_s", "device", "bound_ms_per_iter"}
``vs_baseline`` is the share of the card's own byte bound that the best
sample reaches: (k + 2m) S bytes an iteration (data read, carry read and
written) at the H100's 3.35 TB/s.  On the CPU it is null: that bound is
the card's, not the CPU's.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.ops.gf256 import gf_matmul
from ceph_tpu_torch.tools import (MiB, PEAK_BYTES_PER_S, device_label, random_bytes,
                                  resolve_device, sync)

K, M = 8, 3
TILE = 262144


def loop_encode(bits: torch.Tensor, d: torch.Tensor, n: int) -> torch.Tensor:
    """n acc iterations on a zero carry, iteration i seeded with i."""
    c = torch.zeros((bits.shape[0] // 8, d.shape[1]), dtype=torch.uint8, device=d.device)
    tile = rk._pick_tile(d.shape[1], TILE) or d.shape[1]
    for i in range(n):
        rk.gf_bitmatmul_pallas_acc(bits, d, c, i, tile_s=tile)
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cols", type=int, help="S (default 256 MiB; 64 KiB on the CPU)")
    ap.add_argument("--iters", type=int, help="launches a sample (default 32; 2 on the CPU)")
    ap.add_argument("--rounds", type=int, help="samples (default 6; 1 on the CPU)")
    ap.add_argument("--pause", type=float, help="seconds between samples (default 3)")
    ap.add_argument("--check-cols", type=int, default=MiB)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    cuda = device.type == "cuda"
    s = args.cols or (256 * MiB if cuda else 1 << 16)
    iters = args.iters or (32 if cuda else 2)
    rounds = args.rounds or (6 if cuda else 1)
    pause = (3.0 if cuda else 0.0) if args.pause is None else args.pause

    codec = rk.BitmatrixCodec(isa_cauchy_matrix(K, M), device=device)
    bits = codec.encode_bits
    # sanity: the encode must match the host GF(2^8) encode
    probe = np.random.default_rng(0).integers(0, 256, (K, args.check_cols), dtype=np.uint8)
    got = codec.encode(torch.from_numpy(probe).to(device)).cpu().numpy()
    if not np.array_equal(got, gf_matmul(codec.C, probe)):
        raise AssertionError("kernel/host encode mismatch")
    # fold-correctness of the loop harness itself on a small buffer
    small = np.ascontiguousarray(probe[:, :min(args.check_cols, 2 ** 18)])
    got2 = loop_encode(bits, torch.from_numpy(small).to(device), 2).cpu().numpy()
    if not np.array_equal(got2, gf_matmul(codec.C, small) ^ gf_matmul(codec.C, small ^ 1)):
        raise AssertionError("loop harness fold mismatch")

    data = random_bytes((K, s), 0, device)
    out = loop_encode(bits, data, iters)  # warm
    sync(device)
    times = []
    for r in range(rounds):
        t0 = time.perf_counter()
        out = loop_encode(bits, data, iters)
        out[0, :8].cpu()  # host round trip: the loop has ended
        times.append(time.perf_counter() - t0)
        if r < rounds - 1 and pause:
            time.sleep(pause)
    samples = sorted(K * s * iters / t / 1e9 for t in times)
    gbs = samples[-1]
    bound_ms = (K + 2 * M) * s / PEAK_BYTES_PER_S * 1e3
    best_ms = min(times) / iters * 1e3
    print(json.dumps({
        "metric": f"RS(8,3) erasure encode throughput, 1 {'card' if cuda else 'CPU'} "
                  "(vs_baseline: share of the H100's byte bound, (k+2m)S bytes an "
                  "iteration at 3.35 TB/s)",
        "value": gbs,
        "unit": "GB/s",
        "vs_baseline": bound_ms / best_ms if cuda else None,
        "samples_gb_s": samples,
        "median_gb_s": statistics.median(samples),
        "min_gb_s": samples[0],
        "device": device_label(device),
        "S": s, "iters": iters,
        "bound_ms_per_iter": bound_ms,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""Perf lab 3: the looped acc encode, ``carry ^= encode(data ^ seed)``.

Twin of the JAX package's ``tools/perf_lab3.py``.  Run on the card:

    python -m ceph_tpu_torch.tools.perf_lab3 [--device cuda] [--reps 3]

First two correctness lines on a (k, ``--check-cols``) slice: one call
against the host GF(2^8) encode (seed 0), and a second call with seed 3
folded into the first.  Then ``loop_encode``: n launches of
``lab_kernels.acc_encode`` on one carry (the reference's ``fori_loop``
becomes a Python loop of launches), timed by the host clock to the end
of the last, at ``--sizes`` MiB a row and ``--ns`` launches, ``--reps``
times each.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import lab_kernels as lk
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.ops.gf256 import gf_matmul
from ceph_tpu_torch.tools import (MiB, int_list, random_bytes, resolve_device, size_label,
                                  sync)

K, M = 8, 3


def loop_encode(bits: torch.Tensor, d: torch.Tensor, n: int) -> torch.Tensor:
    """n acc launches on a zero carry, iteration i seeded with i."""
    c = torch.zeros((bits.shape[0] // 8, d.shape[1]), dtype=torch.uint8, device=d.device)
    for i in range(n):
        lk.acc_encode(bits, d, c, i)
    return c


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--check-cols", type=int, default=MiB)
    ap.add_argument("--sizes", type=int_list, default=[64, 256], help="rows, in --unit bytes")
    ap.add_argument("--ns", type=int_list, default=[4, 16])
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--unit", type=int, default=MiB, help="bytes of a --sizes unit")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(K, M), device=device)
    bits = codec.encode_bits

    # correctness first (small S)
    small = random_bytes((K, args.check_cols), 0, device)
    c0 = torch.zeros((M, args.check_cols), dtype=torch.uint8, device=device)
    out = lk.acc_encode(bits, small, c0, torch.tensor([0], dtype=torch.int32))
    host = small.cpu().numpy()
    ref = gf_matmul(codec.C, host)
    print("acc kernel bit-exact (seed 0):", bool(np.array_equal(out.cpu().numpy(), ref)),
          flush=True)
    out2 = lk.acc_encode(bits, small, out, torch.tensor([3], dtype=torch.int32))
    ref2 = ref ^ gf_matmul(codec.C, host ^ np.uint8(3))
    print("acc kernel fold (seed 3):", bool(np.array_equal(out2.cpu().numpy(), ref2)),
          flush=True)
    del small, c0, out, out2

    for i, size in enumerate(args.sizes):
        s = size * args.unit
        data = random_bytes((K, s), 20 + i, device)
        for n in args.ns:
            loop_encode(bits, data, n)
            sync(device)
            for rep in range(args.reps):
                t0 = time.perf_counter()
                out = loop_encode(bits, data, n)
                sync(device)
                dt = time.perf_counter() - t0
                print(f"loop S={size_label(s)}/row n={n:3d} rep{rep}: "
                      f"{dt * 1e3:10.4f} ms  {K * s * n / dt / 1e9:9.2f} GB/s", flush=True)
        del data, out
    return 0


if __name__ == "__main__":
    sys.exit(main())

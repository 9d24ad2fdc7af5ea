"""The port's measurement tools: twins of the JAX package's ``tools/``.

Each runs as ``python -m ceph_tpu_torch.tools.<name>`` on the card, and
on the CPU only when asked (``--device cpu``):

- ``ec_benchmark`` — Ceph's ``ceph_erasure_code_benchmark`` CLI;
- ``bench_all`` — the ``BASELINE.md`` configurations, one JSON line each;
- ``bench`` — the north-star RS(8,3) encode loop, one JSON line;
- ``perf_lab``, ``perf_lab2``, ``perf_lab3`` — the kernel probes: copy
  rooflines, dispatch sweeps, the encode's stage ablation, the repeat
  variant and the looped acc encode.

The helpers below are shared by them.
"""

from __future__ import annotations

import torch

from ceph_tpu_torch.ops.rs_kernels import resolve_device

MiB = 1 << 20
#: NVIDIA H100 SXM data sheet: the HBM3 rate.  The byte bounds of the
#: ``vs_baseline`` shares are taken against it.
PEAK_BYTES_PER_S = 3.35e12


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def random_bytes(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Uniform uint8 tensor made on ``device`` from ``seed``."""
    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device,
                         generator=gen)


def device_label(device: torch.device) -> str:
    """The card's name, or ``cpu``."""
    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def int_list(text: str) -> list[int]:
    """``"1,2,3"`` -> [1, 2, 3] (argparse type)."""
    return [int(v) for v in text.split(",") if v]


def size_label(nbytes: int) -> str:
    """``64MiB``, ``16KiB`` or ``100B``."""
    for unit, name in ((MiB, "MiB"), (1024, "KiB")):
        if nbytes % unit == 0:
            return f"{nbytes // unit}{name}"
    return f"{nbytes}B"


__all__ = ["MiB", "PEAK_BYTES_PER_S", "device_label", "int_list", "random_bytes", "resolve_device",
           "size_label", "sync"]

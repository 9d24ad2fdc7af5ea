"""The port's tools: twins of the JAX package's ``tools/``.

Each runs as ``python -m ceph_tpu_torch.tools.<name>`` on the card, and
on the CPU only when asked (``--device cpu``):

- ``ec_benchmark`` — Ceph's ``ceph_erasure_code_benchmark`` CLI;
- ``bench_all`` — the ``BASELINE.md`` configurations, one JSON line each,
  ``recovery`` with its OSDs in worker processes;
- ``bench`` — the north-star RS(8,3) encode loop, one JSON line;
- ``perf_lab``, ``perf_lab2``, ``perf_lab3`` — the kernel probes: copy
  rooflines, dispatch sweeps, the encode's stage ablation, the repeat
  variant and the looped acc encode;
- ``chaos_run``, ``load_run``, ``chaos_fuzz`` — the chaos matrix, the
  load harness and the coverage-guided fuzz campaign;
- ``crushtool``, ``osdmaptool`` — CRUSH and OSDMap offline tools (their
  ``--test`` and ``--test-map-pgs`` map on the card);
- ``vstart``, ``cephadm``, ``ceph`` — a dev cluster in one process, a
  cluster of daemon processes, and the admin CLI (a RADOS client: no
  device of its own);
- ``lint`` — ctlint over the port (``ceph_tpu_torch/analysis/``): plain
  ``ast``, no torch, no card.

The helpers below are shared by them.
"""

from __future__ import annotations

import os

MiB = 1 << 20
#: the repository root: the processes the tools start import the package from it
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
#: NVIDIA H100 SXM data sheet: the HBM3 rate.  The byte bounds of the
#: ``vs_baseline`` shares are taken against it.
PEAK_BYTES_PER_S = 3.35e12


# torch is imported where it is used: ``lint`` imports this package and
# runs with no torch at all


def resolve_device(device=None):
    """``ceph_tpu_torch.ops.rs_kernels.resolve_device``."""
    from ceph_tpu_torch.ops.rs_kernels import resolve_device as resolve

    return resolve(device)


def sync(device: torch.device) -> None:
    """Wait for the device's queued work (nothing to wait for on the CPU)."""
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def random_bytes(shape, seed: int, device: torch.device) -> torch.Tensor:
    """Uniform uint8 tensor made on ``device`` from ``seed``."""
    import torch

    gen = torch.Generator(device=device).manual_seed(seed)
    return torch.randint(0, 256, tuple(shape), dtype=torch.uint8, device=device,
                         generator=gen)


def device_label(device: torch.device) -> str:
    """The card's name, or ``cpu``."""
    import torch

    return torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu"


def child_env(**extra: str) -> dict[str, str]:
    """This process's environment for a ``python -m ceph_tpu_torch...``
    child: the repository root first on its PYTHONPATH, then ``extra``."""
    path = os.pathsep.join(filter(None, (REPO_ROOT, os.environ.get("PYTHONPATH"))))
    return {**os.environ, "PYTHONPATH": path, **extra}


def int_list(text: str) -> list[int]:
    """``"1,2,3"`` -> [1, 2, 3] (argparse type)."""
    return [int(v) for v in text.split(",") if v]


def size_label(nbytes: int) -> str:
    """``64MiB``, ``16KiB`` or ``100B``."""
    for unit, name in ((MiB, "MiB"), (1024, "KiB")):
        if nbytes % unit == 0:
            return f"{nbytes // unit}{name}"
    return f"{nbytes}B"


__all__ = ["MiB", "PEAK_BYTES_PER_S", "REPO_ROOT", "child_env", "device_label", "int_list",
           "random_bytes", "resolve_device", "size_label", "sync"]

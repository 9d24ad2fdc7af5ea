"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` compiles with ``nvcc`` into a shared library
with a plain C interface, ``ceph_tpu_torch/_build/lib<name>.so``, loaded
with ``ctypes``.  The build happens at first use (never at import: the
CPU-only test host has no ``nvcc``) and again whenever the source is
newer than the library.  ``ptxas -v`` output (registers, shared memory,
spills per kernel) is kept in :data:`BUILD_LOG`.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_HERE), "_build")

NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
]

#: source name -> compiler output of its last build in this process
BUILD_LOG: dict[str, str] = {}

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def sources() -> list[str]:
    """Every kernel source of the package, by name (``gf_bitmatmul``)."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _paths(name: str) -> tuple[str, str]:
    return (os.path.join(CSRC, name + ".cu"),
            os.path.join(BUILD_DIR, f"lib{name}.so"))


def _stale(name: str) -> bool:
    src, so = _paths(name)
    return not os.path.exists(so) or os.path.getmtime(src) > os.path.getmtime(so)


def build(names: list[str] | None = None) -> None:
    """Compile every stale source in ``names`` (default: all), one
    ``nvcc`` per source, all started together.  Raises on any failure."""
    names = [n for n in (names or sources()) if _stale(n)]
    if not names:
        return
    os.makedirs(BUILD_DIR, exist_ok=True)
    exe = nvcc()
    procs = []
    for name in names:
        src, so = _paths(name)
        tmp = f"{so}.tmp.{os.getpid()}"
        procs.append((name, so, tmp, subprocess.Popen(
            [exe, *NVCC_FLAGS, "-o", tmp, src],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    failed = []
    for name, so, tmp, proc in procs:
        log, _ = proc.communicate()
        BUILD_LOG[name] = log
        if proc.returncode != 0:
            failed.append(f"{name}: nvcc exited {proc.returncode}\n{log}")
            continue
        os.replace(tmp, so)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))


def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if stale."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build([name])
            lib = _libs[name] = ctypes.CDLL(_paths(name)[1])
        return lib

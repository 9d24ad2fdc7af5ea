"""This process's kernel launches, by wrapper: every count that a kernel
wrapper adds one to where it launches its kernel (0 on the CPU, where the
wrappers run their plain versions).  Daemons serve them over their admin
socket as ``dump_launches``, so a harness can read the launches of
daemons in processes of their own."""

from __future__ import annotations

import os


def kernel_launch_counts() -> dict[str, int]:
    """The bit-matrix, crc, CRUSH, analytics and CLAY wrappers' counts."""
    from ceph_tpu_torch.crush import cudamapper
    from ceph_tpu_torch.ec.plugins import clay_cuda
    from ceph_tpu_torch.ops import analytics_kernels, hashing, rs_kernels

    return {**rs_kernels.launch_counts(), **hashing.launch_counts(),
            **cudamapper.launch_counts(), **analytics_kernels.launch_counts(),
            **clay_cuda.launch_counts()}


def dump_launches(cmd=None) -> dict:
    """The ``dump_launches`` admin command: the process and its counts
    (daemons sharing a process share them, so a reader dedupes by pid)."""
    return {"pid": os.getpid(), "launches": kernel_launch_counts()}


async def sum_launches(socket_paths) -> dict[str, int]:
    """``dump_launches`` over the admin sockets that answer, summed over
    their processes (daemons in one process share its counts, so each
    pid is counted once)."""
    from ceph_tpu_torch.common import admin_command

    seen: set[int] = set()
    total: dict[str, int] = {}
    for path in socket_paths:
        try:
            d = await admin_command(path, "dump_launches")
        except (OSError, ConnectionError):
            continue
        if d["pid"] not in seen:
            seen.add(d["pid"])
            for k, v in d["launches"].items():
                total[k] = total.get(k, 0) + int(v)
    return total

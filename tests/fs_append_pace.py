"""The pace of a CephFS file's 1 MiB appends, the reference's and the
port's, side by side on the CPU.

    JAX_PLATFORMS=cpu python tests/fs_append_pace.py [--store memory|block]

Each run boots a mini-cluster of one package (a mon, 12 OSDs, one a
host, and a client, as tests/integration's and the port's ``Cluster``
boot them; each OSD on a MemStore, or with ``--store block`` on a
``BlockStore`` over its own ``FileDB`` in a temporary directory, as
chip_smoke.py's cluster path opens them), creates the services path's CephFS pools
(``cephfs.meta``: size 3, 8 PGs; ``cephfs.data``: RS(8,3), 32 PGs, on
``jax`` for the reference and ``cuda`` on ``device="cpu"`` for the port),
starts an MDS and an ``FSClient``, and writes one file in 16 1 MiB
appends, one after another, then reads it back.  Four runs alternate
between the packages, each in its own process (reference, port, port,
reference), and each prints one JSON line: the seconds of every
append, the object writes the client issued and their mean seconds, the
read's seconds and whether it was equal, or the error that ended the
run.  A last line gives each package's median append.
"""

from __future__ import annotations

import argparse
import asyncio
import importlib
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ceph_tpu", "ceph_tpu_torch")
APPEND = 1 << 20
APPENDS = 16
ORDER = PACKAGES + PACKAGES[::-1]


def _block_stores(pkg: str, root: str):
    """A factory of mounted BlockStores, each on its own FileDB."""
    BlockStore = importlib.import_module(f"{pkg}.store.blockstore").BlockStore
    FileDB = importlib.import_module(f"{pkg}.kv").FileDB

    def factory(i: int):
        path = os.path.join(root, f"osd.{i}")
        store = BlockStore(path, db=FileDB(os.path.join(path, "kv")))
        store.fault_domain = f"osd.{i}"
        store.mount()
        return store

    return factory


async def _one(pkg: str, appends: int, root: str | None) -> dict:
    fs_mod = importlib.import_module(f"{pkg}.fs")
    if pkg == "ceph_tpu":
        from tests.integration.test_mini_cluster import Cluster
        plugin = "jax"
    else:
        from tests.test_torch_mini_cluster import Cluster
        plugin = "cuda"
    factory = _block_stores(pkg, root) if root else None
    async with Cluster(n_osds=12, store_factory=factory) as c:
        await c.client.pool_create("cephfs.meta", pg_num=8, size=3)
        await c.client.ec_profile_set("fs", {"plugin": plugin, "k": "8", "m": "3",
                                             "crush-failure-domain": "host"})
        await c.client.pool_create("cephfs.data", pg_num=32, pool_type="erasure",
                                   erasure_code_profile="fs")
        await c.client.wait_clean(timeout=120)
        mds = fs_mod.MDSDaemon(0, c.mon.addr)
        await mds.start()
        fs = fs_mod.FSClient(mds.addr, c.client.ioctx("cephfs.data"))
        await fs.mount()
        try:
            f = await fs.create("/pace.bin")
            data = np.random.default_rng(0).integers(0, 256, appends * APPEND,
                                                     dtype=np.uint8).tobytes()
            io = fs.data_io
            write, ops = io.write, []

            async def timed(oid, buf, off=0):
                t0 = time.perf_counter()
                await write(oid, buf, off=off)
                ops.append(time.perf_counter() - t0)

            io.write = timed
            per = []
            for off in range(0, len(data), APPEND):
                t0 = time.perf_counter()
                await f.write(off, data[off:off + APPEND])
                per.append(time.perf_counter() - t0)
            await f.fsync()
            io.write = write
            t0 = time.perf_counter()
            equal = await (await fs.open("/pace.bin")).read(0) == data
            read_s = time.perf_counter() - t0
        finally:
            await fs.unmount()
            await mds.stop()
    return {"package": pkg, "store": "block" if root else "memory", "appends": appends,
            "append_seconds": per,
            "object_writes": len(ops), "object_write_mean_seconds": statistics.fmean(ops),
            "read_seconds": read_s, "read_equal": equal}


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--store", choices=("memory", "block"), default="memory")
    ap.add_argument("--package", choices=PACKAGES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.package:
        sys.path.insert(0, ROOT)
        try:
            if args.store == "memory":
                line = asyncio.run(_one(args.package, APPENDS, None))
            else:
                with tempfile.TemporaryDirectory(prefix="fs_append_pace_") as root:
                    line = asyncio.run(_one(args.package, APPENDS, root))
        except Exception as e:  # a package that fails the pattern: its error is the result
            line = {"package": args.package, "store": args.store,
                    "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), flush=True)
        return 0
    appends: dict[str, list[float]] = {p: [] for p in PACKAGES}
    for pkg in ORDER:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--package", pkg,
                              "--store", args.store],
                             cwd=ROOT, check=True, capture_output=True, text=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        appends[pkg] += line.get("append_seconds", [])
    print(json.dumps({"median_append_seconds": {p: statistics.median(v) if v else None
                                                for p, v in appends.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

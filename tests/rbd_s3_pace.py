"""The pace of RBD writes and S3 PUTs beside the cluster path's
``write_full``, the reference's and the port's, side by side on the CPU.

    JAX_PLATFORMS=cpu python tests/rbd_s3_pace.py [--objects N] [--rounds R]

Each run boots a mini-cluster of one package (a mon, 12 OSDs on
MemStores, one a host, and a client, as tests/integration's and the
port's ``Cluster`` boot them), creates the services path's pools (``rbd``
and ``rgw.meta``: size 3, 8 PGs; ``rbd.data`` and ``rgw.data``: RS(8,3),
32 PGs, on ``jax`` for the reference and ``cuda`` on ``device="cpu"`` for
the port), waits for active+clean, and times three writers of N payloads
of 4 MiB each, 8 in flight, one after another:

- ``write_full``: N objects into ``rbd.data`` through the client (the
  cluster path's write);
- ``rbd``: an image of N objects of 4 MiB (order 22, ``object-map``)
  written whole in 4 MiB writes;
- ``s3``: N PUTs of 4 MiB to a bucket through the gateway, over HTTP
  with SigV4, each answered 200 with its md5 as ETag (the client is
  the port's ``rgw.frontend.s3_request`` in both packages' runs).

Each writer's payloads are made from the seed and read back whole after
it, and every read must be equal.  Runs alternate between the packages,
each in its own process (reference, port, port, reference, R rounds),
and each prints one JSON line: every writer's seconds and GB/s, or the
error that ended the run.  A last line gives each package's median GB/s
for each writer.
"""

from __future__ import annotations

import argparse
import asyncio
import hashlib
import importlib
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGES = ("ceph_tpu", "ceph_tpu_torch")
ORDER = PACKAGES + PACKAGES[::-1]
OBJECT = 4 << 20
INFLIGHT = 8
WRITERS = ("write_full", "rbd", "s3")
ACCESS, SECRET = "PACEACCESSKEY", "pace-secret-key"


async def _bounded(calls, inflight: int) -> list:
    """Await every coroutine of ``calls``, at most ``inflight`` at once."""
    sem = asyncio.Semaphore(inflight)

    async def one(c):
        async with sem:
            return await c

    return await asyncio.gather(*(one(c) for c in calls))


async def _one(pkg: str, n: int) -> dict:
    # the HTTP client of both runs: host code, the same bytes on the wire
    from ceph_tpu_torch.rgw.frontend import s3_request

    rbd_mod = importlib.import_module(f"{pkg}.rbd")
    rgw = importlib.import_module(f"{pkg}.rgw")
    if pkg == "ceph_tpu":
        from tests.integration.test_mini_cluster import Cluster
        plugin = "jax"
    else:
        from tests.test_torch_mini_cluster import Cluster
        plugin = "cuda"
    rng = np.random.default_rng(0)
    payloads = {w: [rng.integers(0, 256, OBJECT, dtype=np.uint8).tobytes() for _ in range(n)]
                for w in WRITERS}
    out = {"package": pkg, "objects": n, "object_bytes": OBJECT, "inflight": INFLIGHT}
    async with Cluster(n_osds=12) as c:
        await c.client.ec_profile_set("pace", {"plugin": plugin, "k": "8", "m": "3",
                                               "crush-failure-domain": "host"})
        for meta, data in (("rbd", "rbd.data"), ("rgw.meta", "rgw.data")):
            await c.client.pool_create(meta, pg_num=8, size=3)
            await c.client.pool_create(data, pg_num=32, pool_type="erasure",
                                       erasure_code_profile="pace")
        await c.client.wait_clean(timeout=120)

        async def timed(name, calls) -> None:
            t0 = time.perf_counter()
            await _bounded(calls, INFLIGHT)
            secs = time.perf_counter() - t0
            out[name] = {"seconds": secs, "gb_per_s": n * OBJECT / secs / 1e9}

        # the cluster path's client write
        io = c.client.ioctx("rbd.data")
        await timed("write_full", [io.write_full(f"pace.{i}", d)
                                   for i, d in enumerate(payloads["write_full"])])
        reads = await _bounded([io.read(f"pace.{i}") for i in range(n)], INFLIGHT)
        equal = reads == payloads["write_full"]

        # RBD: the image written whole in 4 MiB writes
        rbd = rbd_mod.RBD(c.client.ioctx("rbd"), c.client.ioctx("rbd.data"))
        await rbd.create("pace", size=n * OBJECT, order=22, features=["object-map"])
        img = await rbd.open("pace")
        await timed("rbd", [img.write(i * OBJECT, d) for i, d in enumerate(payloads["rbd"])])
        equal &= await img.read(0, n * OBJECT) == b"".join(payloads["rbd"])

        # S3: PUTs through the gateway over HTTP
        store = rgw.RGWStore(c.client.ioctx("rgw.meta"), {"default": c.client.ioctx("rgw.data")})
        await store.create_user("pace", "Pace User", access_key=ACCESS, secret_key=SECRET)
        fe = rgw.S3Frontend(store)
        await fe.start()
        try:
            async def s3(method: str, path: str, body: bytes = b""):
                return await s3_request(fe.host, fe.port, method, path, ACCESS, SECRET, body)

            assert (await s3("PUT", "/pace"))[0] == 200
            puts: list = []

            async def put(i: int, body: bytes) -> None:
                puts.append((await s3("PUT", f"/pace/obj-{i}", body), body))

            await timed("s3", [put(i, d) for i, d in enumerate(payloads["s3"])])
            equal &= all(r[0] == 200 and r[1].get("etag", "").strip('"')
                         == hashlib.md5(body).hexdigest() for r, body in puts)
            gets = await _bounded([s3("GET", f"/pace/obj-{i}") for i in range(n)], INFLIGHT)
            equal &= [g[2] for g in gets] == payloads["s3"]
        finally:
            await fe.stop()
    out["read_equal"] = equal
    return out


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--objects", type=int, default=16)
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--package", choices=PACKAGES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.package:
        sys.path.insert(0, ROOT)
        try:
            line = asyncio.run(_one(args.package, args.objects))
        except Exception as e:  # a package that fails the pattern: its error is the result
            line = {"package": args.package, "error": f"{type(e).__name__}: {e}"}
        print(json.dumps(line), flush=True)
        return 0
    rates: dict[str, dict[str, list[float]]] = {p: {w: [] for w in WRITERS} for p in PACKAGES}
    for pkg in ORDER * args.rounds:
        out = subprocess.run([sys.executable, os.path.abspath(__file__), "--package", pkg,
                              "--objects", str(args.objects)],
                             cwd=ROOT, check=True, capture_output=True, text=True).stdout
        line = json.loads(out.strip().splitlines()[-1])
        print(json.dumps(line), flush=True)
        for w in WRITERS:
            if w in line:
                rates[pkg][w].append(line[w]["gb_per_s"])
    print(json.dumps({"median_gb_per_s": {
        p: {w: statistics.median(v) if v else None for w, v in ws.items()}
        for p, ws in rates.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

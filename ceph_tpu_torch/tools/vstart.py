"""vstart: boot a dev mini-cluster (mons, OSDs, mgrs) in one process.

Twin of the JAX package's ``tools/vstart.py`` (the src/vstart.sh
analogue): starts a monitor quorum, N OSDs and M manager daemons on
localhost, prints the monmap for ``ceph -m``, and runs until
interrupted.

  python -m ceph_tpu_torch.tools.vstart [--mons 1] [--osds 8] [--mgrs 1] [--beacon 1.0]

Every daemon runs on ``--device`` (default ``cuda``: the OSDs' EC
plugins and batchers, the mgr's digest, the mon's balancer); ``--device
cpu`` runs the cluster on the host.  ``--admin-socket-dir DIR`` gives each
OSD and mgr an admin socket there (``osd.N.asok``, ``mgr.NAME.asok``),
where ``dump_decode_batch`` and ``dump_analytics`` show their launches.
"""

from __future__ import annotations

import argparse
import asyncio
import os
import signal
import sys


async def amain(args) -> int:
    from ceph_tpu_torch.common import ConfigProxy
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.tools import resolve_device

    device = resolve_device(args.device)
    crush = CrushMap()
    B.build_hierarchy(
        crush, osds_per_host=args.osds_per_host,
        n_hosts=(args.osds + args.osds_per_host - 1) // args.osds_per_host,
    )

    def _store(name: str):
        if not args.data:
            return None
        if args.store == "kstore":
            from ceph_tpu_torch.kv import FileDB
            from ceph_tpu_torch.store.kstore import KStore

            s = KStore(FileDB(os.path.join(args.data, name)))
        elif args.store == "block":
            from ceph_tpu_torch.store.blockstore import BlockStore

            s = BlockStore(os.path.join(args.data, name))
        else:
            from ceph_tpu_torch.store.filestore import FileStore

            s = FileStore(os.path.join(args.data, name))
        s.mount()
        return s

    def _conf(pattern: str) -> ConfigProxy:
        if not args.admin_socket_dir:
            return ConfigProxy()
        return ConfigProxy({"admin_socket": os.path.join(args.admin_socket_dir, pattern)})

    mons = [
        Monitor(
            crush=crush.copy(), rank=r, n_mons=args.mons,
            beacon_grace=args.beacon * 4 if args.beacon else 0.0,
            out_interval=args.out_interval,
            store=_store(f"mon{r}"), device=device,
        )
        for r in range(args.mons)
    ]
    for m in mons:
        await m.start()
    monmap = [m.addr for m in mons]
    for m in mons:
        await m.open_quorum(monmap)
    for m in mons:
        await m.wait_stable()
    mgrs = []
    if args.mgrs:
        from ceph_tpu_torch.mgr.daemon import MgrDaemon

        for i in range(args.mgrs):
            mgr = MgrDaemon(chr(ord("x") + i), monmap, conf=_conf("$id.asok"), device=device)
            await mgr.start()
            mgrs.append(mgr)
    osds = []
    for i in range(args.osds):
        osd = OSDDaemon(
            i, monmap, beacon_interval=args.beacon,
            store=_store(f"osd{i}"), conf=_conf("osd.$id.asok"), device=device,
        )
        await osd.start()
        osds.append(osd)
    spec = ",".join(f"{h}:{p}" for h, p in monmap)
    print(f"vstart: cluster up — mons at {spec}", flush=True)
    if mgrs:
        print(f"vstart: mgrs {', '.join(m.name for m in mgrs)} "
              f"(active is the mon's call — `ceph mgr stat`)",
              flush=True)
    print(f"vstart: try  python -m ceph_tpu_torch.tools.ceph -m {spec} status", flush=True)
    dash = None
    if args.dashboard:
        from ceph_tpu_torch.mgr.dashboard import Dashboard

        dash = Dashboard(mons[0])
        dh, dp = await dash.start(port=args.dashboard_port)
        print(f"vstart: dashboard at http://{dh}:{dp}/", flush=True)
    stop = asyncio.Event()
    loop = asyncio.get_running_loop()
    for sig in (signal.SIGTERM, signal.SIGINT):
        loop.add_signal_handler(sig, stop.set)
    try:
        await stop.wait()
    finally:
        if dash is not None:
            await dash.stop()
        for o in osds:
            await o.stop()
        for g in mgrs:
            await g.stop()
        for m in mons:
            await m.stop()
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--mons", type=int, default=1)
    ap.add_argument("--osds", type=int, default=8)
    ap.add_argument("--mgrs", type=int, default=1,
                    help="manager daemons (first to beacon goes "
                         "active, the rest stand by)")
    ap.add_argument("--osds-per-host", type=int, default=1)
    ap.add_argument("--beacon", type=float, default=1.0)
    ap.add_argument("--out-interval", type=float, default=0.0)
    ap.add_argument(
        "--data", default="",
        help="data directory: daemons run on durable stores and the "
             "cluster survives restart (default: volatile MemStores)",
    )
    ap.add_argument(
        "--store", choices=("file", "kstore", "block"), default="file",
        help="durable engine under --data: file = FileStore WAL, "
             "kstore = objects-in-kv over FileDB (src/os/kstore twin), "
             "block = BlockStore (extents + checksums-at-rest, the "
             "BlueStore-grade engine)",
    )
    ap.add_argument(
        "--dashboard", action="store_true",
        help="serve the read-only web dashboard from the rank-0 mon "
             "(ceph_tpu_torch/mgr/dashboard.py)",
    )
    ap.add_argument("--dashboard-port", type=int, default=0,
                    help="dashboard port (default: ephemeral)")
    ap.add_argument("--admin-socket-dir", default="",
                    help="give every OSD and mgr an admin socket in this directory")
    ap.add_argument("--device", default="cuda",
                    help="every daemon's device (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)
    try:
        return asyncio.run(amain(args))
    except KeyboardInterrupt:
        return 0


if __name__ == "__main__":
    sys.exit(main())

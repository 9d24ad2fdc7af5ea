"""osdmaptool: offline OSDMap inspection and batched PG mapping.

Twin of the JAX package's ``tools/osdmaptool.py`` (the reference's
src/tools/osdmaptool.cc):

  python -m ceph_tpu_torch.tools.osdmaptool MAP.bin --print
  python -m ceph_tpu_torch.tools.osdmaptool MAP.bin --test-map-pgs [--pool ID]
  python -m ceph_tpu_torch.tools.osdmaptool --createsimple N -o MAP.bin [--pg-num P]

``--test-map-pgs`` runs the whole-cluster remap through the port's
batched engine (``osd/remap.py`` ``BatchedClusterMapper``, whose CRUSH
step is ``crush_rule.cu``) on ``--device`` (default ``cuda``; ``cpu``
runs the plain version on the host), and prints the same summary as the
reference (PGs, OSDs used, PGs an OSD at least, at most and on average,
seconds).  The map file is the reference's encoding (``osd/mapenc.py``),
so either package reads the other's.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("mapfn", nargs="?", help="osdmap file")
    ap.add_argument("--print", dest="print_", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--pool", type=int)
    ap.add_argument("--createsimple", type=int, metavar="N_OSDS")
    ap.add_argument("--pg-num", type=int, default=128)
    ap.add_argument("-o", "--outfn")
    ap.add_argument("--device", default="cuda",
                    help="where --test-map-pgs maps (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    from ceph_tpu_torch.osd.mapenc import decode_osdmap, encode_osdmap

    if args.createsimple:
        from ceph_tpu_torch.crush import builder as B
        from ceph_tpu_torch.crush.types import CrushMap
        from ceph_tpu_torch.osd.osdmap import OSDMap
        from ceph_tpu_torch.osd.types import PgPool, PoolType

        m = CrushMap()
        root = B.build_hierarchy(m, osds_per_host=1, n_hosts=args.createsimple)
        rrep = B.add_simple_rule(m, root.id, 1, mode="firstn")
        om = OSDMap(crush=m)
        for o in range(args.createsimple):
            om.new_osd(o)
        om.pools[1] = PgPool(
            id=1, type=PoolType.REPLICATED, size=3, crush_rule=rrep,
            pg_num=args.pg_num, pgp_num=args.pg_num,
        )
        om.pool_names[1] = "rbd"
        if not args.outfn:
            ap.error("--createsimple requires -o")
        with open(args.outfn, "wb") as f:
            f.write(encode_osdmap(om))
        print(f"osdmaptool: wrote {args.outfn} (epoch {om.epoch})")
        return 0

    if not args.mapfn:
        ap.error("need an osdmap file")
    with open(args.mapfn, "rb") as f:
        om = decode_osdmap(f.read())

    if args.print_:
        print(json.dumps({
            "epoch": om.epoch,
            "max_osd": om.max_osd,
            "pools": {
                str(pid): {
                    "name": om.pool_names.get(pid, ""),
                    "type": p.type, "size": p.size, "pg_num": p.pg_num,
                    "crush_rule": p.crush_rule,
                }
                for pid, p in sorted(om.pools.items())
            },
            "num_up": sum(om.is_up(o) for o in range(om.max_osd)),
        }, indent=2))

    if args.test_map_pgs:
        from ceph_tpu_torch.osd.remap import BatchedClusterMapper
        from ceph_tpu_torch.tools import resolve_device

        bcm = BatchedClusterMapper(om, device=resolve_device(args.device))
        pools = [args.pool] if args.pool is not None else sorted(om.pools)
        t0 = time.perf_counter()
        per_osd: dict[int, int] = {}
        total = 0
        for pid in pools:
            pm = bcm.map_pool(pid)
            total += pm.up.shape[0]
            for row, cnt in zip(pm.up, pm.up_cnt):
                for o in row[:cnt]:
                    if o != 0x7FFFFFFF:
                        per_osd[int(o)] = per_osd.get(int(o), 0) + 1
        dt = time.perf_counter() - t0
        counts = sorted(per_osd.values())
        print(json.dumps({
            "pg_count": total,
            "osds_used": len(per_osd),
            "pg_per_osd_min": counts[0] if counts else 0,
            "pg_per_osd_max": counts[-1] if counts else 0,
            "pg_per_osd_avg": round(sum(counts) / len(counts), 1) if counts else 0,
            "seconds": round(dt, 3),
        }, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())

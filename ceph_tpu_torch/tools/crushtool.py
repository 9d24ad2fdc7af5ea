"""crushtool: compile/decompile/test CRUSH maps.

Twin of the JAX package's ``tools/crushtool.py`` (the reference's
src/tools/crushtool.cc), over the port's ``crush/compiler`` and
``crush/tester``:

  python -m ceph_tpu_torch.tools.crushtool --build OSDS [--osds-per-host N] -o MAP.txt
  python -m ceph_tpu_torch.tools.crushtool -d MAP.txt                 # decompile
  python -m ceph_tpu_torch.tools.crushtool --test -i MAP.txt --rule R --num-rep N
               [--min-x A --max-x B] [--show-statistics]
               [--show-mappings] [--show-bad-mappings]

``--test`` places the whole x range in one launch of ``crush_rule.cu`` on
the card (``--device``, default ``cuda``; ``--device cpu`` runs the plain
version on the host).  ``--build`` and ``-d`` touch no device.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-i", "--infn", help="input map (text)")
    ap.add_argument("-o", "--outfn", help="output map (text)")
    ap.add_argument("-d", "--decompile", metavar="MAP", help="print a map")
    ap.add_argument("--build", type=int, metavar="OSDS",
                    help="build a fresh map with OSDS devices")
    ap.add_argument("--osds-per-host", type=int, default=1)
    ap.add_argument("--test", action="store_true")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--show-statistics", action="store_true")
    ap.add_argument("--show-mappings", action="store_true")
    ap.add_argument("--show-bad-mappings", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="where --test maps (default cuda; cpu runs on the host)")
    args = ap.parse_args(argv)

    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.compiler import compile_text, decompile
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.tools import resolve_device

    if args.build:
        m = CrushMap()
        n_hosts = (args.build + args.osds_per_host - 1) // args.osds_per_host
        root = B.build_hierarchy(
            m, osds_per_host=args.osds_per_host, n_hosts=n_hosts
        )
        B.add_simple_rule(m, root.id, 1, mode="firstn", rule_id=0)
        B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3, rule_id=1)
        text = decompile(m)
        if args.outfn:
            with open(args.outfn, "w") as f:
                f.write(text)
        else:
            print(text)
        return 0

    if args.decompile:
        with open(args.decompile) as f:
            m = compile_text(f.read())
        print(decompile(m))
        return 0

    if args.test:
        if not args.infn:
            ap.error("--test requires -i MAP")
        with open(args.infn) as f:
            m = compile_text(f.read())
        tester = CrushTester(m, device=resolve_device(args.device))
        res = tester.test(
            args.rule, args.num_rep, args.min_x, args.max_x,
            keep_mappings=args.show_mappings,
        )
        if args.show_mappings:
            for x, row in sorted(res.mappings.items()):
                print(f"CRUSH rule {args.rule} x {x} {row}")
        if args.show_bad_mappings:
            for x in res.bad_mappings:
                print(f"bad mapping rule {args.rule} x {x}")
        if args.show_statistics or not (args.show_mappings or args.show_bad_mappings):
            print(json.dumps(res.statistics(), indent=2))
        return 0

    ap.error("nothing to do (--build, -d or --test)")
    return 2


if __name__ == "__main__":
    sys.exit(main())

"""ctlint — run the static invariant analyzers over the port.

Twin of the JAX package's ``tools/lint.py`` over ``ceph_tpu_torch/``
(:mod:`ceph_tpu_torch.analysis`).  Usage:

    python -m ceph_tpu_torch.tools.lint          # human output; exit 1 on NEW findings
    python -m ceph_tpu_torch.tools.lint --json   # machine-readable (pre-commit / CI)
    python -m ceph_tpu_torch.tools.lint --update-baseline
    python -m ceph_tpu_torch.tools.lint --rule config-dead --rule lock-blocking
    python -m ceph_tpu_torch.tools.lint --catalog  # print the rule catalog

Exit codes: 0 = clean (every finding baselined), 1 = new findings,
2 = stale baseline entries (baseline lists findings that no longer
fire — run --update-baseline to prune).

The baseline (``ctlint_torch_baseline.json`` at the repo root)
grandfathers known findings; every entry carries a one-line
justification.  New code must either fix its findings, suppress inline
(``# ctlint: disable=<rule>``) with a reason in the surrounding code,
or add a justified baseline entry in the same commit.  The analyzer is
plain ``ast``: a lint run imports no ``torch`` and needs no card.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

from ceph_tpu_torch.analysis import (
    Project,
    load_baseline,
    run_analysis,
    split_by_baseline,
)
from ceph_tpu_torch.analysis.core import baseline_integrity, write_baseline
from ceph_tpu_torch.analysis.rules import ALL_RULES, RULE_CATALOG

REPO_ROOT = Path(__file__).resolve().parents[2]
BASELINE_PATH = REPO_ROOT / "ctlint_torch_baseline.json"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="ctlint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit JSON (findings, new, baselined, stale)")
    ap.add_argument("--update-baseline", action="store_true",
                    help="rewrite the baseline to the current finding "
                         "set (keeps existing justifications)")
    ap.add_argument("--rule", action="append", default=None,
                    help="only run rule ids with this prefix "
                         "(repeatable; e.g. --rule config)")
    ap.add_argument("--root", default=str(REPO_ROOT),
                    help="tree to analyze (default: repo root)")
    ap.add_argument("--baseline", default=str(BASELINE_PATH),
                    help="baseline file (default: ctlint_torch_baseline.json)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="report every finding as new (audit mode)")
    ap.add_argument("--catalog", action="store_true",
                    help="print the rule catalog and exit")
    args = ap.parse_args(argv)

    if args.catalog:
        for rid in sorted(RULE_CATALOG):
            print(f"{rid:24s} {RULE_CATALOG[rid]}")
        return 0

    rules = [cls() for cls in ALL_RULES]
    project = Project.load(args.root)
    findings = run_analysis(args.root, rules=rules, project=project)
    if args.rule:
        findings = [
            f for f in findings
            if any(f.rule.startswith(p) for p in args.rule)
        ]

    baseline = {} if args.no_baseline else load_baseline(args.baseline)
    new, old, stale = split_by_baseline(findings, baseline)
    # hard rot: baseline entries whose (rule, file) no longer exists —
    # the stale-baseline preflight chaos/bench runs gate on
    rot = baseline_integrity(baseline, project, set(RULE_CATALOG))

    if args.update_baseline:
        write_baseline(args.baseline, findings, baseline)
        print(f"baseline rewritten: {len(findings)} entr"
              f"{'y' if len(findings) == 1 else 'ies'} "
              f"({len(new)} new — fill in their justifications)")
        return 0

    if args.as_json:
        print(json.dumps({
            "findings": [f.to_json() for f in findings],
            "new": [f.to_json() for f in new],
            "baselined": [f.to_json() for f in old],
            "stale_baseline": [list(k) for k in stale],
            "baseline_rot": [
                {"rule": k[0], "file": k[1], "message": k[2],
                 "reason": why} for k, why in rot
            ],
            "catalog": dict(sorted(RULE_CATALOG.items())),
            "summary": {
                "files": len(project.files),
                "rules": sorted(
                    rid for cls in ALL_RULES for rid in cls.rules),
                "findings": len(findings),
                "new": len(new),
                "baselined": len(old),
                "stale": len(stale),
            },
        }, indent=2))
    else:
        for f in new:
            print(f.render())
        if old:
            print(f"-- {len(old)} baselined finding"
                  f"{'s' if len(old) != 1 else ''} suppressed "
                  f"(see {Path(args.baseline).name})")
        for k in stale:
            print(f"-- stale baseline entry (no longer fires): "
                  f"[{k[0]}] {k[1]}: {k[2]}")
        for k, why in rot:
            print(f"-- dead baseline entry ({why}): [{k[0]}] {k[1]}")
        if not new and not stale and not rot:
            print(f"ctlint clean: {len(findings)} finding"
                  f"{'s' if len(findings) != 1 else ''}, all baselined")
    if new:
        return 1
    if stale or rot:
        return 2
    return 0


if __name__ == "__main__":
    sys.exit(main())

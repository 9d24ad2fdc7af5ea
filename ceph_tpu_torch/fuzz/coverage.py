"""The fuzzer's feedback signal: what did a run TOUCH?

AFL tracks branch edges; here the analogue is a deterministic
fingerprint of a finished chaos run — which invariant checkers
produced nonzero work (:func:`ceph_tpu_torch.chaos.invariants
.touched_checkers`), which perf-counter FAMILIES moved (backfill,
qos_*, tier_*, scrub, host transfers, ...), which event kinds fired,
and which daemon-lifecycle edges the run took.  Counter families, not
raw values: "backfill ran" is a coverage feature, "backfill_started ==
3.0" is noise that would make every run look novel.

``features`` flattens a fingerprint into admission tokens, including
pairwise checker combos and (scenario, kind) context pairs — the
tokens cross-bred mutants earn that no single hand-authored scenario
produces.

Counterpart of ``ceph_tpu/fuzz/coverage.py``: the same results for the same
inputs (``tests/test_torch_fuzz.py``).
"""
# ctlint: pure-trace

from __future__ import annotations

import hashlib
import json

from ceph_tpu_torch.chaos.invariants import touched_checkers

#: counter-name prefixes mapped to coverage families (longest match
#: wins; anything else falls back to its leading token)
KNOWN_FAMILIES = (
    "backfill", "qos_", "tier_", "scrub", "recovery", "cold_launch",
    "host_transfer", "mgr_analytics", "decode", "encode", "ballast",
    "fullness", "progress", "crash",
)


def counter_family(name: str) -> str:
    """Collapse one counter name into its coverage family."""
    for fam in KNOWN_FAMILIES:
        if name.startswith(fam):
            return fam.rstrip("_")
    return name.split("_")[0].split(".")[0]


def fingerprint(result: dict) -> dict:
    """The deterministic coverage fingerprint of one run result
    record (a ``run_trace`` return value, or the same record reloaded
    from a committed artifact)."""
    cov = result.get("coverage") or {}
    deltas = cov.get("perf_deltas") or {}
    families = sorted({
        counter_family(k) for k, v in sorted(deltas.items()) if v
    })
    edges = set()
    for ent in sorted(cov.get("deaths") or {}):
        edges.add(f"{ent.split('.')[0]}_death")
    for stat in sorted(cov.get("netem_moved") or ()):
        edges.add(f"netem_{stat}")
    fl = result.get("fullness_obs") or {}
    for rung in ("nearfull", "backfillfull", "full"):
        if fl.get(f"{rung}_raised"):
            edges.add(f"fullness_{rung}")
    return {
        "checkers": touched_checkers(result),
        "counters": families,
        "kinds": sorted(cov.get("event_kinds") or ()),
        "edges": sorted(edges),
        "red": not result.get("ok", True),
    }


def fingerprint_key(fp: dict) -> str:
    """Canonical sha256 of a fingerprint — corpus identity."""
    blob = json.dumps(fp, sort_keys=True,
                      separators=(",", ":")).encode()
    return hashlib.sha256(blob).hexdigest()


def features(fp: dict, scenario: str) -> set[str]:
    """Flatten a fingerprint into admission tokens.  The ``ctx:`` and
    ``combo:`` classes are where cross-breeding pays off: a verb that
    has never run inside THIS scenario, or two checkers' domains
    touched by ONE trace, are features no seed trace produces."""
    out: set[str] = set()
    checkers = list(fp.get("checkers") or ())
    for c in checkers:
        out.add(f"checker:{c}")
    for i, c1 in enumerate(checkers):
        for c2 in checkers[i + 1:]:
            out.add(f"combo:{c1}+{c2}")
    for fam in fp.get("counters") or ():
        out.add(f"counter:{fam}")
    for kind in fp.get("kinds") or ():
        out.add(f"kind:{kind}")
        out.add(f"ctx:{scenario}:{kind}")
    for edge in fp.get("edges") or ():
        out.add(f"edge:{edge}")
    if fp.get("red"):
        out.add("verdict:red")
    return out

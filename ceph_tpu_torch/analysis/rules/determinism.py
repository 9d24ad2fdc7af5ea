"""Rule family 5: schedule determinism.

The chaos contract is that a trace is a pure function of ``(seed,
scenario)`` — the committed ``trace_hash`` values in CHAOS_*.json
re-derive bit-identically forever.  Three things silently break that
purity: the wall clock, the shared ``random`` module state, and
iteration order over unordered sets (hash-randomized for str-keyed
content, and a refactor hazard even for ints).

Scope: ``ceph_tpu_torch/chaos/schedule.py`` and
``ceph_tpu_torch/loadgen/schedule.py`` (their committed trace hashes carry
the same purity contract) plus any module carrying a
``# ctlint: pure-trace`` marker.

- ``det-wallclock`` — ``time.time()``/``monotonic()``/
  ``datetime.now()`` etc.
- ``det-random`` — module-level ``random.<fn>()`` calls (seeded
  ``random.Random(...)`` instances are the sanctioned source).
- ``det-set-iter`` — iterating a set expression (literal, ``set()``
  call, set algebra, or a name assigned from one) without ``sorted()``.
"""

from __future__ import annotations

import ast

from ceph_tpu_torch.analysis.core import SEV_ERROR, Finding, Project, Rule
from ceph_tpu_torch.analysis.rules.common import attr_chain, call_name, last_name

PURE_TRACE_PATHS = (
    "ceph_tpu_torch/chaos/schedule.py",
    "ceph_tpu_torch/loadgen/schedule.py",
    # the fuzz plane's pure half: mutants, fingerprints, corpus
    # bookkeeping and ddmin all carry the committed-hash contract
    # (FUZZ_*.json lineages re-derive bit-identically forever)
    "ceph_tpu_torch/fuzz/mutate.py",
    "ceph_tpu_torch/fuzz/coverage.py",
    "ceph_tpu_torch/fuzz/corpus.py",
    "ceph_tpu_torch/fuzz/minimize.py",
)

_WALLCLOCK = {
    "time.time", "time.time_ns", "time.monotonic", "time.monotonic_ns",
    "time.perf_counter", "time.perf_counter_ns",
    "datetime.now", "datetime.utcnow", "datetime.today",
    "datetime.datetime.now", "datetime.datetime.utcnow", "date.today",
}

#: order-insensitive wrappers: iterating their result is fine
_ORDER_FREE = {"sorted", "len", "sum", "min", "max", "any", "all"}


def _in_scope(sf) -> bool:
    return sf.path in PURE_TRACE_PATHS or sf.pure_trace


def _is_setish(node: ast.AST, set_names: set[str]) -> bool:
    if isinstance(node, (ast.Set, ast.SetComp)):
        return True
    if isinstance(node, ast.Call):
        name = call_name(node)
        if name and name.split(".")[-1] in ("set", "frozenset"):
            return True
        return False
    if isinstance(node, ast.BinOp) and isinstance(
            node.op, (ast.Sub, ast.BitOr, ast.BitAnd, ast.BitXor)):
        return (_is_setish(node.left, set_names)
                or _is_setish(node.right, set_names))
    name = last_name(node)
    return bool(name and name in set_names)


def _collect_set_names(tree: ast.Module) -> set[str]:
    """Names/attrs assigned from set expressions anywhere in the module
    (attribute granularity: ``self.alive = set()`` marks ``alive``)."""
    names: set[str] = set()
    # two passes so `a = b` where b is a known set propagates once
    for _ in range(2):
        for node in ast.walk(tree):
            if isinstance(node, ast.Assign) and node.targets:
                if _is_setish(node.value, names):
                    for t in node.targets:
                        n = last_name(t)
                        if n:
                            names.add(n)
            elif isinstance(node, ast.AnnAssign) and node.value is not None:
                if _is_setish(node.value, names):
                    n = last_name(node.target)
                    if n:
                        names.add(n)
    return names


class DeterminismRule(Rule):
    name = "determinism"
    rules = ("det-wallclock", "det-random", "det-set-iter")
    catalog = {
        "det-wallclock":
            "wall-clock read in a pure-trace path (trace must be a "
            "function of (seed, scenario) only)",
        "det-random":
            "shared random-module global in a pure-trace path (use a "
            "seeded random.Random instance)",
        "det-set-iter":
            "iteration over an unordered set in a pure-trace path "
            "(wrap in sorted())",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for sf in project.files:
            if not _in_scope(sf):
                continue
            set_names = _collect_set_names(sf.tree)
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Call):
                    findings.extend(self._check_call(sf, node))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    findings.extend(self._check_iter(
                        sf, node.iter, set_names))
                elif isinstance(node, (ast.ListComp, ast.SetComp,
                                       ast.GeneratorExp, ast.DictComp)):
                    for gen in node.generators:
                        findings.extend(self._check_iter(
                            sf, gen.iter, set_names))
        return findings

    def _check_call(self, sf, node: ast.Call) -> list[Finding]:
        name = call_name(node)
        if not name:
            return []
        if name in _WALLCLOCK or any(
                name.endswith("." + w) for w in _WALLCLOCK):
            return [Finding(
                "det-wallclock", SEV_ERROR, sf.path, node.lineno,
                f"{name}() in a pure-trace path — traces must derive "
                f"from (seed, scenario) only, never the wall clock",
            )]
        parts = name.split(".")
        if (len(parts) == 2 and parts[0] == "random"
                and parts[1] != "Random"):
            return [Finding(
                "det-random", SEV_ERROR, sf.path, node.lineno,
                f"{name}() uses the shared random-module state — draw "
                f"from a seeded random.Random instance instead",
            )]
        return []

    def _check_iter(self, sf, it: ast.AST,
                    set_names: set[str]) -> list[Finding]:
        # unwrap order-free wrappers: sorted(x), enumerate(sorted(x))
        expr = it
        while isinstance(expr, ast.Call):
            fname = call_name(expr)
            short = fname.split(".")[-1] if fname else ""
            if short in _ORDER_FREE:
                return []  # sorted()/etc. already canonicalizes
            if short == "enumerate" and expr.args:
                expr = expr.args[0]
                continue
            break
        if _is_setish(expr, set_names):
            label = attr_chain(expr) or ast.dump(expr)[:40]
            return [Finding(
                "det-set-iter", SEV_ERROR, sf.path, it.lineno,
                f"iteration over unordered set {label!r} in a "
                f"pure-trace path — wrap it in sorted() or the trace "
                f"(and its committed hash) depends on hash order",
            )]
        return []

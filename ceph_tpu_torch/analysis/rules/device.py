"""Rule family 1: device discipline.

The runtime invariant is ``cold_launches == 0`` — no kernel build and
no unplanned device sync inside the I/O path.  On this card the
program-creating site is not a ``jax.jit`` but a kernel loader: the
first call of ``ops/_build.py``'s ``library()`` runs nvcc (seconds to
minutes) and loads the result with ``dlopen``.  Statically that decomposes
into three checks:

- ``device-prewarm`` — every ``_build.library`` site in a module
  reachable (via the import graph) from the I/O-path roots (``osd/``,
  ``parallel/``, ``mgr/analytics.py``) must be declared in
  :mod:`ceph_tpu_torch.analysis.prewarm_registry` with a note naming
  the warmup that builds it.
- ``device-raw-shape`` — arguments fed from I/O-path modules to the
  wrappers whose batchers key their warm set by shape
  (``SHAPE_KEYED_ENTRYPOINTS``) must not contain a raw ``len(...)`` or
  ``.shape`` expression: a CUDA launch takes any shape, but a shape
  outside the warmed bucket ladder is a cold launch (allocator growth,
  masks and operators made mid-I/O); go through ``pow2_bucket`` /
  ``bucket_lanes``.
- ``device-sync-under-lock`` — no ``torch.cuda.synchronize()``, stream
  or event ``.synchronize()``, ``.item()`` or blocking ``.cpu()``
  while a lock is held: the thread waits for every launch queued on
  the card, and every other thread waits behind the lock.  Calls under
  the lock are resolved through the project call graph
  (:mod:`ceph_tpu_torch.analysis.dataflow`), so a helper that syncs
  three frames below the critical section is caught too, with the
  chain named in the finding.
"""

from __future__ import annotations

import ast

from ceph_tpu_torch.analysis.core import SEV_ERROR, Finding, Project, Rule
from ceph_tpu_torch.analysis.dataflow import (
    SYNC_CALLS,
    call_short,
    engine_for,
    is_library_call,
    to_target,
)
from ceph_tpu_torch.analysis.prewarm_registry import (
    BUCKET_HELPERS,
    PREWARMED,
    SHAPE_KEYED_ENTRYPOINTS,
)
from ceph_tpu_torch.analysis.rules.common import (
    ScopedVisitor,
    call_name,
    is_lockish,
)

REGISTRY_PATH = "ceph_tpu_torch/analysis/prewarm_registry.py"


class _LibrarySiteVisitor(ScopedVisitor):
    """Collects (qualname, line) of every program-creating site: a
    ``_build.library(...)`` call, keyed by its enclosing def."""

    def __init__(self):
        super().__init__()
        self.sites: list[tuple[str, int]] = []

    def visit_Call(self, node):
        if is_library_call(node):
            self.sites.append((self.qualname, node.lineno))
        self.generic_visit(node)


def library_sites(sf) -> list[tuple[str, int]]:
    v = _LibrarySiteVisitor()
    v.visit(sf.tree)
    return v.sites


def _io_path_roots(project: Project) -> set[str]:
    roots = set()
    for sf in project.files:
        if (sf.path.startswith("ceph_tpu_torch/osd/")
                or sf.path.startswith("ceph_tpu_torch/parallel/")
                or sf.path == "ceph_tpu_torch/mgr/analytics.py"):
            roots.add(sf.module)
    return roots


def loaders_reached(graph, fid: str) -> set[str]:
    """``module:qualname`` of every kernel loader that the function
    ``fid`` reaches through the call graph (a
    :class:`~ceph_tpu_torch.analysis.dataflow.CallGraph`; itself
    included): the libraries a call of it may build."""
    seen: set[str] = set()
    stack = [fid]
    while stack:
        cur = stack.pop()
        if cur in seen or cur not in graph.functions:
            continue
        seen.add(cur)
        fn = graph.functions[cur]
        for node in ast.walk(fn.node):
            if isinstance(node, ast.Call):
                callee = graph.resolve(fn, node)
                if callee is not None and callee not in seen:
                    stack.append(callee)
    return seen & graph.loader_defs


def prewarm_findings(project: Project) -> list[Finding]:
    """The ``device-prewarm`` findings: undeclared loaders reachable
    from the I/O path, and registry entries that match no loader."""
    findings: list[Finding] = []
    roots = _io_path_roots(project)
    reachable = project.reachable_from(roots) | roots
    mods = project.by_module()
    for mod in sorted(reachable):
        sf = mods.get(mod)
        if sf is None:
            continue
        for qual, line in library_sites(sf):
            key = f"{mod}:{qual}"
            if key not in PREWARMED:
                findings.append(Finding(
                    "device-prewarm", SEV_ERROR, sf.path, line,
                    f"kernel loader {key} is not in the prewarm "
                    f"registry ({REGISTRY_PATH}) — declare which "
                    f"warmup builds its library, or nvcc will run "
                    f"inside the I/O path",
                ))

    # stale registry entries point at renamed/removed loaders —
    # only meaningful when the project actually contains the
    # registry module (fixture projects don't)
    if any(sf.path == REGISTRY_PATH for sf in project.files):
        live_keys = set()
        for mod in mods:
            live_keys |= {f"{mod}:{q}"
                          for q, _ in library_sites(mods[mod])}
        for key in sorted(set(PREWARMED) - live_keys):
            findings.append(Finding(
                "device-prewarm", SEV_ERROR, REGISTRY_PATH, 1,
                f"prewarm registry entry {key} matches no kernel "
                f"loader in the tree (renamed or removed kernel?)",
            ))
    return findings


class DeviceDisciplineRule(Rule):
    name = "device-discipline"
    rules = ("device-prewarm", "device-raw-shape", "device-sync-under-lock")
    catalog = {
        "device-prewarm":
            "kernel library loader (_build.library: an nvcc build at "
            "first use) reachable from the I/O path is not declared in "
            "the prewarm registry",
        "device-raw-shape":
            "raw len()/.shape fed to a shape-keyed kernel wrapper "
            "instead of a pow2-bucketed dimension",
        "device-sync-under-lock":
            "synchronize/.item()/.cpu() (a wait for the card) while "
            "holding a lock",
    }

    def run(self, project: Project) -> list[Finding]:
        findings = prewarm_findings(project)
        roots = _io_path_roots(project)

        # -- device-raw-shape / device-sync-under-lock ------------------
        engine = engine_for(project)
        for sf in project.files:
            in_io_path = sf.module in roots
            findings.extend(_scan_module(sf, in_io_path, engine))
        return findings


def _scan_module(sf, in_io_path: bool, engine=None) -> list[Finding]:
    findings: list[Finding] = []
    seen: set[tuple] = set()

    class V(ScopedVisitor):
        def __init__(self):
            super().__init__()
            self.lock_depth = 0

        def visit_With(self, node):
            held = sum(
                1 for item in node.items if is_lockish(item.context_expr))
            self.lock_depth += held
            self.generic_visit(node)
            self.lock_depth -= held

        visit_AsyncWith = visit_With

        def _check_callee_syncs(self, node, name: str) -> None:
            """Call-graph pass: the callee (transitively, bounded
            depth) forces a device sync while our lock is held."""
            if engine is None:
                return
            caller = _enclosing(engine, sf.module, self.qualname)
            if caller is None:
                return
            fid = engine.graph.resolve(caller, node)
            if fid is None:
                return
            hit = engine.may_sync(fid)
            if hit is None:
                return
            sync, chain = hit
            callee = engine.graph.functions[fid]
            via = " -> ".join(
                f"{c}()" for c in (callee.name,) + tuple(
                    x for x in chain if x != callee.name))
            key = (sf.path, name, via)
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(
                "device-sync-under-lock", SEV_ERROR, sf.path,
                node.lineno,
                f"call to {name}() while holding a lock in "
                f"{sf.module}:{self.qualname} — {via} waits for the "
                f"card (via the call graph); every waiter stalls "
                f"behind the device queue; move the wait outside the "
                f"critical section",
            ))

        def visit_Call(self, node):
            name = call_name(node)
            short = call_short(node)
            sync = short if short in SYNC_CALLS or (
                short == "to" and to_target(node) == "cpu") else None
            if self.lock_depth and sync is not None:
                findings.append(Finding(
                    "device-sync-under-lock", SEV_ERROR, sf.path,
                    node.lineno,
                    f"{sync}() while holding a lock in "
                    f"{sf.module}:{self.qualname} — a wait for the card "
                    f"under a lock stalls every waiter; move it outside "
                    f"the critical section",
                ))
            elif self.lock_depth and name is not None:
                self._check_callee_syncs(node, name)
            if in_io_path and short in SHAPE_KEYED_ENTRYPOINTS:
                for arg in list(node.args) + [k.value for k in node.keywords]:
                    bad = _raw_dim(arg)
                    if bad is not None:
                        findings.append(Finding(
                            "device-raw-shape", SEV_ERROR, sf.path,
                            bad.lineno,
                            f"argument of shape-keyed kernel wrapper "
                            f"{short}() in {sf.module}:{self.qualname} "
                            f"contains a raw {_describe(bad)} — a shape "
                            f"outside the warmed bucket ladder is a cold "
                            f"launch; route the size through "
                            f"pow2_bucket()/bucket_lanes()",
                        ))
                        break
            self.generic_visit(node)

    V().visit(sf.tree)
    return findings


def _enclosing(engine, module: str, qualname: str):
    """FunctionInfo for the visitor's scope chain (longest known def
    prefix), shared shape with rules/locks.py."""
    if qualname == "<module>":
        return None
    parts = qualname.split(".")
    for end in range(len(parts), 0, -1):
        fid = f"{module}:{'.'.join(parts[:end])}"
        fn = engine.graph.functions.get(fid)
        if fn is not None:
            return fn
    return None


def _raw_dim(arg: ast.AST) -> ast.AST | None:
    """First raw ``len(...)`` call or ``.shape`` access in the argument
    expression that is not wrapped by a bucket helper."""
    guarded: set[int] = set()
    for sub in ast.walk(arg):
        if isinstance(sub, ast.Call):
            name = call_name(sub)
            if name and name.split(".")[-1] in BUCKET_HELPERS:
                for inner in ast.walk(sub):
                    guarded.add(id(inner))
    for sub in ast.walk(arg):
        if id(sub) in guarded:
            continue
        if (isinstance(sub, ast.Call)
                and isinstance(sub.func, ast.Name)
                and sub.func.id == "len"):
            return sub
        if isinstance(sub, ast.Attribute) and sub.attr == "shape":
            return sub
    return None


def _describe(node: ast.AST) -> str:
    return "len() call" if isinstance(node, ast.Call) else ".shape access"

"""Rule family 2: lock order and blocking-under-lock.

- ``lock-cycle`` — the cross-module lock-acquisition graph (built from
  lexically nested ``with <lock>`` blocks and ``.acquire()`` calls
  under a held lock) must be acyclic; a cycle is a potential deadlock
  the interleave fuzzer can only find by luck.
- ``lock-blocking`` — no blocking call (sleep, fsync, subprocess,
  socket send, dynamic import, store commit) while a lock is held.
  Calls under a lock are resolved through the project call graph
  (:mod:`ceph_tpu_torch.analysis.dataflow`: ``self.method``, module
  functions, imported functions, class methods across modules), so a
  method that takes a lock and then calls a helper three frames away
  that blocks is still caught — the chain that blocks is named in the
  finding.  Depth is bounded by the engine's
  ``CEPH_TPU_CTLINT_TRANSFER_MAX_DEPTH`` rounds; deeper chains widen
  to "not proven" rather than slowing the lint down.
"""

from __future__ import annotations

from ceph_tpu_torch.analysis.core import SEV_ERROR, SEV_WARNING, Finding, Project, Rule
from ceph_tpu_torch.analysis.dataflow import (
    BLOCKING_CALLS,
    BLOCKING_METHODS,
    engine_for,
)
from ceph_tpu_torch.analysis.rules.common import (
    ScopedVisitor,
    call_name,
    is_lockish,
    lock_ident,
)

# the seed sets live in dataflow (shared with the summary pass); kept
# importable here for back-compat with older rule consumers
_BLOCKING = BLOCKING_CALLS
_BLOCKING_METHODS = BLOCKING_METHODS


def _blocking_reason(name: str | None) -> str | None:
    if not name:
        return None
    if name in _BLOCKING:
        return _BLOCKING[name]
    # match dotted suffixes like self._sock.sendall
    for dotted, why in _BLOCKING.items():
        if name.endswith("." + dotted):
            return why
    return _BLOCKING_METHODS.get(name.split(".")[-1])


class _LockVisitor(ScopedVisitor):
    """Per-module pass: collects acquisition-order edges, blocking
    calls under locks, and every call made under a held lock (for the
    call-graph resolution pass)."""

    def __init__(self, sf):
        super().__init__()
        self.sf = sf
        self.held: list[tuple[str, int]] = []   # (lock ident, line)
        self.edges: list[tuple[str, str, str, int]] = []  # a, b, path, line
        self.blocking: list[tuple[str, int, str]] = []
        #: calls made under a held lock, for interprocedural
        #: resolution: (call node, display name, line, holder qualname)
        self.calls_under_lock: list[tuple] = []

    def _enter_locks(self, node) -> int:
        n = 0
        for item in node.items:
            if is_lockish(item.context_expr):
                ident = lock_ident(
                    self.sf.module, self.scope, item.context_expr)
                if self.held:
                    self.edges.append((
                        self.held[-1][0], ident, self.sf.path, node.lineno))
                self.held.append((ident, node.lineno))
                n += 1
        return n

    def visit_With(self, node):
        n = self._enter_locks(node)
        self.generic_visit(node)
        if n:
            del self.held[-n:]

    visit_AsyncWith = visit_With

    def visit_Call(self, node):
        name = call_name(node)
        short = name.split(".")[-1] if name else None
        if short == "acquire" and name and is_lockish(node.func.value):
            ident = lock_ident(self.sf.module, self.scope, node.func.value)
            if self.held:
                self.edges.append((
                    self.held[-1][0], ident, self.sf.path, node.lineno))
        if self.held:
            reason = _blocking_reason(name)
            if reason is not None:
                self.blocking.append((name, node.lineno, reason))
            elif name is not None:
                self.calls_under_lock.append(
                    (node, name, node.lineno, self.qualname))
        self.generic_visit(node)


class LockOrderRule(Rule):
    name = "lock-order"
    rules = ("lock-cycle", "lock-blocking")
    catalog = {
        "lock-cycle":
            "cycle in the cross-module lock-acquisition graph "
            "(potential deadlock)",
        "lock-blocking":
            "blocking call (sleep/fsync/subprocess/import/commit) "
            "while holding a lock — directly or via the call graph",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        engine = engine_for(project)
        edges: dict[str, set[str]] = {}
        edge_at: dict[tuple[str, str], tuple[str, int]] = {}
        by_module = {sf.module: sf for sf in project.files}
        for sf in project.files:
            v = _LockVisitor(sf)
            v.visit(sf.tree)
            for a, b, path, line in v.edges:
                if a == b:
                    continue  # re-entrant nesting of one lock: RLock
                edges.setdefault(a, set()).add(b)
                edge_at.setdefault((a, b), (path, line))
            for name, line, reason in v.blocking:
                findings.append(Finding(
                    "lock-blocking", SEV_ERROR, sf.path, line,
                    f"{name}() under a held lock {reason} — every "
                    f"other acquirer stalls behind it; shrink the "
                    f"critical section",
                ))
            # call-graph pass: a call under a lock whose resolved
            # callee (transitively, bounded depth) blocks
            seen: set[tuple] = set()
            for node, name, line, holder in v.calls_under_lock:
                caller = self._enclosing(engine, sf.module, holder)
                if caller is None:
                    continue
                fid = engine.graph.resolve(caller, node)
                if fid is None:
                    continue
                hit = engine.may_block(fid)
                if hit is None:
                    continue
                reason, chain = hit
                callee = engine.graph.functions[fid]
                via = " -> ".join(
                    f"{c}()" for c in (callee.name,) + tuple(
                        x for x in chain if x != callee.name))
                key = ("lock-blocking", sf.path, name, via)
                if key in seen:
                    continue
                seen.add(key)
                findings.append(Finding(
                    "lock-blocking", SEV_WARNING, sf.path, line,
                    f"call to {name}() under a held lock — {via} "
                    f"{reason} (via the call graph); the lock is held "
                    f"across that",
                ))

        for cycle in _cycles(edges):
            a, b = cycle[0], cycle[1 % len(cycle)]
            path, line = edge_at.get((a, b), ("ceph_tpu_torch", 1))
            findings.append(Finding(
                "lock-cycle", SEV_ERROR, path, line,
                "lock-order cycle: " + " -> ".join(cycle + [cycle[0]]),
            ))
        _ = by_module
        return findings

    @staticmethod
    def _enclosing(engine, module: str, qualname: str):
        """FunctionInfo whose qualname matches the visitor scope chain
        (longest prefix of the scope that is a known def)."""
        if qualname == "<module>":
            return None
        parts = qualname.split(".")
        for end in range(len(parts), 0, -1):
            fid = f"{module}:{'.'.join(parts[:end])}"
            fn = engine.graph.functions.get(fid)
            if fn is not None:
                return fn
        return None


def _cycles(edges: dict[str, set[str]]) -> list[list[str]]:
    """Elementary cycles via DFS; each reported once, rotated so the
    lexicographically smallest node leads (stable messages)."""
    seen: set[tuple[str, ...]] = set()
    out: list[list[str]] = []

    def dfs(start: str, node: str, path: list[str], visited: set[str]):
        for nxt in sorted(edges.get(node, ())):
            if nxt == start:
                i = path.index(min(path))
                canon = tuple(path[i:] + path[:i])
                if canon not in seen:
                    seen.add(canon)
                    out.append(list(canon))
            elif nxt not in visited and nxt > start:
                # only walk nodes > start: each cycle found exactly
                # once, from its smallest member
                dfs(start, nxt, path + [nxt], visited | {nxt})

    for start in sorted(edges):
        dfs(start, start, [start], {start})
    return out

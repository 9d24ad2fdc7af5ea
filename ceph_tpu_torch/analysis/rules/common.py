"""Shared AST helpers for the rule modules."""

from __future__ import annotations

import ast
import re

#: names that look like locks when used as a ``with`` context or
#: ``.acquire()`` receiver
LOCKISH_RE = re.compile(r"(^|_)(lock|mutex)s?$", re.IGNORECASE)


def attr_chain(node: ast.AST) -> str | None:
    """``a.b.c`` -> "a.b.c"; None for anything not a pure name chain."""
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def last_name(node: ast.AST) -> str | None:
    """The rightmost identifier of a name/attribute chain."""
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    return None


def is_lockish(node: ast.AST) -> bool:
    name = last_name(node)
    return bool(name and LOCKISH_RE.search(name))


def lock_ident(sf_module: str, scope: list[str], node: ast.AST) -> str:
    """Stable identity for a lock object: ``self._lock`` inside class C
    -> ``module.C._lock``; a module-global -> ``module.NAME``."""
    chain = attr_chain(node) or "?"
    cls = next((s for s in scope if s[:1].isupper()), None)
    if chain.startswith("self."):
        owner = f"{sf_module}.{cls}" if cls else sf_module
        return f"{owner}.{chain[5:]}"
    return f"{sf_module}.{chain}"


class ScopedVisitor(ast.NodeVisitor):
    """NodeVisitor that tracks the enclosing def/class qualname chain
    in ``self.scope`` (list of names, classes included)."""

    def __init__(self):
        self.scope: list[str] = []

    def _push(self, node):
        self.scope.append(node.name)
        self.generic_visit(node)
        self.scope.pop()

    visit_FunctionDef = _push
    visit_AsyncFunctionDef = _push
    visit_ClassDef = _push

    @property
    def qualname(self) -> str:
        return ".".join(self.scope) or "<module>"

    def func_qualname(self) -> str:
        """Qualname of just the def chain (classes included) — matches
        the prewarm-registry key style."""
        return ".".join(self.scope) or "<module>"


def call_name(call: ast.Call) -> str | None:
    """Full dotted name of a call target, or None."""
    return attr_chain(call.func)


def contains_call_to(node: ast.AST, names: set[str]) -> ast.Call | None:
    """First descendant Call whose dotted or last name is in ``names``."""
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            dotted = call_name(sub)
            if dotted and (dotted in names or dotted.split(".")[-1] in names):
                return sub
    return None

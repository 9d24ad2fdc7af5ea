"""ctlint core: findings model, suppressions, baseline, project walker.

Everything here is plain :mod:`ast` — the analyzer never imports the
code it checks (nor ``torch``: a lint run costs no CUDA context), so
fixture files may contain deliberate violations (duplicate frame ids,
device sync under locks) that would assert or deadlock if executed.
"""

from __future__ import annotations

import ast
import functools
import json
import re
from dataclasses import dataclass, field
from pathlib import Path

SEV_ERROR = "error"
SEV_WARNING = "warning"

#: inline suppression, honored on the flagged line or the line above:
#: ``# ctlint: disable=rule-a,rule-b`` (or ``disable=all``)
_SUPPRESS_RE = re.compile(r"#\s*ctlint:\s*disable=([a-z0-9_,\- ]+|all)")
#: whole-file suppression: ``# ctlint: disable-file=rule-a``
_SUPPRESS_FILE_RE = re.compile(
    r"#\s*ctlint:\s*disable-file=([a-z0-9_,\- ]+|all)")
#: opt a module into the pure-trace determinism scope (anchored to a
#: whole comment line so prose *mentioning* the marker doesn't opt in)
_PURE_TRACE_RE = re.compile(r"^\s*#\s*ctlint:\s*pure-trace\s*$", re.M)


@dataclass(frozen=True)
class Finding:
    """One rule violation at ``path:line``.

    The baseline key deliberately omits ``line`` so unrelated edits
    above a grandfathered finding do not un-baseline it."""

    rule: str
    severity: str
    path: str          # repo-relative, forward slashes
    line: int
    message: str

    def key(self) -> tuple[str, str, str]:
        return (self.rule, self.path, self.message)

    def to_json(self) -> dict:
        return {
            "rule": self.rule, "severity": self.severity,
            "file": self.path, "line": self.line, "message": self.message,
        }

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.rule}] "
                f"{self.severity}: {self.message}")


class SourceFile:
    """One parsed module: AST + per-line suppression sets."""

    def __init__(self, path: str, text: str):
        self.path = path
        self.text = text
        self.lines = text.splitlines()
        self.tree = ast.parse(text, filename=path)
        self.pure_trace = bool(_PURE_TRACE_RE.search(text))
        self._line_disable: dict[int, set[str]] = {}
        self._file_disable: set[str] = set()
        for i, ln in enumerate(self.lines, start=1):
            if "ctlint" not in ln:
                continue
            m = _SUPPRESS_RE.search(ln)
            if m:
                self._line_disable[i] = {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }
            m = _SUPPRESS_FILE_RE.search(ln)
            if m:
                self._file_disable |= {
                    r.strip() for r in m.group(1).split(",") if r.strip()
                }

    def suppressed(self, rule: str, line: int) -> bool:
        if self._file_disable & {rule, "all"}:
            return True
        for at in (line, line - 1):
            rules = self._line_disable.get(at)
            if rules and rules & {rule, "all"}:
                return True
        return False

    @functools.cached_property
    def module(self) -> str:
        """Dotted module name for a repo-relative path (best effort —
        fixture files outside a package just use their stem)."""
        p = self.path[:-3] if self.path.endswith(".py") else self.path
        parts = [x for x in p.split("/") if x]
        if parts and parts[-1] == "__init__":
            parts = parts[:-1]
        return ".".join(parts)


@dataclass
class Project:
    """The unit a rule runs over: parsed sources plus an auxiliary
    read-only set that rules may mine for *evidence* (e.g. config-key
    reads) but never report findings against.  The port's evidence is
    its own tests (``tests/test_torch_*.py``) and ``chip_smoke.py``:
    the JAX package's tests read the JAX package's keys, which are no
    evidence that the port reads its own."""

    root: Path
    files: list[SourceFile] = field(default_factory=list)
    aux_files: list[SourceFile] = field(default_factory=list)

    @classmethod
    def load(cls, root: str | Path,
             include: tuple[str, ...] = ("ceph_tpu_torch",),
             aux: tuple[str, ...] = ("tests/test_torch_*.py",
                                     "chip_smoke.py"),
             ) -> "Project":
        root = Path(root)
        proj = cls(root=root)
        proj.files = _collect(root, include)
        proj.aux_files = _collect(root, aux)
        return proj

    # -- module/import helpers (device-discipline reachability) --------

    def by_module(self) -> dict[str, SourceFile]:
        return {sf.module: sf for sf in self.files}

    def import_graph(self) -> dict[str, set[str]]:
        """module -> imported project modules.  ``from pkg import x``
        resolves ``pkg.x`` when that is a project module, else ``pkg``
        — enough precision for reachability over absolute imports
        (the house style; relative imports are not used).  Computed
        once per file set (several rules ask)."""
        key = tuple(id(sf) for sf in self.files)
        cached = self.__dict__.get("_import_graph")
        if cached is None or cached[0] != key:
            cached = self.__dict__["_import_graph"] = (key, self._import_graph())
        return cached[1]

    def _import_graph(self) -> dict[str, set[str]]:
        mods = self.by_module()
        graph: dict[str, set[str]] = {m: set() for m in mods}
        for mod, sf in mods.items():
            for node in ast.walk(sf.tree):
                if isinstance(node, ast.Import):
                    for alias in node.names:
                        tgt = _project_module(alias.name, mods)
                        if tgt:
                            graph[mod].add(tgt)
                elif isinstance(node, ast.ImportFrom) and node.module:
                    base = _project_module(node.module, mods)
                    for alias in node.names:
                        sub = _project_module(
                            f"{node.module}.{alias.name}", mods)
                        if sub:
                            graph[mod].add(sub)
                        elif base:
                            graph[mod].add(base)
        return graph

    def reachable_from(self, roots: set[str]) -> set[str]:
        graph = self.import_graph()
        seen: set[str] = set()
        stack = [r for r in roots if r in graph]
        while stack:
            m = stack.pop()
            if m in seen:
                continue
            seen.add(m)
            stack.extend(graph.get(m, ()) - seen)
        return seen


def _project_module(name: str, mods: dict[str, SourceFile]) -> str | None:
    if name in mods:
        return name
    # a package import maps to its __init__ module if present
    return None


def _collect(root: Path, names: tuple[str, ...]) -> list[SourceFile]:
    out: list[SourceFile] = []
    for name in names:
        p = root / name
        if any(c in name for c in "*?["):
            paths = sorted(f for f in root.glob(name) if f.suffix == ".py")
        elif p.is_file() and p.suffix == ".py":
            paths = [p]
        elif p.is_dir():
            paths = sorted(p.rglob("*.py"))
        else:
            continue
        for f in paths:
            if "__pycache__" in f.parts:
                continue
            rel = f.relative_to(root).as_posix()
            try:
                out.append(SourceFile(rel, f.read_text()))
            except (SyntaxError, UnicodeDecodeError):
                continue  # fixtures may hold non-module content
    return out


class Rule:
    """Base class: subclasses set ``name`` (the family), ``rules`` (the
    ids they can emit) and implement :meth:`run`."""

    name = "rule"
    rules: tuple[str, ...] = ()

    def run(self, project: Project) -> list[Finding]:
        raise NotImplementedError


def run_analysis(root: str | Path, rules=None,
                 project: Project | None = None) -> list[Finding]:
    """Run ``rules`` (default: all) over the tree at ``root``; returns
    findings with inline suppressions already filtered, sorted by
    (path, line, rule)."""
    from ceph_tpu_torch.analysis.rules import ALL_RULES

    if project is None:
        project = Project.load(root)
    by_path = {sf.path: sf for sf in project.files}
    findings: list[Finding] = []
    for rule in (rules if rules is not None else
                 [cls() for cls in ALL_RULES]):
        for f in rule.run(project):
            sf = by_path.get(f.path)
            if sf is not None and sf.suppressed(f.rule, f.line):
                continue
            findings.append(f)
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


# -- baseline ---------------------------------------------------------------

BASELINE_VERSION = 1


def load_baseline(path: str | Path) -> dict[tuple[str, str, str], str]:
    """baseline key -> justification (empty dict when no file)."""
    p = Path(path)
    if not p.exists():
        return {}
    data = json.loads(p.read_text())
    out = {}
    for e in data.get("findings", []):
        out[(e["rule"], e["file"], e["message"])] = e.get(
            "justification", "")
    return out


def split_by_baseline(
    findings: list[Finding], baseline: dict[tuple[str, str, str], str],
) -> tuple[list[Finding], list[Finding], list[tuple]]:
    """(new, grandfathered, stale-baseline-entries)."""
    keys = {f.key() for f in findings}
    new = [f for f in findings if f.key() not in baseline]
    old = [f for f in findings if f.key() in baseline]
    stale = [k for k in baseline if k not in keys]
    return new, old, stale


def baseline_integrity(
    baseline: dict[tuple[str, str, str], str],
    project: Project,
    known_rules: set[str],
) -> list[tuple[tuple[str, str, str], str]]:
    """Entries that cannot possibly fire again: their rule id is gone
    from the catalog or their file is gone from the tree.  A normal
    stale entry (finding fixed, file still there) merely needs an
    ``--update-baseline``; these are harder rot — the (rule, file)
    pair no longer EXISTS — and the chaos/bench preflight fails on
    them so dead grandfather entries cannot mask a rename."""
    paths = {sf.path for sf in project.files} \
        | {sf.path for sf in project.aux_files}
    out: list[tuple[tuple[str, str, str], str]] = []
    for key in sorted(baseline):
        rule, path, _msg = key
        if rule not in known_rules:
            out.append((key, f"rule {rule!r} no longer exists"))
        elif path not in paths:
            out.append((key, f"file {path!r} no longer exists"))
    return out


def write_baseline(path: str | Path, findings: list[Finding],
                   previous: dict[tuple[str, str, str], str]) -> None:
    """Rewrite the baseline to exactly the current finding set, keeping
    each surviving entry's justification; new entries get a TODO
    placeholder the committer must replace."""
    entries = []
    for f in sorted(findings, key=lambda f: f.key()):
        entries.append({
            "rule": f.rule, "file": f.path, "message": f.message,
            "justification": previous.get(
                f.key(), "TODO: justify or fix before committing"),
        })
    Path(path).write_text(json.dumps(
        {"version": BASELINE_VERSION, "findings": entries},
        indent=2, sort_keys=False) + "\n")

"""Rule family 4: config registry hygiene.

``common/config.py`` is the single source of truth for options — a
read of an undeclared key raises ``KeyError`` at runtime (but only
when that code path runs), and a declared option nothing reads is
documentation debt pretending to be a knob.

- ``config-undeclared`` — every literal config-key read
  (``conf["k"]`` / ``conf.get("k")`` / observer registration /
  ``DoutLogger("sub", ...)`` implying ``debug_<sub>``) must name a
  declared Option.
- ``config-dead`` — every declared Option must be read somewhere in
  the tree (``ceph_tpu_torch/`` plus the port's tests and
  ``chip_smoke.py`` as evidence; env
  ``CEPH_TPU_<KEY>`` references count).
"""

from __future__ import annotations

import ast
import re

from ceph_tpu_torch.analysis.core import SEV_ERROR, SEV_WARNING, Finding, Project, Rule
from ceph_tpu_torch.analysis.rules.common import call_name, last_name

CONFIG_MODULE = "ceph_tpu_torch/common/config.py"

#: receivers treated as a ConfigProxy (exact last-segment match)
_CONF_NAMES = {"conf", "conf0", "config", "cfg", "sc_conf", "mon_conf"}

_ENV_RE = re.compile(r"CEPH_TPU_([A-Z0-9_]{3,})")


def _conf_receiver(node: ast.AST) -> bool:
    return last_name(node) in _CONF_NAMES


def _literal_key(node: ast.AST) -> str | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def collect_declared(project: Project) -> dict[str, tuple[str, int]]:
    """Option name -> (path, line), parsed statically from
    ``Option("name", ...)`` calls (in the live tree these all live in
    ``common/config.py``; fixture projects declare inline)."""
    out: dict[str, tuple[str, int]] = {}
    for sf in project.files:
        for node in ast.walk(sf.tree):
            if (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)
                    and node.func.id == "Option" and node.args):
                key = _literal_key(node.args[0])
                if key:
                    out.setdefault(key, (sf.path, node.lineno))
    return out


def collect_reads(sf) -> tuple[list[tuple[str, int]], list[tuple[str, int]]]:
    """(proxy_reads, env_reads) as (key, line) lists.  Proxy reads are
    subject to the undeclared check; env spellings
    (``CEPH_TPU_<KEY>``) only count as liveness *evidence* — raw
    ``os.environ`` knobs that deliberately bypass the config system
    (compile-cache switches, pre-config constants) are not findings."""
    reads: list[tuple[str, int]] = []
    for node in ast.walk(sf.tree):
        if isinstance(node, ast.Subscript) and _conf_receiver(node.value):
            key = _literal_key(node.slice)
            if key:
                reads.append((key, node.lineno))
        elif isinstance(node, ast.Call):
            name = call_name(node)
            if not name:
                continue
            parts = name.split(".")
            meth = parts[-1]
            recv_ok = len(parts) > 1 and parts[-2] in _CONF_NAMES
            if recv_ok and meth in ("get", "set", "rm") and node.args:
                key = _literal_key(node.args[0])
                if key:
                    reads.append((key, node.lineno))
            elif recv_ok and meth == "add_observer" and node.args:
                arg = node.args[0]
                if isinstance(arg, (ast.List, ast.Tuple)):
                    for el in arg.elts:
                        key = _literal_key(el)
                        if key:
                            reads.append((key, node.lineno))
            elif recv_ok and meth == "apply_changes" and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Dict):
                    for k in arg.keys:
                        key = _literal_key(k)
                        if key:
                            reads.append((key, node.lineno))
            elif meth in ("DoutLogger", "Dout") and node.args:
                sub = _literal_key(node.args[0])
                if sub:
                    reads.append((f"debug_{sub}", node.lineno))
    env_reads: list[tuple[str, int]] = []
    for i, line in enumerate(sf.lines, start=1):
        for m in _ENV_RE.finditer(line):
            env_reads.append((m.group(1).lower(), i))
    return reads, env_reads


class ConfigRegistryRule(Rule):
    name = "config-registry"
    rules = ("config-undeclared", "config-dead")
    catalog = {
        "config-undeclared":
            "config key read without a registered Option default "
            "(KeyError the first time that path runs)",
        "config-dead":
            "registered Option that nothing in the tree reads",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        declared = collect_declared(project)
        if not declared:
            return findings  # fixture projects without a config module
        aux_ids = {id(sf) for sf in project.aux_files}
        read_keys: set[str] = set()
        for sf in project.files + project.aux_files:
            reads, env_reads = collect_reads(sf)
            read_keys |= {k for k, _ in reads}
            read_keys |= {k for k, _ in env_reads}
            if id(sf) in aux_ids:
                continue
            for key, line in reads:
                if key not in declared:
                    findings.append(Finding(
                        "config-undeclared", SEV_ERROR, sf.path, line,
                        f"config key {key!r} is read but not declared "
                        f"in common/config.py OPTIONS — this raises "
                        f"KeyError the first time the path runs",
                    ))
        for key, (path, line) in sorted(declared.items()):
            if key not in read_keys:
                findings.append(Finding(
                    "config-dead", SEV_WARNING, path, line,
                    f"option {key!r} is declared but never read "
                    f"anywhere in the tree — wire it up or delete it",
                ))
        return findings

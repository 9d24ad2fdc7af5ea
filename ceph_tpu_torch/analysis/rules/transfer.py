"""Rule family 6: device-residency / transfer discipline.

A device-resident data plane dies by a thousand quiet host
round-trips: a ``.cpu()`` two calls below a launch, a ``bytes()`` on a
result that never needed to leave the card, a ``.to(device)`` of data
that was already resident, an ``if`` on a device scalar that stalls
the launch queue.  This family rides the interprocedural engine
(:mod:`ceph_tpu_torch.analysis.dataflow`) so a transfer is caught
wherever it hides in the call graph:

- ``device-host-sink`` — a device-resident tensor reaches a
  host-materializing op (``.cpu()``, ``.numpy()``, ``.tolist()``,
  ``.item()``, ``.to("cpu")``, ``bytes()``, ``np.asarray`` /
  ``np.array`` / ``np.ascontiguousarray``, a ``.copy_()`` into a host
  tensor, ``transfer_guard.readback``) inside the I/O-path module set
  (osd/, parallel/, mgr/analytics.py and everything they import).
  ``readback`` counts: it is the *declared* exit, but every use must
  be a justified by-design host boundary (baseline) — anything else is
  a hidden round-trip.
- ``device-redundant-put`` — ``.to(<device>)``, ``.cuda()``,
  ``transfer_guard.upload`` or ``torch.as_tensor(..., device=)`` fed
  an already device-resident tensor: a no-op at best, a copy at worst.
- ``device-nondonated-inout`` — a buffer both passed into and
  reassigned from a kernel wrapper that is not declared to update it
  in place (``prewarm_registry.DONATED``): the wrapper allocates a
  second output buffer every call.
- ``device-implicit-sync`` — a device tensor evaluated for control
  flow (``if``/``while``/``assert``/comparison) or through
  ``bool()``/``float()``/``int()``: an implicit blocking sync that
  drains the launch queue.
"""

from __future__ import annotations

import ast

from ceph_tpu_torch.analysis.core import (
    SEV_ERROR,
    SEV_WARNING,
    Finding,
    Project,
    Rule,
)
from ceph_tpu_torch.analysis.dataflow import attr_chain, engine_for
from ceph_tpu_torch.analysis.prewarm_registry import DONATED, JIT_ENTRYPOINTS
from ceph_tpu_torch.analysis.rules.device import _io_path_roots


class TransferRule(Rule):
    name = "transfer"
    rules = (
        "device-host-sink",
        "device-redundant-put",
        "device-nondonated-inout",
        "device-implicit-sync",
    )
    catalog = {
        "device-host-sink":
            "device-resident tensor reaches a host-materializing op "
            "(.cpu/.numpy/.tolist/.item/bytes/np.asarray/readback) on "
            "the I/O path — declare the host exit or keep the buffer "
            "on device",
        "device-redundant-put":
            ".to(device)/.cuda()/upload applied to an already "
            "device-resident tensor (no-op round-trip)",
        "device-nondonated-inout":
            "buffer passed into and returned from a kernel wrapper "
            "that is not declared (prewarm_registry.DONATED) to "
            "update it in place",
        "device-implicit-sync":
            "device value evaluated for control flow or via "
            "bool()/float()/int() — an implicit blocking sync",
    }

    def run(self, project: Project) -> list[Finding]:
        engine = engine_for(project)
        roots = _io_path_roots(project)
        scope = project.reachable_from(roots) | roots
        findings: list[Finding] = []
        seen: set[tuple] = set()

        def add(rule: str, sev: str, path: str, line: int,
                msg: str) -> None:
            key = (rule, path, line, msg)
            if key in seen:
                return
            seen.add(key)
            findings.append(Finding(rule, sev, path, line, msg))

        donated_names = {
            key.split(":")[-1].split(".")[-1]: args
            for key, args in DONATED.items()
        }

        for fn in engine.functions_in({sf.module for sf in project.files}):
            where = f"{fn.module}:{fn.qual}"
            in_scope = fn.module in scope

            def on_event(kind, node, payload, fn=fn, where=where,
                         in_scope=in_scope):
                line = getattr(node, "lineno", 1)
                if kind == "host_sink" and in_scope:
                    op, why = payload
                    add("device-host-sink", SEV_ERROR, fn.path, line,
                        f"device-resident value reaches {op} in {where} "
                        f"— {why}; keep the buffer on device across the "
                        f"pipeline or baseline this as a by-design host "
                        f"exit")
                elif kind == "redundant_put":
                    (op,) = payload
                    add("device-redundant-put", SEV_WARNING, fn.path,
                        line,
                        f"{op} applied to an already device-resident "
                        f"value in {where} — the copy round-trips a "
                        f"buffer that never left the device; drop it")
                elif kind == "implicit_sync":
                    what, why = payload
                    add("device-implicit-sync", SEV_ERROR, fn.path, line,
                        f"device value evaluated via {what} in {where} "
                        f"— {why}; hoist the predicate into the kernel "
                        f"or fetch the scalar once, explicitly")

            engine.replay(fn, on_event)
            findings_inout = self._inout_pass(
                engine, fn, where, donated_names)
            for f in findings_inout:
                key = (f.rule, f.path, f.line, f.message)
                if key not in seen:
                    seen.add(key)
                    findings.append(f)
        return findings

    # -- device-nondonated-inout --------------------------------------

    def _inout_pass(self, engine, fn, where: str,
                    donated_names: dict) -> list[Finding]:
        out: list[Finding] = []
        for node in ast.walk(fn.node):
            if not (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and len(node.targets) == 1):
                continue
            target = node.targets[0]
            tname = None
            if isinstance(target, ast.Name):
                tname = target.id
            elif isinstance(target, ast.Attribute):
                tname = attr_chain(target)
            if tname is None:
                continue
            call = node.value
            chain = attr_chain(call.func)
            short = chain.split(".")[-1] if chain else None
            fid = engine.graph.resolve(fn, call)
            if short not in JIT_ENTRYPOINTS:
                continue
            for ix, arg in enumerate(call.args):
                aname = None
                if isinstance(arg, ast.Name):
                    aname = arg.id
                elif isinstance(arg, ast.Attribute):
                    aname = attr_chain(arg)
                if aname != tname:
                    continue
                donated = DONATED.get(fid, ()) if fid else () \
                    or donated_names.get(short or "", ())
                if ix in donated:
                    continue
                out.append(Finding(
                    "device-nondonated-inout", SEV_WARNING, fn.path,
                    node.lineno,
                    f"buffer {tname!r} is passed into and reassigned "
                    f"from kernel wrapper {short}() in {where} without "
                    f"an in-place declaration — the wrapper allocates "
                    f"a fresh output buffer every call; update the "
                    f"argument in place and declare it in "
                    f"prewarm_registry.DONATED, or rename the result",
                ))
        return out

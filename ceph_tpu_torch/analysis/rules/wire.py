"""Rule family 3: wire protocol.

Scope: any class that declares a ``TYPE`` frame id and an
``encode_payload``/``decode_payload`` pair (in the live tree that is
``msg/messages.py``; fixtures mimic the shape).

- ``wire-frame-id`` — duplicate frame ids across message classes, and
  classes with an encode/decode pair but no registered (non-zero)
  ``TYPE``: the messenger registry would either assert at import or
  silently never route the frame.
- ``wire-asymmetry`` — the primitive sequence written by
  ``encode_payload`` must match what ``decode_payload`` reads.  The
  comparison is over *wire widths* (``u32``/``i32`` both occupy 4
  bytes; ``str_`` is a ``bytes_`` on the wire), with module-level
  ``_enc_*``/``_dec_*`` helper splicing, counted-loop normalization
  (``enc.u32(len(x))`` + loop == decode loop over ``range(dec.u32())``)
  and branch-tolerant matching for version gates.
"""

from __future__ import annotations

import ast

from ceph_tpu_torch.analysis.core import SEV_ERROR, Finding, Project, Rule
from ceph_tpu_torch.analysis.rules.common import call_name

#: primitive -> canonical wire token (widths, not signedness)
_PRIMS = {
    "u8": "b1", "bool_": "b1",
    "u16": "b2",
    "u32": "b4", "i32": "b4",
    "u64": "b8", "i64": "b8",
    "str_": "blob", "bytes_": "blob",
    "raw": "raw",
}

# sequence node kinds: ("p", token) | ("loop", body, counted) | ("opt",
# then, orelse) | ("ver", body).  ``counted`` marks a loop whose length
# prefix is embedded (decode's ``range(dec.u32())``): it must NOT
# absorb a preceding b4 during normalization — that b4 is a real field.


class _SeqBuilder:
    """Extracts the canonical wire sequence from one payload method."""

    def __init__(self, role: str, helpers: dict[str, list]):
        self.role = role          # "enc" | "dec"
        self.helpers = helpers    # resolved module helper sequences

    def body_seq(self, stmts: list[ast.stmt]) -> list:
        out: list = []
        for st in stmts:
            self._stmt(st, out)
        return _normalize(out)

    # -- statements ----------------------------------------------------

    def _stmt(self, st: ast.stmt, out: list) -> None:
        if isinstance(st, (ast.For, ast.AsyncFor, ast.While)):
            body: list = []
            counted = False
            if isinstance(st, ast.For):
                counted = self._counted_iter(st.iter, body)
            for s in st.body:
                self._stmt(s, body)
            body = _normalize(body)
            if body or counted:
                out.append(("loop", tuple(body), counted))
            return
        if isinstance(st, ast.If):
            then: list = []
            orelse: list = []
            for s in st.body:
                self._stmt(s, then)
            for s in st.orelse:
                self._stmt(s, orelse)
            then, orelse = _normalize(then), _normalize(orelse)
            if then or orelse:
                out.append(("opt", tuple(then), tuple(orelse)))
            return
        if isinstance(st, (ast.With, ast.AsyncWith)):
            ver = any(
                isinstance(item.context_expr, ast.Call)
                and (call_name(item.context_expr) or "").endswith("versioned")
                for item in st.items
            )
            inner: list = []
            for s in st.body:
                self._stmt(s, inner)
            inner = _normalize(inner)
            if ver:
                out.append(("ver", tuple(inner)))
            else:
                out.extend(inner)
            return
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef,
                           ast.ClassDef)):
            return  # nested defs don't run at encode time
        # expression statements / assigns / returns: walk the exprs
        self._expr(st, out)

    # -- expressions ---------------------------------------------------

    def _expr(self, node: ast.AST, out: list) -> None:
        """Evaluation-order walk emitting primitive tokens; loops
        embedded in comprehensions become counted loop nodes."""
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp,
                             ast.DictComp)):
            body: list = []
            counted = False
            for gen in node.generators:
                counted |= self._counted_iter(gen.iter, body)
                for cond in gen.ifs:
                    self._expr(cond, body)
            if isinstance(node, ast.DictComp):
                self._expr(node.key, body)
                self._expr(node.value, body)
            else:
                self._expr(node.elt, body)
            body = _normalize(body)
            if body or counted:
                out.append(("loop", tuple(body), counted))
            return
        if isinstance(node, ast.Call):
            # args first (evaluation order), then the call itself
            emitted = _emit_call(node, self.role, self.helpers, out,
                                 expr_walker=self._expr)
            if emitted:
                return
        for child in ast.iter_child_nodes(node):
            self._expr(child, out)

    def _counted_iter(self, it: ast.AST, body: list) -> bool:
        """``range(dec.u32())``-style iterator: emit nothing (the count
        is part of the loop node) and report counted=True.  A plain
        iterator just gets walked for stray prims."""
        if (isinstance(it, ast.Call) and isinstance(it.func, ast.Name)
                and it.func.id == "range" and len(it.args) == 1):
            arg = it.args[0]
            if (isinstance(arg, ast.Call)
                    and _prim_of(arg, self.role) == "b4"):
                return True
        self._expr(it, body)
        return False


def _prim_of(call: ast.Call, role: str) -> str | None:
    """Wire token when ``call`` is ``enc.<prim>(...)``/``dec.<prim>()``
    for the given role's receiver, else None."""
    name = call_name(call)
    if not name or "." not in name:
        return None
    recv, meth = name.rsplit(".", 1)
    if recv.split(".")[-1] not in ("enc", "dec", "encoder", "decoder"):
        return None
    return _PRIMS.get(meth)


def _emit_call(call: ast.Call, role: str, helpers, out: list,
               expr_walker=None) -> bool:
    """Emit tokens for one call node.  Returns True when the call was
    fully handled (helper splice or primitive)."""
    # helper splice: _enc_x(enc, ...) / _dec_x(dec)
    if isinstance(call.func, ast.Name):
        seq = helpers.get(call.func.id)
        if seq is not None:
            if expr_walker is not None:
                for arg in call.args:
                    if not isinstance(arg, ast.Name):
                        expr_walker(arg, out)
            out.extend(seq)
            return True
    tok = _prim_of(call, role)
    if tok is not None:
        # argument prims evaluate before the write (enc.u32(len(x)))
        if expr_walker is not None:
            for arg in call.args:
                expr_walker(arg, out)
        out.append(("p", tok))
        return True
    # nested struct: any call handed the raw enc/dec object
    # (``o.encode(enc)`` / ``OSDOp.decode(dec)``) is an opaque
    # sub-struct — both sides must have one at the same position
    for arg in call.args:
        if isinstance(arg, ast.Name) and arg.id in (
                "enc", "dec", "encoder", "decoder"):
            if expr_walker is not None:
                for other in call.args:
                    if other is not arg:
                        expr_walker(other, out)
            out.append(("p", "struct"))
            return True
    return False


def _normalize(seq: list) -> list:
    """Counted-loop merge: a ``b4`` write immediately followed by an
    *uncounted* loop is the loop's length prefix (``enc.u32(len(d))``
    + ``for``); fold it in so it matches a decode-side
    ``range(dec.u32())`` loop, whose count is already embedded."""
    out: list = []
    for item in seq:
        if (item[0] == "loop" and not item[2]
                and out and out[-1] == ("p", "b4")):
            out.pop()
            item = (item[0], item[1], True)
        out.append(item)
    return out


def _match(a: tuple, b: tuple) -> bool:
    """Structural sequence match with branch tolerance: an ``opt`` node
    may match the other side's nothing (skipped gate) or either of its
    branches may be compared positionally."""
    return _match_seq(list(a), list(b))


def _match_seq(a: list, b: list) -> bool:
    if not a and not b:
        return True
    # allow an optional group on either side to be skipped or taken
    for x, y in ((a, b), (b, a)):
        if x and x[0][0] == "opt":
            head, rest = x[0], x[1:]
            for branch in (head[1], head[2]):
                if _match_seq(list(branch) + rest, y):
                    return True
            return False
    if not a or not b:
        return False
    ha, hb = a[0], b[0]
    if ha[0] == "p" and hb[0] == "p":
        return ha[1] == hb[1] and _match_seq(a[1:], b[1:])
    if ha[0] == "loop" and hb[0] == "loop":
        # counted flags may differ (length prefix folded on one side)
        return _match_seq(list(ha[1]), list(hb[1])) and _match_seq(
            a[1:], b[1:])
    if ha[0] == "ver" and hb[0] == "ver":
        return _match_seq(list(ha[1]), list(hb[1])) and _match_seq(
            a[1:], b[1:])
    return False


def _render(seq) -> str:
    parts = []
    for item in seq:
        if item[0] == "p":
            parts.append(item[1])
        elif item[0] == "loop":
            parts.append(f"loop[{_render(item[1])}]")
        elif item[0] == "ver":
            parts.append(f"ver[{_render(item[1])}]")
        elif item[0] == "opt":
            parts.append(f"opt[{_render(item[1])}|{_render(item[2])}]")
    return " ".join(parts)


def _is_abstract(fn: ast.FunctionDef) -> bool:
    """encode/decode bodies that only raise (NotImplementedError) are
    the Message base-class stubs, not wire surface."""
    stmts = [s for s in fn.body
             if not (isinstance(s, ast.Expr)
                     and isinstance(s.value, ast.Constant))]
    return all(isinstance(s, ast.Raise) for s in stmts) if stmts else True


def _module_helpers(tree: ast.Module, role: str) -> dict[str, list]:
    """Resolve module-level ``_enc_*``/``_dec_*`` helpers to their wire
    sequences (one level of nesting between helpers is resolved by
    fixpoint iteration)."""
    prefix = "_enc" if role == "enc" else "_dec"
    defs = {
        n.name: n for n in tree.body
        if isinstance(n, ast.FunctionDef) and (
            n.name.startswith(prefix) or n.name.startswith(
                "_encode" if role == "enc" else "_decode"))
    }
    helpers: dict[str, list] = {}
    for _ in range(3):  # helpers calling helpers: tiny fixpoint
        for name, fn in defs.items():
            b = _SeqBuilder(role, helpers)
            helpers[name] = tuple(b.body_seq(fn.body))
    return {k: list(v) for k, v in helpers.items()}


class WireProtocolRule(Rule):
    name = "wire-protocol"
    rules = ("wire-frame-id", "wire-asymmetry")
    catalog = {
        "wire-frame-id":
            "duplicate or unregistered (zero/missing) message TYPE",
        "wire-asymmetry":
            "encode_payload writes a different wire sequence than "
            "decode_payload reads",
    }

    def run(self, project: Project) -> list[Finding]:
        findings: list[Finding] = []
        for sf in project.files:
            classes = [
                n for n in sf.tree.body if isinstance(n, ast.ClassDef)
            ]
            msgs = []
            for cls in classes:
                enc = dec = None
                type_val = type_line = None
                for item in cls.body:
                    if isinstance(item, ast.FunctionDef):
                        if item.name == "encode_payload":
                            enc = item
                        elif item.name == "decode_payload":
                            dec = item
                    elif (isinstance(item, ast.Assign)
                          and len(item.targets) == 1
                          and isinstance(item.targets[0], ast.Name)
                          and item.targets[0].id == "TYPE"
                          and isinstance(item.value, ast.Constant)
                          and isinstance(item.value.value, int)):
                        type_val = item.value.value
                        type_line = item.lineno
                if enc is not None and dec is not None and not (
                        _is_abstract(enc) or _is_abstract(dec)):
                    msgs.append((cls, enc, dec, type_val, type_line))
            if not msgs:
                continue
            findings.extend(self._check_file(sf, msgs))
        return findings

    def _check_file(self, sf, msgs) -> list[Finding]:
        findings: list[Finding] = []
        enc_helpers = _module_helpers(sf.tree, "enc")
        dec_helpers = _module_helpers(sf.tree, "dec")
        by_type: dict[int, list] = {}
        for cls, enc, dec, type_val, type_line in msgs:
            if type_val:
                by_type.setdefault(type_val, []).append((cls, type_line))
            else:
                findings.append(Finding(
                    "wire-frame-id", SEV_ERROR, sf.path, cls.lineno,
                    f"message class {cls.name} has an encode/decode "
                    f"pair but no non-zero TYPE: the messenger registry "
                    f"will never route this frame",
                ))
            e_seq = tuple(_SeqBuilder("enc", enc_helpers).body_seq(enc.body))
            d_seq = tuple(_SeqBuilder("dec", dec_helpers).body_seq(dec.body))
            if not _match(e_seq, d_seq):
                findings.append(Finding(
                    "wire-asymmetry", SEV_ERROR, sf.path, enc.lineno,
                    f"{cls.name}: encode_payload writes "
                    f"[{_render(e_seq)}] but decode_payload reads "
                    f"[{_render(d_seq)}] — a peer decoding this frame "
                    f"mis-frames the payload",
                ))
        for type_val, owners in sorted(by_type.items()):
            if len(owners) > 1:
                names = ", ".join(cls.name for cls, _ in owners)
                cls, line = owners[1]
                findings.append(Finding(
                    "wire-frame-id", SEV_ERROR, sf.path, line or cls.lineno,
                    f"frame id {type_val} claimed by multiple messages "
                    f"({names}): the registry assert fires at import "
                    f"and routing is ambiguous",
                ))
        return findings

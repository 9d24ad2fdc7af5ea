"""ctlint dataflow: project call graph + device-residency analysis.

The lock and device rules must see through calls: "no sync on THIS
line under THIS lock" is not enough when a helper two calls away
copies the tensor you just launched back to the host.  This module is
that middle layer, the program-shaped view of the package:

- :class:`CallGraph` — resolves ``self.method``, module-level
  functions, ``from x import f`` aliases and ``module.func`` chains
  into ``module:qualname`` function ids (the prewarm-registry key
  style), on top of the import-graph reachability ``core.Project``
  already provides;
- **device-residency taint** — a forward abstract interpretation per
  function over the 4-value domain {HOST, DEVICE, DEVICE_FN, TOP}.
  Sources are the kernel wrappers' results (the registry's
  ``JIT_ENTRYPOINTS``), ``torch.*`` constructors given a ``device=``
  that is not ``"cpu"``, ``.to(<device>)``, ``.cuda()``,
  ``transfer_guard.upload`` and calls of functions summarized as
  device-returning; ``_build.library(...)`` yields a DEVICE_FN, a
  loaded kernel library whose handles return a cudaError status (the
  outputs land in device buffers passed by pointer).  A ``torch.*``
  call on a device operand stays on the device; a CPU tensor is host
  data.  The taint propagates through assignments, tuple unpacking,
  attribute stores, container packing and comprehensions;
- **interprocedural summaries** — per function: does it return a
  device value / a kernel handle, which parameters flow through to the
  return, which parameters reach a host-materializing sink, does it
  (transitively) block the thread or force a device sync.  Summaries
  reach a fixpoint by bounded chaotic iteration
  (``CEPH_TPU_CTLINT_TRANSFER_MAX_DEPTH`` rounds — call chains longer
  than that widen to "unknown", keeping the pass fast and
  deterministic) with a per-function tainted-name cap
  (``CEPH_TPU_CTLINT_TRANSFER_MAX_STATES``) as the widening valve.

Everything is plain :mod:`ast`; the analyzer never imports the code
it reasons about.  The rule families consuming this engine live in
``rules/transfer.py`` (host-sink / redundant-put / non-donated in-out
/ implicit-sync) and ``rules/locks.py`` + ``rules/device.py``
(call-graph-deep blocking/sync under locks).
"""

from __future__ import annotations

import ast
import os
from dataclasses import dataclass, field

from ceph_tpu_torch.analysis.core import Project, SourceFile

# -- abstract values --------------------------------------------------------

HOST = "host"          #: definitely host data (numpy/bytes/scalars)
DEVICE = "device"      #: definitely a device-resident array
DEVICE_FN = "device_fn"  #: a callable whose call returns DEVICE (jit(f))
TOP = "top"            #: unknown


def join(a: str, b: str) -> str:
    """MAY-analysis join: agree -> keep, disagree -> TOP."""
    if a == b:
        return a
    return TOP


def taint_join(a: str, b: str) -> str:
    """Taint-biased join for flow-insensitive facts (attribute and
    container residency): device-ness wins, because the rules ask
    "MAY this be a device value" — a HOST assignment on another path
    must not launder the taint away."""
    if DEVICE in (a, b):
        return DEVICE
    if DEVICE_FN in (a, b):
        return DEVICE_FN
    return join(a, b)


#: bounded interprocedural propagation depth (summary fixpoint rounds);
#: call chains deeper than this conservatively widen to "unknown"
MAX_DEPTH = int(os.environ.get("CEPH_TPU_CTLINT_TRANSFER_MAX_DEPTH", "6"))
#: per-function tainted-name cap — the widening valve that keeps one
#: pathological function from dominating the whole lint pass
MAX_STATES = int(os.environ.get("CEPH_TPU_CTLINT_TRANSFER_MAX_STATES", "4096"))

#: torch constructors: the result lives where their ``device=`` says
_TORCH_CONSTRUCTORS = {
    "zeros", "ones", "empty", "full", "arange", "tensor", "as_tensor",
    "randint", "rand", "randn", "linspace", "eye", "empty_strided",
}
#: ``*_like`` constructors: the result lives with the operand unless
#: ``device=`` says otherwise
_LIKE_CONSTRUCTORS = {"zeros_like", "ones_like", "empty_like", "full_like"}
#: dtype names: ``x.to(torch.uint8)`` converts, it does not move
_DTYPES = {
    "uint8", "int8", "int16", "int32", "int64", "float16", "bfloat16",
    "float32", "float64", "bool", "long", "int", "float", "double",
    "half", "short", "uint16", "uint32", "uint64",
}
#: receivers of the transfer guard's declared copies
_GUARD_MODULES = {"tg", "transfer_guard"}

#: host-materializing sinks: full dotted / trailing call names.  Every
#: one of these forces the device buffer back through the host —
#: ``transfer_guard.readback`` included: it is the *declared,
#: sanctioned* exit, but an exit nonetheless, and every use must be a
#: justified by-design host boundary (baseline) or it is hiding a
#: round-trip.
_SINK_CALLS = {
    "np.asarray": "materializes the device tensor on the host",
    "np.array": "copies the device tensor to the host",
    "np.ascontiguousarray": "copies the device tensor to the host",
    "numpy.asarray": "materializes the device tensor on the host",
    "readback": "is the declared device->host copy",
    "bytes": "serializes the device tensor through the host",
    "bytearray": "serializes the device tensor through the host",
    "memoryview": "exposes host memory of the device tensor",
}
#: container constructors that preserve their argument's residency
#: (list(tuple_of_device_tensors) repackages, it does not materialize —
#: .tolist() is the materializing spelling)
_IDENTITY_CALLS = {"list", "tuple", "sorted", "reversed"}
#: method names on a device receiver that materialize host-side
_SINK_METHODS = {
    "cpu": "synchronously copies the device tensor to the host",
    "numpy": "materializes the device tensor on the host",
    "tobytes": "serializes the device tensor through the host",
    "tolist": "materializes the device tensor as host objects",
    "item": "synchronously fetches a device scalar",
}
#: builtins that force an implicit scalar sync on a device operand
_SCALAR_SYNCS = {"bool", "float", "int"}

#: thread-blocking calls (dotted or trailing names) and why — the
#: lock rules' seed set, propagated through the call graph
BLOCKING_CALLS = {
    "time.sleep": "sleeps",
    "os.fsync": "does disk I/O (fsync)",
    "os.fdatasync": "does disk I/O (fdatasync)",
    "subprocess.run": "spawns a process",
    "subprocess.check_call": "spawns a process",
    "subprocess.check_output": "spawns a process",
    "subprocess.Popen": "spawns a process",
    "importlib.import_module": "does a dynamic import (module-level "
                               "code + disk I/O)",
    "socket.create_connection": "does network I/O",
}
#: method names that block regardless of receiver
BLOCKING_METHODS = {
    "sendall": "does network I/O",
    "apply_transaction": "commits to the store",
    "queue_transaction": "commits to the store",
}
#: calls that make the thread wait for the card: ``torch.cuda.synchronize``
#: and a stream's or event's ``.synchronize()``, a device scalar's
#: ``.item()`` and ``.cpu()`` (a blocking copy: it waits for every
#: launch queued before it; ``.to("cpu")`` is one too)
SYNC_CALLS = {"synchronize", "item", "cpu"}


def attr_chain(node: ast.AST) -> str | None:
    parts: list[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def is_library_call(node: ast.AST) -> bool:
    """``_build.library("<source>")``: the call that builds (nvcc, at
    first use) and loads a kernel library — the port's program-creating
    site, the twin of a ``jax.jit`` application."""
    if not isinstance(node, ast.Call):
        return False
    chain = attr_chain(node.func)
    return bool(chain) and (chain == "_build.library"
                            or chain.endswith("._build.library"))


#: tensor methods that answer host metadata, not a tensor
_HOST_METHODS = {
    "size", "dim", "numel", "nelement", "ndimension", "stride",
    "data_ptr", "get_device", "is_contiguous", "element_size",
    "storage_offset", "is_pinned", "record_stream", "__len__",
}


def call_short(call: ast.Call) -> str | None:
    """Trailing name of a call target: ``f`` of ``a.b.f(...)`` and of
    ``g(...).f(...)`` alike."""
    if isinstance(call.func, ast.Attribute):
        return call.func.attr
    if isinstance(call.func, ast.Name):
        return call.func.id
    return None


def _guard_call(chain: str | None, short: str | None) -> str | None:
    """``upload`` / ``readback`` for the transfer guard's declared
    copies (``tg.upload``, ``transfer_guard.readback``, or the bare
    names imported from it), else None."""
    if short not in ("upload", "readback") or not chain:
        return None
    parts = chain.split(".")
    if len(parts) == 1 or parts[-2] in _GUARD_MODULES:
        return short
    return None


def _is_cpu(node: ast.AST) -> bool:
    """``"cpu"`` or ``torch.device("cpu")``."""
    if isinstance(node, ast.Constant):
        return node.value == "cpu"
    if isinstance(node, ast.Call) and attr_chain(node.func) in (
            "torch.device", "device") and node.args:
        return _is_cpu(node.args[0])
    return False


def _is_dtype(node: ast.AST) -> bool:
    chain = attr_chain(node)
    return bool(chain) and chain.startswith("torch.") \
        and chain.split(".")[-1] in _DTYPES


def _device_kw(call: ast.Call) -> str | None:
    """Where a ``torch.*`` call's ``device=`` puts its result: ``cpu``,
    ``device`` (any other device, or one only known at run time), or
    None when it gives none."""
    for kw in call.keywords:
        if kw.arg == "device":
            if isinstance(kw.value, ast.Constant) and kw.value.value is None:
                return None
            return "cpu" if _is_cpu(kw.value) else "device"
    return None


def to_target(call: ast.Call) -> str:
    """What ``x.to(...)`` does: ``cpu`` (a copy to the host),
    ``device`` (a copy to a device), or ``dtype`` (a conversion in
    place of residency)."""
    target = call.args[0] if call.args else None
    for kw in call.keywords:
        if kw.arg == "device":
            target = kw.value
    if target is None or _is_dtype(target):
        return "dtype"
    if isinstance(target, ast.Constant) and isinstance(target.value, str):
        return "cpu" if target.value == "cpu" else "device"
    if _is_cpu(target):
        return "cpu"
    return "device"


@dataclass
class FunctionInfo:
    """One def in the project, addressable as ``module:qualname``."""

    module: str
    qual: str                     # dotted scope incl. classes
    path: str
    node: ast.AST                 # FunctionDef | AsyncFunctionDef
    cls: str | None = None        # innermost enclosing class name
    params: list[str] = field(default_factory=list)

    @property
    def fid(self) -> str:
        return f"{self.module}:{self.qual}"

    @property
    def name(self) -> str:
        return self.qual.rsplit(".", 1)[-1]


@dataclass
class Summary:
    """Interprocedural facts about one function, reached by bounded
    fixpoint.  ``chain`` fields carry the call path that established a
    transitive fact, for actionable messages."""

    returns_device: bool = False
    returns_device_fn: bool = False
    #: param indices that may flow (residency-preserving) to the return
    passthrough: set[int] = field(default_factory=set)
    #: param index -> (sink op, why) when a param reaches a host sink
    sink_params: dict[int, tuple[str, str]] = field(default_factory=dict)
    #: (reason, chain-of-names) when the function may block the thread
    blocks: tuple[str, tuple[str, ...]] | None = None
    #: (sync call, chain-of-names) when it may force a device sync
    syncs: tuple[str, tuple[str, ...]] | None = None


class CallGraph:
    """Functions + call resolution over one :class:`Project`."""

    def __init__(self, project: Project):
        self.project = project
        self.functions: dict[str, FunctionInfo] = {}
        #: (module, bare name) -> fid for module-level defs
        self._module_funcs: dict[tuple[str, str], str] = {}
        #: (module, class, method) -> fid
        self._methods: dict[tuple[str, str, str], str] = {}
        #: module -> {local alias -> ("mod", modname) | ("obj", mod, name)}
        self._imports: dict[str, dict[str, tuple]] = {}
        #: module -> {class -> [base class names]}
        self._bases: dict[str, dict[str, list[str]]] = {}
        #: fids of the kernel loaders: defs that call ``_build.library``
        #: themselves (the port's program-creating sites)
        self.loader_defs: set[str] = set()
        self.modules = {sf.module for sf in project.files}
        #: (caller fid, id(call node)) -> resolved fid (resolution
        #: depends on nothing else, and every round asks again)
        self._resolved: dict[tuple[str, int], str | None] = {}
        for sf in project.files:
            self._index_module(sf)

    # -- indexing ------------------------------------------------------

    def _index_module(self, sf: SourceFile) -> None:
        mod = sf.module
        imports: dict[str, tuple] = {}
        self._imports[mod] = imports
        self._bases[mod] = {}
        mods = self.modules

        for node in ast.walk(sf.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    local = alias.asname or alias.name.split(".")[0]
                    if alias.name in mods:
                        imports[local] = ("mod", alias.name)
            elif isinstance(node, ast.ImportFrom) and node.module:
                for alias in node.names:
                    local = alias.asname or alias.name
                    sub = f"{node.module}.{alias.name}"
                    if sub in mods:
                        imports[local] = ("mod", sub)
                    elif node.module in mods:
                        imports[local] = ("obj", node.module, alias.name)

        scope: list[str] = []
        #: fids of the defs being walked, innermost last
        defs: list[str] = []

        def walk(node: ast.AST) -> None:
            for child in ast.iter_child_nodes(node):
                if defs and isinstance(child, ast.Call) \
                        and is_library_call(child):
                    self.loader_defs.add(defs[-1])
                if isinstance(child, ast.ClassDef):
                    self._bases[mod][child.name] = [
                        b for b in (attr_chain(x) for x in child.bases) if b
                    ]
                    scope.append(child.name)
                    walk(child)
                    scope.pop()
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    qual = ".".join(scope + [child.name])
                    cls = next(
                        (s for s in reversed(scope) if s[:1].isupper()),
                        None)
                    a = child.args
                    params = [x.arg for x in (
                        a.posonlyargs + a.args + a.kwonlyargs)]
                    info = FunctionInfo(
                        module=mod, qual=qual, path=sf.path, node=child,
                        cls=cls, params=params)
                    self.functions[info.fid] = info
                    if cls is None and not scope:
                        self._module_funcs[(mod, child.name)] = info.fid
                    elif cls is not None:
                        self._methods.setdefault(
                            (mod, cls, child.name), info.fid)
                    scope.append(child.name)
                    defs.append(info.fid)
                    walk(child)
                    defs.pop()
                    scope.pop()
                else:
                    walk(child)

        walk(sf.tree)

    # -- resolution ----------------------------------------------------

    def _method_in(self, mod: str, cls: str, meth: str,
                   depth: int = 0) -> str | None:
        """Method lookup with same/imported-module base-class walking
        (bounded — diamond bases in this tree are shallow)."""
        hit = self._methods.get((mod, cls, meth))
        if hit is not None or depth >= 4:
            return hit
        for base in self._bases.get(mod, {}).get(cls, []):
            leaf = base.split(".")[-1]
            tgt = self._imports.get(mod, {}).get(leaf)
            if tgt and tgt[0] == "obj":
                hit = self._method_in(tgt[1], tgt[2], meth, depth + 1)
            else:
                hit = self._method_in(mod, leaf, meth, depth + 1)
            if hit is not None:
                return hit
        return None

    def resolve(self, caller: FunctionInfo, call: ast.Call) -> str | None:
        """fid of the call target, or None when it cannot be pinned to
        a project function (foreign call, dynamic dispatch)."""
        key = (caller.fid, id(call))
        if key not in self._resolved:
            self._resolved[key] = self._resolve(caller, call)
        return self._resolved[key]

    def _resolve(self, caller: FunctionInfo, call: ast.Call) -> str | None:
        chain = attr_chain(call.func)
        if chain is None:
            return None
        parts = chain.split(".")
        mod, imports = caller.module, self._imports.get(caller.module, {})
        if len(parts) == 1:
            name = parts[0]
            hit = self._module_funcs.get((mod, name))
            if hit is not None:
                return hit
            tgt = imports.get(name)
            if tgt and tgt[0] == "obj":
                return self._module_funcs.get((tgt[1], tgt[2]))
            if caller.cls is not None:
                # bare call to a sibling function nested in the class
                return self._methods.get((mod, caller.cls, name))
            return None
        if len(parts) == 2:
            recv, meth = parts
            if recv in ("self", "cls") and caller.cls is not None:
                return self._method_in(mod, caller.cls, meth)
            tgt = imports.get(recv)
            if tgt is not None:
                if tgt[0] == "mod":
                    return self._module_funcs.get((tgt[1], meth))
                if tgt[0] == "obj":
                    # imported class: Class.method (static-ish call)
                    return self._methods.get((tgt[1], tgt[2], meth))
            # same-module class attribute call: Class.method
            hit = self._methods.get((mod, recv, meth))
            if hit is not None:
                return hit
            return None
        # a.b.meth: resolve the module prefix
        prefix, meth = ".".join(parts[:-1]), parts[-1]
        tgt = imports.get(parts[0])
        if tgt and tgt[0] == "mod" and len(parts) == 3:
            # alias.Class.method or package.module.func
            hit = self._methods.get((tgt[1], parts[1], meth))
            if hit is not None:
                return hit
            sub = f"{tgt[1]}.{parts[1]}"
            return self._module_funcs.get((sub, meth))
        if prefix in self.modules:
            return self._module_funcs.get((prefix, meth))
        return None


# -- per-function abstract interpretation -----------------------------------


def _blocking_reason(name: str | None) -> str | None:
    if not name:
        return None
    if name in BLOCKING_CALLS:
        return BLOCKING_CALLS[name]
    for dotted, why in BLOCKING_CALLS.items():
        if name.endswith("." + dotted):
            return why
    return BLOCKING_METHODS.get(name.split(".")[-1])


class _Interp(ast.NodeVisitor):
    """One forward pass over a function body.

    ``env`` maps local names to abstract values; ``attr_env`` maps
    ``self.x`` attribute names (per enclosing class, precomputed by
    the engine) to values.  The pass records sink/sync/blocking events
    into the engine-owned callbacks so rule modules stay thin."""

    def __init__(self, engine: "DataflowEngine", fn: FunctionInfo,
                 attr_env: dict[str, str], on_event=None):
        self.e = engine
        self.fn = fn
        self.attr_env = attr_env
        self.env: dict[str, str] = {}
        self.widened = False
        self.on_event = on_event   # (kind, node, payload) -> None
        self.returns: list[str] = []
        #: param name -> index, for summary updates
        self.param_ix = {p: i for i, p in enumerate(fn.params)}
        self.param_sinks: dict[int, tuple[str, str]] = {}
        self.param_passthrough: set[int] = set()

    # -- environment helpers ------------------------------------------

    def _set(self, name: str, val: str) -> None:
        if len(self.env) >= MAX_STATES:
            self.widened = True
            return
        old = self.env.get(name)
        self.env[name] = val if old is None else join(old, val)

    def _value(self, node: ast.AST) -> str:
        """Abstract value of an expression (also walks it for events)."""
        v = self._eval(node)
        return v

    def _eval(self, node: ast.AST) -> str:
        if isinstance(node, ast.Name):
            if node.id in self.env:
                return self.env[node.id]
            if node.id in self.param_ix:
                return TOP if node.id != "self" else HOST
            return HOST
        if isinstance(node, ast.Attribute):
            chain = attr_chain(node)
            if chain and chain.startswith("self."):
                return self.attr_env.get(chain[5:], HOST)
            # a handle of a loaded kernel library is a handle too; any
            # other attribute (``.shape``, ``.device``) is host metadata
            return DEVICE_FN if self._eval(node.value) == DEVICE_FN \
                else HOST
        if isinstance(node, ast.Constant):
            return HOST
        if isinstance(node, ast.Call):
            return self._eval_call(node)
        if isinstance(node, ast.Subscript):
            # element of a device container / slice of a device array
            base = self._eval(node.value)
            self._eval(node.slice)
            return DEVICE if base == DEVICE else base
        if isinstance(node, ast.BinOp):
            left, right = self._eval(node.left), self._eval(node.right)
            if DEVICE in (left, right):
                return DEVICE
            return join(left, right)
        if isinstance(node, ast.UnaryOp):
            return self._eval(node.operand)
        if isinstance(node, ast.BoolOp):
            vals = [self._eval(v) for v in node.values]
            out = vals[0]
            for v in vals[1:]:
                out = join(out, v)
            return out
        if isinstance(node, ast.Compare):
            ops = [self._eval(node.left)] + [
                self._eval(c) for c in node.comparators]
            if all(isinstance(op, (ast.Is, ast.IsNot)) for op in node.ops):
                return HOST     # identity: no tensor is read
            if all(isinstance(op, (ast.In, ast.NotIn)) for op in node.ops):
                # a key looked up in a container of device tensors
                # reads no tensor; a device element looked for does
                return DEVICE if ops[0] == DEVICE else HOST
            # a comparison WITH a device operand yields a device bool
            return DEVICE if DEVICE in ops else HOST
        if isinstance(node, ast.IfExp):
            self._eval(node.test)
            return join(self._eval(node.body), self._eval(node.orelse))
        if isinstance(node, (ast.Tuple, ast.List, ast.Set)):
            vals = [self._eval(el) for el in node.elts]
            return DEVICE if DEVICE in vals else HOST
        if isinstance(node, ast.Dict):
            vals = [self._eval(v) for v in node.values if v is not None]
            for k in node.keys:
                if k is not None:
                    self._eval(k)
            return DEVICE if DEVICE in vals else HOST
        if isinstance(node, (ast.ListComp, ast.SetComp, ast.GeneratorExp)):
            return self._eval_comp(node, node.elt)
        if isinstance(node, ast.DictComp):
            return self._eval_comp(node, node.value)
        if isinstance(node, ast.Await):
            return self._eval(node.value)
        if isinstance(node, ast.Starred):
            return self._eval(node.value)
        if isinstance(node, ast.NamedExpr):
            v = self._eval(node.value)
            if isinstance(node.target, ast.Name):
                self._set(node.target.id, v)
            return v
        if isinstance(node, (ast.JoinedStr, ast.FormattedValue)):
            for sub in ast.iter_child_nodes(node):
                if isinstance(sub, ast.expr):
                    self._eval(sub)
            return HOST
        if isinstance(node, ast.Lambda):
            return HOST
        return HOST

    def _eval_comp(self, comp: ast.AST, result_expr: ast.AST) -> str:
        for gen in comp.generators:
            it = self._eval(gen.iter)
            self._bind_target(gen.target,
                              DEVICE if it == DEVICE else TOP
                              if it == TOP else HOST)
            for cond in gen.ifs:
                self._check_condition(cond)
        if isinstance(comp, ast.DictComp):
            self._eval(comp.key)
        return self._eval(result_expr)

    # -- calls ---------------------------------------------------------

    def _eval_call(self, call: ast.Call) -> str:
        chain = attr_chain(call.func)
        short = call_short(call)
        argvals = [self._eval(a) for a in call.args]
        kwvals = {k.arg: self._eval(k.value) for k in call.keywords}

        # the receiver of a method call (``t.cpu()``, ``lib.ceph_x``)
        recv_val = None
        func_val = HOST
        if isinstance(call.func, ast.Attribute):
            if chain and chain.startswith("self."):
                func_val = self.attr_env.get(chain[5:], HOST)
            recv_val = self._eval(call.func.value)
            if recv_val == DEVICE_FN:
                func_val = DEVICE_FN
        elif isinstance(call.func, ast.Name):
            func_val = self._eval(call.func)
        elif isinstance(call.func, ast.Call):
            self._eval_call(call.func)
        elif isinstance(call.func, ast.Subscript):
            self._eval(call.func)
            table = call.func.value
            if isinstance(table, ast.Name) and table.id in \
                    self.e.entry_tables.get(self.fn.module, ()):
                # ``_ENTRY[kind](...)``: a table of kernel wrappers
                return DEVICE
        is_method = recv_val is not None and not (
            chain and chain.split(".")[0] in ("torch", "np", "numpy"))
        guard = _guard_call(chain, short)

        # -- events ----------------------------------------------------
        if is_method and short in _SINK_METHODS:
            if recv_val == DEVICE:
                self._emit("host_sink", call,
                           (f".{short}()", _SINK_METHODS[short]))
            # a sink method on a bare parameter: record it so the
            # summary fires at device-valued call sites
            self._note_param_sink(
                call.func.value, f".{short}()", _SINK_METHODS[short])
        elif is_method and short == "to":
            kind = to_target(call)
            if kind == "cpu":
                why = "copies the device tensor to the host"
                if recv_val == DEVICE:
                    self._emit("host_sink", call, (".to('cpu')", why))
                self._note_param_sink(call.func.value, ".to('cpu')", why)
            elif kind == "device" and recv_val == DEVICE:
                self._emit("redundant_put", call, (".to(<device>)",))
        elif is_method and short == "cuda" and recv_val == DEVICE:
            self._emit("redundant_put", call, (".cuda()",))
        elif is_method and short == "copy_" and recv_val == HOST \
                and argvals and argvals[0] == DEVICE:
            self._emit("host_sink", call, (
                ".copy_() into a host tensor",
                "copies the device tensor to the host"))
        elif guard == "upload":
            if argvals and argvals[0] == DEVICE:
                self._emit("redundant_put", call, (chain + "()",))
        elif guard == "readback" or (chain and (
                chain in _SINK_CALLS or short in (
                    "asarray", "array", "ascontiguousarray")
                and chain.split(".")[0] in ("np", "numpy"))
                and chain not in ("bytes", "bytearray", "memoryview")):
            if argvals:
                why = _SINK_CALLS.get(chain) or _SINK_CALLS.get(
                    short if guard else f"np.{short}",
                    "materializes the device tensor on the host")
                if argvals[0] == DEVICE:
                    self._emit("host_sink", call, (chain + "()", why))
                self._note_param_sink(call.args[0], chain + "()", why)
        elif chain in ("bytes", "bytearray", "memoryview") \
                and argvals and argvals[0] == DEVICE:
            self._emit("host_sink", call,
                       (chain + "()", _SINK_CALLS[chain]))
        elif chain in _SCALAR_SYNCS and argvals \
                and argvals[0] == DEVICE:
            self._emit("implicit_sync", call,
                       (chain + "()", "forces a blocking device "
                        "sync to fetch one scalar"))
        elif chain and chain.startswith("torch.") and short in (
                "tensor", "as_tensor") and argvals \
                and argvals[0] == DEVICE and _device_kw(call) == "device":
            self._emit("redundant_put", call, (chain + "()",))

        # -- abstract result -------------------------------------------
        if chain and is_library_call(call):
            return DEVICE_FN
        if chain == "getattr" and argvals and argvals[0] == DEVICE_FN:
            return DEVICE_FN
        if func_val == DEVICE_FN:
            # a kernel handle returns its cudaError status; the outputs
            # land in the device buffers passed to it by pointer
            return HOST
        if guard == "upload":
            return DEVICE
        if guard == "readback":
            return HOST
        if is_method and short == "cuda":
            return DEVICE
        if is_method and short == "to":
            kind = to_target(call)
            if kind == "cpu":
                return HOST
            if kind == "device":
                return DEVICE
            return recv_val
        if chain and chain.startswith("torch."):
            where = _device_kw(call)
            if where == "device":
                return DEVICE
            if where == "cpu":
                return HOST
            if short in _LIKE_CONSTRUCTORS and argvals:
                return argvals[0]
            if DEVICE in argvals or DEVICE in kwvals.values():
                return DEVICE
            if short in _TORCH_CONSTRUCTORS:
                return HOST
        if chain:
            if chain in _IDENTITY_CALLS:
                return argvals[0] if argvals else HOST
            if chain in _SINK_CALLS or chain in _SCALAR_SYNCS or (
                    is_method and short in _SINK_METHODS):
                return HOST

        # project-resolved callee: use its summary
        fid = self.e.graph.resolve(self.fn, call)
        if fid is not None:
            self._emit("call", call, (fid, argvals))
            s = self.e.summaries.get(fid)
            if s is not None:
                info = self.e.graph.functions.get(fid)
                # account for the implicit self on method calls
                shift = 1 if (info is not None and info.cls is not None
                              and info.params[:1] == ["self"]) else 0
                # param sinks inside the callee fire at this call site
                for ix, (op, why) in sorted(s.sink_params.items()):
                    at = ix - shift
                    if 0 <= at < len(call.args) and argvals[at] == DEVICE:
                        self._emit("host_sink", call,
                                   (f"{info.name}() -> {op}", why))
                if s.returns_device:
                    return DEVICE
                if s.returns_device_fn:
                    return DEVICE_FN
                if s.passthrough:
                    vals = [argvals[ix - shift]
                            for ix in s.passthrough
                            if 0 <= ix - shift < len(argvals)]
                    if DEVICE in vals:
                        return DEVICE
        if short in self.e.jit_entrypoints and (chain or is_method):
            # registry-declared kernel wrapper: its result is a device
            # tensor whatever the wrapper around the launch looks like
            # (facades, re-exports, ``mod.fn`` spellings)
            return DEVICE
        # tensor methods preserve residency (x.view/x.reshape/x ^ y ...)
        # but for the host metadata ones (x.numel(), x.data_ptr() ...)
        if recv_val == DEVICE and short not in _SINK_METHODS \
                and short not in _HOST_METHODS:
            return DEVICE
        return TOP if chain is None and recv_val is None else HOST

    def _note_param_sink(self, arg: ast.AST, op: str, why: str) -> None:
        """A parameter fed straight into a host sink — recorded so the
        summary can fire the sink at device-valued call sites."""
        if isinstance(arg, ast.Name) and arg.id in self.param_ix:
            self.param_sinks.setdefault(
                self.param_ix[arg.id], (op, why))

    def _emit(self, kind: str, node: ast.AST, payload: tuple) -> None:
        if self.on_event is not None:
            self.on_event(kind, node, payload)

    # -- statements ----------------------------------------------------

    def _bind_target(self, target: ast.AST, val: str) -> None:
        if isinstance(target, ast.Name):
            self._set(target.id, val)
        elif isinstance(target, (ast.Tuple, ast.List)):
            for el in target.elts:
                self._bind_target(el, val)
        elif isinstance(target, ast.Starred):
            self._bind_target(target.value, val)
        elif isinstance(target, ast.Attribute):
            chain = attr_chain(target)
            if chain and chain.startswith("self."):
                name = chain[5:]
                old = self.attr_env.get(name)
                self.attr_env[name] = (
                    val if old is None else taint_join(old, val))
        elif isinstance(target, ast.Subscript):
            # storing a device value into a container taints the
            # container (MAY semantics)
            self._eval(target.slice)
            base = target.value
            if val == DEVICE:
                self._bind_target(base, DEVICE)

    def visit_Assign(self, node: ast.Assign) -> None:
        val = self._eval(node.value)
        for t in node.targets:
            self._bind_target(t, val)

    def visit_AnnAssign(self, node: ast.AnnAssign) -> None:
        if node.value is not None:
            self._bind_target(node.target, self._eval(node.value))

    def visit_AugAssign(self, node: ast.AugAssign) -> None:
        val = self._eval(node.value)
        if isinstance(node.target, ast.Name):
            old = self.env.get(node.target.id, HOST)
            self._set(node.target.id,
                      DEVICE if DEVICE in (old, val) else join(old, val))

    def visit_Return(self, node: ast.Return) -> None:
        if node.value is None:
            self.returns.append(HOST)
            return
        v = self._eval(node.value)
        self.returns.append(v)
        # param -> return passthrough (residency-preserving)
        if isinstance(node.value, ast.Name) \
                and node.value.id in self.param_ix:
            self.param_passthrough.add(self.param_ix[node.value.id])

    def _check_condition(self, test: ast.AST) -> None:
        v = self._eval(test)
        if v == DEVICE:
            self._emit("implicit_sync", test,
                       ("branch condition",
                        "evaluating a device value for control flow "
                        "forces a blocking sync"))

    def visit_If(self, node: ast.If) -> None:
        self._check_condition(node.test)
        for s in node.body:
            self.visit(s)
        for s in node.orelse:
            self.visit(s)

    def visit_While(self, node: ast.While) -> None:
        self._check_condition(node.test)
        # two passes propagate loop-carried taint (bounded widening)
        for _ in range(2):
            for s in node.body:
                self.visit(s)
        for s in node.orelse:
            self.visit(s)

    def _visit_for(self, node) -> None:
        it = self._eval(node.iter)
        self._bind_target(
            node.target,
            DEVICE if it == DEVICE else TOP if it == TOP else HOST)
        for _ in range(2):
            for s in node.body:
                self.visit(s)
        for s in node.orelse:
            self.visit(s)

    visit_For = _visit_for
    visit_AsyncFor = _visit_for

    def _visit_with(self, node) -> None:
        for item in node.items:
            v = self._eval(item.context_expr)
            if item.optional_vars is not None:
                self._bind_target(item.optional_vars, v)
        for s in node.body:
            self.visit(s)

    visit_With = _visit_with
    visit_AsyncWith = _visit_with

    def visit_Expr(self, node: ast.Expr) -> None:
        self._eval(node.value)

    def visit_Assert(self, node: ast.Assert) -> None:
        self._check_condition(node.test)
        if node.msg is not None:
            self._eval(node.msg)

    def visit_Try(self, node: ast.Try) -> None:
        for s in node.body:
            self.visit(s)
        for h in node.handlers:
            for s in h.body:
                self.visit(s)
        for s in node.orelse:
            self.visit(s)
        for s in node.finalbody:
            self.visit(s)

    def visit_FunctionDef(self, node) -> None:
        # nested defs and classes are separate functions in the graph
        return

    visit_AsyncFunctionDef = visit_FunctionDef
    visit_ClassDef = visit_FunctionDef

    def run(self) -> None:
        for stmt in self.fn.node.body:
            self.visit(stmt)


# -- the engine -------------------------------------------------------------


class DataflowEngine:
    """Builds the call graph, computes interprocedural summaries, and
    replays functions with an event callback for the rule modules.

    One engine instance is built per lint run and shared by every rule
    that needs value flow (transfer family, lock family, device
    family) — construction cost is paid once.
    """

    def __init__(self, project: Project,
                 jit_entrypoints: frozenset[str] | None = None):
        if jit_entrypoints is None:
            from ceph_tpu_torch.analysis.prewarm_registry import JIT_ENTRYPOINTS

            jit_entrypoints = JIT_ENTRYPOINTS
        self.project = project
        self.graph = CallGraph(project)
        self.jit_entrypoints = jit_entrypoints
        #: module -> names of its module-level tables of kernel wrappers
        #: (``_ENTRY = {"firstn": crush_rule_firstn, ...}``)
        self.entry_tables: dict[str, set[str]] = {}
        for sf in project.files:
            for node in sf.tree.body:
                if isinstance(node, ast.Assign) and isinstance(
                        node.value, ast.Dict) and node.value.values and all(
                        isinstance(v, ast.Name) and v.id in jit_entrypoints
                        for v in node.value.values):
                    self.entry_tables.setdefault(sf.module, set()).update(
                        t.id for t in node.targets
                        if isinstance(t, ast.Name))
        self.summaries: dict[str, Summary] = {
            fid: Summary() for fid in self.graph.functions
        }
        #: (module, class) -> {attr -> abstract value} — attribute
        #: stores are flow-insensitive per class (a device attr
        #: anywhere taints reads everywhere in the class)
        self._attr_envs: dict[tuple[str, str | None], dict[str, str]] = {}
        self._callee_lists: dict[str, list[str]] = {}
        self._fixpoint()

    # -- summaries -----------------------------------------------------

    def attr_env(self, fn: FunctionInfo) -> dict[str, str]:
        return self._attr_envs.setdefault((fn.module, fn.cls), {})

    def _fixpoint(self) -> None:
        # seed blocking/sync facts (direct calls only), then iterate
        # the whole summary lattice MAX_DEPTH times — each round
        # extends transitive facts by one call edge, so chains deeper
        # than MAX_DEPTH widen to "not proven" (deterministically)
        order = sorted(self.graph.functions)
        self._seed_block_sync(order)
        for _ in range(max(1, MAX_DEPTH)):
            changed = False
            for fid in order:
                if self._update(fid):
                    changed = True
            if not changed:
                break

    def _seed_block_sync(self, order: list[str]) -> None:
        for fid in order:
            fn = self.graph.functions[fid]
            s = self.summaries[fid]
            for node in ast.walk(fn.node):
                if not isinstance(node, ast.Call):
                    continue
                name = attr_chain(node.func)
                why = _blocking_reason(name)
                if why is not None and s.blocks is None:
                    s.blocks = (why, (name or "?",))
                short = call_short(node)
                if short not in SYNC_CALLS and not (
                        short == "to" and to_target(node) == "cpu"):
                    continue
                if s.syncs is None:
                    s.syncs = (short, (short,))

    def _update(self, fid: str) -> bool:
        fn = self.graph.functions[fid]
        s = self.summaries[fid]
        before = (s.returns_device, s.returns_device_fn,
                  tuple(sorted(s.passthrough)),
                  tuple(sorted(s.sink_params)), s.blocks, s.syncs)

        interp = _Interp(self, fn, dict(self.attr_env(fn)))
        calls: list[tuple[str, tuple[str, ...]]] = []

        def on_event(kind, node, payload):
            if kind == "call":
                calls.append(payload)

        interp.on_event = on_event
        interp.run()

        # merge attribute effects back into the class-wide env
        cls_env = self.attr_env(fn)
        for k, v in interp.attr_env.items():
            old = cls_env.get(k)
            cls_env[k] = v if old is None else taint_join(old, v)

        if DEVICE in interp.returns:
            s.returns_device = True
        if DEVICE_FN in interp.returns:
            s.returns_device_fn = True
        s.passthrough |= interp.param_passthrough
        for ix, hit in interp.param_sinks.items():
            s.sink_params.setdefault(ix, hit)

        # transitive blocking / sync through resolved callees
        if s.blocks is None or s.syncs is None:
            for callee in self._callees(fn):
                if callee == fid:
                    continue
                cs = self.summaries.get(callee)
                if cs is None:
                    continue
                cname = self.graph.functions[callee].name
                if s.blocks is None and cs.blocks is not None \
                        and len(cs.blocks[1]) < MAX_DEPTH:
                    s.blocks = (cs.blocks[0], (cname,) + cs.blocks[1])
                if s.syncs is None and cs.syncs is not None \
                        and len(cs.syncs[1]) < MAX_DEPTH:
                    s.syncs = (cs.syncs[0], (cname,) + cs.syncs[1])

        after = (s.returns_device, s.returns_device_fn,
                 tuple(sorted(s.passthrough)),
                 tuple(sorted(s.sink_params)), s.blocks, s.syncs)
        return before != after

    def _callees(self, fn: FunctionInfo) -> list[str]:
        """Resolved targets of the calls in ``fn`` (nested defs
        included), in walk order."""
        out = self._callee_lists.get(fn.fid)
        if out is None:
            out = self._callee_lists[fn.fid] = [
                callee for callee in (
                    self.graph.resolve(fn, node) for node in ast.walk(fn.node)
                    if isinstance(node, ast.Call))
                if callee is not None]
        return out

    # -- rule-facing API ----------------------------------------------

    def replay(self, fn: FunctionInfo, on_event) -> None:
        """Re-interpret one function with final summaries, streaming
        (kind, node, payload) events: ``host_sink``, ``implicit_sync``,
        ``redundant_put``, ``call``."""
        _Interp(self, fn, dict(self.attr_env(fn)), on_event).run()

    def functions_in(self, modules: set[str]) -> list[FunctionInfo]:
        return [f for fid, f in sorted(self.graph.functions.items())
                if f.module in modules]

    def may_block(self, fid: str) -> tuple[str, tuple[str, ...]] | None:
        s = self.summaries.get(fid)
        return s.blocks if s else None

    def may_sync(self, fid: str) -> tuple[str, tuple[str, ...]] | None:
        s = self.summaries.get(fid)
        return s.syncs if s else None


_ENGINE_CACHE: dict[int, DataflowEngine] = {}


def engine_for(project: Project) -> DataflowEngine:
    """One engine per Project instance per lint run (rules share it)."""
    key = id(project)
    eng = _ENGINE_CACHE.get(key)
    if eng is None:
        _ENGINE_CACHE.clear()   # previous projects are dead
        eng = _ENGINE_CACHE[key] = DataflowEngine(project)
    return eng

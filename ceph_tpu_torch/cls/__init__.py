"""Object classes — the cls/objclass dispatch.

Behavioral twin of the reference's in-OSD object-class mechanism
(src/objclass/objclass.h, src/osd/osd_internal_types + the plugins in
src/cls/): a client op CALL(class, method, input) executes registered
code INSIDE the primary OSD with direct access to the target object;
the method reads/mutates the object through a handle (cls_method_cxx
read/write/getxattr/omap ops) and returns (rc, outdata).

Classes register via :func:`register_class`; methods via the
``@cls.method`` decorator with a read/write flag (RD/WR), which the OSD
uses for op classification.  Shipped classes:

- ``lock``: advisory shared/exclusive object locks, the
  src/cls/lock slice (lock/unlock/break_lock/get_info);
- ``version``: a monotonic object version counter (src/cls/version);
- ``hello``: the reference's example class (src/cls/hello).

Restriction mirrored from the reference's deployment reality: class
data state rides object omap/xattr, so CALL is served on replicated
pools (EC pools reject omap; cls use there returns EOPNOTSUPP).
"""

from __future__ import annotations

import errno
import json
import logging

RD = 1
WR = 2

_CLASSES: dict[str, "ObjectClass"] = {}


class ClsError(OSError):
    pass


class MethodContext:
    """cls_method_context_t: the object handle a method runs against.
    Backed by the primary's local store access (the caller guarantees
    the object lock is held and the pool is replicated)."""

    def __init__(self, store, coll, obj):
        self._store = store
        self._c = coll
        self._o = obj
        # mutations accumulate here; the daemon folds them into the
        # client op's transaction so class effects replicate atomically
        from ceph_tpu_torch.msg.messages import OSDOp

        self.effects: list[OSDOp] = []

    # reads ------------------------------------------------------------
    def exists(self) -> bool:
        return self._store.exists(self._c, self._o)

    def read(self, off: int = 0, length: int | None = None) -> bytes:
        if not self.exists():
            raise ClsError(errno.ENOENT, "no object")
        return self._store.read(self._c, self._o, off, length)

    def getxattr(self, name: str) -> bytes | None:
        try:
            return self._store.getattr(self._c, self._o, "u_" + name)
        except (KeyError, FileNotFoundError):
            return None

    def omap_get(self) -> dict[str, bytes]:
        try:
            return self._store.omap_get(self._c, self._o)
        except FileNotFoundError:
            return {}

    def omap_get_vals_by_keys(self, keys) -> dict[str, bytes]:
        try:
            return self._store.omap_get_values(self._c, self._o, keys)
        except FileNotFoundError:
            return {}

    # writes (recorded as effect ops; applied atomically after return) -
    def write_full(self, data: bytes) -> None:
        from ceph_tpu_torch.msg.messages import OP_WRITE_FULL, OSDOp

        self.effects.append(OSDOp(OP_WRITE_FULL, data=bytes(data)))

    def setxattr(self, name: str, value: bytes) -> None:
        from ceph_tpu_torch.msg.messages import OP_SETXATTR, OSDOp

        self.effects.append(OSDOp(OP_SETXATTR, name=name, data=bytes(value)))

    def omap_set(self, kv: dict[str, bytes]) -> None:
        from ceph_tpu_torch.msg.messages import OP_OMAP_SETKEYS, OSDOp

        self.effects.append(OSDOp(OP_OMAP_SETKEYS, kv=dict(kv)))

    def omap_rm_keys(self, keys) -> None:
        from ceph_tpu_torch.msg.messages import OP_OMAP_RMKEYS, OSDOp

        self.effects.append(OSDOp(OP_OMAP_RMKEYS, keys=list(keys)))


class ObjectClass:
    def __init__(self, name: str):
        self.name = name
        self.methods: dict[str, tuple[int, callable]] = {}

    def method(self, name: str, flags: int = RD):
        def deco(fn):
            self.methods[name] = (flags, fn)
            return fn
        return deco


def register_class(name: str) -> ObjectClass:
    cls = _CLASSES.setdefault(name, ObjectClass(name))
    return cls


def lookup(name: str) -> ObjectClass | None:
    return _CLASSES.get(name)


def call(
    cls_name: str, method: str, ctx: MethodContext, indata: bytes
) -> tuple[int, bytes]:
    """Dispatch (cls_cxx call): returns (rc, outdata)."""
    cls = _CLASSES.get(cls_name)
    if cls is None or method not in cls.methods:
        return -errno.EOPNOTSUPP, b""
    _flags, fn = cls.methods[method]
    try:
        out = fn(ctx, indata)
        return 0, out if out is not None else b""
    except ClsError as e:
        return -(e.errno or errno.EIO), b""
    except Exception:
        # malformed client input (bad json, missing fields, ...) must
        # surface as a clean EINVAL, not an unhandled traceback + EIO —
        # the reference's method-call containment (ClassHandler); keep
        # the traceback at debug level so OSD-side method bugs stay
        # diagnosable without letting clients spam the error log
        logging.getLogger("ceph.cls").debug(
            "cls %s.%s raised", cls_name, method, exc_info=True)
        return -errno.EINVAL, b""


def method_is_write(cls_name: str, method: str) -> bool:
    cls = _CLASSES.get(cls_name)
    if cls is None or method not in cls.methods:
        return False
    return bool(cls.methods[method][0] & WR)


# -- shipped classes --------------------------------------------------------

_lock = register_class("lock")
_LOCK_KEY = "lock.state"


def _lock_state(ctx: MethodContext) -> dict:
    raw = ctx.omap_get_vals_by_keys([_LOCK_KEY]).get(_LOCK_KEY)
    return json.loads(raw) if raw else {"name": "", "type": "", "holders": []}


@_lock.method("lock", WR)
def _lock_lock(ctx: MethodContext, indata: bytes) -> bytes:
    """input: {name, type: exclusive|shared, cookie, owner}
    (cls/lock/cls_lock.cc lock_op semantics, advisory)."""
    req = json.loads(indata)
    st = _lock_state(ctx)
    holder = [req["owner"], req.get("cookie", "")]
    if st["holders"] and st["name"] == req["name"]:
        if st["type"] == "exclusive" or req["type"] == "exclusive":
            if holder not in st["holders"]:
                raise ClsError(errno.EBUSY, "locked")
    if st["name"] not in ("", req["name"]):
        raise ClsError(errno.EBUSY, "another lock present")
    st["name"], st["type"] = req["name"], req["type"]
    if holder not in st["holders"]:
        st["holders"].append(holder)
    ctx.omap_set({_LOCK_KEY: json.dumps(st).encode()})
    return b""


@_lock.method("unlock", WR)
def _lock_unlock(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    st = _lock_state(ctx)
    holder = [req["owner"], req.get("cookie", "")]
    if st["name"] != req["name"] or holder not in st["holders"]:
        raise ClsError(errno.ENOENT, "not held")
    st["holders"].remove(holder)
    if not st["holders"]:
        st["name"], st["type"] = "", ""
    ctx.omap_set({_LOCK_KEY: json.dumps(st).encode()})
    return b""


@_lock.method("break_lock", WR)
def _lock_break(ctx: MethodContext, indata: bytes) -> bytes:
    req = json.loads(indata)
    st = _lock_state(ctx)
    st["holders"] = [
        h for h in st["holders"] if h[0] != req["owner"]
    ]
    if not st["holders"]:
        st["name"], st["type"] = "", ""
    ctx.omap_set({_LOCK_KEY: json.dumps(st).encode()})
    return b""


@_lock.method("get_info", RD)
def _lock_info(ctx: MethodContext, indata: bytes) -> bytes:
    return json.dumps(_lock_state(ctx)).encode()


_version = register_class("version")
_VER_KEY = "cls.version"


@_version.method("read", RD)
def _ver_read(ctx: MethodContext, indata: bytes) -> bytes:
    raw = ctx.omap_get_vals_by_keys([_VER_KEY]).get(_VER_KEY, b"0")
    return raw


@_version.method("inc", WR)
def _ver_inc(ctx: MethodContext, indata: bytes) -> bytes:
    raw = ctx.omap_get_vals_by_keys([_VER_KEY]).get(_VER_KEY, b"0")
    v = int(raw) + 1
    ctx.omap_set({_VER_KEY: str(v).encode()})
    return str(v).encode()


_hello = register_class("hello")


@_hello.method("say_hello", RD)
def _hello_say(ctx: MethodContext, indata: bytes) -> bytes:
    who = indata.decode() or "world"
    return f"Hello, {who}!".encode()


from . import rgw as _cls_rgw  # noqa: E402,F401  (registers the rgw class)

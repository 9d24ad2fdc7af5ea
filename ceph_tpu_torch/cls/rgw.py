"""cls_rgw — the in-OSD bucket-index class (RGW's atomicity core).

Behavioral twin of src/cls/rgw/cls_rgw.cc: the bucket index is an omap
on a ``.dir.<bucket_id>`` object, and ALL index mutations happen inside
the primary OSD via class methods so that concurrent writers serialize
on the object lock and the index entry + stats header update atomically.

The reference's two-phase dance (rgw_bucket_prepare_op /
rgw_bucket_complete_op, cls_rgw.cc:946,1012): the gateway *prepares* an
index entry (pending marker keyed by an op tag) before writing object
data, then *completes* it (apply + drop marker) after the data write
acks.  A crashed gateway leaves a pending marker that ``bucket_list``
reports as pending so a later ``dir_suggest``-style cleanup can settle
it — we expose the same via ``bucket_check_pending``.

Index omap layout (one object per bucket, meta/index pool, replicated):

- ``0_<key>``            -> JSON entry {size, etag, mtime, tag, content_type}
- ``pending.<key>.<tag>``-> JSON {op, time}   (prepared, not yet applied)
- ``.header``            -> JSON {count, bytes, ver}  (bucket stats)
"""

from __future__ import annotations

import json

from . import RD, WR, ClsError, MethodContext, register_class

_rgw = register_class("rgw")

HDR_KEY = ".header"
ENTRY_PREFIX = "0_"
PENDING_PREFIX = "pending."


def _header(ctx: MethodContext) -> dict:
    raw = ctx.omap_get_vals_by_keys([HDR_KEY]).get(HDR_KEY)
    return json.loads(raw) if raw else {"count": 0, "bytes": 0, "ver": 0}


def _entry_key(key: str) -> str:
    return ENTRY_PREFIX + key


@_rgw.method("bucket_init_index", WR)
def _bucket_init(ctx: MethodContext, indata: bytes) -> bytes:
    """cls_rgw.cc rgw_bucket_init_index: create the header."""
    ctx.omap_set({HDR_KEY: json.dumps(_header(ctx)).encode()})
    return b""


@_rgw.method("bucket_prepare_op", WR)
def _bucket_prepare(ctx: MethodContext, indata: bytes) -> bytes:
    """input: {tag, key, op: put|del}.  Records the pending marker
    (rgw_bucket_prepare_op, cls_rgw.cc:946)."""
    req = json.loads(indata)
    tag, key = req["tag"], req["key"]
    if not tag or not key:
        raise ClsError(22, "tag and key required")
    ctx.omap_set({
        f"{PENDING_PREFIX}{key}.{tag}": json.dumps(
            {"op": req.get("op", "put")}).encode(),
    })
    return b""


@_rgw.method("bucket_complete_op", WR)
def _bucket_complete(ctx: MethodContext, indata: bytes) -> bytes:
    """input: {tag, key, op: put|del, meta: {size, etag, mtime, ...}}.
    Applies the entry and stats delta, drops the pending marker
    (rgw_bucket_complete_op, cls_rgw.cc:1012)."""
    req = json.loads(indata)
    tag, key, op = req["tag"], req["key"], req.get("op", "put")
    ek = _entry_key(key)
    hdr = _header(ctx)
    old_raw = ctx.omap_get_vals_by_keys([ek]).get(ek)
    if old_raw:
        old = json.loads(old_raw)
        hdr["count"] -= 1
        hdr["bytes"] -= old.get("size", 0)
    if op == "put":
        meta = dict(req.get("meta", {}))
        meta["tag"] = tag
        ctx.omap_set({ek: json.dumps(meta).encode()})
        hdr["count"] += 1
        hdr["bytes"] += meta.get("size", 0)
    elif op == "del":
        if old_raw:
            ctx.omap_rm_keys([ek])
    else:
        raise ClsError(22, f"bad op {op!r}")
    hdr["count"] = max(0, hdr["count"])
    hdr["bytes"] = max(0, hdr["bytes"])
    hdr["ver"] += 1
    ctx.omap_set({HDR_KEY: json.dumps(hdr).encode()})
    ctx.omap_rm_keys([f"{PENDING_PREFIX}{key}.{tag}"])
    return b""


@_rgw.method("bucket_abort_op", WR)
def _bucket_abort(ctx: MethodContext, indata: bytes) -> bytes:
    """Drop a pending marker without applying (CLS_RGW_OP_CANCEL)."""
    req = json.loads(indata)
    ctx.omap_rm_keys([f"{PENDING_PREFIX}{req['key']}.{req['tag']}"])
    return b""


@_rgw.method("bucket_list", RD)
def _bucket_list(ctx: MethodContext, indata: bytes) -> bytes:
    """input: {marker, prefix, max}.  Returns {entries: [[key, meta]...],
    truncated: bool} in key order (rgw_bucket_list, cls_rgw.cc:614).
    ``marker`` is exclusive, matching the reference's list semantics."""
    req = json.loads(indata) if indata else {}
    marker = req.get("marker", "")
    prefix = req.get("prefix", "")
    max_n = int(req.get("max", 1000))
    omap = ctx.omap_get()
    keys = sorted(
        k[len(ENTRY_PREFIX):] for k in omap
        if k.startswith(ENTRY_PREFIX)
    )
    entries = []
    truncated = False
    for k in keys:
        if marker and k <= marker:
            continue
        if prefix and not k.startswith(prefix):
            continue
        if len(entries) >= max_n:
            truncated = True
            break
        entries.append([k, json.loads(omap[_entry_key(k)])])
    return json.dumps({"entries": entries, "truncated": truncated}).encode()


@_rgw.method("bucket_stats", RD)
def _bucket_stats(ctx: MethodContext, indata: bytes) -> bytes:
    """Header readback (rgw_bucket_get_dir_header)."""
    return json.dumps(_header(ctx)).encode()


@_rgw.method("bucket_check_pending", RD)
def _bucket_check_pending(ctx: MethodContext, indata: bytes) -> bytes:
    """List unsettled pending markers (the dir_suggest seam)."""
    omap = ctx.omap_get()
    out = [
        k[len(PENDING_PREFIX):] for k in sorted(omap)
        if k.startswith(PENDING_PREFIX)
    ]
    return json.dumps(out).encode()

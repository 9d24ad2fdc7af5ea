"""RGW RADOS driver — bucket/object/multipart layout on RADOS.

Twin of rgw/driver/rados/rgw_rados.cc + rgw_user/rgw_bucket metadata
handling, reduced to the layout that matters:

- **Users** (rgw_user.cc): omap on ``users.keys`` maps access_key ->
  {uid, secret_key, display_name}; per-user bucket list on
  ``user.<uid>`` omap.
- **Buckets**: global directory omap on ``buckets.dir``; each bucket
  gets a unique ``bucket_id`` and a ``.dir.<bucket_id>`` index object
  whose omap holds the entries, mutated ONLY through the in-OSD ``rgw``
  object class (src/cls/rgw) with the reference's prepare/complete
  two-phase so index and data never diverge silently.
- **Objects** (rgw_rados.cc put_obj/get_obj): head object
  ``<bucket_id>_<key>`` holds the first ``chunk_size`` bytes + a JSON
  manifest xattr; tails ``<bucket_id>__shadow_<key>.<n>`` hold the
  rest (the RGWObjManifest idea).  Multipart parts are standalone
  chains ``<bucket_id>__multipart_<key>.<upload_id>.<part>``; complete
  stitches them into the head's manifest WITHOUT copying data, exactly
  like the reference.
- **Multipart state** (rgw_multi.cc): upload meta object
  ``mp.<bucket_id>.<key>.<upload_id>`` with one omap row per part.

The index/meta pool must be replicated (omap + cls); data pools may be
EC — the per-bucket ``placement`` selects the data ioctx.

Counterpart of ``ceph_tpu/rgw/store.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno
import hashlib
import json
import os
import time

from ceph_tpu_torch.client.rados import IoCtx, ObjectOperation, RadosError

USERS_KEYS_OID = "users.keys"
BUCKETS_DIR_OID = "buckets.dir"

CHUNK_SIZE = 4 * 2**20  # rgw_obj_stripe_size / rgw_max_chunk_size default 4M


class RGWError(Exception):
    """S3-style error: code string + HTTP status."""

    def __init__(self, code: str, status: int, msg: str = ""):
        super().__init__(msg or code)
        self.code = code
        self.status = status


def _now() -> str:
    return time.strftime("%Y-%m-%dT%H:%M:%S.000Z", time.gmtime())


def _md5(data: bytes) -> str:
    return hashlib.md5(data).hexdigest()


def _parse_ts(s: str) -> float:
    import calendar

    try:
        return calendar.timegm(
            time.strptime(s.split(".")[0], "%Y-%m-%dT%H:%M:%S"))
    except (ValueError, AttributeError):
        return 0.0


class RGWStore:
    def __init__(self, meta_io: IoCtx, data_pools: dict[str, IoCtx],
                 default_placement: str | None = None,
                 chunk_size: int = CHUNK_SIZE):
        self.meta = meta_io
        self.data_pools = dict(data_pools)
        self.default_placement = default_placement or next(iter(data_pools))
        self.chunk_size = chunk_size
        # injectable clock: the lifecycle worker ages objects against
        # it (tests time-warp; the reference uses lc debug intervals)
        self.clock = time.time

    def _nowstr(self) -> str:
        return time.strftime(
            "%Y-%m-%dT%H:%M:%S.000Z", time.gmtime(self.clock()))

    # -- users (rgw_user.cc) -------------------------------------------

    async def create_user(
        self, uid: str, display_name: str,
        access_key: str | None = None, secret_key: str | None = None,
    ) -> dict:
        access_key = access_key or os.urandom(10).hex().upper()
        secret_key = secret_key or os.urandom(20).hex()
        existing = await self.get_user_by_access_key(access_key)
        if existing is not None and existing["uid"] != uid:
            raise RGWError("KeyExists", 409,
                           f"access key bound to {existing['uid']!r}")
        info = {
            "uid": uid, "display_name": display_name,
            "access_key": access_key, "secret_key": secret_key,
        }
        await self.meta.omap_set(USERS_KEYS_OID, {
            access_key: json.dumps(info).encode(),
        })
        await self.meta.omap_set(f"user.{uid}", {"info": json.dumps(info).encode()})
        return info

    async def get_user_by_access_key(self, access_key: str) -> dict | None:
        try:
            got = await self.meta.omap_get_vals_by_keys(
                USERS_KEYS_OID, [access_key])
        except RadosError as e:
            if e.errno == errno.ENOENT:
                return None
            raise
        raw = got.get(access_key)
        return json.loads(raw) if raw else None

    # -- buckets --------------------------------------------------------

    def _data_io(self, bucket: dict) -> IoCtx:
        try:
            return self.data_pools[bucket["placement"]]
        except KeyError:
            raise RGWError("InvalidArgument", 400,
                           f"unknown placement {bucket['placement']!r}")

    def _index_oid(self, bucket: dict) -> str:
        return f".dir.{bucket['id']}"

    async def _buckets_dir(self) -> dict[str, bytes]:
        try:
            return await self.meta.omap_get(BUCKETS_DIR_OID)
        except RadosError as e:
            if e.errno == errno.ENOENT:
                return {}
            raise

    async def get_bucket(self, name: str) -> dict:
        raw = (await self._buckets_dir()).get(name)
        if raw is None:
            raise RGWError("NoSuchBucket", 404, name)
        return json.loads(raw)

    async def create_bucket(
        self, name: str, owner: str, placement: str | None = None,
    ) -> dict:
        existing = (await self._buckets_dir()).get(name)
        if existing is not None:
            b = json.loads(existing)
            if b["owner"] != owner:
                raise RGWError("BucketAlreadyExists", 409, name)
            raise RGWError("BucketAlreadyOwnedByYou", 409, name)
        bucket = {
            "id": os.urandom(8).hex(), "name": name, "owner": owner,
            "created": self._nowstr(),
            "placement": placement or self.default_placement,
        }
        if bucket["placement"] not in self.data_pools:
            raise RGWError("InvalidArgument", 400,
                           f"unknown placement {bucket['placement']!r}")
        await self.meta.execute(
            self._index_oid(bucket), "rgw", "bucket_init_index")
        await self.meta.omap_set(BUCKETS_DIR_OID, {
            name: json.dumps(bucket).encode(),
        })
        await self.meta.omap_set(f"user.{owner}", {f"bucket.{name}": b""})
        return bucket

    async def delete_bucket(self, name: str, owner: str) -> None:
        bucket = await self.get_bucket(name)
        stats = await self.bucket_stats(bucket)
        if stats["count"] > 0:
            raise RGWError("BucketNotEmpty", 409, name)
        try:
            if await self.meta.omap_get(self._vers_oid(bucket)):
                # noncurrent versions / delete markers still exist
                raise RGWError("BucketNotEmpty", 409, name)
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
        await self.meta.omap_rm_keys(BUCKETS_DIR_OID, [name])
        await self.meta.omap_rm_keys(f"user.{owner}", [f"bucket.{name}"])
        for oid in (self._index_oid(bucket), self._vers_oid(bucket)):
            try:
                await self.meta.remove(oid)
            except RadosError:
                pass

    async def list_buckets(self, owner: str) -> list[dict]:
        out = []
        for name, raw in sorted((await self._buckets_dir()).items()):
            b = json.loads(raw)
            if b["owner"] == owner:
                out.append(b)
        return out

    async def bucket_stats(self, bucket: dict) -> dict:
        raw = await self.meta.execute(
            self._index_oid(bucket), "rgw", "bucket_stats")
        return json.loads(raw)

    # -- index two-phase (cls_rgw prepare/complete) ---------------------

    async def _index_prepare(self, bucket: dict, key: str, op: str) -> str:
        tag = os.urandom(8).hex()
        await self.meta.execute(
            self._index_oid(bucket), "rgw", "bucket_prepare_op",
            json.dumps({"tag": tag, "key": key, "op": op}).encode())
        return tag

    async def _index_complete(
        self, bucket: dict, key: str, tag: str, op: str, meta: dict | None = None,
    ) -> None:
        await self.meta.execute(
            self._index_oid(bucket), "rgw", "bucket_complete_op",
            json.dumps({
                "tag": tag, "key": key, "op": op, "meta": meta or {},
            }).encode())

    async def _index_abort(self, bucket: dict, key: str, tag: str) -> None:
        try:
            await self.meta.execute(
                self._index_oid(bucket), "rgw", "bucket_abort_op",
                json.dumps({"tag": tag, "key": key}).encode())
        except RadosError:
            pass

    # -- object data layout --------------------------------------------

    def _head_oid(self, bucket: dict, key: str) -> str:
        return f"{bucket['id']}_{key}"

    def _shadow_prefix(self, bucket: dict, key: str) -> str:
        # unique per write (the reference's tail tag): an overwrite's new
        # tails never collide with the old object's, so the old chain
        # survives intact until the new write fully lands
        return f"{bucket['id']}__shadow_{key}.{os.urandom(4).hex()}"

    def _part_oid(self, bucket: dict, key: str, upload_id: str, part: int) -> str:
        return f"{bucket['id']}__multipart_{key}.{upload_id}.{part}"

    async def _write_tails(
        self, io: IoCtx, tail_prefix: str, data: bytes,
    ) -> list[list]:
        """Write the shadow tails (bytes past chunk_size); returns the
        tail manifest [[oid, size], ...].  The head's first-chunk bytes
        are written by the caller, atomically with the meta xattr."""
        cs = self.chunk_size
        manifest: list[list] = []
        writes = []
        for i, off in enumerate(range(cs, len(data), cs)):
            oid = f"{tail_prefix}.{i}"
            chunk = data[off:off + cs]
            manifest.append([oid, len(chunk)])
            writes.append(io.write_full(oid, chunk))
        if writes:
            await asyncio.gather(*writes)
        return manifest

    async def _read_meta(self, io: IoCtx, head_oid: str) -> dict:
        try:
            raw = await io.getxattr(head_oid, "rgw.meta")
        except RadosError as e:
            if e.errno == errno.ENOENT:
                raise RGWError("NoSuchKey", 404, head_oid)
            raise
        return json.loads(raw)

    async def _remove_chain(self, io: IoCtx, head_oid: str, meta: dict) -> None:
        rms = []
        for oid, _size in meta.get("manifest", []):
            rms.append(self._remove_quiet(io, oid))
        rms.append(self._remove_quiet(io, head_oid))
        await asyncio.gather(*rms)

    @staticmethod
    async def _remove_quiet(io: IoCtx, oid: str) -> None:
        try:
            await io.remove(oid)
        except RadosError:
            pass

    # -- versioning (rgw versioned buckets, rgw_rados versioned ops) ----

    @staticmethod
    def versioning_of(bucket: dict) -> str:
        return bucket.get("versioning", "Off")

    async def _save_bucket(self, bucket: dict) -> None:
        await self.meta.omap_set(BUCKETS_DIR_OID, {
            bucket["name"]: json.dumps(bucket).encode(),
        })

    async def set_bucket_versioning(self, name: str, status: str) -> dict:
        if status not in ("Enabled", "Suspended"):
            raise RGWError("MalformedXML", 400, f"bad status {status!r}")
        bucket = await self.get_bucket(name)
        bucket["versioning"] = status
        await self._save_bucket(bucket)
        return bucket

    def _vers_oid(self, bucket: dict) -> str:
        return f".vers.{bucket['id']}"

    _vseq = 0

    def _vkey(self, key: str, vid: str) -> str:
        # inverted-timestamp component so a lexical scan of the omap
        # yields newest-first per key (the reference's instance-entry
        # ordering in the bucket index); a descending in-process
        # counter breaks same-tick ties toward the later write
        inv = 2**63 - int(self.clock() * 1e9)
        RGWStore._vseq += 1
        tie = 10**9 - (RGWStore._vseq % 10**9)
        return f"{key}\x00{inv:020d}.{tie:09d}.{vid}"

    def _vhead_oid(self, bucket: dict, key: str, vid: str) -> str:
        return f"{bucket['id']}__ver_{vid}_{key}"

    async def _versions_of(self, bucket: dict, key: str) -> list[tuple[str, dict]]:
        """[(vkey, rec)] newest first for one key."""
        try:
            omap = await self.meta.omap_get(self._vers_oid(bucket))
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
            return []
        pfx = f"{key}\x00"
        return [
            (k, json.loads(v)) for k, v in sorted(omap.items())
            if k.startswith(pfx)
        ]

    async def _drop_version(self, bucket: dict, vkey: str, rec: dict) -> None:
        io = self._data_io(bucket)
        if not rec.get("delete_marker"):
            oid = self._vhead_oid(bucket, rec["key"], rec["vid"])
            try:
                meta = await self._read_meta(io, oid)
                await self._remove_chain(io, oid, meta)
            except RGWError:
                pass
        await self.meta.omap_rm_keys(self._vers_oid(bucket), [vkey])

    # -- object ops (rgw_op.cc RGWPutObj/RGWGetObj/RGWDeleteObj) --------

    async def _write_chain(
        self, bucket: dict, key: str, head_oid: str, data: bytes,
        content_type: str, user_meta: dict[str, str] | None,
    ) -> dict:
        """Write one complete object chain at ``head_oid`` (tails
        first, then head bytes + meta xattr atomically) and return its
        meta.  Does NOT touch the bucket index."""
        io = self._data_io(bucket)
        manifest = await self._write_tails(
            io, self._shadow_prefix(bucket, key), data)
        meta = {
            "size": len(data), "etag": _md5(data),
            "mtime": self._nowstr(), "content_type": content_type,
            "head_size": min(len(data), self.chunk_size),
            "manifest": manifest,
        }
        if user_meta:
            meta["user_meta"] = user_meta
        await io.operate(head_oid, ObjectOperation()
                         .write_full(data[:self.chunk_size])
                         .setxattr("rgw.meta", json.dumps(meta).encode()))
        return meta

    async def put_object(
        self, bucket: dict, key: str, data: bytes,
        content_type: str = "binary/octet-stream",
        user_meta: dict[str, str] | None = None,
    ) -> dict:
        if self.versioning_of(bucket) != "Off":
            return await self._put_versioned(
                bucket, key, data, content_type, user_meta)
        io = self._data_io(bucket)
        head_oid = self._head_oid(bucket, key)
        tag = await self._index_prepare(bucket, key, "put")
        try:
            old_manifest: list[list] = []
            try:
                old_manifest = (
                    await self._read_meta(io, head_oid)).get("manifest", [])
            except RGWError:
                pass
            # write-new-then-drop-old: tails first (fresh tag, no
            # collision with the old chain), then head data + meta
            # xattr as ONE atomic compound op, so a crash anywhere
            # leaves either the intact old object or the complete new
            # one — never a head/meta mismatch
            meta = await self._write_chain(
                bucket, key, head_oid, data, content_type, user_meta)
        except BaseException:
            await self._index_abort(bucket, key, tag)
            raise
        await self._index_complete(bucket, key, tag, "put", {
            "size": meta["size"], "etag": meta["etag"],
            "mtime": meta["mtime"], "content_type": content_type,
        })
        # old tails are garbage now (reference: deferred to rgw gc)
        new_oids = {oid for oid, _sz in meta["manifest"]}
        for oid, _sz in old_manifest:
            if oid not in new_oids:
                await self._remove_quiet(io, oid)
        return meta

    async def _put_versioned(
        self, bucket: dict, key: str, data: bytes,
        content_type: str, user_meta: dict[str, str] | None,
    ) -> dict:
        """Versioned PUT: every write is a NEW immutable version
        (Enabled) or replaces the 'null' version (Suspended); the main
        index tracks the current view so plain listings keep working."""
        suspended = self.versioning_of(bucket) == "Suspended"
        vid = "null" if suspended else os.urandom(8).hex()
        if suspended:
            # a previous null version (incl. one from an earlier
            # suspension) is overwritten, reference semantics
            for vkey, rec in await self._versions_of(bucket, key):
                if rec["vid"] == "null":
                    await self._drop_version(bucket, vkey, rec)
        tag = await self._index_prepare(bucket, key, "put")
        try:
            meta = await self._write_chain(
                bucket, key, self._vhead_oid(bucket, key, vid), data,
                content_type, user_meta)
            meta["version_id"] = vid
            await self.meta.omap_set(self._vers_oid(bucket), {
                self._vkey(key, vid): json.dumps({
                    "key": key, "vid": vid, "size": meta["size"],
                    "etag": meta["etag"], "mtime": meta["mtime"],
                    "content_type": content_type,
                    "delete_marker": False,
                }).encode(),
            })
        except BaseException:
            await self._index_abort(bucket, key, tag)
            raise
        await self._index_complete(bucket, key, tag, "put", {
            "size": meta["size"], "etag": meta["etag"],
            "mtime": meta["mtime"], "content_type": content_type,
            "version_id": vid,
        })
        return meta

    async def _resolve_head(
        self, bucket: dict, key: str, version_id: str | None,
    ) -> tuple[str, str | None]:
        """(head_oid, version_id) for a read.  Versioned buckets read
        through the version table; the plain head is the implicit
        pre-versioning object."""
        versions = await self._versions_of(bucket, key)
        if version_id is None:
            if versions:
                _vkey, rec = versions[0]
                if rec.get("delete_marker"):
                    raise RGWError("NoSuchKey", 404, key)
                return (self._vhead_oid(bucket, key, rec["vid"]),
                        rec["vid"])
            return self._head_oid(bucket, key), None
        for _vkey, rec in versions:
            if rec["vid"] == version_id:
                if rec.get("delete_marker"):
                    raise RGWError("MethodNotAllowed", 405,
                                   "delete marker")
                return (self._vhead_oid(bucket, key, version_id),
                        version_id)
        if version_id == "null":
            return self._head_oid(bucket, key), "null"
        raise RGWError("NoSuchVersion", 404, version_id)

    async def head_object(
        self, bucket: dict, key: str, version_id: str | None = None,
    ) -> dict:
        io = self._data_io(bucket)
        head_oid, vid = await self._resolve_head(bucket, key, version_id)
        meta = await self._read_meta(io, head_oid)
        if vid is not None:
            meta.setdefault("version_id", vid)
        return meta

    async def get_object(
        self, bucket: dict, key: str, off: int = 0, length: int | None = None,
        version_id: str | None = None,
    ) -> tuple[dict, bytes]:
        io = self._data_io(bucket)
        head_oid, vid = await self._resolve_head(bucket, key, version_id)
        meta = await self._read_meta(io, head_oid)
        if vid is not None:
            meta.setdefault("version_id", vid)
        size = meta["size"]
        if off >= size and size > 0:
            raise RGWError("InvalidRange", 416, key)
        end = size if length is None else min(size, off + length)
        # segment list: head span + manifest tails, in logical order
        segments: list[tuple[str, int]] = [(head_oid, meta["head_size"])]
        segments += [(oid, sz) for oid, sz in meta.get("manifest", [])]
        reads = []
        pos = 0
        for oid, sz in segments:
            seg_start, seg_end = pos, pos + sz
            pos = seg_end
            lo, hi = max(off, seg_start), min(end, seg_end)
            if lo >= hi:
                continue
            reads.append(io.read(oid, off=lo - seg_start, length=hi - lo))
        chunks = await asyncio.gather(*reads) if reads else []
        return meta, b"".join(chunks)

    async def delete_object(
        self, bucket: dict, key: str, version_id: str | None = None,
    ) -> dict:
        """Returns {"version_id": ..., "delete_marker": bool} for
        versioned outcomes, {} otherwise."""
        if version_id is not None:
            return await self._delete_version(bucket, key, version_id)
        if self.versioning_of(bucket) != "Off":
            return await self._delete_marker(bucket, key)
        io = self._data_io(bucket)
        head_oid = self._head_oid(bucket, key)
        meta = None
        try:
            meta = await self._read_meta(io, head_oid)
        except RGWError:
            pass  # data already gone — still reconcile the index below
        tag = await self._index_prepare(bucket, key, "del")
        try:
            if meta is not None:
                await self._remove_chain(io, head_oid, meta)
        except BaseException:
            await self._index_abort(bucket, key, tag)
            raise
        # completes even when the head was missing: a retried DELETE
        # whose first attempt died between data removal and index
        # update settles the orphaned entry (the dir_suggest role);
        # S3 DELETE of a missing key succeeds either way
        await self._index_complete(bucket, key, tag, "del")
        return {}

    async def _delete_marker(self, bucket: dict, key: str) -> dict:
        """Versioned DELETE without a version id: the object does not
        die — a delete marker becomes the current version and the key
        vanishes from plain listings."""
        vid = os.urandom(8).hex()
        tag = await self._index_prepare(bucket, key, "del")
        try:
            await self.meta.omap_set(self._vers_oid(bucket), {
                self._vkey(key, vid): json.dumps({
                    "key": key, "vid": vid, "size": 0, "etag": "",
                    "mtime": self._nowstr(), "delete_marker": True,
                }).encode(),
            })
        except BaseException:
            await self._index_abort(bucket, key, tag)
            raise
        await self._index_complete(bucket, key, tag, "del")
        return {"version_id": vid, "delete_marker": True}

    async def _delete_version(
        self, bucket: dict, key: str, version_id: str,
    ) -> dict:
        """DELETE with a version id: that version (or marker) is
        physically removed; the next-newest version becomes current —
        removing the newest marker "undeletes" the key."""
        versions = await self._versions_of(bucket, key)
        target = next(
            ((vk, r) for vk, r in versions if r["vid"] == version_id),
            None)
        if target is None:
            if version_id == "null":
                # implicit pre-versioning object
                return await self.delete_object(
                    {**bucket, "versioning": "Off"}, key)
            return {}  # S3: deleting a missing version succeeds
        vkey, rec = target
        was_current = versions[0][0] == vkey
        await self._drop_version(bucket, vkey, rec)
        if was_current:
            rest = [r for vk, r in versions if vk != vkey]
            if rest and not rest[0].get("delete_marker"):
                cur = rest[0]
                tag = await self._index_prepare(bucket, key, "put")
                await self._index_complete(bucket, key, tag, "put", {
                    "size": cur["size"], "etag": cur["etag"],
                    "mtime": cur["mtime"],
                    "content_type": cur.get("content_type", ""),
                    "version_id": cur["vid"],
                })
            else:
                tag = await self._index_prepare(bucket, key, "del")
                await self._index_complete(bucket, key, tag, "del")
        return {"version_id": version_id,
                "delete_marker": bool(rec.get("delete_marker"))}

    async def list_object_versions(
        self, bucket: dict, prefix: str = "", key_marker: str = "",
        max_keys: int = 1000,
    ) -> dict:
        """ListObjectVersions core: every version + delete marker,
        newest first per key, IsLatest computed."""
        try:
            omap = await self.meta.omap_get(self._vers_oid(bucket))
        except RadosError as e:
            if e.errno != errno.ENOENT:
                raise
            omap = {}
        entries = []
        seen_latest: set[str] = set()
        truncated = False
        for vkey in sorted(omap):
            rec = json.loads(omap[vkey])
            key = rec["key"]
            if prefix and not key.startswith(prefix):
                continue
            if key_marker and key <= key_marker:
                continue
            if len(entries) >= max_keys:
                truncated = True
                break
            rec["is_latest"] = key not in seen_latest
            seen_latest.add(key)
            entries.append(rec)
        return {"entries": entries, "truncated": truncated}

    async def list_objects(
        self, bucket: dict, prefix: str = "", delimiter: str = "",
        marker: str = "", max_keys: int = 1000,
    ) -> dict:
        """ListObjectsV2 core: returns {entries, common_prefixes,
        truncated, next_marker}.  Delimiter folding happens here, like
        the reference's RGWRados::Bucket::List::list_objects."""
        entries: list[list] = []
        prefixes: set[str] = set()
        truncated = False
        next_marker = ""
        cur = marker
        last_included = marker
        while True:
            raw = await self.meta.execute(
                self._index_oid(bucket), "rgw", "bucket_list",
                json.dumps({
                    "marker": cur, "prefix": prefix, "max": 1000,
                }).encode())
            page = json.loads(raw)
            for key, emeta in page["entries"]:
                cur = key
                if delimiter:
                    rest = key[len(prefix):]
                    di = rest.find(delimiter)
                    if di >= 0:
                        cp = prefix + rest[:di + len(delimiter)]
                        if cp not in prefixes:
                            if len(entries) + len(prefixes) >= max_keys:
                                # marker is EXCLUSIVE: resume after the
                                # last key we actually returned
                                return {
                                    "entries": entries,
                                    "common_prefixes": sorted(prefixes),
                                    "truncated": True,
                                    "next_marker": last_included,
                                }
                            prefixes.add(cp)
                        last_included = key
                        continue
                if len(entries) + len(prefixes) >= max_keys:
                    return {
                        "entries": entries,
                        "common_prefixes": sorted(prefixes),
                        "truncated": True, "next_marker": last_included,
                    }
                entries.append([key, emeta])
                last_included = key
            if not page["truncated"]:
                break
        return {
            "entries": entries, "common_prefixes": sorted(prefixes),
            "truncated": truncated, "next_marker": next_marker,
        }

    # -- lifecycle (RGWLC, rgw_lc.cc / rgw_lc.h:515) --------------------

    async def set_lifecycle(self, name: str, rules: list[dict]) -> None:
        for r in rules:
            if not isinstance(r, dict) or (
                "days" not in r and "noncurrent_days" not in r
            ):
                raise RGWError("MalformedXML", 400, "rule needs an action")
        bucket = await self.get_bucket(name)
        bucket["lifecycle"] = rules
        await self._save_bucket(bucket)

    async def get_lifecycle(self, name: str) -> list[dict]:
        bucket = await self.get_bucket(name)
        lc = bucket.get("lifecycle")
        if not lc:
            raise RGWError("NoSuchLifecycleConfiguration", 404, name)
        return lc

    async def delete_lifecycle(self, name: str) -> None:
        bucket = await self.get_bucket(name)
        bucket.pop("lifecycle", None)
        await self._save_bucket(bucket)

    async def lc_process(self) -> dict:
        """One lifecycle pass over every bucket (the RGWLC worker's
        bucket_lc_process): expire current objects past their rule's
        Days (versioned buckets get a delete marker instead of
        destruction), and destroy noncurrent versions past
        NoncurrentDays.  Ages are judged against ``self.clock``."""
        stats = {"expired": 0, "noncurrent_removed": 0}
        now = self.clock()
        for name, raw in list((await self._buckets_dir()).items()):
            bucket = json.loads(raw)
            rules = [
                r for r in bucket.get("lifecycle", [])
                if r.get("status", "Enabled") == "Enabled"
            ]
            if not rules:
                continue
            for rule in rules:
                prefix = rule.get("prefix", "")
                days = rule.get("days")
                if days is not None:
                    stats["expired"] += await self._lc_expire_current(
                        bucket, prefix, now - days * 86400)
                nc_days = rule.get("noncurrent_days")
                if nc_days is not None:
                    stats["noncurrent_removed"] += (
                        await self._lc_expire_noncurrent(
                            bucket, prefix, now - nc_days * 86400))
        return stats

    async def _lc_expire_current(
        self, bucket: dict, prefix: str, cutoff: float,
    ) -> int:
        n = 0
        marker = ""
        while True:
            page = await self.list_objects(
                bucket, prefix=prefix, marker=marker, max_keys=1000)
            for key, emeta in page["entries"]:
                marker = key
                if _parse_ts(emeta.get("mtime", "")) <= cutoff:
                    await self.delete_object(bucket, key)
                    n += 1
            if not page["truncated"]:
                return n

    async def _lc_expire_noncurrent(
        self, bucket: dict, prefix: str, cutoff: float,
    ) -> int:
        """A version is noncurrent from the moment a NEWER version (or
        marker) exists; lite model: age by the version's own mtime."""
        n = 0
        res = await self.list_object_versions(
            bucket, prefix=prefix, max_keys=10**9)
        for rec in res["entries"]:
            if rec["is_latest"]:
                continue
            if _parse_ts(rec.get("mtime", "")) <= cutoff:
                await self._delete_version(
                    bucket, rec["key"], rec["vid"])
                n += 1
        return n

    def lc_start(self, interval: float = 60.0) -> None:
        """Background worker (the RGWLC thread)."""
        async def run():
            while True:
                await asyncio.sleep(interval)
                try:
                    await self.lc_process()
                except Exception:
                    import logging

                    logging.getLogger("ceph_tpu_torch.rgw").exception(
                        "lifecycle pass failed")

        self._lc_task = asyncio.ensure_future(run())

    def lc_stop(self) -> None:
        task = getattr(self, "_lc_task", None)
        if task is not None:
            task.cancel()
            self._lc_task = None

    # -- multipart (rgw_multi.cc) --------------------------------------

    def _mp_meta_oid(self, bucket: dict, key: str, upload_id: str) -> str:
        return f"mp.{bucket['id']}.{key}.{upload_id}"

    async def initiate_multipart(self, bucket: dict, key: str,
                                 content_type: str = "binary/octet-stream") -> str:
        upload_id = os.urandom(12).hex()
        oid = self._mp_meta_oid(bucket, key, upload_id)
        await self.meta.create(oid, exclusive=True)
        await self.meta.omap_set(oid, {
            ".meta": json.dumps({
                "key": key, "initiated": self._nowstr(),
                "content_type": content_type,
            }).encode(),
        })
        return upload_id

    async def _mp_state(self, bucket: dict, key: str, upload_id: str) -> dict[str, bytes]:
        oid = self._mp_meta_oid(bucket, key, upload_id)
        try:
            omap = await self.meta.omap_get(oid)
        except RadosError as e:
            if e.errno == errno.ENOENT:
                raise RGWError("NoSuchUpload", 404, upload_id)
            raise
        if ".meta" not in omap:
            raise RGWError("NoSuchUpload", 404, upload_id)
        return omap

    async def upload_part(
        self, bucket: dict, key: str, upload_id: str, part_num: int,
        data: bytes,
    ) -> str:
        if not 1 <= part_num <= 10000:
            raise RGWError("InvalidArgument", 400, "partNumber out of range")
        omap = await self._mp_state(bucket, key, upload_id)
        io = self._data_io(bucket)
        # a fresh tag per attempt: re-uploads never collide with the
        # previous chain, which stays valid until the omap row flips
        part_head = (
            self._part_oid(bucket, key, upload_id, part_num)
            + "." + os.urandom(4).hex())
        manifest = await self._write_tails(io, part_head + ".t", data)
        await io.write_full(part_head, data[:self.chunk_size])
        etag = _md5(data)
        entry = {
            "size": len(data), "etag": etag,
            "head_size": min(len(data), self.chunk_size),
            "oids": [[part_head, min(len(data), self.chunk_size)]] + manifest,
        }
        await self.meta.omap_set(self._mp_meta_oid(bucket, key, upload_id), {
            f"part.{part_num:05d}": json.dumps(entry).encode(),
        })
        old_raw = omap.get(f"part.{part_num:05d}")
        if old_raw:  # replaced: the old chain is garbage now
            for oid, _sz in json.loads(old_raw)["oids"]:
                await self._remove_quiet(io, oid)
        return etag

    async def _mp_claim(self, bucket: dict, key: str, upload_id: str) -> bool:
        """Atomically claim the upload for finalization: complete and
        abort racing on one upload id must not interleave (the
        fuzzer's seed-0 catch: abort deleted the part chains a
        concurrent complete had just stitched into the live object).
        Exclusive-create on a claim object is the arbiter — exactly
        one finalizer wins (rgw_multi.cc serializes through the meta
        object the same way)."""
        try:
            await self.meta.create(
                self._mp_meta_oid(bucket, key, upload_id) + ".claim",
                exclusive=True)
        except RadosError as e:
            if e.errno == errno.EEXIST:
                return False
            raise
        return True

    async def complete_multipart(
        self, bucket: dict, key: str, upload_id: str,
        parts: list[tuple[int, str]],
    ) -> dict:
        """parts: [(part_number, etag)] as sent by the client; must be
        ascending and match uploaded parts (rgw_op.cc
        RGWCompleteMultipart::execute)."""
        omap = await self._mp_state(bucket, key, upload_id)
        mp_meta = json.loads(omap[".meta"])
        if not parts:
            raise RGWError("InvalidPart", 400, "no parts")
        if [p for p, _ in parts] != sorted(set(p for p, _ in parts)):
            raise RGWError("InvalidPartOrder", 400, "parts out of order")
        manifest: list[list] = []
        total = 0
        md5s = b""
        uploaded = {
            int(k.split(".")[1]): json.loads(v)
            for k, v in omap.items() if k.startswith("part.")
        }
        for pn, etag in parts:
            entry = uploaded.get(pn)
            if entry is None or entag_strip(entry["etag"]) != entag_strip(etag):
                raise RGWError("InvalidPart", 400, f"part {pn}")
            manifest += [[oid, sz] for oid, sz in entry["oids"]]
            total += entry["size"]
            md5s += bytes.fromhex(entry["etag"])
        # claim only once the request validates: a rejected complete
        # must not poison the upload for a retry (claim released on any
        # later failure)
        if not await self._mp_claim(bucket, key, upload_id):
            # another finalizer (an abort, or a duplicate complete)
            # owns the upload
            raise RGWError("NoSuchUpload", 404, upload_id)
        io = self._data_io(bucket)
        head_oid = self._head_oid(bucket, key)
        etag = f"{hashlib.md5(md5s).hexdigest()}-{len(parts)}"
        tag = await self._index_prepare(bucket, key, "put")
        try:
            new_oids = {oid for oid, _sz in manifest}
            try:  # replacing an existing object: drop its tails
                old = await self._read_meta(io, head_oid)
                for oid, _sz in old.get("manifest", []):
                    if oid not in new_oids:
                        await self._remove_quiet(io, oid)
            except RGWError:
                pass
            meta = {
                "size": total, "etag": etag, "mtime": self._nowstr(),
                "content_type": mp_meta.get("content_type",
                                            "binary/octet-stream"),
                "head_size": 0, "manifest": manifest,
            }
            await io.operate(head_oid, ObjectOperation()
                             .write_full(b"")
                             .setxattr("rgw.meta", json.dumps(meta).encode()))
        except BaseException:
            await self._index_abort(bucket, key, tag)
            await self._remove_quiet(
                self.meta,
                self._mp_meta_oid(bucket, key, upload_id) + ".claim")
            raise
        await self._index_complete(bucket, key, tag, "put", {
            "size": total, "etag": etag, "mtime": meta["mtime"],
            "content_type": meta["content_type"],
        })
        # unreferenced parts (uploaded but not listed) + the meta object
        for pn, entry in uploaded.items():
            if pn not in {p for p, _ in parts}:
                for oid, _ in entry["oids"]:
                    await self._remove_quiet(io, oid)
        mp_oid = self._mp_meta_oid(bucket, key, upload_id)
        await self._remove_quiet(self.meta, mp_oid)
        await self._remove_quiet(self.meta, mp_oid + ".claim")
        return meta

    async def abort_multipart(self, bucket: dict, key: str, upload_id: str) -> None:
        omap = await self._mp_state(bucket, key, upload_id)
        if not await self._mp_claim(bucket, key, upload_id):
            # a complete is (or was) finalizing this upload: the part
            # chains belong to the live object now — touching them
            # would corrupt it.  S3 abort is idempotent-quiet.
            return
        io = self._data_io(bucket)
        for k, v in omap.items():
            if k.startswith("part."):
                for oid, _ in json.loads(v)["oids"]:
                    await self._remove_quiet(io, oid)
        mp_oid = self._mp_meta_oid(bucket, key, upload_id)
        await self._remove_quiet(self.meta, mp_oid)
        await self._remove_quiet(self.meta, mp_oid + ".claim")

    async def list_parts(self, bucket: dict, key: str, upload_id: str) -> list[dict]:
        omap = await self._mp_state(bucket, key, upload_id)
        out = []
        for k in sorted(omap):
            if k.startswith("part."):
                e = json.loads(omap[k])
                out.append({
                    "part_number": int(k.split(".")[1]),
                    "size": e["size"], "etag": e["etag"],
                })
        return out


def entag_strip(etag: str) -> str:
    return etag.strip().strip('"')

"""S3 REST frontend — asyncio HTTP server + op dispatch.

Twin of the reference's beast/asio frontend (rgw_asio_frontend.cc) and
the REST op dispatch in rgw_op.cc / rgw_rest_s3.cc, for path-style S3:

    GET    /                       ListBuckets
    PUT    /bucket                 CreateBucket
    DELETE /bucket                 DeleteBucket
    GET    /bucket?list-type=2     ListObjectsV2
    GET    /bucket?uploads         ListMultipartUploads (stub: empty)
    POST   /bucket?delete          DeleteObjects (batch)
    PUT    /bucket/key             PutObject | UploadPart (partNumber&uploadId)
                                   | CopyObject (x-amz-copy-source)
    GET    /bucket/key             GetObject (Range) | ListParts (uploadId)
    HEAD   /bucket/key             HeadObject
    DELETE /bucket/key             DeleteObject | AbortMultipart (uploadId)
    POST   /bucket/key?uploads     CreateMultipartUpload
    POST   /bucket/key?uploadId=X  CompleteMultipartUpload

Every request is SigV4-authenticated against the user records in the
store (rgw_auth_s3.cc) — header auth or presigned query auth — and
x-amz-meta-* user metadata round-trips through put/copy/get/head;
errors render as S3 XML error bodies.

Counterpart of ``ceph_tpu/rgw/frontend.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import logging
import time
import urllib.parse
import xml.etree.ElementTree as ET

from . import sigv4
from .store import RGWError, RGWStore, entag_strip

log = logging.getLogger("ceph_tpu_torch.rgw")

XMLNS = "http://s3.amazonaws.com/doc/2006-03-01/"
MAX_BODY = 5 * 2**30


class _HTTPRequest:
    def __init__(self, method, path, query, headers, body):
        self.method = method
        self.path = path
        self.query = query
        self.headers = headers  # lowercased keys
        self.body = body
        self.params = dict(urllib.parse.parse_qsl(
            query, keep_blank_values=True))
        self.uid = None  # set by auth


def _xml(tag: str, *children, text: str | None = None) -> ET.Element:
    el = ET.Element(tag)
    if text is not None:
        el.text = text
    for c in children:
        el.append(c)
    return el


def _render(root: ET.Element) -> bytes:
    root.set("xmlns", XMLNS)
    return (
        b'<?xml version="1.0" encoding="UTF-8"?>'
        + ET.tostring(root, encoding="utf-8")
    )


_STATUS = {
    200: "OK", 204: "No Content", 206: "Partial Content",
    400: "Bad Request", 403: "Forbidden", 404: "Not Found",
    405: "Method Not Allowed", 409: "Conflict",
    416: "Range Not Satisfiable", 500: "Internal Server Error",
    501: "Not Implemented",
}


class S3Frontend:
    def __init__(self, store: RGWStore, host: str = "127.0.0.1",
                 port: int = 0, conf=None):
        self.store = store
        self.host, self.port = host, port
        self._server: asyncio.AbstractServer | None = None
        # mgr report stream: the MgrMap rides the store's rados
        # session (mon subscription); reports dial out over the same
        # client messenger — rgw has no daemon messenger of its own
        from ceph_tpu_torch.common import ConfigProxy, get_perf_counters
        from ceph_tpu_torch.common.tracing import Tracer
        from ceph_tpu_torch.mgr.client import MgrClient

        self.conf = conf if conf is not None else ConfigProxy()
        self.perf = get_perf_counters("rgw.main")
        self.tracer = Tracer(
            "rgw.main",
            ring_max=self.conf["trace_ring_max"],
            sample_rate=self.conf["trace_sample_rate"],
            tail_slow_s=(self.conf["trace_tail_slow_s"] or None),
        )
        self._admin = None
        rados = store.meta.client
        self.mgr_client = MgrClient(
            "rgw.main", rados.messenger, self.conf,
            self._mgr_collect, tracers=(self.tracer,))
        self._rados = rados

    def _mgr_collect(self) -> dict:
        return {
            "counters": self.perf.dump(),
            "status": {"frontend": f"{self.host}:{self.port}"},
        }

    @property
    def addr(self) -> tuple[str, int]:
        return (self.host, self.port)

    async def start(self) -> None:
        self._server = await asyncio.start_server(
            self._serve, self.host, self.port)
        self.port = self._server.sockets[0].getsockname()[1]
        sock_path = self.conf["admin_socket"]
        if sock_path:
            from ceph_tpu_torch.common import AdminSocket

            self._admin = AdminSocket(sock_path.replace("$id", "rgw.main"))
            self._admin.register(
                "dump_traces", "recent spans (blkin/otel role)",
                lambda cmd: self.tracer.dump(),
            )
            self._admin.register(
                "perf dump", "dump perf counters",
                lambda cmd: self.perf.dump(),
            )
            self._admin.register(
                "status", "daemon status",
                lambda cmd: {"frontend": f"{self.host}:{self.port}"},
            )
            await self._admin.start()
        self._rados.set_mgr_map_listener(self.mgr_client.handle_mgr_map)
        self.mgr_client.start()
        log.info("rgw: listening on %s:%d", self.host, self.port)

    async def stop(self) -> None:
        await self.mgr_client.stop()
        if self._admin is not None:
            await self._admin.stop()
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()

    # -- HTTP plumbing -------------------------------------------------

    async def _serve(self, reader: asyncio.StreamReader,
                     writer: asyncio.StreamWriter) -> None:
        try:
            while True:
                req = await self._read_request(reader)
                if req is None:
                    break
                with self.tracer.span(
                    "rgw_req", method=req.method, path=req.path,
                ) as sp:
                    status, headers, body = await self._handle(req)
                    sp.tag(status=status)
                self.perf.inc("req")
                if status >= 400:
                    self.perf.inc("req_err")
                await self._respond(writer, status, headers, body,
                                    head_only=req.method == "HEAD")
        except (ConnectionError, asyncio.IncompleteReadError):
            pass
        finally:
            writer.close()
            try:
                await writer.wait_closed()
            except (ConnectionError, OSError):
                pass

    async def _read_request(self, reader) -> _HTTPRequest | None:
        try:
            line = await reader.readline()
        except (ConnectionError, OSError):
            return None
        if not line:
            return None
        try:
            method, target, _version = line.decode().split()
        except ValueError:
            return None
        headers: dict[str, str] = {}
        while True:
            hline = await reader.readline()
            if hline in (b"\r\n", b"\n", b""):
                break
            name, _, val = hline.decode().partition(":")
            headers[name.strip().lower()] = val.strip()
        try:
            length = int(headers.get("content-length", "0"))
        except ValueError:
            return None
        if length > MAX_BODY or length < 0:
            return None
        body = await reader.readexactly(length) if length else b""
        parsed = urllib.parse.urlsplit(target)
        return _HTTPRequest(method.upper(), parsed.path, parsed.query,
                            headers, body)

    async def _respond(self, writer, status: int, headers: dict, body: bytes,
                       head_only: bool = False) -> None:
        headers.setdefault("content-length", str(len(body)))
        lines = [f"HTTP/1.1 {status} {_STATUS.get(status, '?')}\r\n"]
        lines += [f"{k}: {v}\r\n" for k, v in headers.items()]
        lines.append("\r\n")
        writer.write("".join(lines).encode())
        if body and not head_only:
            writer.write(body)
        await writer.drain()

    # -- auth + dispatch -----------------------------------------------

    def _error(self, e: RGWError) -> tuple[int, dict, bytes]:
        body = _render(_xml(
            "Error",
            _xml("Code", text=e.code),
            _xml("Message", text=str(e)),
        ))
        return e.status, {"content-type": "application/xml"}, body

    async def _authenticate(self, req: _HTTPRequest) -> None:
        auth_hdr = req.headers.get("authorization", "")
        try:
            if not auth_hdr and "X-Amz-Signature" in req.params:
                # presigned URL: auth rides the query string
                parsed = sigv4.parse_presigned_query(req.query)
                user = await self.store.get_user_by_access_key(
                    parsed.access_key)
                if user is None:
                    raise RGWError(
                        "InvalidAccessKeyId", 403, parsed.access_key)
                sigv4.verify_presigned(
                    req.method, req.path, req.query, req.headers,
                    user["secret_key"])
            elif auth_hdr:
                parsed = sigv4.parse_authorization(auth_hdr)
                user = await self.store.get_user_by_access_key(
                    parsed.access_key)
                if user is None:
                    raise RGWError(
                        "InvalidAccessKeyId", 403, parsed.access_key)
                sigv4.verify(req.method, req.path, req.query, req.headers,
                             req.body, user["secret_key"])
            else:
                raise RGWError("AccessDenied", 403,
                               "anonymous access denied")
        except sigv4.SigV4Error as e:
            raise RGWError(e.code, 403, str(e))
        req.uid = user["uid"]

    async def _handle(self, req: _HTTPRequest) -> tuple[int, dict, bytes]:
        try:
            await self._authenticate(req)
            parts = req.path.lstrip("/").split("/", 1)
            bucket_name = urllib.parse.unquote(parts[0])
            key = urllib.parse.unquote(parts[1]) if len(parts) > 1 else ""
            if not bucket_name:
                return await self._service(req)
            if not key:
                return await self._bucket(req, bucket_name)
            return await self._object(req, bucket_name, key)
        except RGWError as e:
            return self._error(e)
        except Exception:
            log.exception("rgw: internal error on %s %s", req.method, req.path)
            return self._error(RGWError("InternalError", 500, "internal"))

    # -- service ops ----------------------------------------------------

    async def _service(self, req) -> tuple[int, dict, bytes]:
        if req.method != "GET":
            raise RGWError("MethodNotAllowed", 405, req.method)
        buckets = await self.store.list_buckets(req.uid)
        root = _xml(
            "ListAllMyBucketsResult",
            _xml("Owner", _xml("ID", text=req.uid)),
            _xml("Buckets", *[
                _xml("Bucket",
                     _xml("Name", text=b["name"]),
                     _xml("CreationDate", text=b["created"]))
                for b in buckets
            ]),
        )
        return 200, {"content-type": "application/xml"}, _render(root)

    # -- bucket ops ------------------------------------------------------

    async def _bucket(self, req, name: str) -> tuple[int, dict, bytes]:
        if req.method == "PUT":
            if "versioning" in req.params:
                status = _xml_find_text(req.body, "Status")
                if status is None:
                    raise RGWError("MalformedXML", 400,
                                   "Status required")
                await self.store.set_bucket_versioning(name, status)
                return 200, {}, b""
            if "lifecycle" in req.params:
                rules = _parse_lifecycle_xml(req.body)
                await self.store.set_lifecycle(name, rules)
                return 200, {}, b""
            placement = req.headers.get("x-rgw-placement")  # extension
            await self.store.create_bucket(name, req.uid, placement)
            return 200, {"location": f"/{name}"}, b""
        if req.method == "DELETE" and "lifecycle" in req.params:
            await self.store.delete_lifecycle(name)
            return 204, {}, b""
        if req.method == "DELETE":
            await self.store.delete_bucket(name, req.uid)
            return 204, {}, b""
        if req.method == "HEAD":
            await self.store.get_bucket(name)
            return 200, {}, b""
        if req.method == "GET":
            bucket = await self.store.get_bucket(name)
            if "uploads" in req.params:
                root = _xml("ListMultipartUploadsResult",
                            _xml("Bucket", text=name))
                return 200, {"content-type": "application/xml"}, _render(root)
            if "versioning" in req.params:
                status = self.store.versioning_of(bucket)
                kids = []
                if status != "Off":
                    kids.append(_xml("Status", text=status))
                root = _xml("VersioningConfiguration", *kids)
                return 200, {"content-type": "application/xml"}, _render(root)
            if "versions" in req.params:
                return await self._list_versions(req, bucket)
            if "lifecycle" in req.params:
                rules = await self.store.get_lifecycle(name)
                root = _xml("LifecycleConfiguration", *[
                    _rule_to_xml(r) for r in rules])
                return 200, {"content-type": "application/xml"}, _render(root)
            return await self._list_objects_v2(req, bucket)
        if req.method == "POST" and "delete" in req.params:
            return await self._batch_delete(req, name)
        raise RGWError("MethodNotAllowed", 405, req.method)

    async def _batch_delete(self, req, name: str) -> tuple[int, dict, bytes]:
        """POST /bucket?delete — DeleteObjects (RGWDeleteMultiObj,
        rgw_op.cc): up to 1000 keys per request, per-key outcome."""
        bucket = await self.store.get_bucket(name)
        try:
            root = ET.fromstring(req.body)
        except ET.ParseError:
            raise RGWError("MalformedXML", 400, "bad Delete body")
        quiet = any(
            c.tag.endswith("Quiet") and (c.text or "").lower() == "true"
            for c in root)
        keys = []
        for obj in root:
            if not obj.tag.endswith("Object"):
                continue
            for child in obj:
                if child.tag.endswith("Key") and child.text:
                    keys.append(child.text)
        if len(keys) > 1000:
            raise RGWError("MalformedXML", 400, "over 1000 keys")
        out = _xml("DeleteResult")
        for key in keys:
            try:
                await self.store.delete_object(bucket, key)
                if not quiet:
                    out.append(_xml("Deleted", _xml("Key", text=key)))
            except RGWError as e:
                out.append(_xml(
                    "Error", _xml("Key", text=key),
                    _xml("Code", text=e.code),
                ))
        return 200, {"content-type": "application/xml"}, _render(out)

    async def _list_versions(self, req, bucket) -> tuple[int, dict, bytes]:
        prefix = req.params.get("prefix", "")
        key_marker = req.params.get("key-marker", "")
        max_keys = _int_param(req.params.get("max-keys", "1000"), "max-keys")
        res = await self.store.list_object_versions(
            bucket, prefix=prefix, key_marker=key_marker,
            max_keys=max_keys)
        children = [
            _xml("Name", text=bucket["name"]),
            _xml("Prefix", text=prefix),
            _xml("MaxKeys", text=str(max_keys)),
            _xml("IsTruncated",
                 text="true" if res["truncated"] else "false"),
        ]
        for rec in res["entries"]:
            tag = ("DeleteMarker" if rec.get("delete_marker")
                   else "Version")
            kids = [
                _xml("Key", text=rec["key"]),
                _xml("VersionId", text=rec["vid"]),
                _xml("IsLatest",
                     text="true" if rec["is_latest"] else "false"),
                _xml("LastModified", text=rec.get("mtime", "")),
            ]
            if tag == "Version":
                kids += [
                    _xml("ETag", text=f"\"{rec.get('etag', '')}\""),
                    _xml("Size", text=str(rec.get("size", 0))),
                ]
            children.append(_xml(tag, *kids))
        root = _xml("ListVersionsResult", *children)
        return 200, {"content-type": "application/xml"}, _render(root)

    async def _list_objects_v2(self, req, bucket) -> tuple[int, dict, bytes]:
        prefix = req.params.get("prefix", "")
        delimiter = req.params.get("delimiter", "")
        max_keys = _int_param(req.params.get("max-keys", "1000"), "max-keys")
        token = req.params.get("continuation-token", "")
        start_after = req.params.get("start-after", "")
        marker = token or start_after
        res = await self.store.list_objects(
            bucket, prefix=prefix, delimiter=delimiter,
            marker=marker, max_keys=max_keys)
        children = [
            _xml("Name", text=bucket["name"]),
            _xml("Prefix", text=prefix),
            _xml("KeyCount", text=str(
                len(res["entries"]) + len(res["common_prefixes"]))),
            _xml("MaxKeys", text=str(max_keys)),
            _xml("IsTruncated", text="true" if res["truncated"] else "false"),
        ]
        if res["truncated"]:
            children.append(
                _xml("NextContinuationToken", text=res["next_marker"]))
        for key, meta in res["entries"]:
            children.append(_xml(
                "Contents",
                _xml("Key", text=key),
                _xml("LastModified", text=meta.get("mtime", "")),
                _xml("ETag", text=f"\"{meta.get('etag', '')}\""),
                _xml("Size", text=str(meta.get("size", 0))),
            ))
        for cp in res["common_prefixes"]:
            children.append(_xml("CommonPrefixes", _xml("Prefix", text=cp)))
        root = _xml("ListBucketResult", *children)
        return 200, {"content-type": "application/xml"}, _render(root)

    # -- object ops ------------------------------------------------------

    async def _object(self, req, bucket_name: str, key: str):
        bucket = await self.store.get_bucket(bucket_name)
        if req.method == "PUT":
            if "partnumber" in {k.lower() for k in req.params}:
                return await self._upload_part(req, bucket, key)
            if "x-amz-copy-source" in req.headers:
                return await self._copy_object(req, bucket, key)
            ct = req.headers.get("content-type", "binary/octet-stream")
            meta = await self.store.put_object(
                bucket, key, req.body, ct,
                user_meta=_user_meta_headers(req.headers))
            hdrs = {"etag": f"\"{meta['etag']}\""}
            if "version_id" in meta:
                hdrs["x-amz-version-id"] = meta["version_id"]
            return 200, hdrs, b""
        if req.method == "POST":
            if "uploads" in req.params:
                ct = req.headers.get("content-type", "binary/octet-stream")
                upload_id = await self.store.initiate_multipart(bucket, key, ct)
                root = _xml(
                    "InitiateMultipartUploadResult",
                    _xml("Bucket", text=bucket_name),
                    _xml("Key", text=key),
                    _xml("UploadId", text=upload_id),
                )
                return 200, {"content-type": "application/xml"}, _render(root)
            if "uploadId" in req.params:
                return await self._complete_multipart(req, bucket, key)
            raise RGWError("MethodNotAllowed", 405, "POST")
        if req.method in ("GET", "HEAD"):
            if "uploadId" in req.params and req.method == "GET":
                parts = await self.store.list_parts(
                    bucket, key, req.params["uploadId"])
                root = _xml(
                    "ListPartsResult",
                    _xml("Bucket", text=bucket_name),
                    _xml("Key", text=key),
                    _xml("UploadId", text=req.params["uploadId"]),
                    *[_xml("Part",
                           _xml("PartNumber", text=str(p["part_number"])),
                           _xml("ETag", text=f"\"{p['etag']}\""),
                           _xml("Size", text=str(p["size"])))
                      for p in parts],
                )
                return 200, {"content-type": "application/xml"}, _render(root)
            return await self._get_object(req, bucket, key)
        if req.method == "DELETE":
            if "uploadId" in req.params:
                await self.store.abort_multipart(
                    bucket, key, req.params["uploadId"])
                return 204, {}, b""
            out = await self.store.delete_object(
                bucket, key, version_id=req.params.get("versionId"))
            hdrs = {}
            if out.get("version_id"):
                hdrs["x-amz-version-id"] = out["version_id"]
            if out.get("delete_marker"):
                hdrs["x-amz-delete-marker"] = "true"
            return 204, hdrs, b""
        raise RGWError("MethodNotAllowed", 405, req.method)

    async def _get_object(self, req, bucket, key):
        rng = req.headers.get("range", "")
        vid = req.params.get("versionId")
        meta = await self.store.head_object(bucket, key, version_id=vid)
        size = meta["size"]
        status = 200
        off, length = 0, None
        resp_headers = {}
        if "version_id" in meta:
            resp_headers["x-amz-version-id"] = meta["version_id"]
        if rng:
            off, end_incl = _parse_range(rng, size)
            length = end_incl - off + 1
            status = 206
            resp_headers["content-range"] = f"bytes {off}-{end_incl}/{size}"
        if req.method == "HEAD":
            body = b""
            resp_headers["content-length"] = str(
                length if length is not None else size)
        else:
            _meta, body = await self.store.get_object(
                bucket, key, off, length, version_id=vid)
        resp_headers.update({
            "etag": f"\"{meta['etag']}\"",
            "last-modified": meta.get("mtime", ""),
            "content-type": meta.get("content_type", "binary/octet-stream"),
            "accept-ranges": "bytes",
        })
        for k, v in meta.get("user_meta", {}).items():
            resp_headers[f"x-amz-meta-{k}"] = v
        return status, resp_headers, body

    async def _copy_object(self, req, bucket, key):
        """PUT with x-amz-copy-source (RGWCopyObj, rgw_op.cc): server-
        side copy, metadata COPY by default or REPLACE per the
        x-amz-metadata-directive header."""
        src = urllib.parse.unquote(req.headers["x-amz-copy-source"])
        src = src.lstrip("/")
        if "/" not in src:
            raise RGWError("InvalidArgument", 400, "bad copy source")
        src_bucket_name, src_key = src.split("/", 1)
        src_bucket = await self.store.get_bucket(src_bucket_name)
        try:
            src_meta, data = await self.store.get_object(
                src_bucket, src_key)
        except RGWError as e:
            if e.code == "NoSuchKey":
                raise RGWError("NoSuchKey", 404, src)
            raise
        directive = req.headers.get(
            "x-amz-metadata-directive", "COPY").upper()
        if directive == "REPLACE":
            ct = req.headers.get("content-type", "binary/octet-stream")
            um = _user_meta_headers(req.headers)
        else:
            ct = src_meta.get("content_type", "binary/octet-stream")
            um = src_meta.get("user_meta", {})
        meta = await self.store.put_object(
            bucket, key, data, ct, user_meta=um)
        out = _xml(
            "CopyObjectResult",
            _xml("ETag", text=f"\"{meta['etag']}\""),
            _xml("LastModified", text=meta["mtime"]),
        )
        return 200, {"content-type": "application/xml"}, _render(out)

    async def _upload_part(self, req, bucket, key):
        params = {k.lower(): v for k, v in req.params.items()}
        upload_id = params.get("uploadid")
        if not upload_id:
            raise RGWError("InvalidArgument", 400, "uploadId required")
        part_num = _int_param(params.get("partnumber", "0"), "partNumber")
        if "x-amz-copy-source" in req.headers:
            # UploadPartCopy (RGWCopyObj in multipart mode): the part
            # body comes from an existing object, optionally ranged
            src = urllib.parse.unquote(
                req.headers["x-amz-copy-source"]).lstrip("/")
            if "/" not in src:
                raise RGWError("InvalidArgument", 400, "bad copy source")
            src_bucket_name, src_key = src.split("/", 1)
            src_bucket = await self.store.get_bucket(src_bucket_name)
            src_meta = await self.store.head_object(src_bucket, src_key)
            off, length = 0, None
            crange = req.headers.get("x-amz-copy-source-range", "")
            if crange:
                off, end_incl = _parse_range(crange, src_meta["size"])
                length = end_incl - off + 1
            _m, data = await self.store.get_object(
                src_bucket, src_key, off, length)
            etag = await self.store.upload_part(
                bucket, key, upload_id, part_num, data)
            out = _xml(
                "CopyPartResult",
                _xml("ETag", text=f"\"{etag}\""),
                _xml("LastModified", text=src_meta["mtime"]),
            )
            return 200, {"content-type": "application/xml"}, _render(out)
        etag = await self.store.upload_part(
            bucket, key, upload_id, part_num, req.body)
        return 200, {"etag": f"\"{etag}\""}, b""

    async def _complete_multipart(self, req, bucket, key):
        upload_id = req.params["uploadId"]
        try:
            root = ET.fromstring(req.body)
        except ET.ParseError:
            raise RGWError("MalformedXML", 400, "bad CompleteMultipartUpload")
        parts: list[tuple[int, str]] = []
        for part in root:
            if not part.tag.endswith("Part"):
                continue
            pn = etag = None
            for child in part:
                if child.tag.endswith("PartNumber"):
                    try:
                        pn = int(child.text)
                    except (TypeError, ValueError):
                        raise RGWError("MalformedXML", 400, "bad PartNumber")
                elif child.tag.endswith("ETag"):
                    etag = entag_strip(child.text or "")
            if pn is None or etag is None:
                raise RGWError("MalformedXML", 400, "Part missing fields")
            parts.append((pn, etag))
        meta = await self.store.complete_multipart(bucket, key, upload_id, parts)
        out = _xml(
            "CompleteMultipartUploadResult",
            _xml("Bucket", text=bucket["name"]),
            _xml("Key", text=key),
            _xml("ETag", text=f"\"{meta['etag']}\""),
        )
        return 200, {"content-type": "application/xml"}, _render(out)


async def http_request(host: str, port: int, method: str, target: str,
                       headers: dict, body: bytes = b"") -> tuple[int, dict, bytes]:
    """One HTTP/1.1 request on its own connection, as a client: (status,
    lowercased headers, body).  The smoke's and the pace harness's S3
    and ``/metrics`` requests."""
    reader, writer = await asyncio.open_connection(host, port)
    try:
        head = [f"{method} {target} HTTP/1.1\r\n", f"host: {host}:{port}\r\n",
                f"content-length: {len(body)}\r\n"]
        head += [f"{k}: {v}\r\n" for k, v in headers.items()
                 if k not in ("host", "content-length")]
        writer.write("".join(head).encode() + b"\r\n" + body)
        await writer.drain()
        status = int((await reader.readline()).split()[1])
        got: dict[str, str] = {}
        while (line := await reader.readline()) not in (b"\r\n", b"\n", b""):
            name, _, val = line.decode().partition(":")
            got[name.strip().lower()] = val.strip()
        n = int(got.get("content-length", "0"))
        return status, got, (await reader.readexactly(n) if n and method != "HEAD" else b"")
    finally:
        writer.close()
        await writer.wait_closed()


async def s3_request(host: str, port: int, method: str, path: str, access: str,
                     secret: str, body: bytes = b"") -> tuple[int, dict, bytes]:
    """An S3 request to the gateway at ``host:port``, signed with SigV4
    (header auth) as the user ``access`` / ``secret``."""
    headers = sigv4.sign_request(method, path, "", {"host": f"{host}:{port}"}, body,
                                 access, secret,
                                 amz_date=time.strftime("%Y%m%dT%H%M%SZ", time.gmtime()))
    return await http_request(host, port, method, path, headers, body)


def _strip_ns(tag: str) -> str:
    return tag.rsplit("}", 1)[-1]


def _xml_find_text(body: bytes, tag: str) -> str | None:
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise RGWError("MalformedXML", 400, "bad XML body")
    for el in root.iter():
        if _strip_ns(el.tag) == tag:
            return (el.text or "").strip()
    return None


def _parse_lifecycle_xml(body: bytes) -> list[dict]:
    """<LifecycleConfiguration><Rule>... -> [{id, prefix, status,
    days?, noncurrent_days?}] (the slice of rgw_lc.cc's rule model the
    lite worker executes)."""
    try:
        root = ET.fromstring(body)
    except ET.ParseError:
        raise RGWError("MalformedXML", 400, "bad lifecycle XML")
    rules = []
    for rel in root:
        if _strip_ns(rel.tag) != "Rule":
            continue
        rule: dict = {"status": "Enabled", "prefix": ""}
        for el in rel:
            t = _strip_ns(el.tag)
            if t == "ID":
                rule["id"] = (el.text or "").strip()
            elif t == "Status":
                rule["status"] = (el.text or "Enabled").strip()
            elif t == "Prefix":
                rule["prefix"] = (el.text or "").strip()
            elif t == "Filter":
                for f in el.iter():
                    if _strip_ns(f.tag) == "Prefix":
                        rule["prefix"] = (f.text or "").strip()
            elif t == "Expiration":
                for d in el:
                    if _strip_ns(d.tag) == "Days":
                        rule["days"] = int(d.text or "0")
            elif t == "NoncurrentVersionExpiration":
                for d in el:
                    if _strip_ns(d.tag) == "NoncurrentDays":
                        rule["noncurrent_days"] = int(d.text or "0")
        rules.append(rule)
    if not rules:
        raise RGWError("MalformedXML", 400, "no rules")
    return rules


def _rule_to_xml(rule: dict) -> ET.Element:
    kids = [
        _xml("ID", text=rule.get("id", "")),
        _xml("Prefix", text=rule.get("prefix", "")),
        _xml("Status", text=rule.get("status", "Enabled")),
    ]
    if "days" in rule:
        kids.append(_xml("Expiration",
                         _xml("Days", text=str(rule["days"]))))
    if "noncurrent_days" in rule:
        kids.append(_xml(
            "NoncurrentVersionExpiration",
            _xml("NoncurrentDays", text=str(rule["noncurrent_days"]))))
    return _xml("Rule", *kids)


def _user_meta_headers(headers: dict[str, str]) -> dict[str, str]:
    """x-amz-meta-* request headers -> the user-metadata dict stored
    alongside the object (RGW_ATTR_META_PREFIX role)."""
    return {
        k[len("x-amz-meta-"):]: v
        for k, v in headers.items() if k.startswith("x-amz-meta-")
    }


def _int_param(value: str, name: str) -> int:
    try:
        return int(value)
    except ValueError:
        raise RGWError("InvalidArgument", 400, f"bad {name}: {value!r}")


def _parse_range(value: str, size: int) -> tuple[int, int]:
    """'bytes=a-b' (also 'a-' and '-suffix') -> (first, last) inclusive."""
    if not value.startswith("bytes="):
        raise RGWError("InvalidRange", 416, value)
    spec = value[len("bytes="):].split(",")[0].strip()
    first_s, _, last_s = spec.partition("-")
    try:
        if first_s == "":           # suffix: last N bytes
            n = int(last_s)
            if n <= 0 or size == 0:
                raise ValueError
            return max(0, size - n), size - 1
        first = int(first_s)
        last = int(last_s) if last_s else size - 1
    except ValueError:
        raise RGWError("InvalidRange", 416, value)
    if first >= size or first > last:
        raise RGWError("InvalidRange", 416, value)
    return first, min(last, size - 1)

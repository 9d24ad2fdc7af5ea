"""RGW-lite end to end: S3 REST over a live mini-cluster.

The reference's RGW suites drive a real S3 client against the gateway
(qa/tasks/s3tests); here a minimal HTTP client signs every request
with SigV4 (header auth) and exercises: create-bucket -> put ->
multipart put -> range get -> list-objects-v2 (prefix/delimiter/
pagination) -> delete, against BOTH a replicated and an EC data pool
(bucket placement), with the bucket index living on the replicated
meta pool via the in-OSD rgw class (src/cls/rgw semantics).

The port's twin of tests/integration/test_rgw.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import hashlib
import time
import urllib.parse
import xml.etree.ElementTree as ET

import pytest

from ceph_tpu_torch.rgw import S3Frontend, RGWStore
from ceph_tpu_torch.rgw.sigv4 import sign_request

from tests.test_torch_mini_cluster import Cluster, run

ACCESS, SECRET = "AKIDTEST", "sekrit-key-for-tests"


class S3Client:
    """Raw-HTTP S3 client: independent of the gateway's code paths
    except the shared sigv4 signer (which the server verifies against
    its own canonicalization — a real round-trip of the algorithm)."""

    def __init__(self, host: str, port: int,
                 access: str = ACCESS, secret: str = SECRET):
        self.host, self.port = host, port
        self.access, self.secret = access, secret

    async def request(self, method: str, path: str, query: str = "",
                      body: bytes = b"", headers: dict | None = None):
        amz_date = time.strftime("%Y%m%dT%H%M%SZ", time.gmtime())
        h = {"host": f"{self.host}:{self.port}"}
        if headers:
            h.update({k.lower(): v for k, v in headers.items()})
        signed = sign_request(method, path, query, h, body,
                              self.access, self.secret, amz_date=amz_date)
        target = path + (f"?{query}" if query else "")
        reader, writer = await asyncio.open_connection(self.host, self.port)
        try:
            req = [f"{method} {target} HTTP/1.1\r\n"]
            signed["content-length"] = str(len(body))
            req += [f"{k}: {v}\r\n" for k, v in signed.items()]
            req.append("\r\n")
            writer.write("".join(req).encode() + body)
            await writer.drain()
            status_line = await reader.readline()
            status = int(status_line.split()[1])
            resp_headers = {}
            while True:
                line = await reader.readline()
                if line in (b"\r\n", b"\n", b""):
                    break
                name, _, val = line.decode().partition(":")
                resp_headers[name.strip().lower()] = val.strip()
            length = int(resp_headers.get("content-length", "0"))
            resp_body = (
                await reader.readexactly(length)
                if length and method != "HEAD" else b""
            )
            return status, resp_headers, resp_body
        finally:
            writer.close()


async def _gateway(c, ec: bool = False):
    """Boot pools + store + frontend on the mini-cluster."""
    await c.client.pool_create("rgw.meta", pg_num=4, size=3)
    if ec:
        await c.client.ec_profile_set(
            "rgwp", {"plugin": "cuda", "k": "3", "m": "2"})
        await c.client.pool_create(
            "rgw.data", pg_num=8, pool_type="erasure",
            erasure_code_profile="rgwp")
    else:
        await c.client.pool_create("rgw.data", pg_num=8, size=3)
    store = RGWStore(
        c.client.ioctx("rgw.meta"),
        {"default": c.client.ioctx("rgw.data")},
        chunk_size=256 * 1024,  # small so tests exercise manifests
    )
    await store.create_user("tester", "Test User",
                            access_key=ACCESS, secret_key=SECRET)
    fe = S3Frontend(store)
    await fe.start()
    return fe, S3Client(fe.host, fe.port)


def _keys_of(list_xml: bytes) -> list[str]:
    root = ET.fromstring(list_xml)
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    return [e.findtext(f"{ns}Key") for e in root.findall(f"{ns}Contents")]


def _prefixes_of(list_xml: bytes) -> list[str]:
    root = ET.fromstring(list_xml)
    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
    return [e.findtext(f"{ns}Prefix")
            for e in root.findall(f"{ns}CommonPrefixes")]


class TestS3BasicOps:
    def test_bucket_object_lifecycle(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    # create + list + auth failure modes
                    st, _, _ = await s3.request("PUT", "/b1")
                    assert st == 200
                    st, _, _ = await s3.request("PUT", "/b1")
                    assert st == 409  # BucketAlreadyOwnedByYou
                    bad = S3Client(fe.host, fe.port, secret="wrong")
                    st, _, body = await bad.request("GET", "/")
                    assert st == 403 and b"SignatureDoesNotMatch" in body
                    unknown = S3Client(fe.host, fe.port, access="NOPE")
                    st, _, body = await unknown.request("GET", "/")
                    assert st == 403 and b"InvalidAccessKeyId" in body

                    # put / get / head / etag
                    payload = b"hello s3 world" * 100
                    st, h, _ = await s3.request(
                        "PUT", "/b1/hello.txt", body=payload,
                        headers={"content-type": "text/plain"})
                    assert st == 200
                    assert h["etag"].strip('"') == hashlib.md5(
                        payload).hexdigest()
                    st, h, body = await s3.request("GET", "/b1/hello.txt")
                    assert st == 200 and body == payload
                    assert h["content-type"] == "text/plain"
                    st, h, _ = await s3.request("HEAD", "/b1/hello.txt")
                    assert st == 200
                    assert int(h["content-length"]) == len(payload)

                    # range get
                    st, h, body = await s3.request(
                        "GET", "/b1/hello.txt",
                        headers={"range": "bytes=3-16"})
                    assert st == 206 and body == payload[3:17]
                    assert h["content-range"] == (
                        f"bytes 3-16/{len(payload)}")
                    st, _, body = await s3.request(
                        "GET", "/b1/hello.txt",
                        headers={"range": "bytes=-5"})
                    assert st == 206 and body == payload[-5:]

                    # 404s
                    st, _, body = await s3.request("GET", "/b1/nope")
                    assert st == 404 and b"NoSuchKey" in body
                    st, _, body = await s3.request("GET", "/nobucket/x")
                    assert st == 404 and b"NoSuchBucket" in body

                    # delete object, then bucket
                    st, _, _ = await s3.request("DELETE", "/b1/hello.txt")
                    assert st == 204
                    st, _, _ = await s3.request("DELETE", "/b1")
                    assert st == 204
                    st, _, body = await s3.request(
                        "GET", "/b1", "list-type=2")
                    assert st == 404
                finally:
                    await fe.stop()

        run(go())

    def test_bucket_not_empty_guard(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/b2")
                    await s3.request("PUT", "/b2/x", body=b"data")
                    st, _, body = await s3.request("DELETE", "/b2")
                    assert st == 409 and b"BucketNotEmpty" in body
                finally:
                    await fe.stop()

        run(go())


class TestS3Listing:
    def test_list_v2_prefix_delimiter_pagination(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/lb")
                    keys = (
                        [f"photos/2024/img{i:02d}.jpg" for i in range(3)]
                        + [f"photos/2025/img{i:02d}.jpg" for i in range(3)]
                        + [f"docs/file{i:02d}.txt" for i in range(4)]
                        + ["root.txt"]
                    )
                    for k in keys:
                        q = urllib.parse.quote(k)
                        st, _, _ = await s3.request(
                            "PUT", f"/lb/{q}", body=k.encode())
                        assert st == 200

                    # full listing, sorted
                    st, _, body = await s3.request("GET", "/lb", "list-type=2")
                    assert st == 200
                    assert _keys_of(body) == sorted(keys)

                    # prefix
                    st, _, body = await s3.request(
                        "GET", "/lb", "list-type=2&prefix=docs/")
                    assert _keys_of(body) == sorted(
                        k for k in keys if k.startswith("docs/"))

                    # delimiter folding
                    st, _, body = await s3.request(
                        "GET", "/lb", "list-type=2&delimiter=/")
                    assert _keys_of(body) == ["root.txt"]
                    assert _prefixes_of(body) == ["docs/", "photos/"]
                    st, _, body = await s3.request(
                        "GET", "/lb",
                        "list-type=2&delimiter=/&prefix=photos/")
                    assert _prefixes_of(body) == [
                        "photos/2024/", "photos/2025/"]

                    # pagination with continuation tokens
                    got: list[str] = []
                    token = ""
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                    for _page in range(10):
                        q = "list-type=2&max-keys=3"
                        if token:
                            q += "&continuation-token=" + urllib.parse.quote(
                                token)
                        st, _, body = await s3.request("GET", "/lb", q)
                        assert st == 200
                        got += _keys_of(body)
                        root = ET.fromstring(body)
                        if root.findtext(f"{ns}IsTruncated") != "true":
                            break
                        token = root.findtext(f"{ns}NextContinuationToken")
                        assert token
                    assert got == sorted(keys)
                finally:
                    await fe.stop()

        run(go())


class TestS3Multipart:
    @pytest.mark.parametrize("ec", [False, True], ids=["replicated", "ec"])
    def test_multipart_lifecycle(self, ec):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c, ec=ec)
                try:
                    await s3.request("PUT", "/mp")
                    # initiate
                    st, _, body = await s3.request(
                        "POST", "/mp/big.bin", "uploads")
                    assert st == 200
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                    upload_id = ET.fromstring(body).findtext(f"{ns}UploadId")
                    assert upload_id

                    # three parts; part 2 is re-uploaded (replacement)
                    import numpy as np
                    rng = np.random.default_rng(7)
                    parts_data = [
                        rng.integers(0, 256, 600 * 1024, dtype=np.uint8)
                        .tobytes() for _ in range(3)
                    ]
                    etags = {}
                    for pn, data in enumerate(parts_data, start=1):
                        st, h, _ = await s3.request(
                            "PUT", "/mp/big.bin",
                            f"partNumber={pn}&uploadId={upload_id}",
                            body=data)
                        assert st == 200
                        etags[pn] = h["etag"].strip('"')
                    # replace part 2
                    parts_data[1] = rng.integers(
                        0, 256, 700 * 1024, dtype=np.uint8).tobytes()
                    st, h, _ = await s3.request(
                        "PUT", "/mp/big.bin",
                        f"partNumber=2&uploadId={upload_id}",
                        body=parts_data[1])
                    etags[2] = h["etag"].strip('"')

                    # list parts
                    st, _, body = await s3.request(
                        "GET", "/mp/big.bin", f"uploadId={upload_id}")
                    assert st == 200
                    listed = ET.fromstring(body).findall(f"{ns}Part")
                    assert [p.findtext(f"{ns}PartNumber")
                            for p in listed] == ["1", "2", "3"]

                    # complete with wrong etag -> InvalidPart
                    bad_xml = (
                        "<CompleteMultipartUpload><Part>"
                        "<PartNumber>1</PartNumber><ETag>deadbeef</ETag>"
                        "</Part></CompleteMultipartUpload>"
                    ).encode()
                    st, _, body = await s3.request(
                        "POST", "/mp/big.bin", f"uploadId={upload_id}",
                        body=bad_xml)
                    assert st == 400 and b"InvalidPart" in body

                    # complete for real
                    xml_parts = "".join(
                        f"<Part><PartNumber>{pn}</PartNumber>"
                        f"<ETag>\"{etags[pn]}\"</ETag></Part>"
                        for pn in (1, 2, 3))
                    st, _, body = await s3.request(
                        "POST", "/mp/big.bin", f"uploadId={upload_id}",
                        body=(f"<CompleteMultipartUpload>{xml_parts}"
                              "</CompleteMultipartUpload>").encode())
                    assert st == 200
                    whole = b"".join(parts_data)
                    md5s = b"".join(
                        hashlib.md5(d).digest() for d in parts_data)
                    want_etag = f"{hashlib.md5(md5s).hexdigest()}-3"
                    assert ET.fromstring(body).findtext(
                        f"{ns}ETag").strip('"') == want_etag

                    # read back whole + ranged across part boundaries
                    st, h, body = await s3.request("GET", "/mp/big.bin")
                    assert st == 200 and body == whole
                    lo = 600 * 1024 - 100  # straddles part1/part2
                    st, _, body = await s3.request(
                        "GET", "/mp/big.bin",
                        headers={"range": f"bytes={lo}-{lo + 299}"})
                    assert st == 206 and body == whole[lo:lo + 300]

                    # upload meta gone: ListParts now 404s
                    st, _, body = await s3.request(
                        "GET", "/mp/big.bin", f"uploadId={upload_id}")
                    assert st == 404 and b"NoSuchUpload" in body
                finally:
                    await fe.stop()

        run(go())

    def test_abort_multipart(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/ab")
                    st, _, body = await s3.request(
                        "POST", "/ab/obj", "uploads")
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                    upload_id = ET.fromstring(body).findtext(f"{ns}UploadId")
                    await s3.request(
                        "PUT", "/ab/obj",
                        f"partNumber=1&uploadId={upload_id}",
                        body=b"x" * 1024)
                    st, _, _ = await s3.request(
                        "DELETE", "/ab/obj", f"uploadId={upload_id}")
                    assert st == 204
                    st, _, body = await s3.request(
                        "GET", "/ab/obj", f"uploadId={upload_id}")
                    assert st == 404
                    # the object itself never materialized
                    st, _, _ = await s3.request("GET", "/ab/obj")
                    assert st == 404
                finally:
                    await fe.stop()

        run(go())


class TestS3Extended:
    """CopyObject, DeleteObjects batch, presigned URLs, x-amz-meta-*
    (RGWCopyObj / RGWDeleteMultiObj / presigned auth in rgw_op.cc +
    rgw_auth_s3.cc)."""

    def test_copy_object_and_user_meta(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/src")
                    await s3.request("PUT", "/dst")
                    st, _, _ = await s3.request(
                        "PUT", "/src/doc.txt", body=b"payload-1",
                        headers={"content-type": "text/plain",
                                 "x-amz-meta-owner": "alice"})
                    assert st == 200
                    # metadata round-trips on GET and HEAD
                    st, h, body = await s3.request("GET", "/src/doc.txt")
                    assert body == b"payload-1"
                    assert h.get("x-amz-meta-owner") == "alice"
                    assert h.get("content-type") == "text/plain"
                    # server-side copy, metadata COPY by default
                    st, _h, body = await s3.request(
                        "PUT", "/dst/copy.txt",
                        headers={"x-amz-copy-source": "/src/doc.txt"})
                    assert st == 200 and b"CopyObjectResult" in body
                    st, h, body = await s3.request("GET", "/dst/copy.txt")
                    assert body == b"payload-1"
                    assert h.get("x-amz-meta-owner") == "alice"
                    # REPLACE directive swaps the metadata
                    st, _h, _ = await s3.request(
                        "PUT", "/dst/copy2.txt",
                        headers={"x-amz-copy-source": "/src/doc.txt",
                                 "x-amz-metadata-directive": "REPLACE",
                                 "x-amz-meta-owner": "bob"})
                    assert st == 200
                    _st, h, _ = await s3.request("HEAD", "/dst/copy2.txt")
                    assert h.get("x-amz-meta-owner") == "bob"
                    # missing source is NoSuchKey
                    st, _h, body = await s3.request(
                        "PUT", "/dst/nope",
                        headers={"x-amz-copy-source": "/src/missing"})
                    assert st == 404
                finally:
                    await fe.stop()

        run(go())

    def test_batch_delete(self):
        async def go():
            async with Cluster(n_osds=4) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/b")
                    for i in range(5):
                        await s3.request("PUT", f"/b/k{i}", body=b"x")
                    payload = (
                        b"<Delete>"
                        + b"".join(
                            f"<Object><Key>k{i}</Key></Object>".encode()
                            for i in range(4))
                        + b"</Delete>"
                    )
                    st, _h, body = await s3.request(
                        "POST", "/b", query="delete=", body=payload)
                    assert st == 200, body
                    assert body.count(b"<Deleted>") == 4
                    st, _h, body = await s3.request(
                        "GET", "/b", query="list-type=2")
                    assert _keys_of(body) == ["k4"]
                finally:
                    await fe.stop()

        run(go())

    def test_presigned_url(self):
        async def go():
            import urllib.parse as up

            from ceph_tpu_torch.rgw.sigv4 import presign_url

            async with Cluster(n_osds=4) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/pub")
                    await s3.request("PUT", "/pub/file", body=b"shared")
                    amz = time.strftime(
                        "%Y%m%dT%H%M%SZ", time.gmtime())
                    host = f"{fe.host}:{fe.port}"
                    url = presign_url(
                        "GET", "/pub/file", host, ACCESS, SECRET,
                        amz_date=amz, expires=60)
                    path, _, query = url.partition("?")
                    # raw unauthenticated HTTP GET with only the query
                    reader, writer = await asyncio.open_connection(
                        fe.host, fe.port)
                    writer.write(
                        f"GET {path}?{query} HTTP/1.1\r\n"
                        f"host: {host}\r\n\r\n".encode())
                    await writer.drain()
                    status = int((await reader.readline()).split()[1])
                    hdrs = {}
                    while True:
                        line = await reader.readline()
                        if line in (b"\r\n", b"\n", b""):
                            break
                        k, _, v = line.decode().partition(":")
                        hdrs[k.strip().lower()] = v.strip()
                    body = await reader.readexactly(
                        int(hdrs.get("content-length", "0")))
                    writer.close()
                    assert status == 200, body
                    assert body == b"shared"

                    # a tampered signature is rejected
                    bad = query.replace(
                        query[-8:], "00000000")
                    reader, writer = await asyncio.open_connection(
                        fe.host, fe.port)
                    writer.write(
                        f"GET {path}?{bad} HTTP/1.1\r\n"
                        f"host: {host}\r\n\r\n".encode())
                    await writer.drain()
                    status = int((await reader.readline()).split()[1])
                    writer.close()
                    assert status == 403

                    # an expired presign is rejected
                    old = time.strftime(
                        "%Y%m%dT%H%M%SZ", time.gmtime(time.time() - 7200))
                    url2 = presign_url(
                        "GET", "/pub/file", host, ACCESS, SECRET,
                        amz_date=old, expires=60)
                    p2, _, q2 = url2.partition("?")
                    reader, writer = await asyncio.open_connection(
                        fe.host, fe.port)
                    writer.write(
                        f"GET {p2}?{q2} HTTP/1.1\r\n"
                        f"host: {host}\r\n\r\n".encode())
                    await writer.drain()
                    status = int((await reader.readline()).split()[1])
                    writer.close()
                    assert status == 403
                finally:
                    await fe.stop()

        run(go())

    def test_upload_part_copy(self):
        """UploadPartCopy: multipart parts sourced from an existing
        object, optionally ranged (RGWCopyObj multipart mode)."""
        async def go():
            async with Cluster(n_osds=4) as c:
                fe, s3 = await _gateway(c)
                try:
                    await s3.request("PUT", "/b")
                    src_data = bytes(range(256)) * 3000  # 750 KB
                    await s3.request("PUT", "/b/src", body=src_data)
                    st, _, body = await s3.request(
                        "POST", "/b/big", query="uploads=")
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                    upload_id = ET.fromstring(body).findtext(f"{ns}UploadId")
                    etags = []
                    # part 1: whole source; part 2: a range of it
                    st, _, body = await s3.request(
                        "PUT", "/b/big",
                        query=f"partNumber=1&uploadId={upload_id}",
                        headers={"x-amz-copy-source": "/b/src"})
                    assert st == 200 and b"CopyPartResult" in body
                    etags.append(ET.fromstring(body).findtext(f"{ns}ETag")
                                 .strip('"'))
                    st, _, body = await s3.request(
                        "PUT", "/b/big",
                        query=f"partNumber=2&uploadId={upload_id}",
                        headers={"x-amz-copy-source": "/b/src",
                                 "x-amz-copy-source-range":
                                     "bytes=0-99999"})
                    assert st == 200, body
                    etags.append(ET.fromstring(body).findtext(f"{ns}ETag")
                                 .strip('"'))
                    parts_xml = "".join(
                        f"<Part><PartNumber>{i+1}</PartNumber>"
                        f"<ETag>\"{e}\"</ETag></Part>"
                        for i, e in enumerate(etags))
                    st, _, body = await s3.request(
                        "POST", "/b/big", query=f"uploadId={upload_id}",
                        body=f"<CompleteMultipartUpload>{parts_xml}"
                             f"</CompleteMultipartUpload>".encode())
                    assert st == 200, body
                    st, _h, got = await s3.request("GET", "/b/big")
                    assert got == src_data + src_data[:100000]
                finally:
                    await fe.stop()

        run(go())


class TestVersioning:
    """Versioned buckets (reference rgw versioned-bucket semantics):
    version-id on PUT, list-versions, delete markers, version-targeted
    GET/DELETE, undelete by removing the newest marker."""

    def test_versioning_round_trip(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"
                    st, _, _ = await s3.request("PUT", "/vb")
                    assert st == 200
                    # enable versioning
                    body = (b'<VersioningConfiguration>'
                            b'<Status>Enabled</Status>'
                            b'</VersioningConfiguration>')
                    st, _, _ = await s3.request(
                        "PUT", "/vb", "versioning", body)
                    assert st == 200
                    st, _, out = await s3.request(
                        "GET", "/vb", "versioning")
                    assert st == 200 and b"Enabled" in out

                    # two versions of one key
                    st, h1, _ = await s3.request("PUT", "/vb/doc", body=b"one")
                    assert st == 200
                    v1 = h1["x-amz-version-id"]
                    st, h2, _ = await s3.request(
                        "PUT", "/vb/doc", body=b"two-longer")
                    v2 = h2["x-amz-version-id"]
                    assert v1 != v2

                    # plain GET serves the newest; versioned GET each
                    st, h, out = await s3.request("GET", "/vb/doc")
                    assert out == b"two-longer"
                    assert h["x-amz-version-id"] == v2
                    st, _, out = await s3.request(
                        "GET", "/vb/doc", f"versionId={v1}")
                    assert out == b"one"

                    # list-versions shows both, newest first
                    st, _, out = await s3.request("GET", "/vb", "versions")
                    root = ET.fromstring(out)
                    vers = root.findall(f"{ns}Version")
                    assert [v.findtext(f"{ns}VersionId") for v in vers] \
                        == [v2, v1]
                    assert [v.findtext(f"{ns}IsLatest") for v in vers] \
                        == ["true", "false"]

                    # plain DELETE -> delete marker; key vanishes from
                    # plain listing + GET, versions persist
                    st, hd, _ = await s3.request("DELETE", "/vb/doc")
                    assert st == 204
                    assert hd.get("x-amz-delete-marker") == "true"
                    marker_vid = hd["x-amz-version-id"]
                    st, _, _ = await s3.request("GET", "/vb/doc")
                    assert st == 404
                    st, _, out = await s3.request("GET", "/vb", "list-type=2")
                    assert _keys_of(out) == []
                    st, _, out = await s3.request(
                        "GET", "/vb/doc", f"versionId={v2}")
                    assert out == b"two-longer"

                    # removing the marker undeletes (newest real
                    # version becomes current again)
                    st, _, _ = await s3.request(
                        "DELETE", "/vb/doc", f"versionId={marker_vid}")
                    assert st == 204
                    st, _, out = await s3.request("GET", "/vb/doc")
                    assert out == b"two-longer"
                    st, _, out = await s3.request("GET", "/vb", "list-type=2")
                    assert _keys_of(out) == ["doc"]

                    # deleting the current version promotes the older
                    st, _, _ = await s3.request(
                        "DELETE", "/vb/doc", f"versionId={v2}")
                    st, _, out = await s3.request("GET", "/vb/doc")
                    assert out == b"one"
                finally:
                    await fe.stop()
        run(go())


class TestLifecycle:
    """RGWLC-lite: expiration under a time-warped clock (reference
    rgw_lc.cc worker; rgw_lc_debug_interval testing stance)."""

    def test_expiration_and_noncurrent(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    import time as _time
                    warp = [0.0]
                    fe.store.clock = lambda: _time.time() + warp[0]

                    st, _, _ = await s3.request("PUT", "/lcb")
                    assert st == 200
                    lc = (b'<LifecycleConfiguration><Rule>'
                          b'<ID>exp</ID><Prefix>logs/</Prefix>'
                          b'<Status>Enabled</Status>'
                          b'<Expiration><Days>7</Days></Expiration>'
                          b'</Rule></LifecycleConfiguration>')
                    st, _, _ = await s3.request("PUT", "/lcb", "lifecycle", lc)
                    assert st == 200
                    st, _, out = await s3.request("GET", "/lcb", "lifecycle")
                    assert st == 200 and b"<Days>7</Days>" in out

                    await s3.request("PUT", "/lcb/logs/old.log", body=b"old")
                    await s3.request("PUT", "/lcb/keep.txt", body=b"keep")
                    stats = await fe.store.lc_process()
                    assert stats["expired"] == 0  # nothing aged yet

                    warp[0] = 8 * 86400  # 8 days later
                    stats = await fe.store.lc_process()
                    assert stats["expired"] == 1
                    st, _, _ = await s3.request("GET", "/lcb/logs/old.log")
                    assert st == 404
                    st, _, out = await s3.request("GET", "/lcb/keep.txt")
                    assert out == b"keep"  # prefix-scoped
                finally:
                    await fe.stop()
        run(go())

    def test_noncurrent_version_expiration(self):
        async def go():
            async with Cluster(n_osds=6) as c:
                fe, s3 = await _gateway(c)
                try:
                    import time as _time
                    warp = [0.0]
                    fe.store.clock = lambda: _time.time() + warp[0]
                    ns = "{http://s3.amazonaws.com/doc/2006-03-01/}"

                    await s3.request("PUT", "/nvb")
                    await s3.request(
                        "PUT", "/nvb", "versioning",
                        b'<VersioningConfiguration><Status>Enabled'
                        b'</Status></VersioningConfiguration>')
                    lc = (b'<LifecycleConfiguration><Rule>'
                          b'<ID>nc</ID><Status>Enabled</Status>'
                          b'<NoncurrentVersionExpiration>'
                          b'<NoncurrentDays>3</NoncurrentDays>'
                          b'</NoncurrentVersionExpiration>'
                          b'</Rule></LifecycleConfiguration>')
                    st, _, _ = await s3.request("PUT", "/nvb", "lifecycle", lc)
                    assert st == 200

                    await s3.request("PUT", "/nvb/f", body=b"v1")
                    warp[0] = 4 * 86400
                    await s3.request("PUT", "/nvb/f", body=b"v2")

                    stats = await fe.store.lc_process()
                    assert stats["noncurrent_removed"] == 1
                    st, _, out = await s3.request("GET", "/nvb/f")
                    assert out == b"v2"  # current survives
                    st, _, out = await s3.request("GET", "/nvb", "versions")
                    root = ET.fromstring(out)
                    assert len(root.findall(f"{ns}Version")) == 1
                finally:
                    await fe.stop()
        run(go())

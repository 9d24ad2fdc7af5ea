"""AWS Signature Version 4 (header-based subset).

The reference implements SigV4 in src/rgw/rgw_auth_s3.cc
(get_v4_canonical_request_hash / get_v4_string_to_sign /
get_v4_signature); this is the same algorithm over the header-auth
path: canonical request -> string-to-sign -> HMAC signing-key chain.
Supported: path-style requests, ``x-amz-content-sha256`` payload hash
(including UNSIGNED-PAYLOAD), and presigned query auth
(X-Amz-Signature in the query string, rgw_auth_s3.cc's
AWSv4ComplSingle presigned branch).  Not supported (rejected
cleanly): chunked (STREAMING-*) payloads.

Both sides live here: :func:`sign_request` for clients/tests and
:func:`verify` for the gateway, so the test exercises a real
independent round-trip of the algorithm.

Counterpart of ``ceph_tpu/rgw/sigv4.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import hashlib
import hmac
import urllib.parse
from dataclasses import dataclass

ALGORITHM = "AWS4-HMAC-SHA256"
UNSIGNED = "UNSIGNED-PAYLOAD"


class SigV4Error(Exception):
    def __init__(self, code: str, msg: str):
        super().__init__(msg)
        self.code = code


def _uri_encode(s: str, *, encode_slash: bool) -> str:
    safe = "-_.~" + ("" if encode_slash else "/")
    return urllib.parse.quote(s, safe=safe)


def canonical_uri(path: str) -> str:
    # normalize: decode then re-encode each segment (AWS S3 does NOT
    # double-encode for the s3 service)
    return _uri_encode(urllib.parse.unquote(path), encode_slash=False) or "/"


def canonical_query(query: str) -> str:
    pairs = urllib.parse.parse_qsl(query, keep_blank_values=True)
    enc = sorted(
        (_uri_encode(k, encode_slash=True), _uri_encode(v, encode_slash=True))
        for k, v in pairs
    )
    return "&".join(f"{k}={v}" for k, v in enc)


def _canonical_headers(headers: dict[str, str], signed: list[str]) -> str:
    out = []
    for name in signed:
        val = headers.get(name, "")
        out.append(f"{name}:{' '.join(val.split())}\n")
    return "".join(out)


def _signing_key(secret: str, date: str, region: str, service: str) -> bytes:
    k = hmac.new(f"AWS4{secret}".encode(), date.encode(), hashlib.sha256).digest()
    k = hmac.new(k, region.encode(), hashlib.sha256).digest()
    k = hmac.new(k, service.encode(), hashlib.sha256).digest()
    return hmac.new(k, b"aws4_request", hashlib.sha256).digest()


def _string_to_sign(
    method: str, path: str, query: str, headers: dict[str, str],
    signed: list[str], payload_hash: str, amz_date: str, scope: str,
) -> str:
    creq = "\n".join([
        method.upper(),
        canonical_uri(path),
        canonical_query(query),
        _canonical_headers(headers, signed),
        ";".join(signed),
        payload_hash,
    ])
    return "\n".join([
        ALGORITHM, amz_date, scope,
        hashlib.sha256(creq.encode()).hexdigest(),
    ])


@dataclass
class ParsedAuth:
    access_key: str
    date: str
    region: str
    service: str
    signed_headers: list[str]
    signature: str

    @property
    def scope(self) -> str:
        return f"{self.date}/{self.region}/{self.service}/aws4_request"


def parse_authorization(value: str) -> ParsedAuth:
    if not value.startswith(ALGORITHM + " "):
        raise SigV4Error("InvalidArgument", "unsupported auth algorithm")
    parts: dict[str, str] = {}
    for item in value[len(ALGORITHM):].split(","):
        item = item.strip()
        if "=" not in item:
            raise SigV4Error("InvalidArgument", f"malformed auth item {item!r}")
        k, v = item.split("=", 1)
        parts[k] = v
    try:
        cred = parts["Credential"].split("/")
        access_key, date, region, service, term = cred
        if term != "aws4_request":
            raise ValueError
        return ParsedAuth(
            access_key=access_key, date=date, region=region, service=service,
            signed_headers=parts["SignedHeaders"].split(";"),
            signature=parts["Signature"],
        )
    except (KeyError, ValueError):
        raise SigV4Error("InvalidArgument", "malformed Credential scope")


MAX_SKEW = 900.0  # the reference's 15-minute RequestTimeTooSkewed window


def verify(
    method: str, path: str, query: str, headers: dict[str, str],
    body: bytes, secret: str, *, now: float | None = None,
) -> None:
    """Raise SigV4Error unless the request's signature is valid and
    fresh (within MAX_SKEW of ``now``, replay defense per
    rgw_auth_s3.cc's request-time check).  ``headers`` keys must
    already be lowercased.  ``now=None`` uses the wall clock."""
    import calendar
    import time as _time

    auth = parse_authorization(headers.get("authorization", ""))
    amz_date = headers.get("x-amz-date", "")
    if not amz_date.startswith(auth.date):
        raise SigV4Error("SignatureDoesNotMatch", "date/scope mismatch")
    try:
        req_time = calendar.timegm(
            _time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
    except ValueError:
        raise SigV4Error("InvalidArgument", f"bad x-amz-date {amz_date!r}")
    if abs((_time.time() if now is None else now) - req_time) > MAX_SKEW:
        raise SigV4Error("RequestTimeTooSkewed", "request time out of window")
    payload_hash = headers.get("x-amz-content-sha256", UNSIGNED)
    if payload_hash.startswith("STREAMING-"):
        raise SigV4Error("NotImplemented", "chunked payloads unsupported")
    if payload_hash != UNSIGNED:
        actual = hashlib.sha256(body).hexdigest()
        if actual != payload_hash:
            raise SigV4Error("XAmzContentSHA256Mismatch", "payload hash mismatch")
    for required in ("host",):
        if required not in auth.signed_headers:
            raise SigV4Error("SignatureDoesNotMatch", f"{required} not signed")
    sts = _string_to_sign(
        method, path, query, headers, auth.signed_headers,
        payload_hash, amz_date, auth.scope,
    )
    key = _signing_key(secret, auth.date, auth.region, auth.service)
    expect = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, auth.signature):
        raise SigV4Error("SignatureDoesNotMatch", "signature mismatch")


def parse_presigned_query(query: str) -> ParsedAuth:
    """Extract the SigV4 fields from a presigned URL's query string."""
    params = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
    if params.get("X-Amz-Algorithm") != ALGORITHM:
        raise SigV4Error("InvalidArgument", "unsupported query algorithm")
    try:
        cred = params["X-Amz-Credential"].split("/")
        access_key, date, region, service, term = cred
        if term != "aws4_request":
            raise ValueError
        return ParsedAuth(
            access_key=access_key, date=date, region=region,
            service=service,
            signed_headers=params["X-Amz-SignedHeaders"].split(";"),
            signature=params["X-Amz-Signature"],
        )
    except (KeyError, ValueError):
        raise SigV4Error("InvalidArgument", "malformed presigned query")


def verify_presigned(
    method: str, path: str, query: str, headers: dict[str, str],
    secret: str, *, now: float | None = None,
) -> None:
    """Presigned-URL verification: the signature covers the query
    minus X-Amz-Signature, the payload is UNSIGNED, and freshness is
    X-Amz-Date + X-Amz-Expires (not MAX_SKEW)."""
    import calendar
    import time as _time

    auth = parse_presigned_query(query)
    params = dict(urllib.parse.parse_qsl(query, keep_blank_values=True))
    amz_date = params.get("X-Amz-Date", "")
    if not amz_date.startswith(auth.date):
        raise SigV4Error("SignatureDoesNotMatch", "date/scope mismatch")
    try:
        req_time = calendar.timegm(
            _time.strptime(amz_date, "%Y%m%dT%H%M%SZ"))
        expires = int(params.get("X-Amz-Expires", "0"))
    except ValueError:
        raise SigV4Error("InvalidArgument", "bad presigned date/expiry")
    if not 0 < expires <= 7 * 86400:  # AWS caps presign at one week
        raise SigV4Error("InvalidArgument", f"bad X-Amz-Expires {expires}")
    t = _time.time() if now is None else now
    if t < req_time - MAX_SKEW or t > req_time + expires:
        raise SigV4Error("AccessDenied", "presigned URL expired")
    unsigned_query = urllib.parse.urlencode(sorted(
        (k, v) for k, v in params.items() if k != "X-Amz-Signature"
    ), quote_via=urllib.parse.quote)
    sts = _string_to_sign(
        method, path, unsigned_query, headers, auth.signed_headers,
        UNSIGNED, amz_date, auth.scope,
    )
    key = _signing_key(secret, auth.date, auth.region, auth.service)
    expect = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    if not hmac.compare_digest(expect, auth.signature):
        raise SigV4Error("SignatureDoesNotMatch", "signature mismatch")


def presign_url(
    method: str, path: str, host: str, access_key: str, secret: str,
    *, amz_date: str, expires: int = 3600, region: str = "us-east-1",
    extra_params: dict[str, str] | None = None,
) -> str:
    """Client side: a path + query string granting time-limited access
    (the `aws s3 presign` role)."""
    date = amz_date[:8]
    scope = f"{date}/{region}/s3/aws4_request"
    params = {
        "X-Amz-Algorithm": ALGORITHM,
        "X-Amz-Credential": f"{access_key}/{scope}",
        "X-Amz-Date": amz_date,
        "X-Amz-Expires": str(expires),
        "X-Amz-SignedHeaders": "host",
        **(extra_params or {}),
    }
    query = urllib.parse.urlencode(
        sorted(params.items()), quote_via=urllib.parse.quote)
    sts = _string_to_sign(
        method, path, query, {"host": host}, ["host"], UNSIGNED,
        amz_date, scope,
    )
    key = _signing_key(secret, date, region, "s3")
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    return f"{path}?{query}&X-Amz-Signature={sig}"


def sign_request(
    method: str, path: str, query: str, headers: dict[str, str],
    body: bytes, access_key: str, secret: str,
    *, amz_date: str, region: str = "us-east-1", unsigned_payload: bool = False,
) -> dict[str, str]:
    """Client side: returns extra headers (x-amz-date,
    x-amz-content-sha256, authorization) for the request.  ``headers``
    must include ``host``; keys lowercase.  ``amz_date`` is the ISO8601
    basic timestamp (e.g. 20260731T120000Z)."""
    date = amz_date[:8]
    payload_hash = (
        UNSIGNED if unsigned_payload else hashlib.sha256(body).hexdigest()
    )
    h = dict(headers)
    h["x-amz-date"] = amz_date
    h["x-amz-content-sha256"] = payload_hash
    signed = sorted(set(h) | {"host"})
    scope = f"{date}/{region}/s3/aws4_request"
    sts = _string_to_sign(method, path, query, h, signed, payload_hash,
                          amz_date, scope)
    key = _signing_key(secret, date, region, "s3")
    sig = hmac.new(key, sts.encode(), hashlib.sha256).hexdigest()
    h["authorization"] = (
        f"{ALGORITHM} Credential={access_key}/{scope}, "
        f"SignedHeaders={';'.join(signed)}, Signature={sig}"
    )
    return h

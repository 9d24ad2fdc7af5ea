"""Dashboard: a read-only web UI + REST API over the monitor's state
(the src/pybind/mgr/dashboard role, radically simplified: no mutation
endpoints — observe-only, the part operators actually keep open).

Access control (the reference dashboard's auth/session layer, lite):
when the monitor runs with auth enabled, every request must carry
``Authorization: Bearer <hex-key>`` where the key belongs to an entity
in the cluster keyring whose caps grant mon read (``capable(caps,
"mon", "r")``) — a token minted by ``ceph auth get-or-create`` works
directly.  Unauthenticated or unauthorized requests get 401.  With
auth off (cephx=none analogue) everything is open, matching the rest
of the command plane.

Endpoints:

  GET /                 HTML overview (auto-refreshing): health, mons,
                        osd up/in counts, pool table, PG state totals
  GET /api/health       the mon's health checks (HEALTH_OK/WARN/ERR)
  GET /api/status       the `ceph status` blob
  GET /api/pools        pool table incl. pg_num/size/type/autoscale
  GET /api/osds         per-osd up/in/weight + crush host
  GET /api/pg           aggregated PG states (by_state)
  GET /api/traces       cross-daemon trace summaries + assembled
                        trees from the active mgr's TraceCollector
                        (rides the MMonMgrReport digest)
  GET /api/logs         the replicated cluster log's newest entries
                        (+ the follow cursor `ceph -w` uses)
  GET /api/progress     mgr progress-module events (recovery/
                        rebalance fractions + ETAs, via the digest)
  GET /metrics          prometheus text (same as the exporter)

Runs inside the monitor process and reads its in-memory state via the
same `_command` plane the CLI uses — no extra wire hops.

Counterpart of ``ceph_tpu/mgr/dashboard.py``: the same endpoints, pages and
bytes.
"""

from __future__ import annotations

import asyncio
import hmac
import html
import json

from ceph_tpu_torch.common.caps import capable
from ceph_tpu_torch.common.metrics import prometheus_text

_PAGE = """<!doctype html>
<html><head><title>ceph_tpu dashboard</title>
<meta http-equiv="refresh" content="5">
<style>
 body {{ font-family: monospace; margin: 2em; background: #101418;
        color: #d8dee9; }}
 h1 {{ font-size: 1.2em; }} h2 {{ font-size: 1em; margin-top: 1.5em; }}
 table {{ border-collapse: collapse; }}
 td, th {{ border: 1px solid #3b4252; padding: 2px 10px;
           text-align: left; }}
 .ok {{ color: #a3be8c; }} .warn {{ color: #ebcb8b; }}
 .err {{ color: #bf616a; }}
</style></head><body>
<h1>ceph_tpu &mdash; cluster dashboard</h1>
<p>health: <span class="{hcls}">{hstatus}</span> {hdetail}</p>
<h2>cluster</h2>
<table>
<tr><th>mons</th><td>{mons}</td></tr>
<tr><th>mgr</th><td>{mgr}</td></tr>
<tr><th>osds</th><td>{osds_up} up / {osds_in} in / {osds_total} total</td></tr>
<tr><th>map epoch</th><td>{epoch}</td></tr>
<tr><th>pg states</th><td>{pgs}</td></tr>
<tr><th>objects</th><td>{objects}</td></tr>
<tr><th>slowest osds</th><td>{top_slow}</td></tr>
</table>
<h2>pools</h2>
<table><tr><th>id</th><th>name</th><th>type</th><th>pg_num</th>
<th>size</th><th>autoscale</th></tr>{pool_rows}</table>
<p><a href="/api/status">status</a> &middot;
<a href="/api/health">health</a> &middot;
<a href="/api/pools">pools</a> &middot;
<a href="/api/osds">osds</a> &middot;
<a href="/api/pg">pg</a> &middot;
<a href="/api/traces">traces</a> &middot;
<a href="/api/logs">logs</a> &middot;
<a href="/api/progress">progress</a> &middot;
<a href="/metrics">metrics</a></p>
</body></html>
"""


class Dashboard:
    def __init__(self, mon):
        self.mon = mon
        self._server: asyncio.base_events.Server | None = None
        self.addr: tuple[str, int] | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()
            self._server = None

    # -- state collection --------------------------------------------------

    async def _api(self, path: str) -> tuple[bytes, bytes]:
        """(body, content_type) for one endpoint."""
        if path == "/metrics":
            # a live mgr's digest carries the CLUSTER-aggregated
            # exposition (every daemon's series, rendered by the
            # prometheus module); fall back to this process's local
            # collections when no mgr is active
            digest = getattr(self.mon, "_mgr_digest", None) or {}
            mgr_map = getattr(self.mon, "_mgr_map", None) or {}
            if mgr_map.get("active") and digest.get("prometheus"):
                return (digest["prometheus"].encode(),
                        b"text/plain; version=0.0.4")
            return prometheus_text().encode(), b"text/plain; version=0.0.4"
        if path == "/api/health":
            return json.dumps(self.mon._health_checks()).encode(), \
                b"application/json"
        if path == "/api/status":
            _c, _rs, data = await self.mon._command({"prefix": "status"})
            return data, b"application/json"
        if path == "/api/pg":
            _c, _rs, data = await self.mon._command({"prefix": "pg stat"})
            return data, b"application/json"
        if path == "/api/traces":
            digest = getattr(self.mon, "_mgr_digest", None) or {}
            return (json.dumps(digest.get("traces", {})).encode(),
                    b"application/json")
        if path == "/api/logs":
            return (json.dumps(self.mon._log_last(50)).encode(),
                    b"application/json")
        if path == "/api/progress":
            digest = getattr(self.mon, "_mgr_digest", None) or {}
            return (json.dumps(digest.get("progress", {})).encode(),
                    b"application/json")
        if path == "/api/pools":
            om = self.mon.osdmap
            rows = []
            for pid, pool in sorted(om.pools.items()):
                rows.append({
                    "id": pid,
                    "name": om.pool_names.get(pid, str(pid)),
                    "type": "erasure" if pool.is_erasure() else
                            "replicated",
                    "pg_num": pool.pg_num,
                    "size": pool.size,
                    "pg_autoscale_mode": pool.extra.get(
                        "pg_autoscale_mode", "off"),
                })
            return json.dumps(rows).encode(), b"application/json"
        if path == "/api/osds":
            om = self.mon.osdmap
            host_of = {}
            for name, bid in om.crush.bucket_names.items():
                b = om.crush.buckets.get(bid)
                if b is None:
                    continue
                for it in b.items:
                    if it >= 0:
                        host_of[it] = name
            rows = [{
                "osd": o,
                "up": om.is_up(o),
                "in": not om.is_out(o),
                "weight": (om.osd_weight[o] if o < len(om.osd_weight)
                           else 0) / 0x10000,
                "host": host_of.get(o, ""),
            } for o in range(om.max_osd) if om.exists(o)]
            return json.dumps(rows).encode(), b"application/json"
        if path == "/":
            return (await self._page()).encode(), b"text/html"
        raise KeyError(path)

    async def _page(self) -> str:
        h = self.mon._health_checks()
        _c, _rs, data = await self.mon._command({"prefix": "status"})
        st = json.loads(data) if data else {}
        om = self.mon.osdmap
        pools_body, _ = await self._api("/api/pools")
        pool_rows = "".join(
            "<tr><td>{id}</td><td>{name}</td><td>{type}</td>"
            "<td>{pg_num}</td><td>{size}</td>"
            "<td>{pg_autoscale_mode}</td></tr>".format(
                **{k: html.escape(str(v)) for k, v in p.items()})
            for p in json.loads(pools_body)
        )
        pgs = st.get("pgs", {})
        status = h.get("status", "HEALTH_OK")
        cls = {"HEALTH_OK": "ok", "HEALTH_WARN": "warn"}.get(status, "err")
        detail = html.escape("; ".join(
            f"{k}: {v.get('summary', '')}"
            for k, v in h.get("checks", {}).items()))
        mgr_map = getattr(self.mon, "_mgr_map", None) or {}
        act = mgr_map.get("active")
        standbys = [sb["name"] for sb in mgr_map.get("standbys", [])]
        mgr_line = "no daemons" if not act else (
            f"{act['name']}(active)"
            + (f", standbys: {', '.join(standbys)}" if standbys else ""))
        digest = getattr(self.mon, "_mgr_digest", None) or {}
        top = digest.get("top_slow_osds") or []
        top_slow = ", ".join(
            f"{name} ({lat_us:g} &micro;s)" for name, lat_us in top
        ) or "&mdash;"
        return _PAGE.format(
            hcls=cls, hstatus=status, hdetail=detail,
            mgr=html.escape(mgr_line),
            top_slow=top_slow,
            mons=st.get("monmap", {}).get("num_mons",
                                          getattr(self.mon, "n_mons", 1)),
            osds_up=sum(1 for o in range(om.max_osd)
                        if om.exists(o) and om.is_up(o)),
            osds_in=sum(1 for o in range(om.max_osd)
                        if om.exists(o) and not om.is_out(o)),
            osds_total=sum(1 for o in range(om.max_osd) if om.exists(o)),
            epoch=om.epoch,
            pgs=json.dumps(pgs.get("by_state", {})),
            objects=pgs.get("num_objects", 0),
            pool_rows=pool_rows or "<tr><td colspan=6>none</td></tr>",
        )

    # -- http --------------------------------------------------------------

    def _authorized(self, token: str | None) -> bool:
        auth = self.mon.messenger.auth
        if auth is None:
            return True  # auth off: open, like the command plane
        if not token:
            return False
        try:
            key = bytes.fromhex(token)
        except ValueError:
            return False
        for entity, ekey in auth.keyring.items():
            if hmac.compare_digest(key, ekey):
                return capable(auth.caps_of(entity), "mon", "r")
        return False

    async def _handle(self, reader, writer) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), 5)
            token = None
            while True:  # drain headers, capturing Authorization
                line = await asyncio.wait_for(reader.readline(), 5)
                if line in (b"\r\n", b"\n", b""):
                    break
                if line.lower().startswith(b"authorization:"):
                    val = line.split(b":", 1)[1].strip()
                    if val.lower().startswith(b"bearer "):
                        token = val[7:].strip().decode("ascii", "replace")
            path = req.split(b" ")[1].decode() if b" " in req else "/"
            path = path.split("?", 1)[0]  # tolerate query strings
            if not self._authorized(token):
                body = b"unauthorized\n"
                ctype = b"text/plain"
                writer.write(
                    b"HTTP/1.1 401 Unauthorized\r\n"
                    b'WWW-Authenticate: Bearer realm="ceph_tpu"\r\n'
                    b"Content-Type: " + ctype + b"\r\n"
                    b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                    b"Connection: close\r\n\r\n" + body
                )
                await writer.drain()
                return
            try:
                body, ctype = await self._api(path)
                status = b"200 OK"
            except KeyError:
                body, ctype = b"not found\n", b"text/plain"
                status = b"404 Not Found"
            except Exception as e:  # state mid-transition: report, not die
                body = f"error: {e}\n".encode()
                ctype, status = b"text/plain", b"500 Internal Server Error"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\n"
                b"Content-Type: " + ctype + b"\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n" + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, IndexError):
            pass
        finally:
            writer.close()

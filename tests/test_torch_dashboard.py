"""Dashboard mgr module: read-only web UI + REST over the mon
(src/pybind/mgr/dashboard role).

The port's twin of tests/integration/test_dashboard.py: the same cases over ``ceph_tpu_torch``,
the daemons on the CPU and the EC pools on the ``cuda`` plugin.
"""

from __future__ import annotations

import asyncio
import json

from ceph_tpu_torch.mgr.dashboard import Dashboard

from tests.test_torch_mini_cluster import Cluster, run


async def _get(addr, path: str, token: str | None = None) -> tuple[int, bytes]:
    reader, writer = await asyncio.open_connection(*addr)
    hdrs = f"GET {path} HTTP/1.1\r\nHost: x\r\n"
    if token is not None:
        hdrs += f"Authorization: Bearer {token}\r\n"
    writer.write((hdrs + "\r\n").encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    head, _, body = raw.partition(b"\r\n\r\n")
    status = int(head.split(b" ")[1])
    return status, body


class TestDashboard:
    def test_endpoints(self):
        async def go():
            async with Cluster(n_osds=3) as c:
                await c.client.pool_create("viz", pg_num=4, size=2)
                io = c.client.ioctx("viz")
                await io.write_full("o", b"x" * 100)
                await c.client.wait_clean(timeout=30)
                dash = Dashboard(c.mon)
                addr = await dash.start()
                try:
                    code, body = await _get(addr, "/")
                    assert code == 200
                    assert b"cluster dashboard" in body
                    assert b"viz" in body

                    code, body = await _get(addr, "/api/health")
                    assert code == 200
                    assert json.loads(body)["status"].startswith("HEALTH")

                    code, body = await _get(addr, "/api/pools")
                    pools = json.loads(body)
                    assert any(p["name"] == "viz" and p["pg_num"] == 4
                               for p in pools)

                    code, body = await _get(addr, "/api/osds")
                    osds = json.loads(body)
                    assert len(osds) == 3
                    assert all(o["up"] and o["in"] for o in osds)
                    assert all(o["host"].startswith("host") for o in osds)

                    code, body = await _get(addr, "/api/pg")
                    assert code == 200

                    code, body = await _get(addr, "/metrics")
                    assert code == 200

                    code, _ = await _get(addr, "/nope")
                    assert code == 404
                finally:
                    await dash.stop()

        run(go())

    def test_auth_gate(self):
        """With mon auth enabled the dashboard requires a Bearer token
        minted by `auth get-or-create` whose caps grant mon read
        (reference: src/pybind/mgr/dashboard auth/session layer)."""
        import json as _json

        from tests.test_torch_auth import SecureCluster

        async def go():
            async with SecureCluster(n_osds=3) as c:
                dash = Dashboard(c.mon)
                addr = await dash.start()
                try:
                    # no token / garbage token -> 401
                    code, _ = await _get(addr, "/api/health")
                    assert code == 401
                    code, _ = await _get(addr, "/api/health", token="zz")
                    assert code == 401
                    code, _ = await _get(
                        addr, "/api/health", token="00" * 16)
                    assert code == 401

                    # mint a viewer with mon read caps via the command
                    # plane; its key IS the dashboard token
                    code, _rs, data = await c.client.command({
                        "prefix": "auth get-or-create",
                        "entity": "client.viewer",
                        "caps": _json.dumps({"mon": "allow r"}),
                    })
                    assert code == 0
                    token = _json.loads(data)["key"]
                    code, body = await _get(
                        addr, "/api/health", token=token)
                    assert code == 200
                    assert _json.loads(body)["status"].startswith("HEALTH")

                    # an entity without mon caps is rejected
                    code, _rs, data = await c.client.command({
                        "prefix": "auth get-or-create",
                        "entity": "client.osd-only",
                        "caps": _json.dumps({"osd": "allow r"}),
                    })
                    assert code == 0
                    bad = _json.loads(data)["key"]
                    code, _ = await _get(addr, "/api/health", token=bad)
                    assert code == 401
                finally:
                    await dash.stop()

        run(go())

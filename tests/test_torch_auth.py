"""cephx-style ticket and seal primitives and the AES-GCM frame crypto.

The port's twin of tests/integration/test_auth.py:38, :55 and the
``SecureCluster`` cases (:109, :131, :154), over ``ceph_tpu_torch``:
a port mon, OSD daemons (on the CPU) and client in secure mode.  The
auth admin and caps cases wait for the reference's other cluster twins.
"""

from __future__ import annotations

import asyncio

import pytest

# the surface under test is the AES-GCM transport: without the
# cryptography wheel these are skips (msg/auth itself imports and
# raises on use)
pytest.importorskip("cryptography")

from ceph_tpu_torch.crush import builder as B  # noqa: E402
from ceph_tpu_torch.crush.types import CrushMap  # noqa: E402
from ceph_tpu_torch.mon import Monitor  # noqa: E402
from ceph_tpu_torch.msg.auth import (  # noqa: E402
    AuthContext,
    FrameCrypto,
    make_secret,
    mint_ticket,
    open_ticket,
    seal,
    unseal,
)
from ceph_tpu_torch.osd.daemon import OSDDaemon  # noqa: E402
from tests.test_torch_mini_cluster import run  # noqa: E402


def test_ticket_and_seal_primitives():
    ss = make_secret()
    sk = make_secret()
    blob = mint_ticket(ss, "client.7", sk, caps={"osd": "allow r"})
    entity, got, caps = open_ticket(ss, blob)
    assert (entity, got) == ("client.7", sk)
    assert caps == {"osd": "allow r"}
    with pytest.raises(Exception):
        open_ticket(make_secret(), blob)  # wrong service secret
    with pytest.raises(Exception):
        unseal(ss, bytearray(seal(ss, b"x" * 32))[:-1] + b"\0")  # tamper
    # expiry enforced
    expired = mint_ticket(ss, "client.7", sk, ttl=-1.0)
    with pytest.raises(PermissionError):
        open_ticket(ss, expired)


def test_frame_crypto_directions_and_replay():
    sk = make_secret()
    a = FrameCrypto.from_session(sk, b"n" * 12, b"m" * 12, connector=True)
    b = FrameCrypto.from_session(sk, b"n" * 12, b"m" * 12, connector=False)
    ct1 = a.encrypt(b"hello")
    ct2 = a.encrypt(b"world")
    assert b.decrypt(ct1) == b"hello"
    assert b.decrypt(ct2) == b"world"
    # replaying ct1 fails: the rx counter has moved on
    with pytest.raises(Exception):
        b.decrypt(ct1)


class SecureCluster:
    def __init__(self, n_osds: int = 6, client_secret: bytes | None = None):
        from ceph_tpu_torch.client import RadosClient

        self.service_secret = make_secret()
        self.client_secret = make_secret()
        crush = CrushMap()
        B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
        keyring = {"client.4242": self.client_secret}
        self.mon = Monitor(crush=crush, auth=AuthContext(
            "mon.0", service_secret=self.service_secret, keyring=keyring,
        ), device="cpu")
        self.osds = [
            OSDDaemon(i, None, auth=AuthContext(
                f"osd.{i}", service_secret=self.service_secret,
            ), device="cpu")
            for i in range(n_osds)
        ]
        self.client = RadosClient(client_id=4242, auth=AuthContext(
            "client.4242",
            secret=client_secret if client_secret is not None
            else self.client_secret,
        ))

    async def __aenter__(self):
        await self.mon.start()
        for o in self.osds:
            o.mon_addrs = [self.mon.addr]
            o.mon_addr = self.mon.addr
            await o.start()
        await self.client.connect(*self.mon.addr)
        return self

    async def __aexit__(self, *exc):
        await self.client.shutdown()
        for o in self.osds:
            await o.stop()
        await self.mon.stop()


class TestSecureCluster:
    def test_ec_round_trip_over_secure_transport(self):
        async def go():
            async with SecureCluster() as c:
                await c.client.ec_profile_set(
                    "p", {"plugin": "cuda", "k": "3", "m": "2"})
                await c.client.pool_create(
                    "sec", pg_num=8, pool_type="erasure",
                    erasure_code_profile="p")
                io = c.client.ioctx("sec")
                await io.write_full("s1", b"classified" * 1000)
                await io.write("s1", b"PATCH", off=100)
                got = await io.read("s1")
                want = bytearray(b"classified" * 1000)
                want[100:105] = b"PATCH"
                assert got == bytes(want)
                # every connection of every daemon is in secure mode
                for o in c.osds:
                    for conn in o.messenger._conns.values():
                        assert conn.crypto is not None

        run(go())

    def test_wrong_secret_rejected(self):
        async def go():
            from ceph_tpu_torch.client.rados import RadosError

            c = SecureCluster(client_secret=make_secret())  # WRONG secret
            await c.mon.start()
            for o in c.osds:
                o.mon_addrs = [c.mon.addr]
                o.mon_addr = c.mon.addr
                await o.start()
            try:
                with pytest.raises((RadosError, OSError, ConnectionError)):
                    await asyncio.wait_for(
                        c.client.connect(*c.mon.addr), 8
                    )
            finally:
                await c.client.shutdown()
                for o in c.osds:
                    await o.stop()
                await c.mon.stop()

        run(go())

    def test_plaintext_peer_rejected(self):
        """A no-auth client cannot talk to a secured mon."""
        async def go():
            from ceph_tpu_torch.client import RadosClient
            from ceph_tpu_torch.client.rados import RadosError

            c = SecureCluster(n_osds=1)
            await c.mon.start()
            legacy = RadosClient(client_id=9)  # no auth context
            try:
                with pytest.raises((RadosError, OSError, ConnectionError)):
                    await asyncio.wait_for(legacy.connect(*c.mon.addr), 8)
            finally:
                await legacy.shutdown()
                await c.mon.stop()
                for o in c.osds:
                    if o.addr is not None:
                        await o.stop()

        run(go())

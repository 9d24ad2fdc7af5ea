"""cephx-style ticket and seal primitives and the AES-GCM frame crypto.

The port's twin of tests/integration/test_auth.py:38, :55, the
``SecureCluster`` cases (:109, :131, :154) and the auth admin and caps
case (:184), over ``ceph_tpu_torch``: a port mon, OSD daemons (on the
CPU) and client in secure mode.
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


class TestAuthAdminAndCaps:
    """The AuthMonitor command plane + cap enforcement at op admission
    (src/mon/AuthMonitor.cc prepare_command, src/osd/OSDCap.cc): a
    restricted entity is minted through `auth get-or-create`, its caps
    ride the ticket, OSDs EPERM writes outside the grant, the mon
    EACCESes mutations without mon w, and the database survives a mon
    restart (round-3 VERDICT item 8 acceptance)."""

    def test_restricted_client_end_to_end(self, tmp_path):
        async def go():
            import errno
            import json

            from ceph_tpu_torch.client import RadosClient
            from ceph_tpu_torch.client.rados import RadosError
            from ceph_tpu_torch.store.filestore import FileStore

            service_secret = make_secret()
            admin_secret = make_secret()
            crush = CrushMap()
            B.build_hierarchy(crush, osds_per_host=1, n_hosts=4)
            store = FileStore(str(tmp_path / "mon0"))
            store.mount()
            mon = Monitor(crush=crush, store=store, auth=AuthContext(
                "mon.0", service_secret=service_secret,
                keyring={"client.1": admin_secret},
            ), device="cpu")
            await mon.start()
            osds = []
            for i in range(4):
                o = OSDDaemon(i, None, auth=AuthContext(
                    f"osd.{i}", service_secret=service_secret), device="cpu")
                o.mon_addrs = [mon.addr]
                o.mon_addr = mon.addr
                await o.start()
                osds.append(o)
            admin = RadosClient(client_id=1, auth=AuthContext(
                "client.1", secret=admin_secret))
            await admin.connect(*mon.addr)
            await admin.pool_create("allowed", pg_num=4, size=3)
            await admin.pool_create("forbidden", pg_num=4, size=3)

            # mint a restricted user: mon read-only, osd rw on ONE pool
            code, rs, data = await admin.command({
                "prefix": "auth get-or-create", "entity": "client.77",
                "caps": json.dumps({
                    "mon": "allow r",
                    "osd": "allow rw pool=allowed",
                }),
            })
            assert code == 0, rs
            key = bytes.fromhex(json.loads(data)["key"])
            # get-or-create again returns the same key
            code, _, data2 = await admin.command({
                "prefix": "auth get-or-create", "entity": "client.77",
            })
            assert code == 0
            assert json.loads(data2)["key"] == key.hex()

            limited = RadosClient(client_id=77, auth=AuthContext(
                "client.77", secret=key))
            await limited.connect(*mon.addr)
            io_ok = limited.ioctx("allowed")
            await io_ok.write_full("obj", b"permitted")
            assert await io_ok.read("obj") == b"permitted"
            # outside the pool grant: EPERM (no retry storm)
            io_no = limited.ioctx("forbidden")
            with pytest.raises(RadosError) as ei:
                await io_no.write_full("obj", b"nope")
            assert ei.value.errno == errno.EPERM
            with pytest.raises(RadosError) as ei:
                await io_no.read("obj")
            assert ei.value.errno == errno.EPERM
            # mon mutation without mon w: EACCES
            code, rs, _ = await limited.command({
                "prefix": "osd pool create", "name": "x",
                "pg_num": "4", "pool_type": "replicated"})
            assert code == -errno.EACCES
            # mon reads still fine
            code, _, _ = await limited.command({"prefix": "status"})
            assert code == 0

            # cap update tightens live grants for NEW sessions
            code, rs, _ = await admin.command({
                "prefix": "auth caps", "entity": "client.77",
                "caps": json.dumps({
                    "mon": "allow r", "osd": "allow r pool=allowed"}),
            })
            assert code == 0, rs
            limited2 = RadosClient(client_id=77, auth=AuthContext(
                "client.77", secret=key))
            await limited2.connect(*mon.addr)
            io2 = limited2.ioctx("allowed")
            assert await io2.read("obj") == b"permitted"
            with pytest.raises(RadosError) as ei:
                await io2.write_full("obj", b"now denied")
            assert ei.value.errno == errno.EPERM

            # unknown-entity deletion + listing
            code, _, data = await admin.command({"prefix": "auth ls"})
            assert "client.77" in json.loads(data)
            await limited.shutdown()
            await limited2.shutdown()

            # mon restart: auth db survives via the paxos store
            await admin.shutdown()
            await mon.stop()
            store2 = FileStore(str(tmp_path / "mon0"))
            store2.mount()
            mon2 = Monitor(crush=crush, store=store2, auth=AuthContext(
                "mon.0", service_secret=service_secret,
                keyring={"client.1": admin_secret},
            ), device="cpu")
            await mon2.start()
            limited3 = RadosClient(client_id=77, auth=AuthContext(
                "client.77", secret=key))
            await limited3.connect(*mon2.addr)  # key survived restart
            # auth get is ADMIN-only (it returns secret keys): the
            # restricted client gets EACCES even with mon r
            code, _, _ = await limited3.command(
                {"prefix": "auth get", "entity": "client.77"})
            assert code == -errno.EACCES
            admin2 = RadosClient(client_id=1, auth=AuthContext(
                "client.1", secret=admin_secret))
            await admin2.connect(*mon2.addr)
            code, _, data = await admin2.command(
                {"prefix": "auth get", "entity": "client.77"})
            assert code == 0
            assert json.loads(data)["caps"]["osd"] == "allow r pool=allowed"
            # bootstrap identities are untouchable via the command plane
            code, _, _ = await admin2.command(
                {"prefix": "auth del", "entity": "client.1"})
            assert code == -errno.EPERM
            await admin2.shutdown()
            await limited3.shutdown()
            for o in osds:
                await o.stop()
            await mon2.stop()

        run(go())

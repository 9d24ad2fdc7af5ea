"""cephx-style ticket and seal primitives and the AES-GCM frame crypto.

The port's twin of tests/integration/test_auth.py:38 and :55, over
``ceph_tpu_torch``.  The ``SecureCluster`` cases of that file boot a
mon, OSD daemons and a client, which the port does not have yet.
"""

from __future__ import annotations

import pytest

# the surface under test is the AES-GCM transport: without the
# cryptography wheel these are skips (msg/auth itself imports and
# raises on use)
pytest.importorskip("cryptography")

from ceph_tpu_torch.msg.auth import (  # noqa: E402
    FrameCrypto,
    make_secret,
    mint_ticket,
    open_ticket,
    seal,
    unseal,
)


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

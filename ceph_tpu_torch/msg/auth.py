"""cephx-style authentication + AES-GCM connection crypto.

Behavioral twin of the reference's auth stack (src/auth/cephx/
CephxProtocol.h, src/msg/async/crypto_onwire.cc), shaped to the same
trust model:

- every entity (mon.N, osd.N, client.N) has a symmetric secret in the
  monitor's keyring (``ceph auth`` / keyring files);
- cluster daemons additionally hold the SERVICE secret, so they can
  both mint and validate service tickets (the reference's rotating
  service keys, minus rotation);
- a client authenticates to the mon by being able to decrypt the
  session key the mon returns under the client's own secret (cephx's
  proof-of-possession, collapsed into the grant: an impostor receives
  only ciphertext it cannot use, and the first AEAD frame it sends
  fails authentication);
- the mon's AUTH_DONE also carries a service TICKET =
  AES-GCM(service_secret, {entity, session_key}) which the client
  presents when dialing OSDs (CephxTicketBlob);
- once both sides share the session key, the connection switches to
  msgr2 SECURE mode: every frame is AES-GCM'd with per-direction keys
  derived from (session key, both nonces) and counter nonces
  (crypto_onwire.cc AES128GCM_OnWireTxRx; 256-bit keys here).

Deliberate simplifications vs the reference, documented: one service
secret instead of per-service rotating keys; no ticket renewal (tickets
carry an expiry and validators enforce it); no CEPHX_V2 legacy
challenge paths.
"""

from __future__ import annotations

import os
import struct
import time

try:
    from cryptography.hazmat.primitives.ciphers.aead import AESGCM

    HAVE_AESGCM = True
except ImportError:  # env without the cryptography wheel
    # degrade cleanly: the module stays importable (messengers built
    # WITHOUT an AuthContext never touch AEAD), and anything that
    # actually needs sealing fails with a clear message instead of an
    # import-time crash taking unrelated test collection down with it.
    # The stdlib has HMAC but no AES — an authenticate-only fallback
    # would silently drop the confidentiality the reference's SECURE
    # mode promises, so secured clusters simply require the wheel.
    HAVE_AESGCM = False

    class AESGCM:  # type: ignore[no-redef]
        def __init__(self, key: bytes):
            raise RuntimeError(
                "cephx SECURE mode needs the 'cryptography' package "
                "(AES-GCM); it is not installed"
            )

from ceph_tpu_torch.msg.denc import Decoder, Encoder

KEY_BYTES = 32
NONCE_BYTES = 12
TICKET_TTL = 3600.0


def make_secret() -> bytes:
    return os.urandom(KEY_BYTES)


def _hkdf(key: bytes, salt: bytes, info: bytes) -> bytes:
    """HKDF-SHA256 (extract+expand, single block)."""
    import hashlib
    import hmac as _hmac

    prk = _hmac.new(salt, key, hashlib.sha256).digest()
    return _hmac.new(prk, info + b"\x01", hashlib.sha256).digest()


def seal(secret: bytes, plaintext: bytes) -> bytes:
    nonce = os.urandom(NONCE_BYTES)
    return nonce + AESGCM(secret).encrypt(nonce, plaintext, b"")


def unseal(secret: bytes, blob: bytes) -> bytes:
    nonce, ct = blob[:NONCE_BYTES], blob[NONCE_BYTES:]
    return AESGCM(secret).decrypt(nonce, ct, b"")


# -- tickets ----------------------------------------------------------------

def mint_ticket(
    service_secret: bytes, entity: str, session_key: bytes,
    ttl: float = TICKET_TTL, caps: dict[str, str] | None = None,
) -> bytes:
    """Caps ride INSIDE the sealed ticket (the reference's
    CephXServiceTicketInfo carrying AuthCapsInfo): validators learn
    the peer's authorization without asking the mon."""
    import json

    enc = Encoder()
    enc.str_(entity)
    enc.bytes_(session_key)
    enc.u64(int((time.time() + ttl) * 1000))
    enc.str_(json.dumps(caps if caps is not None else {}))
    return seal(service_secret, enc.bytes())


def open_ticket(
    service_secret: bytes, blob: bytes,
) -> tuple[str, bytes, dict[str, str]]:
    """Returns (entity, session_key, caps); raises on tamper/expiry."""
    import json

    dec = Decoder(unseal(service_secret, blob))
    entity = dec.str_()
    session_key = dec.bytes_()
    expiry_ms = dec.u64()
    if time.time() * 1000 > expiry_ms:
        raise PermissionError(f"ticket for {entity} expired")
    caps = json.loads(dec.str_())
    return entity, session_key, caps


# -- per-connection AEAD framing -------------------------------------------

class FrameCrypto:
    """Per-direction AES-GCM with counter nonces
    (crypto_onwire.cc:AES128GCM_OnWireTxRx semantics)."""

    def __init__(self, tx_key: bytes, rx_key: bytes):
        self._tx = AESGCM(tx_key)
        self._rx = AESGCM(rx_key)
        self._tx_ctr = 0
        self._rx_ctr = 0

    @classmethod
    def from_session(
        cls, session_key: bytes, nonce_c: bytes, nonce_s: bytes,
        connector: bool,
    ) -> "FrameCrypto":
        salt = nonce_c + nonce_s
        c2s = _hkdf(session_key, salt, b"ceph_tpu c2s")
        s2c = _hkdf(session_key, salt, b"ceph_tpu s2c")
        return cls(c2s, s2c) if connector else cls(s2c, c2s)

    def _nonce(self, ctr: int) -> bytes:
        return struct.pack("<4xQ", ctr)

    def encrypt(self, plaintext: bytes) -> bytes:
        self._tx_ctr += 1
        return self._tx.encrypt(self._nonce(self._tx_ctr), plaintext, b"")

    def decrypt(self, ciphertext: bytes) -> bytes:
        self._rx_ctr += 1
        return self._rx.decrypt(self._nonce(self._rx_ctr), ciphertext, b"")


# -- entity-side contexts ----------------------------------------------------

class AuthContext:
    """What one entity carries into its messenger.

    - clients: ``secret`` (their own), ticket acquired from the mon
      in-band on the first mon connection;
    - cluster daemons (osd/mon): ``service_secret`` (can mint + open
      tickets themselves) and, for mons, the ``keyring``.
    """

    def __init__(
        self,
        entity: str,
        secret: bytes | None = None,
        service_secret: bytes | None = None,
        keyring: dict[str, bytes] | None = None,
        caps_db: dict[str, dict[str, str]] | None = None,
    ):
        self.entity = entity
        self.secret = secret
        self.service_secret = service_secret
        self.keyring = keyring or {}
        # entity -> caps dict (the AuthMonitor's view); keyring entries
        # absent here get ADMIN caps — a statically-keyed entity is the
        # client.admin bootstrap role
        self.caps_db = caps_db or {}
        self.ticket: bytes | None = None       # from the mon (clients)
        self.session_key: bytes | None = None  # paired with self.ticket

    # server side: grant or validate -----------------------------------

    def caps_of(self, entity: str) -> dict[str, str]:
        got = self.caps_db.get(entity)
        if got is not None:
            return got
        from ceph_tpu_torch.common.caps import ADMIN_CAPS

        return dict(ADMIN_CAPS)

    def grant(self, entity: str) -> tuple[bytes, bytes, bytes, dict] | None:
        """Mon-side (keyring holder): returns (sealed_grant, session_key,
        ticket, caps) for a known entity, None for an unknown one.  The
        grant is sealed under the ENTITY's keyring secret — only the
        genuine entity can recover the session key (cephx proof of
        possession); its caps are sealed into the ticket."""
        peer_secret = self.keyring.get(entity)
        if peer_secret is None or self.service_secret is None:
            return None
        session_key = make_secret()
        caps = self.caps_of(entity)
        ticket = mint_ticket(
            self.service_secret, entity, session_key, caps=caps)
        enc = Encoder()
        enc.bytes_(session_key)
        enc.bytes_(ticket)
        return seal(peer_secret, enc.bytes()), session_key, ticket, caps

    def open_grant(self, sealed: bytes) -> tuple[bytes, bytes]:
        """Client-side: recover (session_key, ticket) with our secret."""
        assert self.secret is not None
        dec = Decoder(unseal(self.secret, sealed))
        return dec.bytes_(), dec.bytes_()

    def self_ticket(self) -> tuple[bytes, bytes]:
        """Cluster daemons mint their own (ticket, session_key) — they
        hold the service secret, like the reference's OSDs holding the
        rotating service keys."""
        from ceph_tpu_torch.common.caps import ADMIN_CAPS

        assert self.service_secret is not None
        session_key = make_secret()
        return (
            mint_ticket(self.service_secret, self.entity, session_key,
                        caps=dict(ADMIN_CAPS)),
            session_key,
        )

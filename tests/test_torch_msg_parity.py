"""The wire transport against ceph_tpu: the same bytes in both directions.

``ceph_tpu_torch.msg`` beside the JAX package's ``ceph_tpu.msg``, on
inputs made from a seed with numpy (tolerance: exact bytes):

- every one of the 39 message classes, built from the same seeded field
  values in both packages, encodes to the same header and payload
  segments, and each package decodes the other's segments into its own
  class, which re-encodes to the same bytes;
- each package's type registry holds only its own classes, and the
  port's messenger decodes every type before the message set is imported;
- frame preambles, segments and epilogues are byte-equal, and each
  package reads the other's frames;
- a port ``Messenger`` and a reference ``Messenger`` talk over loopback
  TCP in both directions, in crc mode, with ``compress_mode="force"``
  (zlib) and in secure mode (the connector's package seals the ticket
  and frames, the acceptor's opens them);
- ``seal`` / ``mint_ticket`` / ``FrameCrypto`` output of one package
  opens with the other's.
"""

from __future__ import annotations

import asyncio
import inspect
import os
import subprocess
import sys
import types

import numpy as np
import pytest

import ceph_tpu.msg.auth as ref_auth
import ceph_tpu.msg.frames as ref_frames
import ceph_tpu.msg.messages as ref_messages
import ceph_tpu.msg.messenger as ref_messenger
import ceph_tpu.osd.pglog as ref_pglog
import ceph_tpu.osd.types as ref_types
import ceph_tpu_torch.msg.auth as auth
import ceph_tpu_torch.msg.frames as frames
import ceph_tpu_torch.msg.messages as messages
import ceph_tpu_torch.msg.messenger as messenger
import ceph_tpu_torch.osd.pglog as pglog
import ceph_tpu_torch.osd.types as osd_types
from tests.xla_private import _private_xla_compiles  # noqa: F401

REF = types.SimpleNamespace(messages=ref_messages, messenger=ref_messenger, pglog=ref_pglog,
                            types=ref_types, auth=ref_auth, frames=ref_frames)
PORT = types.SimpleNamespace(messages=messages, messenger=messenger, pglog=pglog,
                             types=osd_types, auth=auth, frames=frames)

#: the message set's classes, from the module itself: the reference's
#: registry also holds the types its mon modules register when imported
CLASSES = sorted((c for c in vars(ref_messages).values()
                  if isinstance(c, type) and issubclass(c, ref_messenger.Message) and c.TYPE
                  and c.__module__ == ref_messages.__name__), key=lambda c: c.TYPE)
#: the constructor arguments that hold an eversion_t
EVERSIONS = {"version", "guard", "prev_version", "since", "last_update", "log_tail", "tail"}


class Seeded:
    """Field values drawn from one numpy generator: two instances with
    the same seed give the same values."""

    def __init__(self, seed: int):
        self.rng = np.random.default_rng(seed)

    def int(self, lo: int = 0, hi: int = 128) -> int:
        return int(self.rng.integers(lo, hi))

    def u64(self) -> int:
        return int(self.rng.integers(0, 1 << 63)) * 2 + self.int(0, 2)

    def float(self) -> float:
        return float(self.rng.normal() * 1000)

    def str(self) -> str:
        alphabet = "abcxyz_.-019AZ" + "é中Ж"
        return "".join(alphabet[i] for i in self.rng.integers(0, len(alphabet), self.int(0, 12)))

    def bytes(self, hi: int = 64) -> bytes:
        return self.rng.integers(0, 256, self.int(0, hi), dtype=np.uint8).tobytes()

    def bool(self) -> bool:
        return bool(self.rng.integers(0, 2))

    def count(self) -> int:
        return self.int(0, 4)


def _osd_op(pkg, v: Seeded):
    kv = {v.str(): v.bytes() for _ in range(v.count())}
    return pkg.messages.OSDOp(v.int(1, 30), off=v.u64(), length=v.u64(), name=v.str(),
                              data=v.bytes(), kv=kv, keys=[v.str() for _ in range(v.count())])


def _value(pkg, cls, name: str, ann, default, v: Seeded):
    """A seeded value for one constructor argument of ``cls``."""
    ann = str(ann)
    if name in EVERSIONS:
        return pkg.pglog.eversion_t(v.int(0, 1 << 30), v.u64() >> 1)
    if cls.__name__ == "MMgrReport" and name in ("counters", "gauges"):
        return {v.str(): v.float() for _ in range(v.count())}
    if cls.__name__ == "MLog" and name == "entries":
        return [{"seq": v.u64(), "stamp": v.float(), "channel": v.str(), "level": v.int(0, 5),
                 "message": v.str()} for _ in range(v.count())]
    if name in ("args", "out"):  # JSON bodies
        return {v.str(): v.int(-1000, 1000) for _ in range(v.count())}
    if ann == "pg_t":
        return pkg.types.pg_t(v.int(0, 1 << 20), v.int(0, 1 << 31))
    if ann == "bool":
        return v.bool()
    if ann == "float":
        return v.float()
    if ann == "str":
        return v.str()
    if ann == "bytes":
        return v.bytes()
    if ann in ("int", "int | None"):
        if name == "op" and cls.__name__ == "MOSDOp":
            return None  # the ops vector carries them
        if name in ("tid", "off", "length", "snapid", "snap", "snap_seq", "clone_snap",
                    "notify_id", "cookie", "ino", "start_epoch", "last_seq", "stamp"):
            return v.u64()
        if default == -1:
            return v.int(-1, 127)
        return v.int()
    if ann == "list[OSDOp] | None":
        return [_osd_op(pkg, v) for _ in range(v.count() + 1)]
    if ann == "dict[str, bytes] | None":
        return {v.str(): v.bytes() for _ in range(v.count())}
    if ann == "dict[str, str] | None":
        return {v.str(): v.str() for _ in range(v.count())}
    if ann == "dict[str, dict[str, str]] | None":
        return {v.str(): {v.str(): v.str() for _ in range(v.count())} for _ in range(v.count())}
    if ann == "dict[str, list[int]] | None":
        return {v.str(): [v.u64() for _ in range(v.count())] for _ in range(v.count())}
    if ann == "dict[int, bytes] | None":
        return {v.int(0, 1 << 30): v.bytes() for _ in range(v.count())}
    if ann in ("list[str] | None",):
        return [v.str() for _ in range(v.count())]
    if ann == "list[int] | None":
        return [v.u64() for _ in range(v.count())]
    if ann == "list[bytes] | None":
        return [v.bytes() for _ in range(v.count())]
    if ann == "list[tuple[int, int]] | None":
        return [(v.u64(), v.u64()) for _ in range(v.count())]
    if ann == "list[tuple[str, bytes]] | None":
        return [(v.str(), v.bytes()) for _ in range(v.count())]
    if ann == "list[tuple[int, bytes, dict[str, bytes]]] | None":
        return [(v.int(-100, 100), v.bytes(), {v.str(): v.bytes() for _ in range(v.count())})
                for _ in range(v.count())]
    if ann == "list[tuple[str, bytes, dict[str, bytes]]] | None":
        return [(v.str(), v.bytes(), {v.str(): v.bytes() for _ in range(v.count())})
                for _ in range(v.count())]
    raise AssertionError(f"no seeded value for {cls.__name__}.{name}: {ann}")


def build(pkg, name: str, seed: int):
    """Message class ``name`` of ``pkg`` with every constructor argument
    drawn from ``seed``."""
    cls = getattr(pkg.messages, name)
    v = Seeded(seed)
    params = list(inspect.signature(cls.__init__).parameters.values())[1:]
    kw = {p.name: _value(pkg, cls, p.name, p.annotation, p.default, v) for p in params}
    return cls(**kw)


def segments(pkg, msg, seq: int = 7) -> list[bytes]:
    return pkg.messenger.encode_message(msg, ("osd", 3), seq)


def test_registries_hold_39_classes_each_of_its_own_package():
    """The 39 classes of ``msg.messages``, and the mon's election and
    Paxos messages, which join the registry when ``mon.paxos`` loads (as
    the reference's do), each the package's own."""
    import ceph_tpu.mon.paxos as ref_paxos
    import ceph_tpu_torch.mon.paxos as paxos

    assert len(CLASSES) == 39
    mon = [paxos.MMonElection, paxos.MMonPaxos]
    assert sorted(messenger._REGISTRY) == sorted([c.TYPE for c in CLASSES] + [c.TYPE for c in mon])
    for cls in CLASSES:
        assert ref_messenger._REGISTRY[cls.TYPE] is cls
        ours = messenger._REGISTRY[cls.TYPE]
        assert ours.__name__ == cls.__name__
        assert ours.__module__ == "ceph_tpu_torch.msg.messages"
    for cls, ref in zip(mon, [ref_paxos.MMonElection, ref_paxos.MMonPaxos]):
        assert messenger._REGISTRY[cls.TYPE] is cls and ref_messenger._REGISTRY[ref.TYPE] is ref
        assert cls.TYPE == ref.TYPE and cls.__name__ == ref.__name__


def test_decode_before_the_message_set_is_imported():
    """A process that has imported the messenger alone still decodes
    every type: ``decode_message`` imports the message set on a miss."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "from ceph_tpu_torch.msg import messenger\n"
        "from ceph_tpu_torch.msg.denc import Encoder\n"
        "assert 'ceph_tpu_torch.msg.messages' not in sys.modules\n"
        "head, body = Encoder(), Encoder()\n"
        "head.u32(127); head.str_('osd'); head.i64(4); head.u64(1); head.bool_(False)\n"
        "body.u64(99)\n"
        "msg = messenger.decode_message([head.bytes(), body.bytes()])\n"
        "assert type(msg).__name__ == 'MLogAck' and msg.last_seq == 99, msg\n"
        "assert msg.src == ('osd', 4)\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = root
    res = subprocess.run([sys.executable, "-c", code], cwd=root, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


@pytest.mark.parametrize("name", [c.__name__ for c in CLASSES])
def test_message_bytes_equal_and_decoded_across(name):
    for seed in (1, 2):
        ref_msg, port_msg = build(REF, name, seed), build(PORT, name, seed)
        ref_segs, port_segs = segments(REF, ref_msg), segments(PORT, port_msg)
        assert port_segs == ref_segs
        # each package decodes the other's bytes into its own class
        got = messenger.decode_message(ref_segs)
        assert type(got) is getattr(messages, name) and got.src == ("osd", 3)
        assert segments(PORT, got) == ref_segs
        back = ref_messenger.decode_message(port_segs)
        assert type(back) is getattr(ref_messages, name)
        assert segments(REF, back) == port_segs


def test_op_constants_and_write_classification_equal():
    ref_ops = {k: v for k, v in vars(ref_messages).items() if k.startswith("OP_")}
    ops = {k: v for k, v in vars(messages).items() if k.startswith("OP_")}
    assert ops == ref_ops and messages.WRITE_OPS == ref_messages.WRITE_OPS
    for op, name in [(messages.OP_CALL, "lock.lock"), (messages.OP_CALL, "lock.get_info"),
                     (messages.OP_CALL, "nope.x"), (messages.OP_WRITE, ""), (messages.OP_READ, "")]:
        assert (messages.OSDOp(op, name=name).is_write()
                == ref_messages.OSDOp(op, name=name).is_write())


class _Sink:
    """A stream writer that keeps what is written."""

    def __init__(self):
        self.data = bytearray()

    def write(self, b: bytes) -> None:
        self.data += b

    async def drain(self) -> None:
        pass


def _write(pkg, tag: int, segs: list[bytes], crypto=None) -> bytes:
    sink = _Sink()
    asyncio.run(pkg.frames.write_frame(sink, tag, segs, crypto=crypto))
    return bytes(sink.data)


def _read(pkg, raw: bytes, crypto=None):
    async def go():
        reader = asyncio.StreamReader()
        reader.feed_data(raw)
        reader.feed_eof()
        return await pkg.frames.read_frame(reader, crypto=crypto)

    return asyncio.run(go())


def test_frames_byte_equal_and_read_across():
    assert frames.BANNER == ref_frames.BANNER
    assert (frames.MAX_FRAME_LEN, frames.MAX_SEGMENTS) == (ref_frames.MAX_FRAME_LEN,
                                                           ref_frames.MAX_SEGMENTS)
    assert {k: v for k, v in vars(frames.Tag).items() if not k.startswith("_")} == {
        k: v for k, v in vars(ref_frames.Tag).items() if not k.startswith("_")}
    rng = np.random.default_rng(13)
    for nseg in (1, 2, 3, 4):
        for _ in range(3):
            segs = [rng.integers(0, 256, int(rng.integers(0, 5000)), dtype=np.uint8).tobytes()
                    for _ in range(nseg)]
            tag = int(rng.choice([frames.Tag.MESSAGE, frames.Tag.HELLO, frames.Tag.KEEPALIVE2]))
            lens = [len(s) for s in segs]
            assert frames._preamble(tag, lens) == ref_frames._preamble(tag, lens)
            raw = _write(PORT, tag, segs)
            assert raw == _write(REF, tag, segs)
            assert _read(REF, raw) == (tag, segs)
            assert _read(PORT, raw) == (tag, segs)


def test_frame_crc_corruption_detected_by_both():
    raw = bytearray(_write(PORT, frames.Tag.MESSAGE, [b"head", b"payload" * 10]))
    raw[-12] ^= 1  # a payload byte
    for pkg in (REF, PORT):
        with pytest.raises(pkg.frames.FrameError):
            _read(pkg, bytes(raw))


def test_banner_exchange_across():
    async def go():
        a, b = _Sink(), _Sink()
        await frames.send_banner(a, features=5)
        await ref_frames.send_banner(b, features=5)
        assert a.data == b.data
        reader = asyncio.StreamReader()
        reader.feed_data(bytes(a.data))
        return await ref_frames.recv_banner(reader)

    assert asyncio.run(go()) == 5


# -- auth ----------------------------------------------------------------------


def test_seal_and_tickets_open_across():
    pytest.importorskip("cryptography")
    ss, sk = auth.make_secret(), ref_auth.make_secret()
    for sealer, opener in ((auth, ref_auth), (ref_auth, auth)):
        assert opener.unseal(ss, sealer.seal(ss, b"secret bytes" * 3)) == b"secret bytes" * 3
        blob = sealer.mint_ticket(ss, "client.7", sk, caps={"osd": "allow rw"})
        assert opener.open_ticket(ss, blob) == ("client.7", sk, {"osd": "allow rw"})
        with pytest.raises(PermissionError):
            opener.open_ticket(ss, sealer.mint_ticket(ss, "client.7", sk, ttl=-1.0))
        with pytest.raises(Exception):
            opener.open_ticket(opener.make_secret(), blob)
    assert auth._hkdf(ss, b"salt", b"info") == ref_auth._hkdf(ss, b"salt", b"info")


def test_frame_crypto_across():
    pytest.importorskip("cryptography")
    sk, nc, ns = auth.make_secret(), b"c" * 12, b"s" * 12
    for a_pkg, b_pkg in ((auth, ref_auth), (ref_auth, auth)):
        a = a_pkg.FrameCrypto.from_session(sk, nc, ns, connector=True)
        b = b_pkg.FrameCrypto.from_session(sk, nc, ns, connector=False)
        twin = b_pkg.FrameCrypto.from_session(sk, nc, ns, connector=True)
        for payload in (b"hello", b"", bytes(range(256)) * 9):
            ct = a.encrypt(payload)
            assert ct == twin.encrypt(payload)  # counter nonces: deterministic
            assert b.decrypt(ct) == payload
        # a secure frame written by one package reads in the other
        tx = a_pkg.FrameCrypto.from_session(sk, nc, ns, connector=True)
        rx = b_pkg.FrameCrypto.from_session(sk, nc, ns, connector=False)
        raw = _write(PORT if a_pkg is auth else REF, frames.Tag.MESSAGE, [b"h", b"p" * 99],
                     crypto=tx)
        assert _read(REF if a_pkg is auth else PORT, raw, crypto=rx) == (
            frames.Tag.MESSAGE, [b"h", b"p" * 99])


# -- a port messenger and a reference messenger over loopback TCP ------------------


def _auth_for(pkg, entity: str, secret: bytes):
    return pkg.auth.AuthContext(entity, service_secret=secret)


async def _session(client_pkg, server_pkg, mode: str) -> dict:
    """``client_pkg``'s messenger dials ``server_pkg``'s, sends a seeded
    EC sub-write and an op, and the server answers each on the same
    connection.  Returns what each side saw."""
    secret = auth.make_secret()
    kw = {"crc": {}, "compress": {"compress_mode": "force", "compress_min_size": 64}}.get(mode)
    server_kw = dict(kw or {})
    client_kw = dict(kw or {})
    if mode == "secure":
        server_kw["auth"] = _auth_for(server_pkg, "osd.1", secret)
        client_kw["auth"] = _auth_for(client_pkg, "osd.2", secret)
    got = asyncio.Queue()
    back = asyncio.Queue()

    async def serve(msg):
        await got.put(msg)
        reply = server_pkg.messages.MOSDECSubOpWriteReply(
            tid=getattr(msg, "tid", 0), pg=server_pkg.types.pg_t(3, 9), shard=4, from_osd=1,
            result=0, epoch=12)
        await msg.conn.send_message(reply)

    async def on_reply(msg):
        await back.put(msg)

    server = server_pkg.messenger.Messenger(("osd", 1), serve, **server_kw)
    await server.bind()
    client = client_pkg.messenger.Messenger(("osd", 2), on_reply, **client_kw)
    try:
        conn = await client.connect(*server.addr)
        sent = [build(client_pkg, "MOSDECSubOpWrite", 5), build(client_pkg, "MOSDOp", 6)]
        sent[0].data = b"shard bytes " * 700  # compressible, past compress_min_size
        for msg in sent:
            await conn.send_message(msg)
        received = [await asyncio.wait_for(got.get(), 10) for _ in sent]
        replies = [await asyncio.wait_for(back.get(), 10) for _ in sent]
        return {"conn": conn, "server_conn": received[0].conn, "sent": sent,
                "received": received, "replies": replies}
    finally:
        await client.shutdown()
        await server.shutdown()


@pytest.mark.parametrize("mode", ["crc", "compress", "secure"])
@pytest.mark.parametrize("direction", ["port-to-ref", "ref-to-port"])
def test_messenger_session_across_packages(direction, mode):
    if mode == "secure":
        pytest.importorskip("cryptography")
    client_pkg, server_pkg = (PORT, REF) if direction == "port-to-ref" else (REF, PORT)
    seen = asyncio.run(_session(client_pkg, server_pkg, mode))
    for sent, received in zip(seen["sent"], seen["received"]):
        assert type(received) is getattr(server_pkg.messages, type(sent).__name__)
        assert received.src == ("osd", 2)
        assert segments(server_pkg, received) == segments(client_pkg, sent)
    for reply in seen["replies"]:
        assert type(reply) is client_pkg.messages.MOSDECSubOpWriteReply
        assert (reply.src, reply.pg, reply.shard, reply.epoch) == (("osd", 1),
                                                                   client_pkg.types.pg_t(3, 9),
                                                                   4, 12)
    conn, server_conn = seen["conn"], seen["server_conn"]
    if mode == "compress":
        assert conn.compressor.name == "zlib" and server_conn.compressor.name == "zlib"
    else:
        assert conn.compressor is None and server_conn.compressor is None
    assert (conn.crypto is not None) == (mode == "secure")
    assert (server_conn.crypto is not None) == (mode == "secure")
    if mode == "secure":
        assert server_conn.peer_caps is not None

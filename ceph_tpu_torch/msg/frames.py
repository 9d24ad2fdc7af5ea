"""msgr2-style framed wire protocol.

Behavioral twin of the reference's protocol v2 framing
(src/msg/async/frames_v2.h:40-143): a banner exchange, then segmented
frames — preamble (tag, segment count, segment lengths, preamble crc)
followed by the segments and an epilogue carrying per-segment crc32c.
crc mode matches the reference's rev1 epilogue semantics.

SECURE mode (the reference's crypto_onwire.cc): once a connection's
auth handshake establishes a session key, ``write_frame``/``read_frame``
take a :class:`~ceph_tpu_torch.msg.auth.FrameCrypto` and every frame ships as
``u32 length || AES-GCM(tag || nseg || seg_lens || segments)`` with
per-direction keys and counter nonces — confidentiality + integrity
replace the crc epilogue, and any tamper or replay fails the AEAD tag.

All crcs use the native crc32c runtime (ceph_tpu_torch/native), seeded -1
like the reference frame crcs.
"""

from __future__ import annotations

import asyncio
import struct

from ceph_tpu_torch.native import crc32c

BANNER = b"ceph_tpu msgr2.0\n"
MAX_SEGMENTS = 4
MAX_FRAME_LEN = 256 * 1024 * 1024


class Tag:
    """frames_v2.h:40-54 (the subset the mini-cluster speaks)."""

    HELLO = 1
    AUTH_REQUEST = 2
    AUTH_DONE = 3
    MESSAGE = 17
    KEEPALIVE2 = 14
    KEEPALIVE2_ACK = 15
    ACK = 16
    CLOSE = 18
    # on-wire compression negotiation (frames_v2.h:60-61; the reference
    # marks compressed frames via a preamble flag bit — here a distinct
    # tag carries the same information)
    COMPRESSION_REQUEST = 21
    COMPRESSION_DONE = 22
    MESSAGE_COMPRESSED = 23


class FrameError(ConnectionError):
    pass


async def send_banner(writer: asyncio.StreamWriter, features: int = 1) -> None:
    writer.write(BANNER + struct.pack("<Q", features))
    await writer.drain()


async def recv_banner(reader: asyncio.StreamReader) -> int:
    got = await reader.readexactly(len(BANNER))
    if got != BANNER:
        raise FrameError(f"bad banner {got!r}")
    (features,) = struct.unpack("<Q", await reader.readexactly(8))
    return features


def _preamble(tag: int, seg_lens: list[int]) -> bytes:
    head = struct.pack(
        "<BB4I", tag, len(seg_lens),
        *(seg_lens + [0] * (MAX_SEGMENTS - len(seg_lens))),
    )
    return head + struct.pack("<I", crc32c(head))


async def write_frame(
    writer: asyncio.StreamWriter, tag: int, segments: list[bytes],
    crypto=None,
) -> None:
    assert 0 < len(segments) <= MAX_SEGMENTS
    segs = [bytes(s) for s in segments]
    if crypto is not None:
        plain = struct.pack(
            "<BB4I", tag, len(segs),
            *([len(s) for s in segs] + [0] * (MAX_SEGMENTS - len(segs))),
        ) + b"".join(segs)
        ct = crypto.encrypt(plain)
        writer.write(struct.pack("<I", len(ct)) + ct)
        await writer.drain()
        return
    writer.write(_preamble(tag, [len(s) for s in segs]))
    for s in segs:
        writer.write(s)
    # epilogue: one crc32c per present segment (frames_v2.h:124-143)
    writer.write(struct.pack(f"<{len(segs)}I", *(crc32c(s) for s in segs)))
    await writer.drain()


async def read_frame(
    reader: asyncio.StreamReader, crypto=None,
) -> tuple[int, list[bytes]]:
    if crypto is not None:
        (ln,) = struct.unpack("<I", await reader.readexactly(4))
        if ln > MAX_FRAME_LEN:
            raise FrameError("secure frame too large")
        try:
            plain = crypto.decrypt(await reader.readexactly(ln))
        except Exception as e:  # InvalidTag and friends
            raise FrameError(f"secure frame authentication failed: {e}")
        tag, nseg = plain[0], plain[1]
        if not 0 < nseg <= MAX_SEGMENTS:
            raise FrameError(f"bad segment count {nseg}")
        seg_lens = struct.unpack_from("<4I", plain, 2)[:nseg]
        off = 2 + 16
        segs = []
        for n in seg_lens:
            segs.append(plain[off : off + n])
            off += n
        if off != len(plain):
            raise FrameError("secure frame length mismatch")
        return tag, segs
    head = await reader.readexactly(18)
    (want_crc,) = struct.unpack("<I", await reader.readexactly(4))
    if crc32c(head) != want_crc:
        raise FrameError("preamble crc mismatch")
    tag, nseg = head[0], head[1]
    if not 0 < nseg <= MAX_SEGMENTS:
        raise FrameError(f"bad segment count {nseg}")
    seg_lens = struct.unpack("<4I", head[2:])[:nseg]
    if sum(seg_lens) > MAX_FRAME_LEN:
        raise FrameError("frame too large")
    segs = [await reader.readexactly(n) for n in seg_lens]
    crcs = struct.unpack(f"<{nseg}I", await reader.readexactly(4 * nseg))
    for s, c in zip(segs, crcs):
        if crc32c(s) != c:
            raise FrameError("segment crc mismatch")
    return tag, list(segs)

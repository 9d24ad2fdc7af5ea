"""Versioned wire encoding — the denc/encoding.h twin.

The reference encodes every wire/disk struct with ENCODE_START(v,
compat, bl) ... ENCODE_FINISH(bl) (src/include/encoding.h): a leading
(version, compat_version, length) header per struct so old decoders can
skip unknown tails and new decoders can reject too-old peers.  This
module is the same contract over little-endian struct packing:

    enc = Encoder()
    with enc.versioned(2, 1):
        enc.u32(x); enc.str_(name)
    wire = enc.bytes()

    dec = Decoder(wire)
    with dec.versioned(compat=1) as v:
        x = dec.u32()
        name = dec.str_()
        # fields added in later versions guarded by `v`
    # decoder skips any unread tail of the struct (DECODE_FINISH)
"""

from __future__ import annotations

import contextlib
import struct


class EncodingError(Exception):
    pass


class Encoder:
    def __init__(self) -> None:
        self._buf = bytearray()

    # scalars (little-endian, like ceph_le types)
    def u8(self, v: int) -> None:
        self._buf += struct.pack("<B", v & 0xFF)

    def u16(self, v: int) -> None:
        self._buf += struct.pack("<H", v & 0xFFFF)

    def u32(self, v: int) -> None:
        self._buf += struct.pack("<I", v & 0xFFFFFFFF)

    def u64(self, v: int) -> None:
        self._buf += struct.pack("<Q", v & 0xFFFFFFFFFFFFFFFF)

    def i32(self, v: int) -> None:
        self._buf += struct.pack("<i", v)

    def i64(self, v: int) -> None:
        self._buf += struct.pack("<q", v)

    def bool_(self, v: bool) -> None:
        self.u8(1 if v else 0)

    def bytes_(self, b: bytes) -> None:
        self.u32(len(b))
        self._buf += b

    def str_(self, s: str) -> None:
        self.bytes_(s.encode("utf-8"))

    def raw(self, b: bytes) -> None:
        self._buf += b

    @contextlib.contextmanager
    def versioned(self, version: int, compat: int):
        """ENCODE_START/ENCODE_FINISH: u8 v, u8 compat, u32 length."""
        self.u8(version)
        self.u8(compat)
        pos = len(self._buf)
        self.u32(0)  # placeholder
        yield
        length = len(self._buf) - pos - 4
        self._buf[pos : pos + 4] = struct.pack("<I", length)

    def bytes(self) -> bytes:
        return bytes(self._buf)

    def __len__(self) -> int:
        return len(self._buf)


class Decoder:
    def __init__(self, data: bytes | bytearray | memoryview, off: int = 0):
        self._d = memoryview(data)
        self._off = off

    def _take(self, n: int) -> memoryview:
        if self._off + n > len(self._d):
            raise EncodingError(
                f"buffer underrun: need {n} at {self._off}/{len(self._d)}"
            )
        v = self._d[self._off : self._off + n]
        self._off += n
        return v

    def u8(self) -> int:
        return self._take(1)[0]

    def u16(self) -> int:
        return struct.unpack("<H", self._take(2))[0]

    def u32(self) -> int:
        return struct.unpack("<I", self._take(4))[0]

    def u64(self) -> int:
        return struct.unpack("<Q", self._take(8))[0]

    def i32(self) -> int:
        return struct.unpack("<i", self._take(4))[0]

    def i64(self) -> int:
        return struct.unpack("<q", self._take(8))[0]

    def bool_(self) -> bool:
        return bool(self.u8())

    def bytes_(self) -> bytes:
        n = self.u32()
        return bytes(self._take(n))

    def str_(self) -> str:
        return self.bytes_().decode("utf-8")

    def raw(self, n: int) -> bytes:
        return bytes(self._take(n))

    def remaining(self) -> int:
        return len(self._d) - self._off

    @contextlib.contextmanager
    def versioned(self, compat: int = 1):
        """DECODE_START/DECODE_FINISH: yields the peer's struct version;
        skips the unread tail, errors if the struct's compat is newer
        than what we understand."""
        v = self.u8()
        struct_compat = self.u8()
        length = self.u32()
        end = self._off + length
        if end > len(self._d):
            raise EncodingError("versioned struct overruns buffer")
        if struct_compat > compat:
            # peer says decoders older than struct_compat can't parse it
            raise EncodingError(
                f"struct compat {struct_compat} > supported {compat}"
            )
        yield v
        if self._off > end:
            raise EncodingError("versioned struct over-read")
        self._off = end  # skip what we did not understand

"""Transport tests: denc round-trips, frame integrity, messenger
dispatch, map encoding (reference test analogues: test_denc.cc,
msgr tests in src/test/msgr/).

The port's twin of tests/test_msg.py: the same cases over
``ceph_tpu_torch``.
"""

import asyncio

import numpy as np
import pytest

from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import ChooseArg, CrushMap
from ceph_tpu_torch.msg import frames
from ceph_tpu_torch.msg.denc import Decoder, Encoder, EncodingError
from ceph_tpu_torch.msg.messages import (
    MOSDECSubOpWrite,
    MOSDMap,
    MOSDOp,
    MOSDOpReply,
    OP_WRITE_FULL,
)
from ceph_tpu_torch.msg.messenger import Messenger, decode_message, encode_message
from ceph_tpu_torch.osd.mapenc import decode_osdmap, encode_osdmap
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgPool, PoolType, pg_t


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


class TestDenc:
    def test_scalar_roundtrip(self):
        enc = Encoder()
        enc.u8(7); enc.u16(300); enc.u32(70000); enc.u64(1 << 40)
        enc.i32(-5); enc.i64(-(1 << 40)); enc.bool_(True)
        enc.bytes_(b"abc"); enc.str_("héllo")
        dec = Decoder(enc.bytes())
        assert dec.u8() == 7
        assert dec.u16() == 300
        assert dec.u32() == 70000
        assert dec.u64() == 1 << 40
        assert dec.i32() == -5
        assert dec.i64() == -(1 << 40)
        assert dec.bool_() is True
        assert dec.bytes_() == b"abc"
        assert dec.str_() == "héllo"
        assert dec.remaining() == 0

    def test_versioned_skips_unknown_tail(self):
        """A v2 encoder adds a field; a v1 decoder must skip it."""
        enc = Encoder()
        with enc.versioned(2, 1):
            enc.u32(42)
            enc.str_("new-field-from-v2")
        enc.u32(99)  # data after the struct
        dec = Decoder(enc.bytes())
        with dec.versioned() as v:
            assert v == 2
            assert dec.u32() == 42
            # v1 decoder stops reading here
        assert dec.u32() == 99

    def test_underrun_raises(self):
        with pytest.raises(EncodingError):
            Decoder(b"\x01").u32()


class TestFrames:
    def test_frame_roundtrip(self):
        async def go():
            server_got = []

            async def handle(reader, writer):
                tag, segs = await frames.read_frame(reader)
                server_got.append((tag, segs))
                await frames.write_frame(writer, frames.Tag.ACK, [b"ok"])

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            await frames.write_frame(
                writer, frames.Tag.MESSAGE, [b"head", b"payload" * 100]
            )
            tag, segs = await frames.read_frame(reader)
            assert (tag, segs) == (frames.Tag.ACK, [b"ok"])
            assert server_got == [
                (frames.Tag.MESSAGE, [b"head", b"payload" * 100])
            ]
            writer.close()
            server.close()

        run(go())

    def test_corrupt_segment_detected(self):
        async def go():
            async def handle(reader, writer):
                data = await reader.read(10000)
                data = bytearray(data)
                data[-5] ^= 0xFF  # flip a payload byte
                writer.write(data)
                await writer.drain()

            server = await asyncio.start_server(handle, "127.0.0.1", 0)
            port = server.sockets[0].getsockname()[1]
            reader, writer = await asyncio.open_connection("127.0.0.1", port)
            await frames.write_frame(writer, frames.Tag.MESSAGE, [b"payload"])
            with pytest.raises(frames.FrameError):
                await frames.read_frame(reader)
            writer.close()
            server.close()

        run(go())


class TestMessages:
    def test_mosdop_roundtrip(self):
        m = MOSDOp(
            tid=9, pool=3, oid="foo", op=OP_WRITE_FULL,
            data=b"\x00\x01" * 50, epoch=12,
        )
        segs = encode_message(m, ("client", 4), 1)
        m2 = decode_message(segs)
        assert isinstance(m2, MOSDOp)
        assert (m2.tid, m2.pool, m2.oid, m2.op, m2.data, m2.epoch) == (
            9, 3, "foo", OP_WRITE_FULL, b"\x00\x01" * 50, 12,
        )
        assert m2.src == ("client", 4)

    def test_ec_subop_roundtrip(self):
        m = MOSDECSubOpWrite(
            tid=5, pg=pg_t(2, 7), shard=3, from_osd=1, oid="o",
            off=64, data=b"chunk", attrs={"hinfo": b"\x01"}, epoch=4,
        )
        m2 = decode_message(encode_message(m, ("osd", 1), 2))
        assert (m2.pg, m2.shard, m2.off, m2.data, m2.attrs) == (
            pg_t(2, 7), 3, 64, b"chunk", {"hinfo": b"\x01"},
        )


class TestMapEncoding:
    def test_osdmap_roundtrip(self):
        m = CrushMap()
        root = B.build_hierarchy(m, osds_per_host=2, n_hosts=4)
        rid = B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3)
        m.choose_args[root.id] = ChooseArg(
            root.id, weight_set=[[0x10000] * root.size]
        )
        om = OSDMap(crush=m, epoch=5)
        for o in range(8):
            om.new_osd(o)
        om.mark_down(3)
        om.set_primary_affinity(1, 0x8000)
        om.pools[1] = PgPool(
            id=1, type=PoolType.ERASURE, size=3, min_size=2,
            crush_rule=rid, pg_num=8, pgp_num=8,
            erasure_code_profile="myprofile",
        )
        om.erasure_code_profiles["myprofile"] = {
            "plugin": "jax", "k": "2", "m": "1",
        }
        om.pg_upmap[pg_t(1, 2)] = [0, 2, 4]
        om.pg_upmap_items[pg_t(1, 3)] = [(1, 5)]
        om.pg_temp[pg_t(1, 4)] = [2, 4, 6]
        om.primary_temp[pg_t(1, 5)] = 6
        om.osd_addrs[0] = ("127.0.0.1", 6800)

        # NON-uniform balancer overrides on the OSDMap itself: these
        # drive placement and must survive the wire (straw2 is
        # scale-invariant, so only a non-uniform set catches bugs)
        om.choose_args = {
            root.id: ChooseArg(root.id, weight_set=[[0x8000, 0x10000, 0x18000, 0x20000]])
        }
        om2 = decode_osdmap(encode_osdmap(om))
        assert om2.choose_args == om.choose_args
        assert om2.epoch == 5
        assert om2.osd_state == om.osd_state
        assert om2.osd_weight == om.osd_weight
        assert om2.osd_primary_affinity == om.osd_primary_affinity
        assert om2.pools[1] == om.pools[1]
        assert om2.pg_upmap == om.pg_upmap
        assert om2.pg_upmap_items == om.pg_upmap_items
        assert om2.pg_temp == om.pg_temp
        assert om2.primary_temp == om.primary_temp
        assert om2.erasure_code_profiles == om.erasure_code_profiles
        assert om2.osd_addrs == om.osd_addrs
        # placement must be identical through the round-trip
        for ps in range(8):
            assert om2.pg_to_up_acting_osds(
                pg_t(1, ps)
            ) == om.pg_to_up_acting_osds(pg_t(1, ps))


class TestMessenger:
    def test_hello_and_dispatch(self):
        async def go():
            got = asyncio.Queue()

            async def dispatch(msg):
                await got.put(msg)

            server = Messenger(("osd", 0), dispatch)
            await server.bind()
            client = Messenger(("client", 99))
            conn = await client.connect(*server.addr)
            assert conn.peer == ("osd", 0)
            await conn.send_message(MOSDOpReply(tid=1, result=0, data=b"x"))
            msg = await asyncio.wait_for(got.get(), 5)
            assert isinstance(msg, MOSDOpReply)
            assert msg.src == ("client", 99)
            # server learned the client's identity
            assert server.get_connection(("client", 99)) is not None
            # reply over the server->client direction of the same conn
            await server.get_connection(("client", 99)).send_message(
                MOSDMap(maps={1: b"mapbytes"})
            )
            back = asyncio.Queue()
            client.dispatcher = lambda m: back.put(m)
            msg2 = await asyncio.wait_for(back.get(), 5)
            assert isinstance(msg2, MOSDMap)
            assert msg2.maps == {1: b"mapbytes"}
            await client.shutdown()
            await server.shutdown()

        run(go())

    def test_reset_callback_on_peer_close(self):
        async def go():
            resets = []

            async def on_reset(conn):
                resets.append(conn.peer)

            server = Messenger(("mon", 0), on_reset=on_reset)
            await server.bind()
            client = Messenger(("osd", 2))
            conn = await client.connect(*server.addr)
            await asyncio.sleep(0.05)
            await conn.close()
            await asyncio.sleep(0.1)
            assert resets == [("osd", 2)]
            await client.shutdown()
            await server.shutdown()

        run(go())


class TestOnWireCompression:
    """msgr2 on-wire compression negotiation + compressed message
    round-trip (reference src/msg/async/compression_onwire.cc,
    compressor_registry.cc)."""

    def test_negotiated_roundtrip(self):
        import asyncio

        from ceph_tpu_torch.msg.frames import Tag
        from ceph_tpu_torch.msg.messages import MOSDOp
        from ceph_tpu_torch.msg.messenger import Messenger

        async def go():
            got = asyncio.get_running_loop().create_future()

            async def on_msg(msg):
                if not got.done():
                    got.set_result(msg)

            srv = Messenger(("osd", 1), on_msg, compress_mode="force")
            await srv.bind("127.0.0.1", 0)
            cli = Messenger(("client", 2), compress_mode="force",
                            compress_min_size=64)
            conn = await cli.connect(*srv.addr)
            assert conn.compressor is not None, "negotiation failed"
            assert conn.compressor.name == "zlib"
            big = MOSDOp(tid=7, pool=1, oid="o", op=2,
                         data=b"compress me " * 500)
            await conn.send_message(big)
            msg = await asyncio.wait_for(got, 10)
            assert isinstance(msg, MOSDOp)
            assert msg.data == b"compress me " * 500
            # the server side negotiated too: its reply would compress
            assert msg.conn.compressor is not None
            # a tiny message stays below the threshold: still delivered
            got2 = asyncio.get_running_loop().create_future()
            srv.dispatcher = lambda m: _set(got2, m)
            await conn.send_message(MOSDOp(tid=8, pool=1, oid="o", op=2,
                                           data=b"sm"))
            msg2 = await asyncio.wait_for(got2, 10)
            assert msg2.data == b"sm"
            await cli.shutdown()
            await srv.shutdown()

        async def _set(fut, m):
            if not fut.done():
                fut.set_result(m)

        asyncio.run(go())

    def test_none_peer_refuses_negotiation(self):
        """'none = never': a mode-none acceptor answers the request
        with an empty pick and both sides stay uncompressed."""
        import asyncio

        from ceph_tpu_torch.msg.messages import MOSDOp
        from ceph_tpu_torch.msg.messenger import Messenger

        async def go():
            got = asyncio.get_running_loop().create_future()

            async def on_msg(msg):
                if not got.done():
                    got.set_result(msg)

            srv = Messenger(("osd", 1), on_msg)  # compress_mode=none
            await srv.bind("127.0.0.1", 0)
            cli = Messenger(("client", 9), compress_mode="force",
                            compress_min_size=64)
            conn = await cli.connect(*srv.addr)
            assert conn.compressor is None
            await conn.send_message(MOSDOp(tid=1, pool=1, oid="o", op=2,
                                           data=b"plain " * 100))
            msg = await asyncio.wait_for(got, 10)
            assert msg.data == b"plain " * 100
            await cli.shutdown()
            await srv.shutdown()

        asyncio.run(go())

    def test_no_negotiation_stays_plain(self):
        import asyncio

        from ceph_tpu_torch.msg.messages import MOSDOp
        from ceph_tpu_torch.msg.messenger import Messenger

        async def go():
            got = asyncio.get_running_loop().create_future()

            async def on_msg(msg):
                if not got.done():
                    got.set_result(msg)

            srv = Messenger(("osd", 1), on_msg)
            await srv.bind("127.0.0.1", 0)
            cli = Messenger(("client", 3))  # compress_mode=none
            conn = await cli.connect(*srv.addr)
            assert conn.compressor is None
            await conn.send_message(MOSDOp(tid=1, pool=1, oid="x", op=2,
                                           data=b"plain " * 400))
            msg = await asyncio.wait_for(got, 10)
            assert msg.data == b"plain " * 400
            await cli.shutdown()
            await srv.shutdown()

        asyncio.run(go())

"""Async messenger: connections, dispatch, typed messages.

Behavioral twin of the reference messenger layer (src/msg/Messenger.h,
src/msg/async/AsyncMessenger.cc): an entity (osd.3, mon.0, client.17)
owns one Messenger; connections are established lazily by address,
carry a HELLO handshake (peer identity exchange, ProtocolV2.cc
HelloFrame), and deliver typed messages to the owner's dispatcher.
The asyncio event loop plays the role of the reference's epoll worker
threads; per-connection send serialization replaces the write-queue
locks.

Messages subclass :class:`Message` and register a wire type id; the
MESSAGE frame is [header segment | payload segment] like the
reference's msgr2 message frames (header: type, source entity, seq).
"""

from __future__ import annotations

import asyncio
import contextlib
import logging
from typing import Awaitable, Callable

from ceph_tpu_torch.msg import frames
from ceph_tpu_torch.msg.denc import Decoder, Encoder

log = logging.getLogger("ceph_tpu_torch.msg")

# bound on the banner/HELLO/auth exchange, both directions (the
# reference's ms_connection_ready_timeout, src/common/options/global
# .yaml.in): a half-open peer must fail the dial, not wedge it
HANDSHAKE_TIMEOUT = 10.0

_REGISTRY: dict[int, type] = {}


class Message:
    """Typed wire message.  Subclasses set ``TYPE`` and implement
    encode_payload/decode_payload."""

    TYPE = 0

    def __init_subclass__(cls, **kw):
        super().__init_subclass__(**kw)
        if cls.TYPE:
            prev = _REGISTRY.setdefault(cls.TYPE, cls)
            assert prev is cls, f"duplicate message type {cls.TYPE}"

    # filled in on receive
    src: tuple[str, int] | None = None
    conn: "Connection | None" = None
    # distributed-tracing context riding the frame header (the jaeger
    # context-propagation role): set by the sender, decoded on receive.
    # None = untraced message (zero wire cost beyond one bool).
    trace = None

    def encode_payload(self, enc: Encoder) -> None:  # pragma: no cover
        raise NotImplementedError

    @classmethod
    def decode_payload(cls, dec: Decoder) -> "Message":  # pragma: no cover
        raise NotImplementedError

    def __repr__(self) -> str:
        return f"<{type(self).__name__}>"


def encode_message(msg: Message, src: tuple[str, int], seq: int) -> list[bytes]:
    head = Encoder()
    head.u32(type(msg).TYPE)
    head.str_(src[0])
    head.i64(src[1])
    head.u64(seq)
    # trace context rides the header, not the payload: every message
    # type propagates it without per-type encode changes (the msgr2
    # frame-extension seam)
    trace = getattr(msg, "trace", None)
    head.bool_(trace is not None)
    if trace is not None:
        trace.encode(head)
    payload = Encoder()
    msg.encode_payload(payload)
    return [head.bytes(), payload.bytes()]


def decode_message(segments: list[bytes]) -> Message:
    dec = Decoder(segments[0])
    mtype = dec.u32()
    src = (dec.str_(), dec.i64())
    _seq = dec.u64()
    trace = None
    if dec.bool_():
        from ceph_tpu_torch.common.tracing import TraceContext

        trace = TraceContext.decode(dec)
    cls = _REGISTRY.get(mtype)
    if cls is None:
        # the typed message set registers itself on import: a process
        # that decodes before importing it still knows every type
        from ceph_tpu_torch.msg import messages  # noqa: F401

        cls = _REGISTRY.get(mtype)
    if cls is None:
        raise frames.FrameError(f"unknown message type {mtype}")
    msg = cls.decode_payload(Decoder(segments[1]))
    msg.src = src
    msg.trace = trace
    return msg


class Connection:
    """One established peer session (reference AsyncConnection)."""

    def __init__(
        self,
        messenger: "Messenger",
        reader: asyncio.StreamReader,
        writer: asyncio.StreamWriter,
        peer: tuple[str, int] | None = None,
    ):
        self.messenger = messenger
        self.reader = reader
        self.writer = writer
        self.peer = peer            # entity, learned in HELLO
        self.peer_addr: tuple[str, int] | None = None  # (host, port), for reconnect
        self._send_lock = asyncio.Lock()
        self._seq = 0
        self._closed = False
        self._reader_task: asyncio.Task | None = None
        # msgr2 SECURE mode: set by the auth handshake; None = crc mode
        self.crypto = None
        # peer authorization from its ticket; None = auth off (allow)
        self.peer_caps: dict[str, str] | None = None
        # negotiated on-wire compressor (None = uncompressed)
        self.compressor = None

    async def send_message(self, msg: Message) -> None:
        if self._closed:
            raise ConnectionError("connection closed")
        # deterministic network emulation (the chaos shim,
        # chaos/netem.py): per-peer partitions raise, one-way drops
        # swallow the message,
        # delay/reorder holds run here — BEFORE the send lock, so a
        # held message is genuinely overtaken on the wire
        shim = self.messenger.netem
        if shim is not None and self.peer is not None:
            if not await shim.on_send(self.messenger.entity, self.peer):
                return
        n = self.messenger.inject_socket_failures
        if n > 0:
            self.messenger._inject_counter += 1
            if self.messenger._inject_counter % n == 0:
                await self.close(notify=True)
                raise ConnectionError("injected socket failure")
        # ms_inject_delay analogue (reference global.yaml.in:1242-1267):
        # per-send latency, for testing fan-out concurrency
        delay = self.messenger.inject_delay
        if delay > 0:
            await asyncio.sleep(delay)
        trace = getattr(msg, "trace", None)
        tracer = self.messenger.tracer
        span_cm = (
            tracer.span(
                "msg_send", ctx=trace, stage="net",
                msg=type(msg).__name__,
                peer=f"{self.peer[0]}.{self.peer[1]}" if self.peer else "?",
            )
            if tracer is not None and trace is not None and trace.sampled
            else contextlib.nullcontext()
        )
        with span_cm:
            async with self._send_lock:
                self._seq += 1
                segs = encode_message(msg, self.messenger.entity, self._seq)
                tag = frames.Tag.MESSAGE
                if (
                    self.compressor is not None
                    and sum(len(s) for s in segs)
                    >= self.messenger.compress_min_size
                ):
                    segs = [self.compressor.compress(s) for s in segs]
                    tag = frames.Tag.MESSAGE_COMPRESSED
                await frames.write_frame(
                    self.writer, tag, segs, crypto=self.crypto
                )

    async def send_messages(self, msgs: list[Message]) -> None:
        """Send a burst of messages back-to-back under ONE send-lock
        hold (the objecter's per-OSD coalescing seam): frames hit the
        wire consecutively with no interleaved waits, so a batch of
        ops to the same primary costs one writer wakeup instead of N.
        Netem/injection semantics stay per-message (a partitioned peer
        drops each message exactly as single sends would)."""
        if self._closed:
            raise ConnectionError("connection closed")
        shim = self.messenger.netem
        if shim is not None and self.peer is not None:
            kept = []
            for m in msgs:
                if await shim.on_send(self.messenger.entity, self.peer):
                    kept.append(m)
            msgs = kept
        if not msgs:
            return
        n = self.messenger.inject_socket_failures
        if n > 0:
            self.messenger._inject_counter += len(msgs)
            if self.messenger._inject_counter % n < len(msgs):
                await self.close(notify=True)
                raise ConnectionError("injected socket failure")
        delay = self.messenger.inject_delay
        if delay > 0:
            await asyncio.sleep(delay)
        tracer = self.messenger.tracer
        async with self._send_lock:
            for msg in msgs:
                trace = getattr(msg, "trace", None)
                span_cm = (
                    tracer.span(
                        "msg_send", ctx=trace, stage="net",
                        msg=type(msg).__name__,
                        peer=(f"{self.peer[0]}.{self.peer[1]}"
                              if self.peer else "?"),
                    )
                    if tracer is not None and trace is not None
                    and trace.sampled
                    else contextlib.nullcontext()
                )
                with span_cm:
                    self._seq += 1
                    segs = encode_message(
                        msg, self.messenger.entity, self._seq)
                    tag = frames.Tag.MESSAGE
                    if (
                        self.compressor is not None
                        and sum(len(s) for s in segs)
                        >= self.messenger.compress_min_size
                    ):
                        segs = [
                            self.compressor.compress(s) for s in segs
                        ]
                        tag = frames.Tag.MESSAGE_COMPRESSED
                    await frames.write_frame(
                        self.writer, tag, segs, crypto=self.crypto
                    )

    async def _run(self) -> None:
        try:
            # frames that arrived interleaved with the connect-side
            # negotiation (see Messenger.connect) are handled first,
            # in arrival order
            for tag, segs in getattr(self, "_preread", ()):  # noqa: B020
                await self._handle_frame(tag, segs)
            self._preread = ()
            while not self._closed:
                tag, segs = await frames.read_frame(
                    self.reader, crypto=self.crypto
                )
                await self._handle_frame(tag, segs)
        except (
            asyncio.IncompleteReadError, ConnectionError, OSError
        ) as e:
            if not self._closed:
                log.debug("%s: connection lost: %r", self.messenger.entity, e)
        except asyncio.CancelledError:
            pass  # cancelled by local close(); nothing to notify
        finally:
            await self.close(notify=True)

    async def _handle_frame(self, tag: int, segs: list) -> None:
        if getattr(self, "_needs_auth_proof", False):
            # first frame decrypted+authenticated: the peer
            # holds the session key; NOW adopt it for routing
            self._needs_auth_proof = False
            await self.messenger._register(self)
        if tag in (frames.Tag.MESSAGE,
                   frames.Tag.MESSAGE_COMPRESSED):
            if tag == frames.Tag.MESSAGE_COMPRESSED:
                if self.compressor is None:
                    raise frames.FrameError(
                        "compressed frame on an unnegotiated "
                        "connection")
                segs = [
                    self.compressor.decompress(s) for s in segs
                ]
            msg = decode_message(segs)
            msg.conn = self
            tracer = self.messenger.tracer
            if (tracer is not None and msg.trace is not None
                    and msg.trace.sampled):
                # a zero-length arrival marker: the collector pairs it
                # with the sender's msg_send span to bound wire time
                with tracer.span(
                    "msg_recv", ctx=msg.trace, stage="net",
                    msg=type(msg).__name__,
                ):
                    pass
            await self.messenger._dispatch(msg)
        elif tag == frames.Tag.COMPRESSION_REQUEST:
            # inbound negotiation (compression_onwire.cc server
            # role): pick the first of the peer's algorithms we
            # have; empty reply = stay uncompressed
            from ceph_tpu_torch import compressor as _comp

            offered = segs[0].decode().split(",") if segs[0] else []
            if self.messenger.compress_mode == "none":
                offered = []  # 'none = never': refuse politely
            picked = next(
                (a for a in offered
                 if a != "none" and a in _comp.available()), "")
            await frames.write_frame(
                self.writer, frames.Tag.COMPRESSION_DONE,
                [picked.encode()], crypto=self.crypto,
            )
            if picked:
                self.compressor = _comp.create(picked)
        elif tag == frames.Tag.KEEPALIVE2:
            await frames.write_frame(
                self.writer, frames.Tag.KEEPALIVE2_ACK, segs,
                crypto=self.crypto,
            )
        elif tag == frames.Tag.CLOSE:
            raise ConnectionError("peer closed")

    async def close(self, notify: bool = False) -> None:
        if self._closed:
            return
        self._closed = True
        self.messenger._forget(self)
        try:
            self.writer.close()
        except Exception:
            pass
        try:
            task = self._reader_task
            if task is not None and task is not asyncio.current_task():
                task.cancel()
        except RuntimeError:
            return  # event loop already torn down
        if notify:
            await self.messenger._handle_reset(self)


class Messenger:
    """Owns the listener + connection table for one entity."""

    def __init__(
        self,
        entity: tuple[str, int],
        dispatcher: Callable[[Message], Awaitable[None]] | None = None,
        on_reset: Callable[[Connection], Awaitable[None]] | None = None,
        auth=None,
        compress_mode: str = "none",
        compress_algorithm: str = "zlib",
        compress_min_size: int = 1024,
        handshake_timeout: float = HANDSHAKE_TIMEOUT,
    ):
        self.entity = entity
        # ms_connection_ready_timeout role: raise on deployments whose
        # event loops stall for seconds (e.g. many daemons + kernel
        # builds contending for few cores) or false timeouts cascade
        # into false failure reports
        self.handshake_timeout = handshake_timeout
        self.dispatcher = dispatcher
        self.on_reset = on_reset
        # AuthContext (ceph_tpu_torch.msg.auth) => cephx handshake + SECURE
        # frames on every connection; None => legacy crc mode
        self.auth = auth
        # on-wire compression (reference compression_onwire.cc +
        # compressor_registry.cc): 'force' negotiates on every outbound
        # connection; inbound always answers requests with the best
        # mutually available algorithm
        self.compress_mode = compress_mode
        self.compress_algorithm = compress_algorithm
        self.compress_min_size = compress_min_size
        self._server: asyncio.base_events.Server | None = None
        self._conns: dict[tuple[str, int], Connection] = {}  # by entity
        # every live connection needs a strong root: asyncio's
        # StreamReaderProtocol only holds the reader WEAKLY (py3.8+), so
        # an un-referenced Connection/reader-task cycle would be
        # garbage-collected mid-session, silently closing the socket —
        # which the peer misreads as a daemon failure
        self._live: set[Connection] = set()
        self._connect_locks: dict[tuple[str, int], asyncio.Lock] = {}
        self.addr: tuple[str, int] | None = None
        #: set by shutdown(): no session may start after it
        self._shut = False
        # fault injection (reference ms_inject_socket_failures,
        # src/common/options/global.yaml.in:1242): every Nth outgoing
        # message tears the connection down instead of sending
        self.inject_socket_failures = 0
        self._inject_counter = 0
        # ms_inject_delay analogue: seconds of latency added to every
        # outgoing message (0 = off)
        self.inject_delay = 0.0
        # deterministic chaos shim (chaos/netem.py's Netem attaches
        # itself here); None = transparent
        self.netem = None
        # the owning daemon's Tracer: messages carrying a SAMPLED
        # trace context get msg_send/msg_recv spans (stage=net), the
        # wire legs of the cluster-wide span tree; None = no messenger
        # spans (clients of the raw messenger)
        self.tracer = None

    async def _dispatch(self, msg: Message) -> None:
        if self.dispatcher is not None:
            await self.dispatcher(msg)

    async def _handle_reset(self, conn: Connection) -> None:
        if self.on_reset is not None:
            await self.on_reset(conn)

    def _forget(self, conn: Connection) -> None:
        self._live.discard(conn)
        if conn.peer is not None and self._conns.get(conn.peer) is conn:
            del self._conns[conn.peer]

    # -- server side ---------------------------------------------------

    async def bind(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._accept, host, port)
        sock = self._server.sockets[0]
        self.addr = sock.getsockname()[:2]
        return self.addr

    async def _accept(
        self, reader: asyncio.StreamReader, writer: asyncio.StreamWriter
    ) -> None:
        conn = Connection(self, reader, writer)

        async def _handshake() -> None:
            await frames.send_banner(writer)
            await frames.recv_banner(reader)
            # HELLO: peer introduces itself first, then we do
            tag, segs = await frames.read_frame(reader)
            if tag != frames.Tag.HELLO:
                raise frames.FrameError(f"expected HELLO, got {tag}")
            dec = Decoder(segs[0])
            conn.peer = (dec.str_(), dec.i64())
            enc = Encoder()
            enc.str_(self.entity[0])
            enc.i64(self.entity[1])
            await frames.write_frame(writer, frames.Tag.HELLO, [enc.bytes()])
            if self.auth is not None:
                await self._auth_accept(conn)

        try:
            # a dialer that accepted TCP but never completes the
            # banner/HELLO must not pin this task forever (the
            # reference's ms_connection_ready_timeout role)
            await asyncio.wait_for(_handshake(), self.handshake_timeout)
        except (ConnectionError, asyncio.IncompleteReadError, OSError,
                PermissionError, asyncio.TimeoutError):
            writer.close()
            return
        if self._shut:
            # accepted before shutdown(), handshaken after it: a session
            # kept now would feed a stopped daemon its peers' messages,
            # and its answers come from a map frozen at the stop
            writer.close()
            return
        if not getattr(conn, "_needs_auth_proof", False):
            await self._register(conn)
        self._live.add(conn)
        conn._reader_task = asyncio.ensure_future(conn._run())

    async def _register(self, conn: Connection) -> None:
        """Latest connection wins per peer for OUTBOUND routing, but the
        displaced one is NEVER closed here.

        Closing it would tear down a session whose in-flight sub-ops the
        far side misreads as a daemon failure (false MOSDFailure) — so
        cross-dials (A dials B while B dials A) simply leave both
        sockets open, replies always travel on the connection the
        request arrived on, and a displaced predecessor drains until its
        own EOF.  Routing to the NEWEST connection matters when a peer
        restarts and re-dials: the old socket may look healthy locally
        for minutes while every send into it would stall."""
        self._conns[conn.peer] = conn

    # -- client side ---------------------------------------------------

    async def connect_to(
        self, peer: tuple[str, int], host: str, port: int
    ) -> Connection:
        """Connection to a known peer, deduplicated: reuses a live
        session (either direction) and serializes concurrent dials so
        only one socket per peer exists."""
        conn = self._conns.get(peer)
        if conn is not None and not conn._closed:
            return conn
        lock = self._connect_locks.setdefault(peer, asyncio.Lock())
        async with lock:
            conn = self._conns.get(peer)
            if conn is not None and not conn._closed:
                return conn
            conn = await self.connect(host, port)
            if conn.peer != peer:
                await conn.close()
                raise ConnectionError(
                    f"dialed {host}:{port} expecting {peer}, got {conn.peer}"
                )
            return conn

    async def connect(self, host: str, port: int) -> Connection:
        """Dial, then handshake bounded by HANDSHAKE_TIMEOUT: a
        half-open peer (accepted TCP, wedged before HELLO) must surface
        as ConnectionError, not hang the dial — connect_to holds the
        per-peer dial lock, so an unbounded dial would wedge EVERY
        future message to that peer (found by the interleaving fuzzer,
        tests/test_interleave_fuzz.py).

        The TCP connect itself is deliberately NOT under the timeout:
        on the loopback deployments we run, connect() either completes
        or refuses immediately, and cancelling asyncio's sock_connect
        mid-flight leaves a stale selector registration that a reused
        fd number then trips over (the CPython _sock_write_done /
        _ensure_fd_no_transport race — also fuzzer-found)."""
        reader, writer = await asyncio.open_connection(host, port)
        try:
            return await asyncio.wait_for(
                self._handshake_out(reader, writer, host, port),
                self.handshake_timeout)
        except asyncio.TimeoutError:
            writer.close()
            raise ConnectionError(
                f"handshake with {host}:{port} timed out") from None
        except BaseException:
            # handshake failure: the socket must not leak (the
            # retrying callers re-dial every pass)
            writer.close()
            raise

    async def _handshake_out(self, reader, writer, host, port) -> Connection:
        conn = Connection(self, reader, writer)
        conn.peer_addr = (host, port)
        await frames.recv_banner(reader)
        await frames.send_banner(writer)
        enc = Encoder()
        enc.str_(self.entity[0])
        enc.i64(self.entity[1])
        await frames.write_frame(writer, frames.Tag.HELLO, [enc.bytes()])
        tag, segs = await frames.read_frame(reader)
        if tag != frames.Tag.HELLO:
            raise frames.FrameError(f"expected HELLO, got {tag}")
        dec = Decoder(segs[0])
        conn.peer = (dec.str_(), dec.i64())
        if self.auth is not None:
            await self._auth_connect(conn)
        if self.compress_mode == "force":
            # client-driven negotiation (COMPRESSION_REQUEST before the
            # reader loop starts; the acceptor answers from its loop)
            from ceph_tpu_torch import compressor as _comp

            offer = ",".join(
                [self.compress_algorithm]
                + [a for a in _comp.available()
                   if a not in (self.compress_algorithm, "none")]
            )
            await frames.write_frame(
                writer, frames.Tag.COMPRESSION_REQUEST,
                [offer.encode()], crypto=conn.crypto,
            )
            # the acceptor registers us for routing before its reader
            # loop answers the request, so its own traffic can arrive
            # interleaved ahead of COMPRESSION_DONE: buffer it (the
            # reader task drains _preread first)
            preread = []
            while True:
                tag, segs = await frames.read_frame(
                    reader, crypto=conn.crypto)
                if tag == frames.Tag.COMPRESSION_DONE:
                    break
                preread.append((tag, segs))
                if len(preread) > 256:
                    raise frames.FrameError(
                        "no COMPRESSION_DONE in 256 frames")
            conn._preread = preread
            picked = segs[0].decode()
            if picked:
                conn.compressor = _comp.create(picked)
        if self._shut:
            raise ConnectionError(f"{self.entity} shut down during a dial")
        await self._register(conn)
        self._live.add(conn)
        conn._reader_task = asyncio.ensure_future(conn._run())
        return conn

    # -- cephx handshake (see msg/auth.py) ------------------------------

    async def _auth_connect(self, conn: Connection) -> None:
        """Outbound side: present a ticket (cluster daemons self-mint;
        clients use the one granted by the mon) or, first mon contact,
        request a grant.  Ends with the connection in SECURE mode."""
        import os as _os

        from ceph_tpu_torch.msg.auth import FrameCrypto

        a = self.auth
        nonce_c = _os.urandom(12)
        if a.service_secret is not None:
            ticket, session_key = a.self_ticket()
        elif a.ticket is not None:
            ticket, session_key = a.ticket, a.session_key
        else:
            ticket, session_key = None, None  # mon grant flow
        enc = Encoder()
        enc.str_(a.entity)
        enc.bool_(ticket is not None)
        enc.bytes_(ticket or b"")
        enc.bytes_(nonce_c)
        await frames.write_frame(
            conn.writer, frames.Tag.AUTH_REQUEST, [enc.bytes()]
        )
        tag, segs = await frames.read_frame(conn.reader)
        if tag != frames.Tag.AUTH_DONE:
            raise frames.FrameError(f"expected AUTH_DONE, got {tag}")
        dec = Decoder(segs[0])
        granted = dec.bool_()
        sealed = dec.bytes_()
        nonce_s = dec.bytes_()
        if granted:
            try:
                session_key, new_ticket = a.open_grant(sealed)
            except Exception as e:  # InvalidTag: not sealed for OUR key
                raise frames.FrameError(
                    f"grant not decryptable with our secret: {e}"
                )
            # keep the grant for subsequent OSD dials (client flow)
            a.ticket, a.session_key = new_ticket, session_key
        if session_key is None:
            raise frames.FrameError("auth refused")
        conn.crypto = FrameCrypto.from_session(
            session_key, nonce_c, nonce_s, connector=True
        )

    async def _auth_accept(self, conn: Connection) -> None:
        import os as _os

        from ceph_tpu_torch.msg.auth import FrameCrypto, open_ticket

        a = self.auth
        tag, segs = await frames.read_frame(conn.reader)
        if tag != frames.Tag.AUTH_REQUEST:
            raise frames.FrameError(f"expected AUTH_REQUEST, got {tag}")
        dec = Decoder(segs[0])
        entity = dec.str_()
        has_ticket = dec.bool_()
        ticket = dec.bytes_()
        nonce_c = dec.bytes_()
        nonce_s = _os.urandom(12)
        if has_ticket:
            if a.service_secret is None:
                raise PermissionError("cannot validate tickets")
            try:
                t_entity, session_key, peer_caps = open_ticket(
                    a.service_secret, ticket)
            except PermissionError:
                raise
            except Exception as e:  # InvalidTag / malformed blob
                raise PermissionError(f"bad ticket: {type(e).__name__}")
            if t_entity != entity:
                raise PermissionError(
                    f"ticket entity {t_entity!r} != claimed {entity!r}"
                )
            # authorization rides the ticket (AuthCapsInfo): op
            # admission reads it off the connection
            conn.peer_caps = peer_caps
            enc = Encoder()
            enc.bool_(False)
            enc.bytes_(b"")
            enc.bytes_(nonce_s)
            await frames.write_frame(
                conn.writer, frames.Tag.AUTH_DONE, [enc.bytes()]
            )
        else:
            res = a.grant(entity)
            if res is None:
                raise PermissionError(f"unknown entity {entity!r}")
            sealed, session_key, _ticket, peer_caps = res
            conn.peer_caps = peer_caps
            enc = Encoder()
            enc.bool_(True)
            enc.bytes_(sealed)
            enc.bytes_(nonce_s)
            await frames.write_frame(
                conn.writer, frames.Tag.AUTH_DONE, [enc.bytes()]
            )
        # the claimed entity must match the HELLO identity
        kind, _, num = entity.partition(".")
        try:
            claimed = (kind, int(num))
        except ValueError:
            raise PermissionError(f"malformed entity {entity!r}")
        if conn.peer != claimed:
            raise PermissionError(
                f"auth entity {entity!r} != hello identity {conn.peer}"
            )
        conn.crypto = FrameCrypto.from_session(
            session_key, nonce_c, nonce_s, connector=False
        )
        # identity is CLAIMED until the peer proves possession of the
        # session key by sending a frame that authenticates: outbound
        # routing must not be hijackable by a keyless impostor
        conn._needs_auth_proof = True

    def get_connection(self, peer: tuple[str, int]) -> Connection | None:
        return self._conns.get(peer)

    async def shutdown(self) -> None:
        self._shut = True
        if self._server is not None:
            self._server.close()
        # close connections FIRST: in py3.12 Server.wait_closed() also
        # waits for accepted transports, which our reader tasks hold open
        for conn in list(self._conns.values()) + list(self._live):
            await conn.close()
        self._conns.clear()
        self._live.clear()
        await asyncio.sleep(0)  # let cancelled reader tasks unwind
        if self._server is not None:
            try:
                await asyncio.wait_for(self._server.wait_closed(), 2)
            except asyncio.TimeoutError:
                pass

"""A session whose handshake ends after its messenger shut down is closed,
not kept.

The fault the port shares with the reference: a daemon is stopped while a
peer's dial to it is between the TCP accept and the end of the handshake.
``Messenger.shutdown`` closes the listener and every session it knows,
then the handshake ends and ``_accept`` registers the session anyway.  The
stopped daemon keeps it and answers on it from the map it held at its
stop.  In ``test_torch_snaps::TestSnapsUnderThrash`` under load that was a
killed OSD's primary: the client's session to it outlived it, and every
resend of a snapshot read bounced EAGAIN from a daemon that could no
longer reach its peers (their new addresses came in maps it never got),
until the test's limit.

The case below holds a dialer's handshake until the acceptor has shut
down, then lets it finish and sends one message.  The port's acceptor
closes the session and dispatches nothing; the reference's registers it
and dispatches the message (asserted: it keeps the fault)."""

from __future__ import annotations

import asyncio
import importlib

import pytest

from tests.test_torch_cluster_parity import PORT, REF
from tests.test_torch_mini_cluster import run


@pytest.mark.parametrize("pkg", [PORT, REF])
def test_session_handshaken_after_shutdown_is_closed(pkg):
    m = importlib.import_module(f"{pkg}.msg.messenger")
    messages = importlib.import_module(f"{pkg}.msg.messages")

    async def go():
        got = []

        async def dispatch(msg):
            got.append(msg)

        server = m.Messenger(("osd", 6), dispatch)
        accepted = asyncio.Event()
        accept = server._accept

        async def held_accept(reader, writer):
            accepted.set()
            await accept(reader, writer)

        server._accept = held_accept
        host, port = await server.bind()
        gate = asyncio.Event()

        class HeldDialer(m.Messenger):
            async def _handshake_out(self, reader, writer, h, p):
                await gate.wait()
                return await super()._handshake_out(reader, writer, h, p)

        client = HeldDialer(("client", 1))
        dial = asyncio.ensure_future(client.connect(host, port))
        await asyncio.wait_for(accepted.wait(), 10)  # the acceptor holds the socket
        await server.shutdown()
        gate.set()
        try:
            conn = await asyncio.wait_for(dial, 10)
            await conn.send_message(messages.MOSDOpReply(tid=7))
        except (ConnectionError, OSError, asyncio.IncompleteReadError):
            conn = None
        await asyncio.sleep(0.5)
        try:
            if pkg == REF:
                # the stopped acceptor kept the session and dispatched on it
                assert conn is not None and [x.tid for x in got] == [7]
                assert server._live
                return
            assert got == []
            assert not server._live and not server._conns
            assert conn is None or conn._closed
        finally:
            await client.shutdown()
            await server.shutdown()

    run(go())


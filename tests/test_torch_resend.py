"""The client resends an op that bounces or whose OSD session dies, as
Ceph's Objecter does.

Two faults the port shares with the reference, each run over both
packages on a cluster of three OSDs and a replicated pool of size 2:

- **No resend budget.**  The op's primary answers EAGAIN until a newer
  map arrives.  Ceph's Objecter resends on every new map until the op's
  own deadline; the reference's objecter counts every bounce and fails
  the op after 25, while a dead OSD is still up in the map (the chaos
  scenario ``compose_load`` lost EC writes so, ``RadosError(11, ...
  failed after 25 tries)``).  The port's op completes once the map
  moves.
- **The session reset.**  The op's primary is killed while the op waits
  there on a sub-op that its replica never answers.  The port's client
  fails the attempt when the session resets and resends to the new
  primary (``Objecter::ms_handle_reset``); the reference's waits out its
  attempt timeout first (``compose_load``'s 30 s runs).

A third case holds the port's writer to the attempts still live after
its dial: an op whose attempt times out while the dial is on is dropped
from the burst, and the rest of the burst still goes out.

The reference's side of each case is asserted red: it keeps the fault.
The daemons run on the CPU; the reference's compile privately
(tests/xla_private.py)."""

from __future__ import annotations

import asyncio
import errno
import importlib

import pytest

from tests.test_torch_cluster_parity import PORT, REF, MixedCluster
from tests.test_torch_mini_cluster import run
from tests.xla_private import _private_xla_compiles  # noqa: F401

#: EAGAIN rounds the primary answers before the map moves (> 25)
ROUNDS = 30
#: the attempt timeout for the reset case (30 s in both packages)
HELD = 10.0


def _acting(c, io, oid: str) -> tuple[list[int], int]:
    om = c.client.osdmap
    pool = om.get_pg_pool(io.pool_id)
    pg = importlib.import_module(f"{c.osd_pkgs[0]}.osd.daemon").object_to_pg(pool, oid)
    _, _, acting, primary = om.pg_to_up_acting_osds(pg)
    return acting, primary


@pytest.mark.parametrize("pkg", [PORT, REF])
def test_op_bouncing_eagain_completes_on_a_new_map(pkg, monkeypatch):
    # a short backoff, so that 30 rounds take well under a second
    monkeypatch.setattr(importlib.import_module(f"{pkg}.client.rados"), "BACKOFF_MAX", 0.02)
    messages = importlib.import_module(f"{pkg}.msg.messages")

    async def go():
        async with MixedCluster(pkg, pkg, [pkg] * 3) as c:
            await c.client.pool_create("rep", pg_num=1, size=2)
            io = c.client.ioctx("rep")
            await io.write_full("o", b"v1")
            osd = c.osds[_acting(c, io, "o")[1]]
            e0 = c.client.osdmap.epoch
            bounces = 0
            enough = asyncio.Event()
            handle = osd._handle_client_op

            async def bouncing(msg):
                nonlocal bounces
                if msg.oid == "o" and osd.epoch <= e0:
                    bounces += 1
                    if bounces > ROUNDS:
                        enough.set()
                    await msg.conn.send_message(messages.MOSDOpReply(
                        tid=msg.tid, result=-errno.EAGAIN, epoch=osd.epoch))
                    return
                await handle(msg)

            osd._handle_client_op = bouncing
            write = asyncio.ensure_future(io.write_full("o", b"v2"))
            waiting = asyncio.ensure_future(enough.wait())
            await asyncio.wait([write, waiting], timeout=60,
                               return_when=asyncio.FIRST_COMPLETED)
            waiting.cancel()
            if pkg == REF:
                with pytest.raises(OSError, match="failed after 25 tries"):
                    await write
                assert bounces == 25
                return
            assert enough.is_set() and not write.done()
            await c.client.pool_create("other", pg_num=1, size=2)  # the map moves
            await asyncio.wait_for(write, 30)
            assert bounces > ROUNDS
            assert await io.read("o") == b"v2"

    run(go())


@pytest.mark.parametrize("pkg", [PORT, REF])
def test_op_at_a_killed_primary_resends_on_the_session_reset(pkg, monkeypatch):
    monkeypatch.setattr(importlib.import_module(f"{pkg}.client.objecter"),
                        "ATTEMPT_TIMEOUT", HELD)

    async def go():
        async with MixedCluster(pkg, pkg, [pkg] * 3) as c:
            await c.client.pool_create("rep", pg_num=1, size=2)
            io = c.client.ioctx("rep")
            await io.write_full("o", b"v1")
            acting, primary = _acting(c, io, "o")
            replica = c.osds[next(o for o in acting if o != primary)]
            arrived = asyncio.Event()
            handle = replica._handle_rep_op

            async def swallow(msg):
                # the first replicated write of "o" is never answered
                if msg.oid == "o" and not arrived.is_set():
                    arrived.set()
                    return
                await handle(msg)

            replica._handle_rep_op = swallow
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            write = asyncio.ensure_future(io.write_full("o", b"v2"))
            await asyncio.wait_for(arrived.wait(), 30)
            victim, c.osds[primary] = c.osds[primary], None
            await victim.stop()
            code, _, _ = await c.client.command({"prefix": "osd down", "id": str(primary)})
            assert code == 0
            await asyncio.wait_for(write, 60)
            took = loop.time() - t0
            assert await io.read("o") == b"v2"
            if pkg == REF:
                # the client waited out its attempt timeout
                assert took >= HELD
                return
            assert took < HELD / 2, took

    run(go())



def test_attempt_given_up_while_its_writer_dials(monkeypatch):
    """Two ops share one burst to their primary, and the dial outlasts the
    first op's own deadline: its driver fails it and clears its attempt.
    The second must still be sent at the dial's end, not wait out
    ``ATTEMPT_TIMEOUT`` for a frame that never went."""
    objecter = importlib.import_module(f"{PORT}.client.objecter")
    monkeypatch.setattr(objecter, "ATTEMPT_TIMEOUT", HELD)
    rados = importlib.import_module(f"{PORT}.client.rados")

    async def go():
        async with MixedCluster(PORT, PORT, [PORT] * 3) as c:
            await c.client.pool_create("rep", pg_num=1, size=2)
            io = c.client.ioctx("rep")
            await io.write_full("o", b"v1")
            _, primary = _acting(c, io, "o")
            messenger = c.client.messenger
            dial = messenger.connect_to
            released = asyncio.Event()
            held = []

            async def slow(peer, host, port):
                if peer == ("osd", primary) and not held:
                    held.append(peer)
                    await released.wait()
                return await dial(peer, host, port)

            messenger.connect_to = slow
            loop = asyncio.get_running_loop()
            c.client.op_timeout = 0.6
            early = asyncio.ensure_future(io.write_full("a", b"A"))
            await asyncio.sleep(0)
            c.client.op_timeout = 120.0
            late = asyncio.ensure_future(io.write_full("b", b"B"))
            with pytest.raises(rados.RadosError) as e:
                await asyncio.wait_for(early, 5)
            assert e.value.errno == errno.ETIMEDOUT
            assert held and not late.done()
            t0 = loop.time()
            released.set()
            await asyncio.wait_for(late, 2 * HELD)
            assert loop.time() - t0 < HELD / 2
            assert await io.read("b") == b"B"

    run(go())

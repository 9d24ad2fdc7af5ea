"""Async client plane end to end: the aio/batched path must sustain
a multiple of the serial client's throughput on the SAME cluster with
zero lost or corrupt acked writes — the PR's acceptance bar — plus
the backpressure window and per-OSD coalescing behaviors.

The port's twin of tests/integration/test_async_client.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import time

from ceph_tpu_torch.common import ConfigProxy

from tests.test_torch_mini_cluster import Cluster, run

N_OPS = 200


def _payload(i: int) -> bytes:
    return (f"async-{i}|".encode() * 64)[:512]


class TestAsyncThroughput:
    def test_async_path_sustains_5x_serial(self):
        """Serial = await each write round trip; async = submit all
        through the objecter window and await completions.  Same
        cluster, same client, same object sizes — under a realistic
        injected wire latency (the reference's ms_inject_delay knob:
        in-process loopback has ~zero network cost, which is exactly
        the cost an async client exists to pipeline over).  The
        serial client pays the latency per op; the objecter overlaps
        it and must deliver >= 5x the ops/s, with EVERY acked write
        reading back bit-exact."""
        async def go():
            async with Cluster(n_osds=4) as c:
                from ceph_tpu_torch.client import RadosClient

                cl = RadosClient(client_id=7779)
                await cl.connect_multi([c.mon.addr])
                try:
                    await cl.pool_create("p", pg_num=8, size=2)
                    io = cl.ioctx("p")
                    # 15ms client->osd wire latency, both paths (the
                    # serial client pays it per op; the objecter's
                    # writers amortize it per burst) — high enough
                    # that the 5x bar holds even when the whole suite
                    # contends for CPU and squeezes the async ceiling
                    cl.messenger.inject_delay = 0.015

                    t0 = time.monotonic()
                    for i in range(N_OPS):
                        await io.write_full(
                            f"serial-{i}", _payload(i))
                    serial_s = time.monotonic() - t0

                    t0 = time.monotonic()
                    comps = []
                    for i in range(N_OPS):
                        comps.append(await io.aio_write_full(
                            f"async-{i}", _payload(i)))
                    for comp in comps:
                        reply = await comp.wait()
                        assert reply.result == 0
                    async_s = time.monotonic() - t0

                    # zero lost/corrupt acked writes: every async
                    # object reads back exactly
                    rcomps = [await io.aio_read(f"async-{i}")
                              for i in range(N_OPS)]
                    for i, comp in enumerate(rcomps):
                        reply = await comp.wait()
                        assert reply.result == 0
                        assert reply.data == _payload(i), f"async-{i}"

                    speedup = (N_OPS / async_s) / (N_OPS / serial_s)
                    assert speedup >= 5.0, (
                        f"async {N_OPS / async_s:.0f} ops/s vs serial "
                        f"{N_OPS / serial_s:.0f} ops/s = "
                        f"{speedup:.1f}x")

                    # the per-OSD writers coalesced ops into shared
                    # wire bursts (frames back-to-back, one lock hold)
                    perf = cl.objecter.perf.dump()
                    assert perf["ops_sent"] >= 2 * N_OPS
                    assert perf["coalesced_ops"] > 0
                    assert perf["wire_bursts"] < perf["ops_sent"]
                finally:
                    await cl.shutdown()
        run(go())


class TestBackpressureWindow:
    def test_inflight_ops_window_blocks_submitters(self):
        """objecter_inflight_ops=4: a 40-op burst must park
        submitters (backpressure_waits grows), never exceed 4 in
        flight, and still complete everything."""
        async def go():
            conf = ConfigProxy({"objecter_inflight_ops": 4})
            async with Cluster(n_osds=3) as c:
                from ceph_tpu_torch.client import RadosClient

                cl = RadosClient(client_id=7777, conf=conf)
                await cl.connect_multi([c.mon.addr])
                try:
                    await cl.pool_create("bp", pg_num=4, size=2)
                    io = cl.ioctx("bp")
                    peaks = []
                    comps = []
                    for i in range(40):
                        comps.append(await io.aio_write_full(
                            f"o-{i}", b"x" * 128))
                        peaks.append(cl.objecter._inflight)
                    for comp in comps:
                        assert (await comp.wait()).result == 0
                    assert max(peaks) <= 4
                    assert cl.objecter._inflight == 0
                    d = cl.objecter.perf.dump()
                    assert d["backpressure_waits"] > 0
                    # mon commands (pool create) bypass the objecter:
                    # exactly the 40 data ops completed through it
                    assert d["ops_completed"] == 40
                finally:
                    await cl.shutdown()
        run(go())

    def test_byte_window_admits_oversized_op_alone(self):
        """An op bigger than the whole byte budget still runs (alone)
        instead of deadlocking the window."""
        async def go():
            conf = ConfigProxy({"objecter_inflight_op_bytes": 1024})
            async with Cluster(n_osds=3) as c:
                from ceph_tpu_torch.client import RadosClient

                cl = RadosClient(client_id=7778, conf=conf)
                await cl.connect_multi([c.mon.addr])
                try:
                    await cl.pool_create("big", pg_num=4, size=2)
                    io = cl.ioctx("big")
                    comp = await io.aio_write_full("huge", b"z" * 8192)
                    assert (await comp.wait()).result == 0
                    assert await io.read("huge") == b"z" * 8192
                finally:
                    await cl.shutdown()
        run(go())


class TestCompletionSurface:
    def test_callbacks_and_latency(self):
        async def go():
            async with Cluster(n_osds=3) as c:
                await c.client.pool_create("cb", pg_num=4, size=2)
                io = c.client.ioctx("cb")
                seen = []
                comp = await io.aio_write_full("obj", b"payload")
                comp.add_done_callback(lambda cc: seen.append(cc))
                reply = await comp.wait()
                await asyncio.sleep(0)  # let the callback fire
                assert reply.result == 0
                assert seen == [comp]
                assert comp.latency is not None and comp.latency > 0
                # compound vectors ride the same engine
                from ceph_tpu_torch.client.rados import ObjectOperation

                wop = ObjectOperation().setxattr(
                    "k", b"v").append(b"-more")
                comp2 = await io.aio_operate("obj", wop)
                assert (await comp2.wait()).result == 0
                assert await io.getxattr("obj", "k") == b"v"
                assert await io.read("obj") == b"payload-more"
        run(go())

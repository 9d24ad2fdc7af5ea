"""Objecter behavior under client-link partitions (the chaos
client-netem scenario's unit-level twin): the per-op driver's
deadline/backoff/map-wait machinery against REAL netem cuts.

- the deadline fires as ETIMEDOUT, never a hang, when the client is
  cut off from the data plane;
- an ACK lost to a one-way drop is healed by the jittered resend and
  deduplicated by reqid — the op applies exactly once;
- a peer OSD dying mid-burst drains the bounded in-flight window
  cleanly: every completion resolves after the remap, nothing leaks.

The port's twin of tests/integration/test_client_partition.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio
import errno

import pytest

from ceph_tpu_torch.chaos.netem import Netem
from ceph_tpu_torch.client.rados import RadosError

from tests.test_torch_mini_cluster import Cluster, run

FAST_DOWN = {"mon_osd_beacon_grace": 0.6}
FAST_BEACON = {"osd_beacon_report_interval": 0.15}


class TestDeadlineUnderPartition:
    def test_full_partition_times_out_not_hangs(self):
        async def go():
            async with Cluster(
                n_osds=3, mon_conf=FAST_DOWN, osd_conf=FAST_BEACON,
            ) as c:
                await c.client.pool_create("dp", pg_num=4, size=2)
                io = c.client.ioctx("dp")
                await io.write_full("pre", b"before the cut")
                netem = Netem()
                netem.attach(c.client.messenger)
                # cut the client off from the WHOLE data plane (mon
                # links stay up: maps keep flowing, there is just no
                # one to serve the op)
                netem.partition(("client", None), ("osd", None))
                c.client.op_timeout = 1.5
                loop = asyncio.get_running_loop()
                t0 = loop.time()
                with pytest.raises(RadosError) as ei:
                    await io.write_full("cutoff", b"never lands")
                assert ei.value.errno == errno.ETIMEDOUT
                # the deadline, not an attempt-timeout pileup
                assert loop.time() - t0 < 10.0
                # heal: the SAME handle serves again (no poisoned state)
                netem.clear()
                c.client.op_timeout = 30.0
                await io.write_full("after", b"healed")
                assert await io.read("after") == b"healed"

        run(go())


class TestResendDedup:
    def test_lost_acks_resend_applies_exactly_once(self, monkeypatch):
        """Drop every OSD->client reply for a while: the op APPLIES on
        the first attempt, the ack vanishes, the per-op driver resends
        after its attempt window, and reqid dedup answers without
        re-applying — an append ends up in the object exactly once."""
        import ceph_tpu_torch.client.objecter as objecter_mod

        monkeypatch.setattr(objecter_mod, "ATTEMPT_TIMEOUT", 0.6)

        async def go():
            async with Cluster(
                n_osds=3, mon_conf=FAST_DOWN, osd_conf=FAST_BEACON,
            ) as c:
                await c.client.pool_create("dd", pg_num=4, size=2)
                io = c.client.ioctx("dd")
                await io.write_full("obj", b"base-")
                netem = Netem()
                for osd in c.osds:
                    netem.attach(osd.messenger)
                netem.drop_oneway(("osd", None), ("client", None))

                async def heal():
                    await asyncio.sleep(1.4)
                    netem.clear()

                heal_task = asyncio.ensure_future(heal())
                comp = await io.aio_append("obj", b"X")
                reply = await comp.wait()
                assert reply.result == 0
                await heal_task
                assert netem.stats["dropped_sends"] >= 1
                assert await io.read("obj") == b"base-X"

        run(go())


class TestWindowDrainOnPeerDeath:
    def test_inflight_window_drains_when_osd_dies_mid_burst(self):
        """Saturate the bounded in-flight window, kill an OSD with a
        burst outstanding: the mon marks it down, the drivers re-home
        to the new acting set, every completion resolves, and the
        window + admit queue drain to zero."""
        from ceph_tpu_torch.common import ConfigProxy

        async def go():
            conf = ConfigProxy({"objecter_inflight_ops": 4})
            async with Cluster(
                n_osds=3, mon_conf=FAST_DOWN, osd_conf=FAST_BEACON,
            ) as c:
                # swap in a tight-window client against the same mon
                from ceph_tpu_torch.client import RadosClient

                cl = RadosClient(client_id=477, conf=conf,
                                 op_timeout=60.0)
                await cl.connect(*c.mon.addr)
                try:
                    await c.client.pool_create("wd", pg_num=8, size=2)
                    io = cl.ioctx("wd")
                    comps = []
                    for i in range(12):
                        comps.append(await io.aio_write_full(
                            f"o{i}", f"v-{i}".encode() * 64))
                    # kill mid-burst; the remap serves the rest
                    victim = c.osds[2]
                    c.osds[2] = None
                    await victim.stop()
                    for comp in comps:
                        reply = await comp.wait()
                        assert reply.result == 0
                    dump = cl.objecter.dump()
                    assert dump["inflight_ops"] == 0
                    assert dump["inflight_bytes"] == 0
                    assert dump["admit_waiters"] == 0
                    assert not dump["queued"]
                    # every write is readable at its acked content
                    for i in range(12):
                        got = await io.read(f"o{i}")
                        assert got == f"v-{i}".encode() * 64, i
                finally:
                    await cl.shutdown()

        run(go())

"""MClockGate unit tests: admission gating through dmclock ordering
(the OpScheduler seam, reference src/osd/scheduler/mClockScheduler.h).

The port's twin of tests/test_opqueue.py: the same cases over
``ceph_tpu_torch``.
"""

import asyncio

from ceph_tpu_torch.osd.opqueue import MClockGate
from ceph_tpu_torch.osd.scheduler import ClientProfile


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def _gate(max_inflight):
    return MClockGate(max_inflight=max_inflight, profiles={
        "client": ClientProfile(weight=10.0),
        "recovery": ClientProfile(weight=1.0),
    })


def test_disabled_gate_is_transparent():
    async def main():
        g = _gate(0)
        done = []

        async def op(i):
            async with g.admit("client"):
                done.append(i)
                await asyncio.sleep(0.01)

        await asyncio.gather(*[op(i) for i in range(20)])
        assert len(done) == 20
        assert g.stats["admitted"]["client"] == 20
        assert g.stats["peak_inflight"] == 0  # never counted

    run(main())


def test_inflight_bound():
    async def main():
        g = _gate(3)
        inflight = 0
        peak = 0

        async def op():
            nonlocal inflight, peak
            async with g.admit("client"):
                inflight += 1
                peak = max(peak, inflight)
                await asyncio.sleep(0.005)
                inflight -= 1

        await asyncio.gather(*[op() for _ in range(20)])
        assert peak <= 3
        assert g.stats["peak_inflight"] == 3

    run(main())


def test_clients_outrank_recovery_under_saturation():
    async def main():
        g = _gate(1)
        served: list[str] = []
        blocker = g.admit("client")
        await blocker.__aenter__()  # saturate the single slot

        async def op(klass):
            async with g.admit(klass):
                served.append(klass)
                await asyncio.sleep(0)

        # interleave arrivals so neither class wins by queue position
        tasks = []
        for _ in range(5):
            tasks.append(asyncio.ensure_future(op("recovery")))
            tasks.append(asyncio.ensure_future(op("client")))
            await asyncio.sleep(0)
        await blocker.__aexit__(None, None, None)
        await asyncio.gather(*tasks)
        assert len(served) == 10
        # dmclock weights 10:1 — the first 6 grants carry at most one
        # recovery op; clients overtake despite arriving second
        assert served[:6].count("client") >= 5, served

    run(main())


def test_cancelled_waiter_releases_nothing():
    async def main():
        g = _gate(1)
        hold = g.admit("client")
        await hold.__aenter__()

        async def op():
            async with g.admit("client"):
                pass

        t = asyncio.ensure_future(op())
        await asyncio.sleep(0)
        t.cancel()
        try:
            await t
        except asyncio.CancelledError:
            pass
        await hold.__aexit__(None, None, None)
        # the slot must be reusable after the cancelled waiter
        async with g.admit("recovery"):
            pass
        assert g.stats["admitted"]["recovery"] == 1

    run(main())


def test_set_max_inflight_drains_queue():
    async def main():
        g = _gate(1)
        hold = g.admit("client")
        await hold.__aenter__()
        got = asyncio.Event()

        async def op():
            async with g.admit("client"):
                got.set()
                await asyncio.sleep(0.05)

        asyncio.ensure_future(op())
        await asyncio.sleep(0)
        assert not got.is_set()
        g.set_max_inflight(2)
        await asyncio.sleep(0.01)
        assert got.is_set()
        await hold.__aexit__(None, None, None)

    run(main())

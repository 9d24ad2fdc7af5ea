"""AsyncReserver unit tests (src/common/AsyncReserver.h semantics:
slot cap, priority ordering, FIFO within priority, preemption,
cancellation, runtime max change).

The port's twin of tests/test_reserver.py: the same cases over
``ceph_tpu_torch``.
"""

import asyncio

import pytest

from ceph_tpu_torch.common.reserver import AsyncReserver


def run(coro):
    return asyncio.get_event_loop_policy().new_event_loop().run_until_complete(coro)


def test_slot_cap_and_fifo():
    async def main():
        r = AsyncReserver(max_allowed=2)
        a = await r.request("a", 1).wait()
        b = await r.request("b", 1).wait()
        assert r.in_use == 2

        order = []

        async def take(name):
            async with r.request(name, 1):
                order.append(name)
                await asyncio.sleep(0)

        t = [asyncio.ensure_future(take(n)) for n in ("c", "d", "e")]
        await asyncio.sleep(0)
        assert r.queued() == 3
        a.release()
        b.release()
        await asyncio.gather(*t)
        assert order == ["c", "d", "e"]  # FIFO within equal priority
        assert r.peak_granted == 2

    run(main())


def test_priority_ordering():
    async def main():
        r = AsyncReserver(max_allowed=1)
        hold = await r.request("hold", 5).wait()
        order = []

        async def take(name, prio):
            async with r.request(name, prio):
                order.append(name)

        lo = asyncio.ensure_future(take("lo", 1))
        await asyncio.sleep(0)
        hi = asyncio.ensure_future(take("hi", 9))
        await asyncio.sleep(0)
        hold.release()
        await asyncio.gather(lo, hi)
        assert order == ["hi", "lo"]

    run(main())


def test_preemption_signal():
    async def main():
        r = AsyncReserver(max_allowed=1)
        low = await r.request("low", 1).wait()
        assert not low.preempted.is_set()

        async def want_high():
            async with r.request("high", 10):
                pass

        t = asyncio.ensure_future(want_high())
        await asyncio.sleep(0)
        # the queued high-priority request preempts the low holder
        assert low.preempted.is_set()
        low.release()
        await t

    run(main())


def test_cancel_queued_and_granted():
    async def main():
        r = AsyncReserver(max_allowed=1)
        await r.request("a", 1).wait()

        async def take(name):
            await r.request(name, 1).wait()

        t = asyncio.ensure_future(take("b"))
        await asyncio.sleep(0)
        assert r.queued() == 1
        r.cancel("b")
        with pytest.raises(asyncio.CancelledError):
            await t
        assert r.queued() == 0
        # cancelling the granted holder frees the slot
        r.cancel("a")
        assert r.in_use == 0
        c = await r.request("c", 1).wait()
        assert r.has_reservation("c")
        c.release()

    run(main())


def test_set_max_kicks_waiters():
    async def main():
        r = AsyncReserver(max_allowed=1)
        await r.request("a", 1).wait()
        got = asyncio.Event()

        async def take():
            await r.request("b", 1).wait()
            got.set()

        asyncio.ensure_future(take())
        await asyncio.sleep(0)
        assert not got.is_set()
        r.set_max(2)
        await asyncio.sleep(0)
        assert got.is_set()

    run(main())


def test_duplicate_item_reuses_grant():
    async def main():
        r = AsyncReserver(max_allowed=1)
        a1 = await r.request("a", 1).wait()
        a2 = await r.request("a", 1).wait()  # no deadlock, same slot
        assert a1 is a2
        a1.release()
        assert r.in_use == 0

    run(main())

"""Seeded deterministic-interleaving fuzzer for asyncio.

The race-detection analogue of the reference's TSan/valgrind suites
(reference CMakeLists.txt:626-642 WITH_TSAN/WITH_ASAN builds,
qa/suites/rados/valgrind-leaks): our daemons are asyncio tasks in one
process, so data races manifest as *wakeup-order* dependences — task A
observing state mid-update because B yielded at an await point.  The
stock event loop serves its ready queue FIFO, which explores exactly
one interleaving; this loop PERMUTES callback execution order under a
seeded RNG so every seed explores a different legal schedule, and a
failing seed replays the identical schedule for debugging.

Mechanics: ``call_soon`` enqueues normally, then swap-shuffles the new
entry with a random *coroutine-step* entry already in the ready deque.
Only task wakeups are permuted: asyncio guarantees no ordering between
independent tasks, so any permutation is a schedule a real deployment
could exhibit — a failure under some seed is a real bug, not harness
noise.  Transport/protocol callbacks are left in FIFO order (the
streams layer genuinely relies on data_received/eof_received arrival
order — permuting those would fabricate impossible histories).

Usage::

    run_interleaved(lambda: my_scenario(), seed=1234)

or sweep seeds::

    for seed in range(100):
        run_interleaved(lambda: my_scenario(), seed=seed)

On failure the harness raises with the seed in the message so the
schedule can be replayed exactly.
"""

from __future__ import annotations

import asyncio
import random
import selectors


class InterleaveLoop(asyncio.SelectorEventLoop):
    """SelectorEventLoop whose ready-callback order is a seeded
    permutation instead of FIFO."""

    def __init__(self, seed: int):
        super().__init__(selectors.DefaultSelector())
        self._rng = random.Random(seed)
        self.seed = seed
        self._shuffling = True

    @staticmethod
    def _is_task_step(handle) -> bool:
        cb = getattr(handle, "_callback", None)
        return isinstance(getattr(cb, "__self__", None), asyncio.Task)

    #: how far back a new wakeup may jump the queue.  Bounded so the
    #: harness explores reorderings a real loop could plausibly
    #: produce, not unbounded starvation of one task (which no fair
    #: scheduler exhibits and which only wedges the run on timeouts
    #: the code under test legitimately relies on).
    WINDOW = 12

    def _shuffle_ready(self) -> None:
        rdy = self._ready
        n = len(rdy)
        if n < 2 or not self._is_task_step(rdy[-1]):
            return
        # swap the newly appended task wakeup with a resident task
        # wakeup from the CONTIGUOUS task-step suffix — never across a
        # plain callback.  asyncio's own plumbing (e.g. sock_connect's
        # _sock_write_done unregistering an fd before the owning task
        # resumes and closes/reuses it) relies on call_soon FIFO
        # between a plain handle and the task it unblocks; jumping a
        # task over such a handle fabricates schedules no real loop
        # produces (fd-reuse selector corruption, found the hard way).
        lo = max(0, n - 1 - self.WINDOW)
        slots = []
        for i in range(n - 2, lo - 1, -1):
            if not self._is_task_step(rdy[i]):
                break
            slots.append(i)
        if not slots:
            return
        i = self._rng.choice(slots + [n - 1])
        if i != n - 1:
            rdy[i], rdy[n - 1] = rdy[n - 1], rdy[i]

    def call_soon(self, callback, *args, context=None):
        h = super().call_soon(callback, *args, context=context)
        if self._shuffling:
            self._shuffle_ready()
        return h

    def call_soon_threadsafe(self, callback, *args, context=None):
        h = super().call_soon_threadsafe(callback, *args, context=context)
        # no shuffle: mutating _ready from a foreign thread races the
        # loop thread; cross-thread wakeups keep FIFO order
        return h


class InterleaveError(AssertionError):
    """Scenario failure with the seed needed to replay it."""

    def __init__(self, seed: int, cause: BaseException):
        super().__init__(
            f"interleaving failure under seed={seed} "
            f"(replay: run_interleaved(scenario, seed={seed})): "
            f"{type(cause).__name__}: {cause}")
        self.seed = seed
        self.__cause__ = cause


def run_interleaved(scenario_factory, seed: int, timeout: float = 120.0):
    """Run ``scenario_factory()`` (a fresh coroutine) to completion on
    an :class:`InterleaveLoop` seeded with ``seed``.  Failures re-raise
    as :class:`InterleaveError` carrying the seed."""
    loop = InterleaveLoop(seed)
    try:
        return loop.run_until_complete(
            asyncio.wait_for(scenario_factory(), timeout))
    except asyncio.TimeoutError as e:
        raise InterleaveError(seed, e) from e
    except (AssertionError, Exception) as e:
        raise InterleaveError(seed, e) from e
    finally:
        try:
            # drain cancellations so daemon tasks don't leak across
            # seeds
            pending = asyncio.all_tasks(loop)
            for t in pending:
                t.cancel()
            if pending:
                loop._shuffling = False  # deterministic teardown
                loop.run_until_complete(
                    asyncio.gather(*pending, return_exceptions=True))
        finally:
            loop.close()


def sweep(scenario_factory, seeds, timeout: float = 120.0) -> int:
    """Run the scenario under every seed; returns the count of green
    runs, raising on the FIRST failing seed (its number is in the
    exception)."""
    n = 0
    for seed in seeds:
        run_interleaved(scenario_factory, seed, timeout=timeout)
        n += 1
    return n

"""The port's twin of tests/test_interleave_fuzz.py's harness case over
``ceph_tpu_torch.common.interleave``: a failing scenario's error carries
its seed for exact replay.

The sweeps of that file (the mon quorum storm, write/recovery, EC RMW,
cache-tier promote, split, multipart and scrub races) each boot monitors
and OSDs, so they wait for the port's daemons.
"""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.common.interleave import InterleaveError, run_interleaved, sweep


def test_failure_carries_seed():
    async def boom():
        await asyncio.sleep(0)
        raise AssertionError("intentional")

    with pytest.raises(InterleaveError, match="seed=42"):
        run_interleaved(boom, 42)


def test_sweep_counts_green_seeds_and_stops_at_the_first_red():
    seen = []

    async def ok():
        await asyncio.sleep(0)

    assert sweep(ok, range(5)) == 5

    async def third_fails():
        seen.append(len(seen))
        await asyncio.sleep(0)
        if len(seen) == 3:
            raise ValueError("third")

    with pytest.raises(InterleaveError, match="seed=12") as e:
        sweep(third_fails, range(10, 20))
    assert e.value.seed == 12 and len(seen) == 3

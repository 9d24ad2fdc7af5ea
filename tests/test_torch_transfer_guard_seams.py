"""The port's transfer guard (``ceph_tpu_torch/common/transfer_guard.py``)
at its seams, on the CPU: an implicit transfer planted in a guarded
launch is counted in ``host_transfers`` and the launch raises, with no
host answer in its place (the reference answers from its host path);
declared copies pass; a disarmed or ``off`` guard judges nothing.

On the CPU the host is the launch's device, so the planted transfer is
an operand on another device (``meta``), and the op watch that judges a
card's windows is held here on a window over the ``meta`` device.
"""

from __future__ import annotations

import asyncio

import numpy as np
import pytest
import torch

from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.common.metrics import BucketCounters
from ceph_tpu_torch.ops import hashing
from ceph_tpu_torch.parallel import scrub_batcher
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier


@pytest.fixture
def guard(monkeypatch, request):
    """The guard armed on private counters (the process-wide ones are
    read by other tests as absolute counts), disarmed after."""
    monkeypatch.setattr(tg, "_counters", BucketCounters(
        f"transfer_guard_test_{request.node.name}"))
    tg.configure("on")
    yield tg
    tg.disarm()


def test_planted_operand_fails_the_decode_launch(guard, monkeypatch):
    agg = DecodeAggregator(device="cpu", window_s=0.001)
    monkeypatch.setattr(agg, "_bits", lambda D: torch.zeros(
        (8 * D.shape[0], 8 * D.shape[1]), dtype=torch.uint8, device="meta"))
    D = np.eye(2, dtype=np.uint8)
    rows = np.arange(200, dtype=np.uint8).reshape(2, 100)

    async def go():
        return await agg.apply(D, rows)

    with pytest.raises(tg.TransferGuardError, match="decode_batch"):
        asyncio.run(go())
    snap = tg.snapshot()
    assert snap["host_transfers"] == 1 and snap["guard_windows"] == 1
    assert agg.stats["launches"] == 0      # nothing answered in its place


def test_planted_upload_fails_the_scrub_crc_launch(guard, monkeypatch):
    ver = ScrubVerifier(device="cpu", window_s=0.001)
    monkeypatch.setattr(scrub_batcher.tg, "upload", lambda a, d: torch.from_numpy(
        np.ascontiguousarray(a)).to("meta"))

    async def go():
        return await ver.verify_object(None, {0: b"x" * 5000, 1: b"y" * 5000})

    with pytest.raises(tg.TransferGuardError, match="scrub_crc"):
        asyncio.run(go())
    assert tg.snapshot()["host_transfers"] == 1


def test_the_same_launches_pass_when_nothing_is_planted(guard):
    agg = DecodeAggregator(device="cpu", window_s=0.001)
    D = np.array([[1, 1], [1, 2]], dtype=np.uint8)
    rows = np.arange(200, dtype=np.uint8).reshape(2, 100)

    async def go():
        return await agg.apply(D, rows)

    out = asyncio.run(go())
    assert out.shape == (2, 100)
    snap = tg.snapshot()
    assert snap["host_transfers"] == 0 and snap["guard_windows"] == 1


def test_the_crc_operators_go_up_before_the_scrub_window(guard, monkeypatch):
    """The crc kernel's operand block for a width is a host-to-device
    copy: planted lazily inside a ``scrub_crc`` window it is counted and
    raises; ``hashing.prepare`` puts it up before the window, and the
    verifier prepares each bucket's width before its launch's window."""
    monkeypatch.setattr(hashing, "_operators", {})
    meta = torch.device("meta")
    with tg.no_implicit_transfers("scrub_crc", meta):
        with pytest.raises(tg.TransferGuardError, match="scrub_crc"):
            hashing._device_operators(4096, meta)
    assert tg.snapshot()["host_transfers"] == 1
    hashing.prepare(4096, meta)
    with tg.no_implicit_transfers("scrub_crc", meta):
        assert hashing._device_operators(4096, meta).device == meta
    assert tg.snapshot()["host_transfers"] == 1

    seen = []
    monkeypatch.setattr(scrub_batcher, "prepare_crc",
                        lambda w, device: seen.append((w, tg._window())))
    ver = ScrubVerifier(device="cpu", window_s=0.001)

    async def go():
        return await ver.verify_object(None, {0: b"x" * 5000, 1: b"y" * 5000})

    asyncio.run(go())
    assert seen and all(window is None for _, window in seen)
    assert ver.stats["crc_launches"] > 0
    assert tg.snapshot()["host_transfers"] == 1


def test_the_op_watch_judges_copies_across_the_window_device(guard):
    with tg.no_implicit_transfers("probe", "meta"):
        t = tg.upload(np.arange(4, dtype=np.uint8), "meta")   # declared
        assert t.device.type == "meta"
        assert (t + 1).device.type == "meta"                   # no copy
        with pytest.raises(tg.TransferGuardError, match="_to_copy"):
            torch.zeros(3).to("meta")
        with pytest.raises(tg.TransferGuardError, match="operand on cpu"):
            tg.check_operands(torch.zeros(1))
        with tg.declared():
            torch.zeros(3).to("meta")
    assert tg.snapshot() == {"guard_windows": 1, "host_transfers": 2,
                             "host_exits": 0}
    # outside any window nothing is judged
    torch.zeros(3).to("meta")
    tg.check_operands(torch.zeros(1, device="meta"))
    assert tg.snapshot()["host_transfers"] == 2


def test_a_disarmed_or_off_guard_judges_nothing(guard):
    tg.disarm()
    assert not tg.active()
    with tg.no_implicit_transfers("probe", "meta"):
        torch.zeros(3).to("meta")
    tg.configure("off", 0.0)
    assert not tg.active()
    with tg.no_implicit_transfers("probe", "meta"):
        tg.check_operands(torch.zeros(1))
    assert tg.snapshot() == {"guard_windows": 0, "host_transfers": 0,
                             "host_exits": 0}
    tg.disarm()
    tg.configure("auto", 30.0)       # armed, but only after its window
    assert not tg.active()


def test_configure_primes_the_op_watch_once(monkeypatch):
    """Arming on a card first pays the op watch's one-time set-up (its
    first window in a process took 6.9-9.4 s on the H100, and fell on a
    steady-state launch): ``configure(..., device=)`` enters the watch
    once per process, judges nothing while it does, and the CPU, where
    windows install no watch, needs none."""
    entered = []
    real = tg._Watch

    class Counting(real):
        def __enter__(self):
            entered.append(self.kind)
            return super().__enter__()

    monkeypatch.setattr(tg, "_Watch", Counting)
    monkeypatch.setattr(tg, "_primed", False)
    monkeypatch.setattr(tg, "_counters", BucketCounters("transfer_guard_test_prime"))
    try:
        tg.configure("on", 0.0, device="cpu")
        assert entered == [] and not tg._primed
        tg.configure("off", 0.0, device="meta")
        assert entered == [] and not tg._primed
        tg.configure("on", 0.0, device="meta")
        tg.configure("auto", 0.0, device="meta")
        assert entered == ["prime"] and tg._primed
        assert tg.snapshot() == {"guard_windows": 0, "host_transfers": 0, "host_exits": 0}
    finally:
        tg.disarm()

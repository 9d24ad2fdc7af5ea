"""The port's ``MgrDaemon`` where it differs from the reference's, on
purpose: a digest pass that raises is counted in ``digest_failures``
(and shown by ``dump_analytics``), never answered from the host path
when the engine's backend is ``cuda``; a failed prewarm is logged and
kept in ``warmup_failures``; the digest never runs before the prewarm
has landed, so ``cold_launches`` stays 0.  The daemons run on the CPU.
"""

from __future__ import annotations

import asyncio
import threading

import pytest

from tests.test_torch_mgr import _fast_conf, _wait_for
from tests.test_torch_mini_cluster import run


class _Sock:
    """Collects what a daemon registers on its admin socket."""

    def __init__(self):
        self.commands = {}

    def register(self, name, _help, fn):
        self.commands[name] = fn


async def _boot(wrap_prewarm=None):
    from ceph_tpu_torch.crush import builder as B
    from ceph_tpu_torch.crush.types import CrushMap
    from ceph_tpu_torch.mgr.daemon import MgrDaemon
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=1)
    mon = Monitor(crush=crush, conf=_fast_conf(), device="cpu")
    await mon.start()
    mgr = MgrDaemon("x", [mon.addr], conf=_fast_conf(), device="cpu")
    if wrap_prewarm is not None:
        mgr.engine.prewarm = wrap_prewarm(mgr.engine.prewarm)
    await mgr.start()
    osd = OSDDaemon(0, mon.addr, conf=_fast_conf(), device="cpu")
    await osd.start()
    return mon, mgr, osd


async def _halt(mon, mgr, osd):
    await osd.stop()
    await mgr.stop()
    await mon.stop()


def _dump(mgr) -> dict:
    sock = _Sock()
    mgr._register_admin_commands(sock)
    return sock.commands["dump_analytics"]({})


def test_a_failed_digest_is_counted_not_answered_by_the_host():
    async def go():
        mon, mgr, osd = await _boot()
        try:
            assert await _wait_for(lambda: mgr.digests_sent >= 1)
            assert mgr.digest_failures == 0
            good = mgr.last_analytics

            def broken(*a, **kw):
                raise RuntimeError("launch failed")

            mgr.engine._run_device = broken
            assert await _wait_for(lambda: mgr.digest_failures >= 2)
            sent = mgr.digests_sent
            await asyncio.sleep(0.5)
            # no digest left while every pass fails, and the last
            # analytics are the last good pass's
            assert mgr.digests_sent == sent
            assert mgr.last_analytics is good
            stats = mgr.engine.stats
            assert "fallbacks" not in stats
            assert stats["passes"] > stats["launches"]
            dump = _dump(mgr)
            assert dump["digest_failures"] == mgr.digest_failures >= 2
            assert dump["warmup_failures"] == []
            assert mgr.perf.dump()["digest_failures"] == mgr.digest_failures
        finally:
            await _halt(mon, mgr, osd)

    run(go())


def test_a_failed_prewarm_is_kept():
    def bad_prewarm():
        raise RuntimeError("no kernel")

    async def go():
        mon, mgr, osd = await _boot(wrap_prewarm=lambda real: bad_prewarm)
        try:
            assert await _wait_for(lambda: mgr._warm_task.done())
            assert [(w, str(e)) for w, e in mgr.warmup_failures] == [
                ("analytics", "no kernel")]
            assert _dump(mgr)["warmup_failures"] == [
                "analytics: RuntimeError: no kernel"]
        finally:
            await _halt(mon, mgr, osd)

    run(go())


def test_no_digest_before_the_prewarm_lands():
    gate = threading.Event()

    def slow(real):
        def prewarm():
            gate.wait(10)
            return real()
        return prewarm

    async def go():
        mon, mgr, osd = await _boot(wrap_prewarm=slow)
        try:
            # the digest ticks while the prewarm is held, and waits
            assert await _wait_for(lambda: mgr.active)
            await asyncio.sleep(0.6)
            assert mgr.engine.stats["passes"] == 0 and mgr.digests_sent == 0
            gate.set()
            assert await _wait_for(lambda: mgr.digests_sent >= 2)
            assert mgr.engine.stats["cold_launches"] == 0
            assert mgr.engine.stats["prewarmed_shapes"] == 1
            assert mgr.digest_failures == 0
        finally:
            gate.set()
            await _halt(mon, mgr, osd)

    run(go())


def test_numpy_backend_is_the_configured_host_path():
    from ceph_tpu_torch.mgr.daemon import MgrDaemon

    mgr = MgrDaemon("n", ("127.0.0.1", 1), device="cpu",
                    conf=_fast_conf(mgr_analytics_backend="numpy"))
    assert mgr.engine.backend == "numpy" and mgr.engine.prewarm() == 0
    with pytest.raises(ValueError):
        MgrDaemon("j", ("127.0.0.1", 1), device="cpu",
                  conf=_fast_conf(mgr_analytics_backend="jax"))

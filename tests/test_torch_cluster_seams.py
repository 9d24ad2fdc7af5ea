"""The device seam of the port's daemons, pinned.

Where the port's OSD daemon, mon and batchers part from the reference
on purpose (the device each runs on, the default plugin, when the
encode service attaches, what a failed warmup, scrub or fast read
does), one test each.  Everything runs on the CPU; a machine without a
card is simulated by patching ``torch.cuda.is_available``.
"""

from __future__ import annotations

import asyncio
import errno

import numpy as np
import pytest
import torch

from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.osd.daemon import OSDDaemon, object_to_pg
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgPool, PoolType
from ceph_tpu_torch.parallel import decode_batcher, encode_service, scrub_batcher
from tests.test_torch_mini_cluster import Cluster, reset_shared, run

SERVICES = [encode_service, decode_batcher, scrub_batcher]
IDS = ["encode_service", "decode_batcher", "scrub_batcher"]


@pytest.fixture(autouse=True)
def fresh_services():
    reset_shared()
    yield
    reset_shared()


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


@pytest.fixture
def one_card(monkeypatch):
    """A process that believes it has one card (nothing is launched)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)


# ---------------------------------------------------------------------------
# shared(device): one process-wide service, on the device it was asked for
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mod", SERVICES, ids=IDS)
def test_shared_cpu_then_card_raises(mod, one_card):
    held = mod.shared(device="cpu")
    with pytest.raises(RuntimeError, match="reset_shared"):
        mod.shared()
    with pytest.raises(RuntimeError, match="reset_shared"):
        mod.shared(device="cuda")
    assert mod.shared(device="cpu") is held


@pytest.mark.parametrize("mod", SERVICES, ids=IDS)
def test_shared_without_a_card_raises(mod, no_card):
    mod.shared(device="cpu")
    with pytest.raises(RuntimeError):
        mod.shared()
    mod.reset_shared()
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.shared()


@pytest.mark.parametrize("mod", SERVICES, ids=IDS)
def test_shared_same_device_same_object(mod):
    first = mod.shared(device="cpu")
    assert mod.shared(device="cpu") is first
    assert mod.shared(device=torch.device("cpu")) is first
    mod.reset_shared()
    assert mod.shared(device="cpu") is not first


# ---------------------------------------------------------------------------
# the OSD daemon's device, encode service and default plugin
# ---------------------------------------------------------------------------

def _daemon(conf: dict | None = None, device="cpu") -> OSDDaemon:
    from ceph_tpu_torch.common import ConfigProxy

    return OSDDaemon(0, ("127.0.0.1", 1), conf=ConfigProxy(conf or {}), device=device)


def _with_profiles(d: OSDDaemon, profiles: dict) -> OSDDaemon:
    d.osdmap = OSDMap(crush=CrushMap())
    d.osdmap.erasure_code_profiles = profiles
    return d


def test_daemon_device_is_the_card_unless_asked(no_card):
    with pytest.raises(RuntimeError, match="CUDA"):
        _daemon(device=None)
    assert _daemon().device == torch.device("cpu")


@pytest.mark.parametrize("mode,attached", [("auto", False), ("on", True), ("off", False)])
def test_cpu_daemon_encode_farm_modes(mode, attached):
    d = _daemon({"osd_ec_encode_farm": mode})
    svc = d.encode_service
    if attached:
        assert svc is encode_service.shared(device="cpu")
        assert svc.active() and svc.device == torch.device("cpu")
    else:
        assert svc is None
    # the batchers attach on the daemon's device whatever the mode
    assert d.decode_aggregator is decode_batcher.shared(device="cpu")
    assert d.scrub_verifier is scrub_batcher.shared(device="cpu")


def test_card_daemon_auto_attaches_the_service(one_card):
    d = _daemon({"osd_ec_encode_farm": "auto"}, device=None)
    assert d.device.type == "cuda"
    # built lazily; nothing is launched by attaching it
    assert d.encode_service is encode_service.shared()


def test_default_plugin_is_cuda():
    d = _with_profiles(_daemon(), {"bare": {"k": "2", "m": "1"}})
    pool = PgPool(id=1, type=PoolType.ERASURE, size=3, min_size=2,
                  erasure_code_profile="bare")
    ec = d._ec_for(pool)
    assert type(ec).__name__ == "ErasureCodeCuda"
    assert ec.device == torch.device("cpu")

    async def go():
        async with Cluster(n_osds=3) as c:
            await c.client.ec_profile_set("p", {"k": "2", "m": "1"})
            prof = c.mon.osdmap.erasure_code_profiles["p"]
            assert prof["plugin"] == "cuda"
            assert c.client.osdmap.erasure_code_profiles["p"]["plugin"] == "cuda"

    run(go())


def test_warmup_failure_is_recorded():
    d = _with_profiles(_daemon(), {
        "good": {"plugin": "cuda", "k": "2", "m": "1"},
        "bad": {"plugin": "no_such_plugin", "k": "2", "m": "1"},
    })

    async def go():
        d._warm_ec_profiles()
        await asyncio.gather(*list(d._warm_tasks))

    run(go())
    assert [name for name, _ in d.warmup_failures] == ["bad"]
    assert isinstance(d.warmup_failures[0][1], ECError)
    dumped = d._dump_faults()["warmup_failures"]
    assert [f["profile"] for f in dumped] == ["bad"]
    # the good profile warmed its batchers on the daemon's device
    assert d.decode_aggregator.stats["prewarmed_shapes"] > 0
    assert d.scrub_verifier.stats["prewarmed_shapes"] > 0
    assert d.decode_aggregator.stats["cold_launches"] == 0


def test_a_failed_warmup_does_not_arm_the_transfer_guard():
    """``osd_transfer_guard=auto`` arms after a warmup that built every
    profile's ladder, and not after one that failed (as the mgr)."""
    from ceph_tpu_torch.common import transfer_guard as tg

    good = {"plugin": "cuda", "k": "2", "m": "1"}
    bad = {"plugin": "no_such_plugin", "k": "2", "m": "1"}
    tg.disarm()
    try:
        for profiles, armed in (({"good": good, "bad": bad}, False),
                                ({"good": good}, True)):
            d = _with_profiles(_daemon(), profiles)

            async def go():
                d._warm_ec_profiles()
                await asyncio.gather(*list(d._warm_tasks))

            run(go())
            assert tg.active() is armed, profiles
    finally:
        tg.disarm()


def test_warmup_arms_the_guard_primed_on_the_daemons_device(monkeypatch):
    """The warmup that arms the transfer guard hands it the daemon's
    device, so the op watch's one-time set-up is paid there and not by
    the first steady-state launch (the osd_thrash seed-0 red on the card)."""
    from ceph_tpu_torch.common import transfer_guard as tg

    calls = []
    monkeypatch.setattr(tg, "configure", lambda *a, **kw: calls.append((a, kw)))
    d = _with_profiles(_daemon(), {"good": {"plugin": "cuda", "k": "2", "m": "1"}})

    async def go():
        d._warm_ec_profiles()
        await asyncio.gather(*list(d._warm_tasks))

    run(go())
    assert len(calls) == 1
    assert calls[0][1]["device"] == d.device == torch.device("cpu")


# ---------------------------------------------------------------------------
# scrub: an EC pool whose plugin does not build raises, never crc only
# ---------------------------------------------------------------------------

def _payloads():
    rng = np.random.default_rng(5)
    return {s: rng.integers(0, 256, 4096, dtype=np.uint8).tobytes() for s in range(3)}


def test_ec_scrub_with_a_broken_plugin_raises():
    d = _with_profiles(_daemon(), {"bad": {"plugin": "no_such_plugin"}})
    pool = PgPool(id=1, type=PoolType.ERASURE, size=3, min_size=2,
                  erasure_code_profile="bad")
    with pytest.raises(ECError) as ei:
        run(d._verify_payloads(pool, _payloads()))
    assert "no_such_plugin" in str(ei.value)


def test_host_crc_serves_replicated_pools_and_verify_off():
    from ceph_tpu_torch.native import crc32c

    payloads = _payloads()
    want = {s: crc32c(p) for s, p in payloads.items()}
    d = _daemon()
    replicated = PgPool(id=1)
    assert run(d._verify_payloads(replicated, payloads)) == (want, None)
    off = _with_profiles(_daemon({"osd_scrub_verify_batch": "off"}),
                         {"bad": {"plugin": "no_such_plugin"}})
    ec_pool = PgPool(id=2, type=PoolType.ERASURE, size=3, min_size=2,
                     erasure_code_profile="bad")
    assert run(off._verify_payloads(ec_pool, payloads)) == (want, None)


def test_ec_scrub_goes_through_the_verifier():
    d = _with_profiles(_daemon(), {"p": {"plugin": "cuda", "k": "2", "m": "1"}})
    pool = PgPool(id=1, type=PoolType.ERASURE, size=3, min_size=2,
                  erasure_code_profile="p")
    ec = d._ec_for(pool)
    rng = np.random.default_rng(6)
    data = rng.integers(0, 256, (2, 4096), dtype=np.uint8)
    from ceph_tpu_torch.ops.gf256 import gf_matmul

    parity = gf_matmul(np.asarray(ec.coding_matrix, np.uint8), data)
    payloads = {0: data[0].tobytes(), 1: data[1].tobytes(), 2: parity[0].tobytes()}
    crcs, parity_bad = run(d._verify_payloads(pool, payloads))
    assert parity_bad == frozenset()
    assert d.scrub_verifier.stats["objects"] == 1


# ---------------------------------------------------------------------------
# fast read: a peer's failure takes the normal path, the device's propagates
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("error,result", [
    (ConnectionError("peer gone"), None),
    (RuntimeError("kernel launch failed"), -errno.EIO),
], ids=["connection", "device"])
def test_fast_read_failures(error, result):
    async def go():
        async with Cluster(n_osds=6) as c:
            await c.client.ec_profile_set(
                "frp", {"plugin": "cuda", "k": "3", "m": "2",
                        "crush-failure-domain": "host"})
            await c.client.pool_create(
                "fr", pg_num=4, pool_type="erasure",
                erasure_code_profile="frp", fast_read="true")
            io = c.client.ioctx("fr")
            data = np.random.default_rng(0).integers(
                0, 256, 20000, dtype=np.uint8).tobytes()
            await io.write_full("obj", data)
            om = c.client.osdmap
            pool = om.get_pg_pool(io.pool_id)
            _, _, _, primary = om.pg_to_up_acting_osds(object_to_pg(pool, "obj"))
            calls = []

            async def failing(*a, **kw):
                calls.append(1)
                raise error

            c.osds[primary]._ec_fetch_fast = failing
            if result is None:
                assert await io.read("obj") == data
            else:
                from ceph_tpu_torch.client import RadosError

                with pytest.raises(RadosError) as ei:
                    await io.read("obj")
                assert ei.value.errno == -result
            assert calls

    run(go())


# ---------------------------------------------------------------------------
# concurrent writes into new PG shards on a store that commits off the loop
# ---------------------------------------------------------------------------

def test_concurrent_first_writes_on_blockstores(tmp_path):
    """BlockStore commits on a worker thread.  Two writes into a PG shard
    that does not exist yet each build their transaction before either
    commits; had both carried the collection's creation, the second would
    fail ("collection exists") and its op answer EIO.  64 objects written
    at once into 32 new PGs all land."""
    from ceph_tpu_torch.store.blockstore import BlockStore

    def factory(i):
        s = BlockStore(str(tmp_path / f"osd{i}"))
        s.mount()
        return s

    async def go():
        async with Cluster(n_osds=6, store_factory=factory) as c:
            await c.client.ec_profile_set(
                "p", {"plugin": "cuda", "k": "3", "m": "2", "crush-failure-domain": "host"})
            await c.client.pool_create("bp", pg_num=32, pool_type="erasure",
                                       erasure_code_profile="p")
            io = c.client.ioctx("bp")
            objs = {f"o{i}": bytes([i]) * 20000 for i in range(64)}
            res = await asyncio.gather(*(io.write_full(oid, data) for oid, data in objs.items()),
                                       return_exceptions=True)
            assert [r for r in res if r is not None] == []
            for oid, data in objs.items():
                assert await io.read(oid) == data

    run(go())

"""Clusters that mix the two packages, and one workload on each package.

The wire and the on-store bytes of the port's daemons are the
reference's, so daemons of both packages serve one cluster together.
Three mixes run the same script on a ``jerasure`` RS(4,2) pool (a
plugin both packages hold; a profile names one plugin for every daemon
that loads the pool):

- a reference mon and client with 8 port OSDs;
- a port mon and client with 8 reference OSDs;
- OSDs 0-3 of the port and 4-7 of the reference, so sub-ops, pushes and
  PG-log peering cross packages (a reference mon and a port client).

The script: a round trip of ``PAYLOADS``, a degraded read after an OSD
goes down, recovery after it goes out, and a deep scrub that finds a
flipped shard, then a repair.

Then one seeded workload runs on an all-reference cluster (plugin
``jax``) and an all-port cluster (``cuda`` on the CPU), and every
object's placement ``(pg, shard -> osd)``, each shard's bytes and its
``hinfo`` and ``_size`` xattrs are held equal, byte for byte.

Last, 12 reference OSDs under a port mon, whose erasure rule carries
Ceph's ``set_choose_tries 100`` (the reference's lacks it), place an
RS(8,3) pool with one OSD out as the mon does, and the rule places
2,000 seeds alike through both packages' mappers.

The port's daemons run with ``device="cpu"``.  The reference's run on
JAX's CPU backend; the module compiles privately (tests/xla_private.py).
"""

from __future__ import annotations

import asyncio
import copy
import importlib
import json

import numpy as np
import pytest

from tests.test_torch_mini_cluster import PAYLOADS, reset_shared, run
from tests.xla_private import _private_xla_compiles  # noqa: F401

REF, PORT = "ceph_tpu", "ceph_tpu_torch"
N_OSDS = 8
JERASURE = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "4", "m": "2",
            "crush-failure-domain": "host"}


def _pkg(name: str):
    """The classes of one package a cluster is built from."""
    mod = lambda m: importlib.import_module(f"{name}.{m}")  # noqa: E731
    return {
        "Monitor": mod("mon").Monitor,
        "OSDDaemon": mod("osd.daemon").OSDDaemon,
        "RadosClient": mod("client").RadosClient,
        "CrushMap": mod("crush.types").CrushMap,
        "builder": mod("crush.builder"),
        "coll_t": mod("store").coll_t,
        "ghobject_t": mod("store").ghobject_t,
        "Transaction": mod("store").Transaction,
        "object_to_pg": mod("osd.daemon").object_to_pg,
    }


def _device_kw(name: str) -> dict:
    return {"device": "cpu"} if name == PORT else {}


def _reset_reference_shared() -> None:
    from ceph_tpu.parallel import decode_batcher, encode_service, scrub_batcher

    encode_service.reset_shared()
    decode_batcher.reset_shared()
    scrub_batcher.reset_shared()


class MixedCluster:
    """A mon of ``mon_pkg``, a client of ``client_pkg`` and one OSD per
    host, OSD ``i`` of ``osd_pkgs[i]``."""

    def __init__(self, mon_pkg: str, client_pkg: str, osd_pkgs: list[str]):
        mon = _pkg(mon_pkg)
        crush = mon["CrushMap"]()
        mon["builder"].build_hierarchy(crush, osds_per_host=1, n_hosts=len(osd_pkgs))
        self.mon = mon["Monitor"](crush=crush, **_device_kw(mon_pkg))
        self.osd_pkgs = osd_pkgs
        self.osds: list = [None] * len(osd_pkgs)
        self.client = _pkg(client_pkg)["RadosClient"](client_id=4242)

    async def __aenter__(self):
        reset_shared()
        _reset_reference_shared()
        await self.mon.start()
        for i, name in enumerate(self.osd_pkgs):
            self.osds[i] = _pkg(name)["OSDDaemon"](i, self.mon.addr, **_device_kw(name))
            await self.osds[i].start()
        await self.client.connect(*self.mon.addr)
        return self

    async def __aexit__(self, *exc):
        await self.client.shutdown()
        for osd in self.osds:
            if osd is not None:
                await osd.stop()
        await self.mon.stop()
        reset_shared()
        _reset_reference_shared()

    def pkg_of(self, osd: int) -> dict:
        return _pkg(self.osd_pkgs[osd])

    async def wait_epoch(self, epoch: int) -> None:
        await self.client._wait_new_map(epoch - 1, timeout=10)
        assert self.client.osdmap.epoch >= epoch


async def _ec_pool(c, profile: dict, name="mix"):
    await c.client.ec_profile_set("p", dict(profile))
    await c.client.pool_create(name, pg_num=8, pool_type="erasure", erasure_code_profile="p")
    return c.client.ioctx(name)


def _placement(c, io, oid):
    om = c.client.osdmap
    pool = om.get_pg_pool(io.pool_id)
    pg = _pkg(REF)["object_to_pg"](pool, oid)
    _, _, acting, primary = om.pg_to_up_acting_osds(pg)
    return pool, pool.raw_pg_to_pg(pg), acting, primary


def _flip_one_shard(c, io, oid) -> tuple[int, int, object]:
    """Flip one byte of a non-primary shard of ``oid`` in its OSD's
    store; returns (osd, shard, folded pg)."""
    pool, folded, acting, primary = _placement(c, io, oid)
    shard, osd = next((s, o) for s, o in enumerate(acting) if o != primary)
    p = c.pkg_of(osd)
    cl = p["coll_t"](pool.id, folded.ps, shard)
    o = p["ghobject_t"](oid, shard=shard)
    store = c.osds[osd].store
    data = bytearray(store.read(cl, o))
    data[17] ^= 0x5A
    store.queue_transaction(p["Transaction"]().write(cl, o, 0, bytes(data)))
    return osd, shard, folded


async def _script(c) -> None:
    io = await _ec_pool(c, JERASURE)
    # round trip
    for oid, data in PAYLOADS.items():
        await io.write_full(oid, data)
    for oid, data in PAYLOADS.items():
        assert await io.read(oid) == data
        assert await io.stat(oid) == len(data)

    # degraded read after an OSD goes down
    _, _, acting, primary = _placement(c, io, "obj-odd")
    victim = next(o for o in acting if o != primary)
    epoch = c.client.osdmap.epoch
    await c.osds[victim].stop()
    c.osds[victim] = None
    code, _, _ = await c.client.command({"prefix": "osd down", "id": str(victim)})
    assert code == 0
    await c.wait_epoch(epoch + 1)
    for oid, data in PAYLOADS.items():
        assert await io.read(oid) == data

    # recovery after it goes out
    code, _, _ = await c.client.command({"prefix": "osd out", "id": str(victim)})
    assert code == 0
    await c.wait_epoch(epoch + 2)
    await c.client.wait_clean(timeout=60)
    _, _, acting1, _ = _placement(c, io, "obj-odd")
    assert victim not in acting1
    for oid, data in PAYLOADS.items():
        assert await io.read(oid) == data

    # deep scrub finds a flipped shard, repair fixes it
    bad_osd, bad_shard, folded = _flip_one_shard(c, io, "obj-exact")
    pgid = f"{io.pool_id}.{folded.ps}"
    code, _, data = await c.client.command({"prefix": "pg deep-scrub", "pgid": pgid})
    assert code == 0
    rep = json.loads(data)
    found = {(i["object"], i.get("shard")) for i in rep["inconsistencies"]}
    assert found == {("obj-exact", bad_shard)}, rep
    code, _, data = await c.client.command({"prefix": "pg repair", "pgid": pgid})
    assert code == 0
    rep = json.loads(data)
    assert rep["repaired"] == ["obj-exact"] and rep["inconsistencies"] == [], rep
    code, _, data = await c.client.command({"prefix": "pg deep-scrub", "pgid": pgid})
    assert json.loads(data)["inconsistencies"] == []
    assert await io.read("obj-exact") == PAYLOADS["obj-exact"]


MIXES = {
    "ref_mon_client_port_osds": (REF, REF, [PORT] * N_OSDS),
    "port_mon_client_ref_osds": (PORT, PORT, [REF] * N_OSDS),
    "half_and_half_osds": (REF, PORT, [PORT] * 4 + [REF] * 4),
}


@pytest.mark.parametrize("mix", list(MIXES))
def test_mixed_cluster_round_trip_degrade_recover_scrub_repair(mix):
    mon_pkg, client_pkg, osd_pkgs = MIXES[mix]

    async def go():
        async with MixedCluster(mon_pkg, client_pkg, osd_pkgs) as c:
            await _script(c)

    run(go())


# ---------------------------------------------------------------------------
# one seeded workload on an all-reference and an all-port cluster
# ---------------------------------------------------------------------------

def _workload() -> dict[str, bytes]:
    rng = np.random.default_rng(1234)
    objs = dict(PAYLOADS)
    for i in range(16):
        n = int(rng.integers(0, 3 * 65536))
        objs[f"seeded-{i}"] = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
    return objs


async def _layout(name: str, plugin: str) -> dict:
    """Write the workload on a cluster of ``name``'s daemons; return,
    for every object, its placement and each shard's bytes and xattrs."""
    p = _pkg(name)
    objs = _workload()
    out: dict = {}
    async with MixedCluster(name, name, [name] * N_OSDS) as c:
        io = await _ec_pool(c, {"plugin": plugin, "k": "4", "m": "2",
                                "crush-failure-domain": "host"}, name="seeded")
        await asyncio.gather(*(io.write_full(oid, data) for oid, data in objs.items()))
        await c.client.wait_clean(timeout=60)
        for oid, data in objs.items():
            assert await io.read(oid) == data
            pool, folded, acting, primary = _placement(c, io, oid)
            shards = {}
            for shard, osd in enumerate(acting):
                cl = p["coll_t"](pool.id, folded.ps, shard)
                o = p["ghobject_t"](oid, shard=shard)
                store = c.osds[osd].store
                attrs = store.getattrs(cl, o)
                shards[shard] = (osd, store.read(cl, o), attrs.get("hinfo"), attrs.get("_size"))
            out[oid] = ((folded.pool, folded.ps), primary, shards)
    return out


def test_seeded_workload_byte_equal_on_reference_and_port():
    ref = run(_layout(REF, "jax"))
    port = run(_layout(PORT, "cuda"))
    assert list(ref) == list(port)
    for oid in ref:
        assert ref[oid][:2] == port[oid][:2], oid
        for shard, (r_osd, r_bytes, r_hinfo, r_size) in ref[oid][2].items():
            p_osd, p_bytes, p_hinfo, p_size = port[oid][2][shard]
            assert (r_osd, shard) == (p_osd, shard), oid
            assert r_bytes == p_bytes, (oid, shard)
            assert r_hinfo == p_hinfo and r_hinfo is not None, (oid, shard)
            assert r_size == p_size and r_size is not None, (oid, shard)


# ---------------------------------------------------------------------------
# a port mon's erasure rule under reference OSDs, with an OSD out
# ---------------------------------------------------------------------------

def test_port_mon_erasure_rule_places_alike_with_an_osd_out():
    """The port's mon writes Ceph's ``set_choose_tries 100`` into an
    erasure rule, which the reference's own rule lacks.  Under a port mon,
    12 reference OSDs decode that rule from the wire; with OSD 5 out,
    every PG of an RS(8,3) pool places alike through the mon's map and
    each OSD's, and 2,000 seeds place alike through both scalar mappers
    and the port's batched one (``crush_rule.cu``'s plain version), those
    among them where the reference's own rule leaves a hole too."""
    from ceph_tpu.crush import mapper as ref_mapper
    from ceph_tpu.osd.types import pg_t as ref_pg_t
    from ceph_tpu_torch.crush import mapper as port_mapper
    from ceph_tpu_torch.crush.cudamapper import BatchedRuleMapper, compile_map
    from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, RuleOp
    from ceph_tpu_torch.osd.types import pg_t

    lost, n, seeds = 5, 11, 2000

    async def go():
        async with MixedCluster(PORT, PORT, [REF] * 12) as c:
            io = await _ec_pool(c, {**JERASURE, "k": "8", "m": "3"})
            epoch = c.client.osdmap.epoch
            code, _, _ = await c.client.command({"prefix": "osd out", "id": str(lost)})
            assert code == 0
            await c.wait_epoch(epoch + 1)
            await c.client.wait_clean(timeout=60, min_epoch=epoch + 1)
            for _ in range(1000):
                if all(o.osdmap.epoch == c.mon.osdmap.epoch for o in c.osds):
                    break
                await asyncio.sleep(0.01)
            mon_map, pool_id = c.mon.osdmap, io.pool_id
            pool = mon_map.get_pg_pool(pool_id)
            steps = [(int(s.op), s.arg1) for s in mon_map.crush.rules[pool.crush_rule].steps]
            assert mon_map.osd_weight[lost] == 0
            for o in c.osds:
                assert o.osdmap.epoch == mon_map.epoch
                rule = o.osdmap.crush.rules[pool.crush_rule]
                assert [(int(s.op), s.arg1) for s in rule.steps] == steps
                for ps in range(pool.pg_num):
                    assert (o.osdmap.pg_to_up_acting_osds(ref_pg_t(pool_id, ps), folded=True)
                            == mon_map.pg_to_up_acting_osds(pg_t(pool_id, ps), folded=True))
            return (copy.deepcopy(mon_map.crush), copy.deepcopy(c.osds[0].osdmap.crush),
                    pool.crush_rule, list(mon_map.osd_weight), steps)

    port_crush, ref_crush, ruleno, weights, steps = run(go())
    assert (int(RuleOp.SET_CHOOSE_TRIES), 100) in steps
    port_rows = [port_mapper.crush_do_rule(port_crush, ruleno, x, n, weights)
                 for x in range(seeds)]
    assert [ref_mapper.crush_do_rule(ref_crush, ruleno, x, n, weights)
            for x in range(seeds)] == port_rows
    assert not any(CRUSH_ITEM_NONE in row for row in port_rows)
    # the reference's own rule, without the step, leaves holes at some of
    # these seeds: the rule's step is what places them
    own = copy.deepcopy(ref_crush)
    own.rules[ruleno].steps = [s for s in own.rules[ruleno].steps
                               if int(s.op) != int(RuleOp.SET_CHOOSE_TRIES)]
    holes = [x for x in range(seeds)
             if CRUSH_ITEM_NONE in ref_mapper.crush_do_rule(own, ruleno, x, n, weights)]
    assert holes
    # the batched mapper at those seeds and the first 64 (its plain
    # version walks every lane in lockstep, so every seed costs it the
    # longest retry chain)
    xs = sorted(set(holes) | set(range(64)))
    vals, cnt = BatchedRuleMapper(compile_map(port_crush), ruleno, n, device="cpu")(
        np.asarray(xs, dtype=np.uint32), weights)
    assert [[int(v) for v in vals[i, :cnt[i]]] for i in range(len(xs))] == \
        [port_rows[x] for x in xs]

"""The whole-cluster remap, the scalar OSDMap pipeline and the upmap
balancer of the port against ceph_tpu's.

Each cluster is built twice, once with each package, from the same
steps (the clusters of tests/test_jaxmapper.py:189-312).  Every row of
``BatchedClusterMapper(om, device="cpu")`` must equal the reference's
scalar ``OSDMap.pg_to_up_acting_osds(folded=True)`` (tolerance 0), and
the port's scalar pipeline must equal the reference's on every PG.
"""

from __future__ import annotations

import pytest

import ceph_tpu.crush.builder as rb
import ceph_tpu.crush.types as rtypes
import ceph_tpu.osd.balancer as rbalancer
import ceph_tpu.osd.osdmap as rosdmap
import ceph_tpu.osd.types as rosdtypes
import ceph_tpu_torch.crush.builder as pb
import ceph_tpu_torch.crush.types as ptypes
import ceph_tpu_torch.osd.osdmap as posdmap
import ceph_tpu_torch.osd.types as posdtypes
from ceph_tpu_torch.crush import cudamapper as cm
from ceph_tpu_torch.osd import balancer as pbalancer
from ceph_tpu_torch.osd import remap
from tests.xla_private import _private_xla_compiles  # noqa: F401

REF = (rb, rtypes, rosdmap, rosdtypes)
PORT = (pb, ptypes, posdmap, posdtypes)


def _main_cluster(pkg):
    """test_jaxmapper.py TestBatchedRemap.cluster, with one package."""
    B, T, O, P = pkg
    m = T.CrushMap()
    root = B.build_hierarchy(m, osds_per_host=4, n_hosts=8)
    r_rep = B.add_simple_rule(m, root.id, 1, mode="firstn")
    r_ec = B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3)
    r_msr = B.add_osd_multi_per_domain_rule(m, root.id, 1, num_per_domain=2, num_domains=3)
    om = O.OSDMap(crush=m)
    for o in range(32):
        om.new_osd(o)
    om.mark_down(5)
    om.mark_down(17)
    om.mark_out(9)
    om.osd_weight[11] = 0x8000
    om.set_primary_affinity(3, 0x4000)
    om.set_primary_affinity(20, 0)
    PT = P.PoolType
    om.pools[1] = P.PgPool(id=1, type=PT.REPLICATED, size=3, crush_rule=r_rep,
                           pg_num=64, pgp_num=64)
    om.pools[2] = P.PgPool(id=2, type=PT.ERASURE, size=6, min_size=5, crush_rule=r_ec,
                           pg_num=32, pgp_num=32)
    om.pools[3] = P.PgPool(id=3, type=PT.ERASURE, size=6, min_size=5, crush_rule=r_msr,
                           pg_num=16, pgp_num=16)
    pg = P.pg_t
    om.pg_upmap[pg(1, 3)] = [0, 4, 8]
    om.pg_upmap_items[pg(1, 7)] = [(1, 2)]
    om.pg_upmap_items[pg(2, 5)] = [(6, 7)]
    om.pg_upmap_primaries[pg(1, 9)] = 8
    om.pg_temp[pg(2, 11)] = [1, 2, 3, 4, 6, 7]
    om.primary_temp[pg(1, 13)] = 12
    return om


def _edge_cluster(pkg):
    """test_jaxmapper.py TestRemapEdgeCases.om, with one package."""
    B, T, O, P = pkg
    m = T.CrushMap()
    root = B.build_hierarchy(m, osds_per_host=2, n_hosts=8)
    r_rep = B.add_simple_rule(m, root.id, 1, mode="firstn")
    om = O.OSDMap(crush=m)
    for o in range(16):
        om.new_osd(o)
    om.pools[1] = P.PgPool(id=1, type=P.PoolType.REPLICATED, size=3, crush_rule=r_rep,
                           pg_num=16, pgp_num=16)
    return om


def _wide_cluster(pkg):
    """A root of 70 hosts, more than a warp's 32 lanes and no multiple of
    them, with a replicated, an EC indep and an MSR pool on it."""
    B, T, O, P = pkg
    m = T.CrushMap()
    root = B.build_hierarchy(m, osds_per_host=2, n_hosts=70)
    r_rep = B.add_simple_rule(m, root.id, 1, mode="firstn")
    r_ec = B.add_simple_rule(m, root.id, 1, mode="indep", rule_type=3)
    r_msr = B.add_osd_multi_per_domain_rule(m, root.id, 1, num_per_domain=1, num_domains=11)
    om = O.OSDMap(crush=m)
    for o in range(140):
        om.new_osd(o)
    om.mark_down(3)
    om.mark_out(70)
    om.osd_weight[101] = 0x6000
    PT = P.PoolType
    om.pools[1] = P.PgPool(id=1, type=PT.REPLICATED, size=3, crush_rule=r_rep,
                           pg_num=32, pgp_num=32)
    om.pools[2] = P.PgPool(id=2, type=PT.ERASURE, size=11, min_size=8, crush_rule=r_ec,
                           pg_num=16, pgp_num=16)
    om.pools[3] = P.PgPool(id=3, type=PT.ERASURE, size=11, min_size=8, crush_rule=r_msr,
                           pg_num=16, pgp_num=16)
    return om


def _edge_upmap_wider(pkg, om):
    om.pg_upmap[pkg[3].pg_t(1, 2)] = [0, 4, 8, 12]


def _edge_pg_temp_wider(pkg, om):
    om.pg_temp[pkg[3].pg_t(1, 3)] = [1, 2, 3, 6, 10]


def _edge_indep_on_replicated(pkg, om):
    B = pkg[0]
    om.pools[1].crush_rule = B.add_simple_rule(
        om.crush, om.crush.bucket_names["default"], 1, mode="indep")
    om.mark_down(1)
    om.mark_out(1)
    for ps in range(16):
        om.pg_upmap_primaries[pkg[3].pg_t(1, ps)] = 4


def _epoch_change(pkg, om):
    om.epoch += 1
    om.mark_down(0)
    om.mark_out(0)


CLUSTERS = {
    "main": (_main_cluster, None),
    "main, epoch change": (_main_cluster, _epoch_change),
    "upmap wider than size": (_edge_cluster, _edge_upmap_wider),
    "pg_temp wider than size": (_edge_cluster, _edge_pg_temp_wider),
    "indep rule on a replicated pool": (_edge_cluster, _edge_indep_on_replicated),
    "root of 70 hosts": (_wide_cluster, None),
}


def _pair(name):
    make, change = CLUSTERS[name]
    om, ref = make(PORT), make(REF)
    if change is not None:
        change(PORT, om)
        change(REF, ref)
    return om, ref


def _ref_rows(ref, pid):
    return [ref.pg_to_up_acting_osds(rosdtypes.pg_t(pid, ps), folded=True)
            for ps in range(ref.pools[pid].pg_num)]


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_remap_rows_match_reference(name):
    om, ref = _pair(name)
    remap.reset_counters()
    res = remap.BatchedClusterMapper(om, device="cpu").map_cluster()
    assert sorted(res) == sorted(ref.pools)
    for pid, pm in res.items():
        want = _ref_rows(ref, pid)
        assert [pm.rows(ps) for ps in range(len(want))] == want, (name, pid)
    assert remap.counters() == {"batched_pools": len(res), "scalar_pools": 0,
                                "map_uploads": 1}


@pytest.mark.parametrize("name", sorted(CLUSTERS))
def test_scalar_pipeline_matches_reference(name):
    om, ref = _pair(name)
    for pid in ref.pools:
        want = _ref_rows(ref, pid)
        got = [om.pg_to_up_acting_osds(posdtypes.pg_t(pid, ps), folded=True)
               for ps in range(len(want))]
        assert got == want, (name, pid)
        # raw pgs past pg_num fold as the reference folds them
        for ps in (om.pools[pid].pg_num, 3 * om.pools[pid].pg_num + 1):
            assert om.pg_to_up_acting_osds(posdtypes.pg_t(pid, ps)) == \
                ref.pg_to_up_acting_osds(rosdtypes.pg_t(pid, ps))


def test_ec_rows_keep_positional_holes():
    om, _ = _pair("main")
    pm = remap.BatchedClusterMapper(om, device="cpu").map_pool(2)
    assert (pm.up_cnt == 6).all()
    assert (pm.up == 0x7FFFFFFF).any()  # osd 5 and 17 are down: holes


def test_failed_launch_raises_and_nothing_answers(monkeypatch):
    """No fallback: a launch that raises propagates out of map_pool, and
    no pool is answered from the scalar pipeline."""
    om, _ = _pair("main")
    remap.reset_counters()
    bcm = remap.BatchedClusterMapper(om, device="cpu")

    def refuse(*_a, **_k):
        raise RuntimeError("crush_rule kernel launch failed: cudaError 98")

    # the mapper takes the card's path on these tensors, and its launch fails
    monkeypatch.setattr(cm, "_on_cpu", lambda t: False)
    monkeypatch.setattr(cm, "_launch", refuse)
    with pytest.raises(RuntimeError, match="cudaError 98"):
        bcm.map_pool(1)
    assert remap.counters()["scalar_pools"] == 0
    assert remap.counters()["batched_pools"] == 0


def test_legacy_map_takes_the_scalar_pipeline():
    B, T, O, P = PORT
    om = O.OSDMap(crush=T.CrushMap())
    root = B.build_hierarchy(om.crush, osds_per_host=2, n_hosts=6, alg=T.BucketAlg.LIST)
    rule = B.add_simple_rule(om.crush, root.id, 1, mode="firstn")
    for o in range(12):
        om.new_osd(o)
    om.pools[1] = P.PgPool(id=1, size=3, crush_rule=rule, pg_num=16, pgp_num=16)
    remap.reset_counters()
    pm = remap.BatchedClusterMapper(om, device="cpu").map_pool(1)
    assert remap.counters() == {"batched_pools": 0, "scalar_pools": 1, "map_uploads": 0}
    for ps in range(16):
        assert pm.rows(ps) == om.pg_to_up_acting_osds(P.pg_t(1, ps), folded=True)


def test_epochs_of_osd_state_and_weights_upload_once():
    om, ref = _pair("main")
    remap.reset_counters()
    for epoch in range(3):
        if epoch:
            for o in (om, ref):
                o.epoch += 1
                o.mark_down(20 + epoch)
                o.osd_weight[24 + epoch] = 0x4000 * epoch
        res = remap.BatchedClusterMapper(om, device="cpu").map_cluster()
        for pid, pm in res.items():
            want = _ref_rows(ref, pid)
            assert [pm.rows(ps) for ps in range(len(want))] == want
    assert remap.counters() == {"batched_pools": 9, "scalar_pools": 0, "map_uploads": 1}
    # a topology change compiles and uploads again
    pb.add_simple_rule(om.crush, om.crush.bucket_names["default"], 0, mode="firstn")
    remap.BatchedClusterMapper(om, device="cpu").map_pool(1)
    assert remap.counters()["map_uploads"] == 2


def _balancer_cluster(pkg):
    B, T, O, P = pkg
    m = T.CrushMap()
    root = B.build_hierarchy(m, osds_per_host=4, n_hosts=6)
    rule = B.add_simple_rule(m, root.id, 1, mode="firstn")
    om = O.OSDMap(crush=m)
    for o in range(24):
        om.new_osd(o)
    om.osd_weight[5] = 0x8000
    om.pools[1] = P.PgPool(id=1, size=3, crush_rule=rule, pg_num=128, pgp_num=128)
    return om


def test_balancer_census_matches_scalar_pipeline():
    om = _balancer_cluster(PORT)
    counts, pgs = pbalancer.UpmapBalancer(om, device="cpu").census()
    want_counts: dict[int, int] = {}
    for ps in range(128):
        up = om.pg_to_up_acting_osds(posdtypes.pg_t(1, ps), folded=True)[0]
        row = [o for o in up if o != 0x7FFFFFFF]
        assert pgs[posdtypes.pg_t(1, ps)] == row
        for o in row:
            want_counts[o] = want_counts.get(o, 0) + 1
    assert counts == want_counts


def test_balancer_optimize_beside_the_jax_engine():
    """The same upmap items as the reference balancer, whose census runs
    through the JAX batched engine."""
    om, ref = _balancer_cluster(PORT), _balancer_cluster(REF)
    got = pbalancer.UpmapBalancer(om, device="cpu").optimize(max_swaps=16)
    want = rbalancer.UpmapBalancer(ref).optimize(max_swaps=16)
    assert {(pg.pool, pg.ps): v for pg, v in got.items()} == {
        (pg.pool, pg.ps): v for pg, v in want.items()}
    assert got  # the map is uneven enough to move something
    assert pbalancer.balance(om, max_swaps=16, device="cpu") == len(got)

"""OSDMap incrementals: 100 epochs of deltas land bit-identical.

Reference contract: OSDMap::Incremental (src/osd/OSDMap.h) applied via
OSDMap::apply_incremental (src/osd/OSDMap.cc) must reproduce the full
map exactly; the mon publishes deltas and subscribers stay in lockstep.

The port's twin of tests/test_osdmap_incremental.py: the same cases over
``ceph_tpu_torch``.
"""

from __future__ import annotations

import random

import pytest

from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.osd.mapenc import (
    apply_incremental,
    decode_incremental,
    decode_osdmap,
    diff_osdmap,
    encode_incremental,
    encode_osdmap,
)
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import PgPool, pg_t


def fresh_map(n_osds: int = 12) -> OSDMap:
    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=2, n_hosts=n_osds // 2)
    m = OSDMap(crush=crush)
    m.set_max_osd(n_osds)
    for o in range(n_osds):
        m.new_osd(o)
        m.osd_addrs[o] = ("127.0.0.1", 7000 + o)
    return m


def mutate(m: OSDMap, rng: random.Random, step: int) -> None:
    """One epoch's worth of random map churn."""
    kind = rng.randrange(10)
    if kind == 0:
        m.mark_down(rng.randrange(m.max_osd))
    elif kind == 1:
        m.mark_up(rng.randrange(m.max_osd))
    elif kind == 2:
        m.osd_weight[rng.randrange(m.max_osd)] = rng.choice(
            [0, 0x8000, 0x10000]
        )
    elif kind == 3:
        o = m.max_osd
        m.new_osd(o)
        m.osd_addrs[o] = ("127.0.0.1", 7000 + o)
    elif kind == 4:
        pid = len(m.pools) + 1
        m.pools[pid] = PgPool(
            id=pid, type=1, size=3, min_size=2, crush_rule=0,
            pg_num=8, pgp_num=8,
        )
        m.pool_names[pid] = f"pool{pid}"
    elif kind == 5:
        m.erasure_code_profiles[f"prof{step}"] = {
            "plugin": "jax", "k": "4", "m": "2",
        }
    elif kind == 6:
        pg = pg_t(1, rng.randrange(8))
        if pg in m.pg_upmap_items:
            del m.pg_upmap_items[pg]
        else:
            m.pg_upmap_items[pg] = [(0, 1)]
    elif kind == 7:
        pg = pg_t(1, rng.randrange(8))
        if pg in m.pg_temp:
            del m.pg_temp[pg]
        else:
            m.pg_temp[pg] = [rng.randrange(m.max_osd) for _ in range(3)]
    elif kind == 8:
        m.set_primary_affinity(rng.randrange(m.max_osd), rng.choice(
            [0, 0x8000, 0x10000]
        ))
    elif kind == 9:
        # crush churn: reweight one device bucket item
        for b in m.crush.buckets.values():
            if b.items and rng.random() < 0.5:
                b.item_weights[0] = rng.choice([0x8000, 0x10000, 0x18000])
                break
    m.epoch += 1


def test_100_epochs_of_deltas_land_bit_identical():
    rng = random.Random(42)
    authority = fresh_map()
    follower = decode_osdmap(encode_osdmap(authority))
    for step in range(100):
        prev = decode_osdmap(encode_osdmap(authority))
        mutate(authority, rng, step)
        inc_blob = encode_incremental(diff_osdmap(prev, authority))
        apply_incremental(follower, decode_incremental(inc_blob))
        assert encode_osdmap(follower) == encode_osdmap(authority), (
            f"divergence at epoch {authority.epoch} (step {step})"
        )


def test_gap_detection():
    m = fresh_map()
    m2 = decode_osdmap(encode_osdmap(m))
    prev = decode_osdmap(encode_osdmap(m))
    m.mark_down(0)
    m.epoch += 1
    m.mark_up(0)
    m.epoch += 1
    inc2 = diff_osdmap(prev, m)  # skips an epoch
    with pytest.raises(ValueError):
        apply_incremental(m2, inc2)


def test_pool_and_profile_removal():
    m = fresh_map()
    m.pools[9] = PgPool(id=9, type=1, size=3, min_size=2, crush_rule=0,
                        pg_num=4, pgp_num=4)
    m.pool_names[9] = "doomed"
    m.erasure_code_profiles["p"] = {"k": "2", "m": "1", "plugin": "jax"}
    follower = decode_osdmap(encode_osdmap(m))
    prev = decode_osdmap(encode_osdmap(m))
    del m.pools[9]
    del m.pool_names[9]
    del m.erasure_code_profiles["p"]
    m.epoch += 1
    apply_incremental(
        follower, decode_incremental(encode_incremental(diff_osdmap(prev, m)))
    )
    assert encode_osdmap(follower) == encode_osdmap(m)
    # name-only removal (pool kept) must also propagate
    m.pools[11] = PgPool(id=11, type=1, size=3, min_size=2, crush_rule=0,
                         pg_num=4, pgp_num=4)
    m.pool_names[11] = "transient-name"
    m.epoch += 1
    prev = decode_osdmap(encode_osdmap(m))
    apply_incremental(
        follower, decode_incremental(encode_incremental(diff_osdmap(
            decode_osdmap(encode_osdmap(follower)), m)))
    )
    del m.pool_names[11]
    m.epoch += 1
    apply_incremental(
        follower, decode_incremental(encode_incremental(diff_osdmap(prev, m)))
    )
    assert encode_osdmap(follower) == encode_osdmap(m)

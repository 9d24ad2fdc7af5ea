"""Pool and placement-group types.

Behavioral twin of the reference pool model (src/osd/osd_types.h
``pg_pool_t``, src/include/rados.h ``ceph_stable_mod``): the stable-mod
PG folding that lets pg_num grow without reshuffling every object, the
pool-salted placement seed (``raw_pg_to_pps``,
src/osd/osd_types.cc:1805-1827), and the replicated/erasure split that
decides whether holes may shift left (``can_shift_osds``,
src/osd/osd_types.h:1762).  ``get_snap_context`` comes with the OSD
slice, with the snaps module it needs.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.ops.hashing import crush_hash32_2

CEPH_OSD_IN = 0x10000
CEPH_OSD_OUT = 0
CEPH_OSD_MAX_PRIMARY_AFFINITY = 0x10000
CEPH_OSD_DEFAULT_PRIMARY_AFFINITY = 0x10000


def ceph_stable_mod(x: int, b: int, bmask: int) -> int:
    """src/include/rados.h:96 — fold x into [0,b) such that growing b
    moves as few values as possible."""
    if (x & bmask) < b:
        return x & bmask
    return x & (bmask >> 1)


def _pg_mask(n: int) -> int:
    """(1 << cbits(n-1)) - 1: smallest all-ones mask covering [0, n)."""
    return (1 << max(n - 1, 0).bit_length()) - 1


@dataclass(frozen=True)
class pg_t:
    """Placement group id: (pool, ps).  Mirrors src/osd/osd_types.h pg_t."""

    pool: int
    ps: int


class PoolType:
    REPLICATED = 1
    ERASURE = 3


FLAG_HASHPSPOOL = 1


@dataclass
class PgPool:
    """Twin of pg_pool_t (src/osd/osd_types.h:1472+): the per-pool
    placement parameters the mapping pipeline consumes."""

    id: int
    type: int = PoolType.REPLICATED
    size: int = 3
    min_size: int = 2
    crush_rule: int = 0
    pg_num: int = 32
    pgp_num: int = 32
    flags: int = FLAG_HASHPSPOOL
    # erasure pools record their profile name; the profile itself lives
    # in the cluster map (OSDMonitor semantics)
    erasure_code_profile: str = ""
    # snapshot state (pg_pool_t snap_seq / removed_snaps / snaps):
    # snap_seq is the newest snap id ever allocated in this pool;
    # removed_snaps feeds the OSD snap trimmer; pool_snaps maps
    # ``osd pool mksnap`` names to their ids (self-managed snaps don't
    # appear here)
    snap_seq: int = 0
    removed_snaps: set = field(default_factory=set)
    pool_snaps: dict = field(default_factory=dict)
    # peering_crush_bucket_* / tiering fields intentionally omitted
    # until those subsystems exist.
    extra: dict = field(default_factory=dict)

    @property
    def pg_num_mask(self) -> int:
        return _pg_mask(self.pg_num)

    @property
    def pgp_num_mask(self) -> int:
        return _pg_mask(self.pgp_num)

    def can_shift_osds(self) -> bool:
        """Replicated sets compact over holes; EC sets are positional
        (src/osd/osd_types.h:1762-1771)."""
        if self.type == PoolType.REPLICATED:
            return True
        if self.type == PoolType.ERASURE:
            return False
        raise ValueError(f"unhandled pool type {self.type}")

    def raw_pg_to_pg(self, pg: pg_t) -> pg_t:
        """Fold a raw ps into the current pg_num (osd_types.cc:1805)."""
        return pg_t(pg.pool, ceph_stable_mod(pg.ps, self.pg_num, self.pg_num_mask))

    def raw_pg_to_pps(self, pg: pg_t) -> int:
        """Placement seed fed to CRUSH (osd_types.cc:1816-1827); the
        HASHPSPOOL salt keeps per-pool PG placements decorrelated."""
        if self.flags & FLAG_HASHPSPOOL:
            return int(
                crush_hash32_2(
                    ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask),
                    pg.pool,
                )
            )
        return ceph_stable_mod(pg.ps, self.pgp_num, self.pgp_num_mask) + pg.pool

    @property
    def fast_read(self) -> bool:
        """Read every available shard and decode from the first k to
        answer (pool fast_read flag; reference ECCommon.cc:531)."""
        return self.extra.get("fast_read") == "1"

    def is_erasure(self) -> bool:
        return self.type == PoolType.ERASURE

    def is_replicated(self) -> bool:
        return self.type == PoolType.REPLICATED

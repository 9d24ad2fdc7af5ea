"""Cluster map and the pg -> up/acting placement pipeline.

Behavioral twin of the reference OSDMap mapping path
(src/osd/OSDMap.cc:2670-2971): CRUSH raw placement, upmap exception
tables (explicit ``pg_upmap``, item swaps ``pg_upmap_items``, primary
pins ``pg_upmap_primaries``), down/dne filtering with EC positional
holes, hashed primary-affinity rejection, and pg_temp/primary_temp
recovery overrides — composed exactly as ``_pg_to_up_acting_osds``
(OSDMap.cc:2923-2971) does.

This is the scalar host pipeline; the batched whole-cluster remap
(ParallelPGMapper's job, src/osd/OSDMapMapping.h:18-114) runs on the card via
ceph_tpu_torch.osd.remap.
"""

from __future__ import annotations

from dataclasses import dataclass, field

from ceph_tpu_torch.crush.mapper import crush_do_rule
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE, ChooseArg, CrushMap
from ceph_tpu_torch.ops.hashing import crush_hash32_2
from ceph_tpu_torch.osd.types import (
    CEPH_OSD_DEFAULT_PRIMARY_AFFINITY,
    CEPH_OSD_MAX_PRIMARY_AFFINITY,
    PgPool,
    pg_t,
)

CEPH_OSD_EXISTS = 1
CEPH_OSD_UP = 2
# fullness states, mon-committed from beacon statfs (the reference
# keeps these per-osd in the map too: CEPH_OSD_NEARFULL/.../FULL,
# src/mon/OSDMonitor.cc:669-671); they ride the existing per-osd u8
# state byte on the wire
CEPH_OSD_NEARFULL = 4
CEPH_OSD_BACKFILLFULL = 8
CEPH_OSD_FULL = 16
CEPH_OSD_FULL_MASK = (
    CEPH_OSD_NEARFULL | CEPH_OSD_BACKFILLFULL | CEPH_OSD_FULL)


class _InvalidatingDict(dict):
    """An exception-table dict (pg_temp/upmap/...) that drops its
    OSDMap's mapping memo on every mutation — callers write these
    tables directly (mon _apply_op, balancer, tests), so method-level
    invalidation alone would miss them."""

    __slots__ = ("_owner",)

    def __init__(self, owner: "OSDMap", *a, **kw):
        super().__init__(*a, **kw)
        self._owner = owner

    def _inv(self) -> None:
        self._owner._mapping_cache = None

    def __setitem__(self, k, v):
        self._inv()
        super().__setitem__(k, v)

    def __delitem__(self, k):
        self._inv()
        super().__delitem__(k)

    def pop(self, *a):
        self._inv()
        return super().pop(*a)

    def popitem(self):
        self._inv()
        return super().popitem()

    def clear(self):
        self._inv()
        super().clear()

    def update(self, *a, **kw):
        self._inv()
        super().update(*a, **kw)

    def setdefault(self, k, d=None):
        if k not in self:
            self._inv()
        return super().setdefault(k, d)


class _InvalidatingList(list):
    """osd_state/osd_weight/affinity twin of :class:`_InvalidatingDict`
    — index writes like ``om.osd_state[o] = 0`` must drop the memo."""

    _owner: "OSDMap"

    def _inv(self) -> None:
        self._owner._mapping_cache = None

    def __setitem__(self, i, v):
        self._inv()
        super().__setitem__(i, v)

    def __delitem__(self, i):
        self._inv()
        super().__delitem__(i)

    def __iadd__(self, other):
        self._inv()
        return super().__iadd__(other)

    def append(self, v):
        self._inv()
        super().append(v)

    def extend(self, it):
        self._inv()
        super().extend(it)

    def insert(self, i, v):
        self._inv()
        super().insert(i, v)

    def pop(self, i=-1):
        self._inv()
        return super().pop(i)

    def remove(self, v):
        self._inv()
        super().remove(v)

    def clear(self):
        self._inv()
        super().clear()


def _wrap_list(owner: "OSDMap", cur: list) -> "_InvalidatingList":
    out = _InvalidatingList(cur)
    out._owner = owner
    return out


@dataclass
class OSDMap:
    """Mutable cluster map (an epoch's worth of state).

    ``osd_weight`` is the *out* weight (16.16; 0 = out, 0x10000 = in) —
    distinct from CRUSH bucket weights, it drives probabilistic
    rejection inside CRUSH (mapper.c is_out) and upmap validity.
    """

    crush: CrushMap
    epoch: int = 1
    max_osd: int = 0
    osd_state: list[int] = field(default_factory=list)
    osd_weight: list[int] = field(default_factory=list)
    osd_primary_affinity: list[int] | None = None
    pools: dict[int, PgPool] = field(default_factory=dict)
    # exception tables, all keyed by *folded* pg (raw_pg_to_pg applied):
    pg_upmap: dict[pg_t, list[int]] = field(default_factory=dict)
    pg_upmap_items: dict[pg_t, list[tuple[int, int]]] = field(default_factory=dict)
    pg_upmap_primaries: dict[pg_t, int] = field(default_factory=dict)
    pg_temp: dict[pg_t, list[int]] = field(default_factory=dict)
    primary_temp: dict[pg_t, int] = field(default_factory=dict)
    erasure_code_profiles: dict[str, dict[str, str]] = field(default_factory=dict)
    choose_args: dict[int, ChooseArg] | None = None
    # entity addresses (reference OSDMap osd_addrs): osd -> (host, port)
    osd_addrs: dict[int, tuple[str, int]] = field(default_factory=dict)
    # pool id -> name (reference OSDMap pool_name map)
    pool_names: dict[int, str] = field(default_factory=dict)
    # per-epoch memo of pg_to_up_acting_osds (see its docstring);
    # (epoch, {(pg, folded): (up, upp, acting, actp)}) — never encoded
    _mapping_cache: tuple | None = field(
        default=None, repr=False, compare=False)

    def __post_init__(self) -> None:
        # exception tables invalidate the mapping memo on direct writes
        for name in ("pg_upmap", "pg_upmap_items", "pg_upmap_primaries",
                     "pg_temp", "primary_temp"):
            cur = getattr(self, name)
            if not isinstance(cur, _InvalidatingDict):
                setattr(self, name, _InvalidatingDict(self, cur))
        for name in ("osd_state", "osd_weight", "osd_primary_affinity"):
            cur = getattr(self, name)
            if isinstance(cur, list) and not isinstance(
                    cur, _InvalidatingList):
                setattr(self, name, _wrap_list(self, cur))

    def invalidate_mapping_cache(self) -> None:
        """Drop the per-epoch mapping memo.  Mutator methods and the
        exception-table dicts call this; remaining direct-field writes
        (osd_weight[i] in mon _apply_op / apply_incremental, CRUSH
        structural edits via builder) are covered by the epoch bump
        that lands with every committed mutation — call this by hand
        when mutating those outside a map commit."""
        self._mapping_cache = None

    def lookup_pg_pool_name(self, name: str) -> int:
        for pid, n in self.pool_names.items():
            if n == name:
                return pid
        return -1

    # -- osd state ---------------------------------------------------

    def set_max_osd(self, n: int) -> None:
        self.max_osd = n
        self.osd_state += [0] * (n - len(self.osd_state))
        self.osd_weight += [0] * (n - len(self.osd_weight))
        if self.osd_primary_affinity is not None:
            self.osd_primary_affinity += [CEPH_OSD_DEFAULT_PRIMARY_AFFINITY] * (
                n - len(self.osd_primary_affinity)
            )
        del self.osd_state[n:]
        del self.osd_weight[n:]

    def new_osd(self, osd: int, weight: int = 0x10000, up: bool = True) -> None:
        self.invalidate_mapping_cache()
        if osd >= self.max_osd:
            self.set_max_osd(osd + 1)
        self.osd_state[osd] = CEPH_OSD_EXISTS | (CEPH_OSD_UP if up else 0)
        self.osd_weight[osd] = weight

    def exists(self, osd: int) -> bool:
        return (
            0 <= osd < self.max_osd
            and bool(self.osd_state[osd] & CEPH_OSD_EXISTS)
        )

    def is_up(self, osd: int) -> bool:
        return self.exists(osd) and bool(self.osd_state[osd] & CEPH_OSD_UP)

    def is_down(self, osd: int) -> bool:
        return not self.is_up(osd)

    def is_out(self, osd: int) -> bool:
        return not self.exists(osd) or self.osd_weight[osd] == 0

    def is_full(self, osd: int) -> bool:
        return self.exists(osd) and bool(
            self.osd_state[osd] & CEPH_OSD_FULL)

    def is_backfillfull(self, osd: int) -> bool:
        # FULL implies backfillfull (ratios are ordered)
        return self.exists(osd) and bool(
            self.osd_state[osd] & (CEPH_OSD_BACKFILLFULL | CEPH_OSD_FULL))

    def is_nearfull(self, osd: int) -> bool:
        return self.exists(osd) and bool(
            self.osd_state[osd] & CEPH_OSD_FULL_MASK)

    def mark_down(self, osd: int) -> None:
        self.invalidate_mapping_cache()
        self.osd_state[osd] &= ~CEPH_OSD_UP

    def mark_up(self, osd: int) -> None:
        self.invalidate_mapping_cache()
        self.osd_state[osd] |= CEPH_OSD_UP | CEPH_OSD_EXISTS

    def mark_out(self, osd: int) -> None:
        self.invalidate_mapping_cache()
        self.osd_weight[osd] = 0

    def set_primary_affinity(self, osd: int, aff: int) -> None:
        self.invalidate_mapping_cache()
        if self.osd_primary_affinity is None:
            self.osd_primary_affinity = _wrap_list(self, [
                CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
            ] * self.max_osd)
        self.osd_primary_affinity[osd] = aff

    def get_pg_pool(self, poolid: int) -> PgPool | None:
        return self.pools.get(poolid)

    # -- the pipeline (OSDMap.cc:2670-2971) --------------------------

    def _remove_nonexistent_osds(self, pool: PgPool, osds: list[int]) -> None:
        """OSDMap.cc:2646-2668: dne OSDs vanish (replicated) or become
        positional holes (EC)."""
        if pool.can_shift_osds():
            osds[:] = [o for o in osds if self.exists(o)]
        else:
            for i, o in enumerate(osds):
                if not self.exists(o):
                    osds[i] = CRUSH_ITEM_NONE

    def _pg_to_raw_osds(self, pool: PgPool, pg: pg_t) -> tuple[list[int], int]:
        """OSDMap.cc:2670-2688."""
        pps = pool.raw_pg_to_pps(pg)
        osds: list[int] = []
        if pool.crush_rule >= 0 and pool.crush_rule in self.crush.rules:
            osds = crush_do_rule(
                self.crush, pool.crush_rule, pps, pool.size,
                self.osd_weight, self.choose_args,
            )
        self._remove_nonexistent_osds(pool, osds)
        return osds, pps

    @staticmethod
    def _pick_primary(osds: list[int]) -> int:
        """OSDMap.cc:2690-2697: first non-hole."""
        for o in osds:
            if o != CRUSH_ITEM_NONE:
                return o
        return -1

    def _upmap_target_invalid(self, osd: int) -> bool:
        """A target is unusable if it is marked out or an invalid id."""
        return not (
            osd != CRUSH_ITEM_NONE
            and 0 <= osd < self.max_osd
            and self.osd_weight[osd] != 0
        )

    def _apply_upmap(self, pool: PgPool, raw_pg: pg_t, raw: list[int]) -> None:
        """OSDMap.cc:2699-2765."""
        pg = pool.raw_pg_to_pg(raw_pg)
        explicit = self.pg_upmap.get(pg)
        if explicit is not None:
            for osd in explicit:
                if (
                    osd != CRUSH_ITEM_NONE
                    and 0 <= osd < self.max_osd
                    and self.osd_weight[osd] == 0
                ):
                    return  # reject the whole explicit mapping
            raw[:] = list(explicit)
            # fall through: pg_upmap_items still applies
        for osd_from, osd_to in self.pg_upmap_items.get(pg, []):
            exists = False
            pos = -1
            # skip only when osd_to is a *valid* id that is marked out
            # (OSDMap.cc:2736-2740); invalid ids are applied and later
            # filtered into holes by _raw_to_up_osds
            to_valid_but_out = (
                osd_to != CRUSH_ITEM_NONE
                and 0 <= osd_to < self.max_osd
                and self.osd_weight[osd_to] == 0
            )
            for i, osd in enumerate(raw):
                if osd == osd_to:
                    exists = True
                    break
                if osd == osd_from and pos < 0 and not to_valid_but_out:
                    pos = i
            if not exists and pos >= 0:
                raw[pos] = osd_to
        new_prim = self.pg_upmap_primaries.get(pg)
        if new_prim is not None and not self._upmap_target_invalid(new_prim):
            new_prim_idx = 0
            for i in range(1, len(raw)):  # start from 1 on purpose
                if raw[i] == new_prim:
                    new_prim_idx = i
                    break
            if new_prim_idx > 0:
                raw[new_prim_idx] = raw[0]
                raw[0] = new_prim

    def _raw_to_up_osds(self, pool: PgPool, raw: list[int]) -> list[int]:
        """OSDMap.cc:2767-2791: drop (replicated) or hole-out (EC) the
        down/dne members."""
        if pool.can_shift_osds():
            return [o for o in raw if self.exists(o) and not self.is_down(o)]
        return [
            CRUSH_ITEM_NONE if (not self.exists(o) or self.is_down(o)) else o
            for o in raw
        ]

    def _apply_primary_affinity(
        self, seed: int, pool: PgPool, osds: list[int], primary: int
    ) -> int:
        """OSDMap.cc:2793-2846: hashed proportional rejection so an OSD
        with affinity a primaries only a/0x10000 of its PGs."""
        aff = self.osd_primary_affinity
        if aff is None:
            return primary
        if not any(
            o != CRUSH_ITEM_NONE and aff[o] != CEPH_OSD_DEFAULT_PRIMARY_AFFINITY
            for o in osds
        ):
            return primary
        pos = -1
        for i, o in enumerate(osds):
            if o == CRUSH_ITEM_NONE:
                continue
            a = aff[o]
            if a < CEPH_OSD_MAX_PRIMARY_AFFINITY and (
                int(crush_hash32_2(seed, o)) >> 16
            ) >= a:
                if pos < 0:
                    pos = i  # fallback, keep looking
            else:
                pos = i
                break
        if pos < 0:
            return primary
        primary = osds[pos]
        if pool.can_shift_osds() and pos > 0:
            # move the new primary to the front
            for i in range(pos, 0, -1):
                osds[i] = osds[i - 1]
            osds[0] = primary
        return primary

    def _get_temp_osds(self, pool: PgPool, raw_pg: pg_t) -> tuple[list[int], int]:
        """OSDMap.cc:2848-2881: recovery-time acting-set overrides."""
        pg = pool.raw_pg_to_pg(raw_pg)
        temp_pg: list[int] = []
        for o in self.pg_temp.get(pg, []):
            if not self.exists(o) or self.is_down(o):
                if pool.can_shift_osds():
                    continue
                temp_pg.append(CRUSH_ITEM_NONE)
            else:
                temp_pg.append(o)
        temp_primary = self.primary_temp.get(pg, -1)
        if temp_primary == -1 and temp_pg:
            temp_primary = self._pick_primary(temp_pg)
        return temp_pg, temp_primary

    # -- public queries ----------------------------------------------

    def pg_to_raw_osds(self, pg: pg_t) -> tuple[list[int], int]:
        """(raw osds, primary) before upmap/filters (OSDMap.cc:2883)."""
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, _ = self._pg_to_raw_osds(pool, pg)
        return raw, self._pick_primary(raw)

    def pg_to_raw_up(self, pg: pg_t) -> tuple[list[int], int]:
        """OSDMap.cc:2909-2925."""
        pool = self.get_pg_pool(pg.pool)
        if pool is None:
            return [], -1
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        primary = self._pick_primary(raw)
        primary = self._apply_primary_affinity(pps, pool, up, primary)
        return up, primary

    def pg_to_up_acting_osds(
        self, pg: pg_t, folded: bool = False
    ) -> tuple[list[int], int, list[int], int]:
        """(up, up_primary, acting, acting_primary) —
        OSDMap.cc:2923-2971.  ``pg`` is a raw pg by default (the
        pipeline folds it, raw_pg_to_pg=true branch); with
        ``folded=True`` the ps must already be in [0, pg_num) and
        out-of-range returns empty.

        Results are memoized per epoch (the OSDMapMapping /
        ParallelPGMapper role, src/osd/OSDMapMapping.h:18): every
        daemon subsystem — peering, recovery, scrub, op admission —
        asks for the same mappings many times per epoch, and the
        scalar pipeline is pure given one epoch's state.  Mutators
        bump ``epoch`` (mon commit path) which naturally invalidates;
        in-place mutators below also drop the cache explicitly."""
        cache = self._mapping_cache
        if cache is None or cache[0] != self.epoch:
            cache = (self.epoch, {})
            self._mapping_cache = cache
        hit = cache[1].get((pg, folded))
        if hit is not None:
            up, up_primary, acting, acting_primary = hit
            return list(up), up_primary, list(acting), acting_primary
        pool = self.get_pg_pool(pg.pool)
        if pool is None or (folded and pg.ps >= pool.pg_num):
            return [], -1, [], -1
        acting, acting_primary = self._get_temp_osds(pool, pg)
        raw, pps = self._pg_to_raw_osds(pool, pg)
        self._apply_upmap(pool, pg, raw)
        up = self._raw_to_up_osds(pool, raw)
        up_primary = self._pick_primary(up)
        up_primary = self._apply_primary_affinity(pps, pool, up, up_primary)
        if not acting:
            acting = list(up)
            if acting_primary == -1:
                acting_primary = up_primary
        cache[1][(pg, folded)] = (
            tuple(up), up_primary, tuple(acting), acting_primary)
        return up, up_primary, acting, acting_primary

    def pg_is_ec(self, pg: pg_t) -> bool:
        pool = self.get_pg_pool(pg.pool)
        return pool is not None and pool.is_erasure()

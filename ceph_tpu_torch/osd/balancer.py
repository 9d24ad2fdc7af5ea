"""Upmap balancer: even out PG placement with pg_upmap_items.

Behavioral twin of the reference's upmap optimizer
(OSDMap::calc_pg_upmaps, src/osd/OSDMap.h:1519, driven by the mgr
balancer module in upmap mode): compute every PG's mapping, find
overfull/underfull OSDs against their weight-proportional targets, and
emit pg_upmap_items entries (per-PG [from, to] swaps) that move PGs
from the fullest devices to the emptiest ones without breaking
placement constraints.

The whole-cluster placement census runs through the batched CUDA engine
(BatchedClusterMapper, on the card unless ``device`` says otherwise) —
the reference iterates pg-by-pg on the CPU; here each pool's full
mapping is one kernel launch, and the greedy
swap selection is cheap host work over the resulting arrays.

Constraint checking: a candidate swap is valid only if the destination
OSD is up/in, not already in the PG's set, and lives in a different
failure domain than every *other* member (same-or-better isolation than
the mapping it replaces — the reference validates candidates by
re-running crush; we validate structurally against the bucket tree).
"""

from __future__ import annotations

from collections import defaultdict

from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops.rs_kernels import resolve_device
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.remap import BatchedClusterMapper
from ceph_tpu_torch.osd.types import pg_t


class UpmapBalancer:
    def __init__(self, osdmap: OSDMap, failure_domain_type: int = 1, device=None):
        self.om = osdmap
        self.domain_type = failure_domain_type
        self.device = resolve_device(device)
        crush = osdmap.crush
        self._parent: dict[int, int] = {}
        for b in crush.buckets.values():
            for it in b.items:
                self._parent[it] = b.id

    def _domain(self, osd: int) -> int:
        cur = osd
        while cur in self._parent:
            cur = self._parent[cur]
            b = self.om.crush.buckets.get(cur)
            if b is not None and b.type == self.domain_type:
                return cur
        return osd  # degenerate maps: the osd is its own domain

    def census(self) -> tuple[dict[int, int], dict[pg_t, list[int]]]:
        """Whole-cluster placement: per-OSD PG counts + per-PG up sets
        (one batched remap)."""
        bcm = BatchedClusterMapper(self.om, device=self.device)
        counts: dict[int, int] = defaultdict(int)
        pgs: dict[pg_t, list[int]] = {}
        for pid, pm in bcm.map_cluster().items():
            for ps in range(self.om.pools[pid].pg_num):
                row = [
                    int(o) for o in pm.up[ps, : pm.up_cnt[ps]]
                    if o != CRUSH_ITEM_NONE
                ]
                pgs[pg_t(pid, ps)] = row
                for o in row:
                    counts[o] += 1
        return dict(counts), pgs

    def targets(self, total_slots: int) -> dict[int, float]:
        """Weight-proportional PG-count target per up+in OSD."""
        om = self.om
        weights = {
            o: om.osd_weight[o]
            for o in range(om.max_osd)
            if om.is_up(o) and not om.is_out(o)
        }
        wsum = sum(weights.values()) or 1
        return {o: total_slots * w / wsum for o, w in weights.items()}

    def optimize(
        self, max_swaps: int = 64, max_deviation: float = 1.0
    ) -> dict[pg_t, list[tuple[int, int]]]:
        """Greedy calc_pg_upmaps: repeatedly move one PG slot from the
        most-overfull OSD to the most-underfull valid OSD.  Returns the
        new pg_upmap_items entries (not yet applied to the map)."""
        om = self.om
        new_items: dict[pg_t, list[tuple[int, int]]] = {}
        counts, pgs = self.census()
        total = sum(counts.values())
        target = self.targets(total)
        for o in target:
            counts.setdefault(o, 0)

        for _ in range(max_swaps):
            over = max(target, key=lambda o: counts[o] - target[o])
            under = min(target, key=lambda o: counts[o] - target[o])
            if (
                counts[over] - target[over] <= max_deviation
                and target[under] - counts[under] <= max_deviation
            ):
                break  # balanced enough
            moved = False
            for pg, row in pgs.items():
                if over not in row or under in row:
                    continue
                if pg in new_items or pg in om.pg_upmap_items:
                    continue  # one adjustment per pg keeps this simple
                others = [o for o in row if o != over]
                udom = self._domain(under)
                if any(self._domain(o) == udom for o in others):
                    continue  # would stack two members in one domain
                new_items[pg] = [(over, under)]
                row[row.index(over)] = under
                counts[over] -= 1
                counts[under] += 1
                moved = True
                break
            if not moved:
                break  # no legal move improves the worst pair
        return new_items

    def apply(self, items: dict[pg_t, list[tuple[int, int]]]) -> None:
        """Install the computed exception-table entries (what the mgr
        balancer sends as 'osd pg-upmap-items' commands)."""
        for pg, pairs in items.items():
            self.om.pg_upmap_items[pg] = list(pairs)


def balance(osdmap: OSDMap, max_swaps: int = 64, device=None) -> int:
    """One balancer round: optimize + apply; returns swaps installed."""
    try:
        fd = osdmap.crush.type_id("host")
    except KeyError:
        fd = 1
    b = UpmapBalancer(osdmap, failure_domain_type=fd, device=device)
    items = b.optimize(max_swaps=max_swaps)
    b.apply(items)
    return len(items)

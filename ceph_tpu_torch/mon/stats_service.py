"""Stats/health service: the MgrStatMonitor + HealthMonitor plane.

Aggregates per-PG stats and per-OSD statfs from beacons into the
cluster pg map, fullness bits, and health checks (reference
src/mon/MgrStatMonitor.cc, src/mon/HealthMonitor.cc, and the
DaemonServer ingestion path).
"""

from __future__ import annotations

import logging

log = logging.getLogger("ceph_tpu_torch.mon")


class StatsServiceMixin:
    def _ingest_pg_stats(self, osd: int, epoch: int, raw: bytes) -> None:
        """MgrStatMonitor/DaemonServer role: fold one OSD's per-PG
        report into the cluster pg map (newest epoch wins per pg)."""
        import json
        import re

        try:
            stats = json.loads(raw)
            if not isinstance(stats, dict):
                return
        except ValueError:
            return
        book = getattr(self, "_pg_stats", None)
        if book is None:
            book = self._pg_stats = {}
        for pgid, st in stats.items():
            # shape-check: a version-skewed OSD must not be able to
            # poison the status plane
            if not (isinstance(pgid, str) and re.fullmatch(r"\d+\.\d+", pgid)
                    and isinstance(st, dict)
                    and isinstance(st.get("state"), str)):
                continue
            cur = book.get(pgid)
            if cur is None or cur.get("epoch", 0) <= epoch:
                st = dict(st)
                st["epoch"] = epoch
                st["primary"] = osd
                book[pgid] = st

    async def _ingest_statfs(self, osd: int, raw: bytes) -> None:
        """Fold one OSD's store usage into the fullness plane
        (reference OSDMonitor full-state tracking,
        src/mon/OSDMonitor.cc:669-671 ratios + OSD.cc:773
        recalc_full_state): keep the latest statfs for `df`, derive
        the osd's fullness bits from the configured ratios, and commit
        a map change whenever the bits flip so every daemon and client
        gates on the same epoch's truth."""
        import json

        try:
            sf = json.loads(raw)
            total = int(sf["total"])
            used = int(sf["used"])
        except (ValueError, KeyError, TypeError):
            return
        book = getattr(self, "_osd_statfs", None)
        if book is None:
            book = self._osd_statfs = {}
        book[osd] = sf
        ratio = (used / total) if total > 0 else 0.0
        from ceph_tpu_torch.osd.osdmap import (
            CEPH_OSD_BACKFILLFULL,
            CEPH_OSD_FULL,
            CEPH_OSD_FULL_MASK,
            CEPH_OSD_NEARFULL,
        )

        bits = 0
        if ratio >= self.conf["mon_osd_full_ratio"]:
            bits = CEPH_OSD_FULL
        elif ratio >= self.conf["mon_osd_backfillfull_ratio"]:
            bits = CEPH_OSD_BACKFILLFULL
        elif ratio >= self.conf["mon_osd_nearfull_ratio"]:
            bits = CEPH_OSD_NEARFULL
        om = self.osdmap
        if not om.exists(osd):
            return
        cur = om.osd_state[osd] & CEPH_OSD_FULL_MASK
        if cur != bits:
            await self._propose({
                "op": "full_state", "osd": osd, "bits": bits,
            })

    def _pg_summary(self) -> dict:
        """Aggregate pg states (the `ceph -s` pgs block)."""
        book = getattr(self, "_pg_stats", {}) or {}
        om = self.osdmap
        expected = sum(p.pg_num for p in om.pools.values())
        by_state: dict[str, int] = {}
        objects = 0
        min_epoch = om.epoch
        primaries = self._pg_primaries(om)
        for pgid, st in book.items():
            pid_s, ps_s = pgid.split(".")
            pid = int(pid_s)
            if pid not in om.pools:
                continue
            if int(ps_s) >= om.pools[pid].pg_num:
                continue  # dissolved merge child (late beacon)
            state = st.get("state", "unknown")
            # a report from a primary that is now down — or that is no
            # longer THE primary after a remap — is STALE until the
            # current primary reports (reference pg_state stale
            # semantics: stats are per-interval)
            reporter = st.get("primary", -1)
            cur_primary = primaries.get((pid, int(ps_s)), -1)
            if not om.is_up(reporter) or reporter != cur_primary:
                state = "stale"
            by_state[state] = by_state.get(state, 0) + 1
            objects += int(st.get("objects", 0))
            min_epoch = min(min_epoch, int(st.get("epoch", 0)))
        reported = sum(by_state.values())
        return {
            "num_pgs": expected,
            "num_reported": reported,
            "by_state": by_state,
            "num_objects": objects,
            # the oldest osdmap epoch any counted report was computed
            # at: a waiter that just forced a map change can require
            # min_reported_epoch >= that epoch so pre-change
            # active+clean reports can't satisfy it (the qa-helper
            # wait_for_clean checks last_epoch_clean the same way)
            "min_reported_epoch": (
                min_epoch if reported else 0),
        }

    def _pg_primaries(self, om) -> dict[tuple[int, int], int]:
        """pg -> current primary, CACHED PER EPOCH: status/health are
        the hottest mon read path and a full CRUSH pass per call would
        stall beacon dispatch (the balancer learned this the hard way
        — see the to_thread note there)."""
        from ceph_tpu_torch.osd.types import pg_t as _pg_t

        cache_epoch, out, seen = getattr(
            self, "_primaries_cache", (None, {}, set()))
        if cache_epoch != om.epoch:
            out, seen = {}, set()
            self._primaries_cache = (om.epoch, out, seen)
        # memoize per epoch, computing only the pgids actually present
        # in the stats book (bounded by reports, not pools x pg_num) —
        # lazily, so pgids whose first report lands mid-epoch still
        # resolve; `seen` keeps warm calls near-O(1)
        book = getattr(self, "_pg_stats", {}) or {}
        if len(seen) != len(book):
            for pgid in book:
                if pgid in seen:
                    continue
                seen.add(pgid)
                pid_s, ps_s = pgid.split(".")
                pid, ps = int(pid_s), int(ps_s)
                if pid not in om.pools:
                    continue
                _u, _up, _a, primary = om.pg_to_up_acting_osds(
                    _pg_t(pid, ps), folded=True)
                out[(pid, ps)] = primary
        return out

    def _health_checks(self, pgsum: dict | None = None) -> dict:
        """HealthMonitor role (reference src/mon/HealthMonitor.cc +
        per-map checks): OSD_DOWN, MON_DOWN, PG_DEGRADED."""
        om = self.osdmap
        checks: dict[str, dict] = {}
        # down+IN only: a drained (down+out) osd is not a warning
        # (HealthMonitor counts num_down_in_osds)
        down = [
            o for o in range(om.max_osd)
            if om.exists(o) and not om.is_up(o) and not om.is_out(o)
        ]
        if down:
            checks["OSD_DOWN"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(down)} osds down",
                "detail": [f"osd.{o} is down" for o in down],
            }
        if self.n_mons > 1:
            q = sorted(self.paxos.quorum)
            if len(q) < self.n_mons:
                missing = [r for r in range(self.n_mons) if r not in q]
                checks["MON_DOWN"] = {
                    "severity": "HEALTH_WARN",
                    "summary": (
                        f"{len(missing)}/{self.n_mons} mons out of quorum"
                    ),
                    "detail": [f"mon.{r} out of quorum" for r in missing],
                }
        if pgsum is None:
            pgsum = self._pg_summary()
        bad = {
            st: n for st, n in pgsum["by_state"].items()
            if "degraded" in st or "recovering" in st or "stale" in st
        }
        if bad:
            checks["PG_DEGRADED"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{sum(bad.values())} pgs not clean: "
                    + ", ".join(f"{n} {st}" for st, n in sorted(bad.items()))
                ),
                "detail": [],
            }
        # fullness (reference OSD_FULL/OSD_BACKFILLFULL/OSD_NEARFULL
        # health checks): FULL is an error — writes are bouncing
        full = [o for o in range(om.max_osd) if om.is_full(o)]
        bfull = [
            o for o in range(om.max_osd)
            if om.is_backfillfull(o) and o not in full
        ]
        near = [
            o for o in range(om.max_osd)
            if om.is_nearfull(o) and o not in full and o not in bfull
        ]
        if full:
            checks["OSD_FULL"] = {
                "severity": "HEALTH_ERR",
                "summary": f"{len(full)} full osd(s); writes blocked",
                "detail": [f"osd.{o} is full" for o in full],
            }
        if bfull:
            checks["OSD_BACKFILLFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": (
                    f"{len(bfull)} backfillfull osd(s); backfill paused"
                ),
                "detail": [f"osd.{o} is backfillfull" for o in bfull],
            }
        if near:
            checks["OSD_NEARFULL"] = {
                "severity": "HEALTH_WARN",
                "summary": f"{len(near)} nearfull osd(s)",
                "detail": [f"osd.{o} is nearfull" for o in near],
            }
        if any(c["severity"] == "HEALTH_ERR" for c in checks.values()):
            status = "HEALTH_ERR"
        else:
            status = "HEALTH_OK" if not checks else "HEALTH_WARN"
        return {"status": status, "checks": checks}

"""The mgr's time-series store and the analytics digest.

Counterpart of the part of ``ceph_tpu/mgr/daemon.py`` that the digest
path needs: :data:`SAMPLE_CLAMP`, :class:`TimeSeriesStore` (:52-155) and
:func:`analytics_summary`, the body of ``MgrDaemon._analytics_summary``
(:523-560) as a function of the store and the engine's result.  Every
daemon's MgrClient report lands in the store; each digest tick the
analytics engine (:mod:`.analytics`) reduces the whole store in one
kernel launch, and the summary keys that result back to daemon and
metric names (`ceph osd perf`, the SLOW_OPS and scrub-deprioritize
decisions).

``MgrDaemon`` itself — beacons, the MgrMap, the report sessions, the
digest loop — needs the messenger (``msg``) and is ported with the
daemons (``ROADMAP.md`` Queue 1, items 4-5).
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.mgr.analytics import PCTS, SCALE_SHIFT

#: ring samples are clamped here so the int64 reductions can never
#: overflow (a sum over D*W clamped samples stays far below 2**63)
SAMPLE_CLAMP = 1 << 40


class TimeSeriesStore:
    """Fixed-shape per-(daemon, metric) ring buffers.

    The whole store is three dense arrays — ``values`` (D, M, W) int64,
    ``valid`` (D, M, W) bool, ``cursor`` (D,) — so the analytics engine
    reduces it in one launch with a shape known at mgr start (the
    prewarm contract).  Daemon slots are LRU-evicted when full; metric
    slots are first-come with overflow counted and dropped (never a
    silent resize, which would change the launch shape)."""

    def __init__(self, max_daemons: int, max_metrics: int, window: int):
        self.shape = (max_daemons, max_metrics, window)
        self.values = np.zeros(self.shape, np.int64)
        self.valid = np.zeros(self.shape, bool)
        self.cursor = np.zeros(max_daemons, np.int64)
        self.daemons: dict[str, int] = {}
        self.metric_names: dict[str, int] = {}
        self.last_seen: dict[str, float] = {}
        self.dropped_metrics: dict[str, int] = {}
        self.evictions = 0

    def _daemon_slot(self, daemon: str) -> int:
        slot = self.daemons.get(daemon)
        if slot is not None:
            return slot
        D = self.shape[0]
        if len(self.daemons) < D:
            used = set(self.daemons.values())
            slot = next(i for i in range(D) if i not in used)
        else:
            victim = min(self.last_seen, key=self.last_seen.get)
            slot = self.daemons.pop(victim)
            self.last_seen.pop(victim, None)
            self.evictions += 1
        self.daemons[daemon] = slot
        self.values[slot] = 0
        self.valid[slot] = False
        self.cursor[slot] = 0
        return slot

    def _metric_slot(self, name: str) -> int | None:
        slot = self.metric_names.get(name)
        if slot is not None:
            return slot
        if len(self.metric_names) >= self.shape[1]:
            self.dropped_metrics[name] = self.dropped_metrics.get(name, 0) + 1
            return None
        slot = len(self.metric_names)
        self.metric_names[name] = slot
        return slot

    def ingest(self, daemon: str, samples: dict[str, float], now: float) -> None:
        """One report: every sample lands in the same window column (one
        column a report), then the cursor advances — samples absent from
        this report leave an invalid cell, so means and percentiles never
        see stale values."""
        d = self._daemon_slot(daemon)
        c = int(self.cursor[d])
        self.values[d, :, c] = 0
        self.valid[d, :, c] = False
        for name, v in samples.items():
            m = self._metric_slot(name)
            if m is None:
                continue
            q = int(np.rint(v))
            self.values[d, m, c] = min(max(q, 0), SAMPLE_CLAMP)
            self.valid[d, m, c] = True
        self.cursor[d] = (c + 1) % self.shape[2]
        self.last_seen[daemon] = now

    def series(self, daemon: str, metric: str) -> list[int]:
        """Time-ordered valid samples of one (daemon, metric) — the
        dashboard's and the tests' view; analytics never walks it."""
        d = self.daemons.get(daemon)
        m = self.metric_names.get(metric)
        if d is None or m is None:
            return []
        W = self.shape[2]
        c = int(self.cursor[d])
        out = []
        for t in range(W):
            i = (c + t) % W
            if self.valid[d, m, i]:
                out.append(int(self.values[d, m, i]))
        return out

    def reserve(self, names) -> None:
        """Pre-assign metric slots (in order) so declared analytics
        columns get deterministic positions and are never dropped by
        transient metrics racing for slots."""
        for name in names:
            self._metric_slot(name)

    def snapshot(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        return self.values.copy(), self.valid.copy(), self.cursor.copy()


def analytics_summary(store: TimeSeriesStore, result: dict | None) -> dict:
    """The analytics result keyed back to daemon and metric names:
    percentiles of each metric with samples, each reporting daemon's
    mean, EWMA and outlier flag by metric, and the outlier daemons of
    each metric (sorted).  ``{}`` before the first pass."""
    a = result
    if a is None:
        return {}
    names = {i: n for n, i in store.metric_names.items()}
    daemons = {i: n for n, i in store.daemons.items()}
    pct = {}
    for m, name in names.items():
        if int(a["n_samples"][m]) == 0:
            continue
        pct[name] = {f"p{p}": int(a["percentiles"][m, i]) for i, p in enumerate(PCTS)}
        pct[name]["n"] = int(a["n_samples"][m])
    outliers = {}
    means = {}
    for m, mname in names.items():
        row = {}
        for d, dname in daemons.items():
            if int(a["count"][d, m]) > 0:
                row[dname] = {
                    "mean": int(a["mean_scaled"][d, m]) / (1 << SCALE_SHIFT),
                    "ewma": int(a["ewma_scaled"][d, m]) / (1 << SCALE_SHIFT),
                    "outlier": bool(a["outlier"][d, m]),
                }
        if row:
            means[mname] = row
            out = sorted(d for d, v in row.items() if v["outlier"])
            if out:
                outliers[mname] = out
    return {"percentiles": pct, "series": means, "outliers": outliers}

"""Cluster analytics engine: one kernel launch over the whole time-series
store.

Counterpart of ``ceph_tpu/mgr/analytics.py``.  The mgr lands every
report in a fixed-shape ``(daemons x metrics x window)`` ring buffer
(:class:`ceph_tpu_torch.mgr.daemon.TimeSeriesStore`).  This module
computes the cluster-wide view — p50/p95/p99 per metric, the EWMA trend
of each (daemon, metric) series, and outlier daemons — as one launch of
``ops/csrc/mgr_analytics.cu`` over that whole array: the same shape
every tick, launched once at mgr start by :meth:`AnalyticsEngine.prewarm`,
so the digest path meets no first-use cost (the ``cold_launches``
discipline of the decode and scrub batchers; counters in
``BucketCounters("mgr_analytics")``).

The engine is integer-exact end to end, so the kernel and the numpy host
path :func:`analyze_numpy` return bit-identical arrays: samples are
int64; percentiles are nearest-rank selections; the EWMA runs in fixed
point (values scaled by ``2**SCALE_SHIFT``, ``e += (x*S - e) >>
ALPHA_SHIFT``, alpha = 1/4); means are ``(sum << SCALE_SHIFT) // count``;
a daemon is an outlier on a metric when its mean exceeds
``OUTLIER_FACTOR`` x the lower median of all reporting daemons' means.

Two choices differ from the reference on purpose: a device failure in
:meth:`AnalyticsEngine.analyze` raises (the reference answers from
``analyze_numpy`` and counts a fallback), and :meth:`~AnalyticsEngine.prewarm`
lets an exception out (the reference swallows it).  ``backend="numpy"``
stays: it is the mgr's configured host backend
(``mgr_analytics_backend``), not a fallback.
"""

from __future__ import annotations

import collections
import contextlib
import threading

import numpy as np
import torch

from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.common.metrics import BucketCounters
from ceph_tpu_torch.common.tracing import device_tracer
from ceph_tpu_torch.ops import analytics_kernels as ak
from ceph_tpu_torch.ops.analytics_kernels import (  # noqa: F401
    ALPHA_SHIFT,
    OUTLIER_FACTOR,
    PCTS,
    SCALE_SHIFT,
)
from ceph_tpu_torch.ops.rs_kernels import resolve_device

_I64_MAX = np.int64(np.iinfo(np.int64).max)

#: the engine's backends: the kernel, or the host reference
BACKENDS = ("cuda", "numpy")


def analytics_counters() -> BucketCounters:
    """Process-wide analytics perf collection (launch and cold-launch
    accounting, shaped as the decode and scrub batchers')."""
    return BucketCounters("mgr_analytics")


def _ordered(values, valid, cursor):
    """Each daemon's ring in time order: ``cursor[d]`` is the next write
    position, i.e. the oldest sample."""
    D, M, W = values.shape
    idx = (cursor[:, None].astype(np.int64) + np.arange(W, dtype=np.int64)[None, :]) % W
    gid = np.broadcast_to(idx[:, None, :], (D, M, W))
    return np.take_along_axis(values, gid, axis=2), np.take_along_axis(valid, gid, axis=2)


def _percentiles(vals, mask):
    """(M, len(PCTS)) nearest-rank percentiles over every valid sample of
    each metric (daemons x window flattened)."""
    D, M, W = vals.shape
    flat = np.swapaxes(vals, 0, 1).reshape(M, D * W)
    fmask = np.swapaxes(mask, 0, 1).reshape(M, D * W)
    srt = np.sort(np.where(fmask, flat, _I64_MAX), axis=1)
    n = np.sum(fmask.astype(np.int64), axis=1)
    cols = []
    for p in PCTS:
        pos = (np.int64(p) * n + np.int64(99)) // np.int64(100) - np.int64(1)
        pos = np.clip(pos, 0, D * W - 1)
        v = np.take_along_axis(srt, pos[:, None], axis=1)[:, 0]
        cols.append(np.where(n > 0, v, np.int64(0)))
    return np.stack(cols, axis=1), n


def _means(vals, mask):
    """Scaled per-(daemon, metric) means and counts, exact int64."""
    sums = np.sum(np.where(mask, vals, np.int64(0)), axis=2)
    cnt = np.sum(mask.astype(np.int64), axis=2)
    mean_scaled = (sums << np.int64(SCALE_SHIFT)) // np.maximum(cnt, np.int64(1))
    return np.where(cnt > 0, mean_scaled, np.int64(0)), cnt


def _outliers(mean_scaled, cnt):
    """(D, M) bool: a daemon's mean > OUTLIER_FACTOR x the lower median of
    the reporting daemons' means on that metric."""
    col = np.swapaxes(mean_scaled, 0, 1)
    have = np.swapaxes(cnt, 0, 1) > 0
    srt = np.sort(np.where(have, col, _I64_MAX), axis=1)
    nv = np.sum(have.astype(np.int64), axis=1)
    med_idx = np.clip((nv - 1) // 2, 0, col.shape[1] - 1)
    med = np.take_along_axis(srt, med_idx[:, None], axis=1)[:, 0]
    med = np.where(nv > 0, med, np.int64(0))
    out = have & (col > np.int64(OUTLIER_FACTOR) * med[:, None]) & (med[:, None] > 0)
    return np.swapaxes(out, 0, 1)


def _ewma(vals, mask):
    D, M, W = vals.shape
    e = np.zeros((D, M), np.int64)
    seen = np.zeros((D, M), bool)
    for t in range(W):
        x, v = vals[:, :, t], mask[:, :, t]
        xs = x << np.int64(SCALE_SHIFT)
        upd = e + ((xs - e) >> np.int64(ALPHA_SHIFT))
        e = np.where(v, np.where(seen, upd, xs), e)
        seen = seen | v
    return e


def analyze_numpy(values: np.ndarray, valid: np.ndarray,
                  cursor: np.ndarray) -> dict[str, np.ndarray]:
    """The host path: the semantics the kernel matches bit for bit."""
    values = values.astype(np.int64, copy=False)
    valid = valid.astype(bool, copy=False)
    vals, mask = _ordered(values, valid, cursor)
    pct, nsamples = _percentiles(vals, mask)
    mean_scaled, cnt = _means(vals, mask)
    return {
        "percentiles": pct,                 # (M, 3) int64, raw units
        "n_samples": nsamples,              # (M,) int64
        "ewma_scaled": _ewma(vals, mask),   # (D, M) int64 << 8
        "mean_scaled": mean_scaled,         # (D, M) int64 << 8
        "count": cnt,                       # (D, M) int64
        "outlier": _outliers(mean_scaled, cnt),  # (D, M) bool
    }


class AnalyticsEngine:
    """One analytics launch per pass over a store of fixed (D, M, W).

    The shape is fixed at construction (from the mgr_stats_* options), so
    :meth:`prewarm` covers the whole launch set — one shape — at mgr
    start; every later :meth:`analyze` is a warm launch.  ``backend``
    "cuda" runs the kernel on ``device`` (the card unless the caller asks
    for the CPU, where the kernel's plain version runs); "numpy" is the
    host reference."""

    def __init__(self, n_daemons: int, n_metrics: int, window: int,
                 backend: str = "cuda", device=None):
        if backend not in BACKENDS:
            raise ValueError(f"backend must be one of {BACKENDS}, got {backend!r}")
        self.shape = (n_daemons, n_metrics, window)
        self.backend = backend
        self.device = resolve_device(device) if backend == "cuda" else None
        if backend == "cuda":
            ak.check_shape(n_daemons, n_metrics, window)  # one the kernel cannot launch raises
        self.stats = collections.Counter()
        self.metrics = analytics_counters()
        self._warm: set[tuple] = set()
        self._warm_lock = threading.Lock()

    def _run_device(self, values, valid, cursor,
                    count_cold: bool = True) -> dict[str, np.ndarray]:
        shape_key = ("analytics", self.shape)
        if shape_key not in self._warm:
            with self._warm_lock:
                if shape_key not in self._warm:
                    self._warm.add(shape_key)
                    if count_cold:
                        # an analyze() before prewarm is a cold launch;
                        # prewarm passes False and never touches the counter
                        self.stats["cold_launches"] += 1
                        self.metrics.inc("cold_launches")
        # the launch span on real digest passes only (prewarm's first
        # launch is intentional, not a launch to study)
        span = (device_tracer().span("cuda_launch", stage="device", kind="mgr_analytics",
                                     shape=str(self.shape))
                if count_cold else contextlib.nullcontext())
        D, M, _ = self.shape
        with span, tg.no_implicit_transfers("mgr_analytics", self.device):
            # one declared upload of each of the three store arrays, one
            # declared copy of the six outputs back (the digest is
            # consumed on the host)
            v = tg.upload(np.asarray(values, np.int64), self.device)
            b = tg.upload(np.asarray(valid, bool), self.device)
            c = tg.upload(np.asarray(cursor, np.int64), self.device)
            buf = torch.from_numpy(tg.readback(ak.analyze_packed(v, b, c)))
        return {name: t.numpy() for name, t in ak.unpack(buf, D, M).items()}

    def prewarm(self) -> int:
        """Launch the engine's one shape with zeros.  Call at mgr start
        (via to_thread); after it :meth:`analyze` meets no first-use cost
        (``cold_launches`` stays 0).  Returns shapes launched (0 for the
        numpy backend or a warm shape).  A failure raises."""
        if self.backend != "cuda":
            return 0
        if ("analytics", self.shape) in self._warm:
            return 0
        D, M, W = self.shape
        self._run_device(np.zeros((D, M, W), np.int64), np.zeros((D, M, W), bool),
                         np.zeros(D, np.int64), count_cold=False)
        self.stats["prewarmed_shapes"] += 1
        self.metrics.inc("prewarmed_shapes")
        return 1

    def analyze(self, values: np.ndarray, valid: np.ndarray,
                cursor: np.ndarray) -> dict[str, np.ndarray]:
        """One pass over the whole store snapshot, whose shape must be the
        engine's (D, M, W).  A device failure raises."""
        if values.shape != self.shape:
            raise ValueError(f"store of shape {values.shape}, the engine's is {self.shape}")
        self.stats["passes"] += 1
        self.metrics.inc("passes")
        if self.backend == "numpy":
            return analyze_numpy(values, valid, cursor)
        out = self._run_device(values, valid, cursor)
        self.stats["launches"] += 1
        self.metrics.inc("launches")
        return out

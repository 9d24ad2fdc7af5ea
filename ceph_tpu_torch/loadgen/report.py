"""Load-run reporting: percentiles, mgr cross-check, the artifact.

The client-side truth is every completed op's (kind, tenant, latency)
record; the mgr-side truth is the analytics digest computed from the
interval-mean gauges the load driver streamed over the report plane
(``loadgen.*`` MgrClient sessions).  The cross-check compares the SAME
series from both ends:

- the driver keeps every ``load_lat_us`` interval mean it shipped
  (quantized exactly as ``TimeSeriesStore.ingest`` does — int64
  ``rint``);
- the mgr's digest reports nearest-rank percentiles over the last
  ``mgr_stats_window`` ingested samples of that metric;
- :func:`cross_check` recomputes the identical nearest-rank
  percentile over the driver's own tail window and requires agreement
  within ``loadgen_latency_tolerance`` (relative) — drift means the
  report plane dropped/garbled samples, not that the cluster was slow.

A second, looser plausibility row records osd-side op latency against
client-side latency (the server component can never exceed what the
client observed, modulo the report-interval skew).

Counterpart of ``ceph_tpu/loadgen/report.py``: the same report and artifact schema.
"""

from __future__ import annotations

import numpy as np


def percentile(samples, p: int) -> float:
    """Nearest-rank percentile, the analytics engine's convention
    (mgr/analytics.py _percentiles): pos = ceil(p*n/100) - 1 on the
    sorted samples."""
    if not samples:
        return 0.0
    srt = sorted(samples)
    n = len(srt)
    pos = (p * n + 99) // 100 - 1
    return float(srt[max(0, min(pos, n - 1))])


def summarize_latencies(records) -> dict:
    """Client-side latency summary: overall + per-kind + per-tenant
    p50/p95/p99 (µs) and counts.  ``records`` are (kind, tenant,
    latency_s, ok) tuples."""
    def _row(lats_us) -> dict:
        return {
            "n": len(lats_us),
            "p50_us": round(percentile(lats_us, 50), 1),
            "p95_us": round(percentile(lats_us, 95), 1),
            "p99_us": round(percentile(lats_us, 99), 1),
            "mean_us": round(float(np.mean(lats_us)), 1)
            if lats_us else 0.0,
        }

    ok_lats = [r[2] * 1e6 for r in records if r[3]]
    by_kind: dict[str, list] = {}
    by_tenant: dict[str, list] = {}
    errors = 0
    for kind, tenant, lat, ok in records:
        if not ok:
            errors += 1
            continue
        by_kind.setdefault(kind, []).append(lat * 1e6)
        by_tenant.setdefault(tenant, []).append(lat * 1e6)
    return {
        "overall": _row(ok_lats),
        "by_kind": {k: _row(v) for k, v in sorted(by_kind.items())},
        "by_tenant": {k: _row(v) for k, v in sorted(by_tenant.items())},
        "errors": errors,
    }


def cross_check(report_log, mgr_percentiles: dict | None,
                window: int, tolerance: float) -> dict:
    """Client-vs-mgr agreement on the ``load_lat_us`` series.

    ``report_log``: one entry PER REPORT the driver sent, the int-
    quantized interval mean or None for an empty interval — the same
    shape the mgr's ring holds, where every report advances a column
    and an empty one leaves an invalid cell.  The ring keeps the last
    ``window`` REPORTS, so the client windows its log in reports and
    drops the Nones, exactly like the store's valid mask.
    ``mgr_percentiles``: the digest's row for the metric ({"p50": ...,
    "p95": ..., "p99": ..., "n": ...}) or None when the digest never
    saw it.  Agreement is relative within ``tolerance`` plus a 2µs
    quantization floor per side."""
    shipped = [v for v in report_log if v is not None]
    out: dict = {
        "shipped_samples": len(shipped),
        "mgr": dict(mgr_percentiles or {}),
        "client": {},
        "agree": False,
    }
    if not shipped or not mgr_percentiles:
        return out
    tail = [v for v in list(report_log)[-window:] if v is not None]
    if not tail:
        return out
    checks = []
    for p in (50, 95, 99):
        client_v = percentile(tail, p)
        mgr_v = float(mgr_percentiles.get(f"p{p}", 0.0))
        out["client"][f"p{p}"] = round(client_v, 1)
        # the digest may have ticked one report before/after our last
        # ship; a one-sample phase skew on a tail window moves a
        # nearest-rank percentile by at most one sample's worth, which
        # the relative tolerance absorbs for any steady workload
        lim = tolerance * max(client_v, mgr_v) + 2.0
        checks.append(abs(client_v - mgr_v) <= lim)
    out["agree"] = all(checks)
    return out


def plausibility(client_summary: dict, osd_perf: dict) -> dict:
    """The loose osd-vs-client row: mean osd commit latency (ms) per
    OSD from the digest, against the client-side overall mean — the
    server-side component of a write can't exceed what clients saw
    end-to-end (recorded, not asserted: report-interval skew and
    CPU-contended hosts make this advisory)."""
    commit_ms = [row.get("commit_latency_ms", 0.0)
                 for row in (osd_perf or {}).values()]
    return {
        "osd_commit_ms_max": max(commit_ms) if commit_ms else 0.0,
        "client_overall_mean_ms": round(
            client_summary["overall"]["mean_us"] / 1000.0, 3),
    }


def build_artifact(runs: list[dict]) -> dict:
    """The committed LOAD_*.json shape (test_bench_artifacts guards
    it): per-run trace hash, client percentiles, cross-check verdict,
    QoS fairness rows and the cold-launch/transfer-guard zeros."""
    ok = all(r.get("ok") for r in runs)
    return {
        "schema": "ceph_tpu.loadgen/v1",
        "profiles": [r["profile"] for r in runs],
        "runs": runs,
        "summary": {
            "total": len(runs),
            "green": sum(1 for r in runs if r.get("ok")),
            "all_green": ok,
        },
    }

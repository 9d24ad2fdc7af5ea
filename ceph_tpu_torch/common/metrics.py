"""Perf counters + prometheus-text exposition.

The port's twin of ceph_tpu/common/metrics.py: the same collections,
the same ``ceph_tpu_`` metric names and the same exposition bytes, so
dashboards read both packages the same way.  Behavioral twin of the
reference's always-on metrics
(src/common/perf_counters.h: typed counters/gauges/averages dumped via
the admin socket's `perf dump`; exported to prometheus by the mgr
module and src/exporter/).  Daemons hold a :class:`PerfCounters` per
subsystem; :func:`prometheus_text` renders every registered collection
in the exposition format, and :class:`MetricsServer` serves it over
HTTP — the standalone-exporter analogue.
"""

from __future__ import annotations

import asyncio
import threading
from collections import defaultdict


class PerfCounters:
    """One named collection of counters/gauges (PerfCountersBuilder)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, float] = defaultdict(float)
        self._gauges: dict[str, float] = {}
        # shared LatencyHistogram objects (common/optracker.py): the
        # owner registers its live histogram and exposition renders it
        self._histograms: dict[str, object] = {}
        self._lock = threading.Lock()

    def inc(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[key] += by

    def set_gauge(self, key: str, value: float) -> None:
        with self._lock:
            self._gauges[key] = value

    def register_histogram(self, key: str, hist) -> None:
        """Attach a live LatencyHistogram (fixed log2 buckets) under
        ``key`` — rendered by prometheus_text as a real histogram
        (_bucket/_sum/_count)."""
        with self._lock:
            self._histograms[key] = hist

    def dump(self) -> dict[str, float]:
        """`perf dump` over the admin socket."""
        with self._lock:
            return {**self._counters, **self._gauges}

    def dump_typed(self) -> tuple[dict[str, float], dict[str, float], dict]:
        """(counters, gauges, histograms) — the split prometheus
        exposition needs for its ``# TYPE`` lines."""
        with self._lock:
            return (dict(self._counters), dict(self._gauges),
                    dict(self._histograms))


class BucketCounters:
    """Per-bucket counters for batched-dispatch layers (the encode
    service, the recovery-decode aggregator, the scrub verifier and the
    analytics engine): each counter is tracked both as an aggregate and
    per (width, batch) bucket, so `perf dump` / prometheus can report
    batching efficiency — occupancy, launches and cold launches per
    shape."""

    def __init__(self, name: str):
        self.pc = get_perf_counters(name)

    def inc(self, key: str, *, by: float = 1.0, **labels) -> None:
        self.pc.inc(key, by)
        if labels:
            suffix = "".join(
                f"_{k}{v}" for k, v in sorted(labels.items()))
            self.pc.inc(key + suffix, by)

    def dump(self) -> dict[str, float]:
        return self.pc.dump()

    def efficiency(self) -> dict[str, float]:
        """Aggregate batching-efficiency summary for bench reports."""
        d = self.pc.dump()
        out = {
            "launches": d.get("launches", 0.0),
            "cold_launches": d.get("cold_launches", 0.0),
            "prewarmed_shapes": d.get("prewarmed_shapes", 0.0),
        }
        if d.get("padded_lanes"):
            out["lane_occupancy"] = d["occupied_lanes"] / d["padded_lanes"]
            out["mean_batch"] = d["occupied_lanes"] / max(
                d.get("launches", 1.0), 1.0)
        if d.get("padded_bytes"):
            out["byte_occupancy"] = d["occupied_bytes"] / d["padded_bytes"]
        return out


_COLLECTIONS: dict[str, PerfCounters] = {}
_REG_LOCK = threading.Lock()


def get_perf_counters(name: str) -> PerfCounters:
    with _REG_LOCK:
        pc = _COLLECTIONS.get(name)
        if pc is None:
            pc = _COLLECTIONS[name] = PerfCounters(name)
        return pc


def all_collections() -> dict[str, PerfCounters]:
    with _REG_LOCK:
        return dict(_COLLECTIONS)


def _sanitize(s: str) -> str:
    return "".join(ch if (ch.isalnum() or ch == "_") else "_" for ch in s)


def histogram_text(metric: str, counts: list[int], sum_us: int,
                   total: int) -> list[str]:
    """Proper prometheus histogram exposition for one fixed-shape
    log2-µs histogram: cumulative ``_bucket`` lines with ``le`` upper
    bounds in SECONDS, then ``_sum`` (seconds) and ``_count``."""
    out = [f"# TYPE {metric} histogram"]
    cum = 0
    for i, c in enumerate(counts):
        cum += int(c)
        le = (1 << (i + 1)) / 1e6  # bucket upper bound, seconds
        out.append(f'{metric}_bucket{{le="{le:g}"}} {cum}')
    out.append(f'{metric}_bucket{{le="+Inf"}} {int(total)}')
    out.append(f"{metric}_sum {sum_us / 1e6:g}")
    out.append(f"{metric}_count {int(total)}")
    return out


def prometheus_text(collections: dict[str, PerfCounters] | None = None) -> str:
    """Prometheus exposition format over every collection (the
    mgr/prometheus + ceph-exporter output shape).  Emits ``# TYPE``
    lines (counter vs gauge vs histogram); metric NAMES are unchanged
    from the untyped exposition so scrapers keep their queries."""
    out = []
    for cname, pc in sorted((collections or all_collections()).items()):
        counters, gauges, hists = pc.dump_typed()
        typed = {**{k: "counter" for k in counters},
                 **{k: "gauge" for k in gauges}}
        merged = {**counters, **gauges}
        for key in sorted(merged):
            metric = f"ceph_tpu_{_sanitize(cname)}_{_sanitize(key)}"
            out.append(f"# TYPE {metric} {typed[key]}")
            out.append(f"{metric} {merged[key]}")
        for key, hist in sorted(hists.items()):
            metric = f"ceph_tpu_{_sanitize(cname)}_{_sanitize(key)}"
            out.extend(histogram_text(
                metric, hist.counts, hist.sum_us, hist.total))
    return "\n".join(out) + "\n"


class MetricsServer:
    """Minimal HTTP /metrics endpoint (src/exporter/ analogue)."""

    def __init__(self, collections: dict[str, PerfCounters] | None = None):
        self._collections = collections
        self._server: asyncio.base_events.Server | None = None
        self.addr: tuple[str, int] | None = None

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> tuple[str, int]:
        self._server = await asyncio.start_server(self._handle, host, port)
        self.addr = self._server.sockets[0].getsockname()[:2]
        return self.addr

    async def stop(self) -> None:
        if self._server:
            self._server.close()
            await self._server.wait_closed()

    async def _handle(self, reader, writer) -> None:
        try:
            req = await asyncio.wait_for(reader.readline(), 5)
            while True:  # drain headers
                line = await asyncio.wait_for(reader.readline(), 5)
                if line in (b"\r\n", b"\n", b""):
                    break
            path = req.split(b" ")[1].decode() if b" " in req else "/"
            if path == "/metrics":
                body = prometheus_text(self._collections).encode()
                status = b"200 OK"
            else:
                body = b"see /metrics\n"
                status = b"404 Not Found"
            writer.write(
                b"HTTP/1.1 " + status + b"\r\n"
                b"Content-Type: text/plain; version=0.0.4\r\n"
                b"Content-Length: " + str(len(body)).encode() + b"\r\n"
                b"Connection: close\r\n\r\n" + body
            )
            await writer.drain()
        except (asyncio.TimeoutError, ConnectionError, IndexError):
            pass
        finally:
            writer.close()

"""Perf counters for the batched-dispatch layers.

Behavioral twin of the reference's always-on metrics
(src/common/perf_counters.h: typed counters/gauges dumped via the admin
socket's `perf dump`).  This slice carries the collection registry and
:class:`BucketCounters`, which the recovery-decode aggregator reports
through; prometheus exposition arrives with the daemons.
"""

from __future__ import annotations

import threading
from collections import defaultdict


class PerfCounters:
    """One named collection of counters (PerfCountersBuilder)."""

    def __init__(self, name: str):
        self.name = name
        self._counters: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    def inc(self, key: str, by: float = 1.0) -> None:
        with self._lock:
            self._counters[key] += by

    def dump(self) -> dict[str, float]:
        """`perf dump` over the admin socket."""
        with self._lock:
            return dict(self._counters)


class BucketCounters:
    """Per-bucket counters for batched-dispatch layers (the recovery-
    decode aggregator): each counter is tracked both as an aggregate and
    per (width, batch) bucket, so `perf dump` can report batching
    efficiency — occupancy, launches and cold launches per shape."""

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

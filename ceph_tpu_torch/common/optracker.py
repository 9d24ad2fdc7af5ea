"""In-flight op tracking + slow-op forensics — the TrackedOp twin.

Behavioral twin of the reference's op tracker (src/common/TrackedOp.h:
121 OpTracker, TrackedOp::mark_event; src/osd/OpRequest.h): every
client op registers on arrival, marks named events as it moves through
the pipeline, and lands in a bounded history on completion; ops slower
than the complaint threshold are kept in a separate slow-op history
and counted, and the admin socket exposes ``dump_ops_in_flight`` /
``dump_historic_ops`` / ``dump_historic_slow_ops`` exactly like the
reference daemons.

Latency histograms (the reference's PerfHistogram / ``perf histogram
dump`` plane): every completed op also lands in a per-op-class
**log2-bucket latency histogram** (:class:`LatencyHistogram`).  The
bucket count is FIXED (:data:`HIST_BUCKETS`), so histograms from many
daemons merge as plain arrays — which is exactly what the mgr's
MMgrReport stream needs (fixed shapes, no per-daemon schemas).
"""

from __future__ import annotations

import itertools
import time
from collections import deque

#: fixed bucket count for every latency histogram in the process:
#: bucket ``i`` counts latencies in [2^i, 2^(i+1)) microseconds, so
#: 32 buckets span 1 µs .. ~71 min — and histograms merge as arrays
HIST_BUCKETS = 32


class LatencyHistogram:
    """Fixed-shape log2 latency histogram (PerfHistogram twin, 1-D).

    ``counts[i]`` is the number of samples in [2^i, 2^(i+1)) µs;
    ``sum_us``/``total`` give exact means.  All integer state, so
    cumulative snapshots diff and merge exactly.
    """

    __slots__ = ("counts", "sum_us", "total")

    def __init__(self, counts: list[int] | None = None,
                 sum_us: int = 0, total: int = 0):
        self.counts = list(counts) if counts else [0] * HIST_BUCKETS
        if len(self.counts) != HIST_BUCKETS:
            # foreign bucket count (version skew): renormalize by
            # truncation/zero-fill so merges stay fixed-shape
            self.counts = (self.counts + [0] * HIST_BUCKETS)[:HIST_BUCKETS]
        self.sum_us = sum_us
        self.total = total

    @staticmethod
    def bucket_of(us: int) -> int:
        return min(max(us, 1).bit_length() - 1, HIST_BUCKETS - 1)

    @staticmethod
    def le_us(i: int) -> int:
        """Upper bound (µs, exclusive) of bucket ``i`` — the
        prometheus ``le`` label value."""
        return 1 << (i + 1)

    def record(self, seconds: float) -> None:
        us = max(int(seconds * 1e6), 0)
        self.counts[self.bucket_of(us)] += 1
        self.sum_us += us
        self.total += 1

    def merge(self, other: "LatencyHistogram") -> None:
        for i in range(HIST_BUCKETS):
            self.counts[i] += other.counts[i]
        self.sum_us += other.sum_us
        self.total += other.total

    def mean_us(self) -> float:
        return (self.sum_us / self.total) if self.total else 0.0

    def dump(self) -> dict:
        return {
            "buckets": list(self.counts),
            "sum_us": self.sum_us,
            "count": self.total,
            "unit": "log2_us",
        }


class TrackedOp:
    __slots__ = ("tracker", "id", "description", "start", "events",
                 "done_at", "op_class")

    def __init__(self, tracker: "OpTracker", opid: int, description: str,
                 op_class: str = "other"):
        self.tracker = tracker
        self.id = opid
        self.description = description
        self.op_class = op_class
        self.start = time.monotonic()
        self.events: list[tuple[float, str]] = [(self.start, "initiated")]
        self.done_at: float | None = None

    def mark_event(self, name: str) -> None:
        self.events.append((time.monotonic(), name))

    def finish(self) -> None:
        self.tracker.complete(self)

    @property
    def duration(self) -> float:
        return (self.done_at or time.monotonic()) - self.start

    def dump(self) -> dict:
        return {
            "id": self.id,
            "description": self.description,
            "age": round(time.monotonic() - self.start, 6),
            "duration": round(self.duration, 6),
            "type_data": {
                "events": [
                    {"event": name, "at": round(t - self.start, 6)}
                    for t, name in self.events
                ],
            },
        }


class OpTracker:
    """Reference OpTracker: in-flight registry + bounded histories."""

    def __init__(
        self,
        history_size: int = 20,
        slow_threshold: float = 30.0,
        slow_history_size: int = 20,
    ):
        self._ids = itertools.count(1)
        self.inflight: dict[int, TrackedOp] = {}
        self.history: deque[TrackedOp] = deque(maxlen=history_size)
        self.slow_history: deque[TrackedOp] = deque(maxlen=slow_history_size)
        self.slow_threshold = slow_threshold
        self.complaints = 0
        # per-op-class log2 latency histograms (PerfHistogram role)
        self.histograms: dict[str, LatencyHistogram] = {}

    def create(self, description: str, op_class: str = "other") -> TrackedOp:
        op = TrackedOp(self, next(self._ids), description, op_class)
        self.inflight[op.id] = op
        return op

    def record_latency(self, op_class: str, seconds: float) -> None:
        """Direct histogram feed for work that never mints a TrackedOp
        (replica/shard sub-op service, recovery pushes)."""
        h = self.histograms.get(op_class)
        if h is None:
            h = self.histograms[op_class] = LatencyHistogram()
        h.record(seconds)

    def complete(self, op: TrackedOp) -> None:
        op.done_at = time.monotonic()
        op.mark_event("done")
        self.inflight.pop(op.id, None)
        self.history.append(op)
        self.record_latency(op.op_class, op.duration)
        if op.duration >= self.slow_threshold:
            self.slow_history.append(op)
            self.complaints += 1

    # -- admin-socket dumps (TrackedOp.cc dump_ops_in_flight et al) ----

    def dump_ops_in_flight(self) -> dict:
        return {
            "num_ops": len(self.inflight),
            "ops": [op.dump() for op in self.inflight.values()],
        }

    def dump_historic_ops(self) -> dict:
        return {
            "num_ops": len(self.history),
            "ops": [op.dump() for op in self.history],
        }

    def dump_historic_slow_ops(self) -> dict:
        return {
            "num_ops": len(self.slow_history),
            "complaints": self.complaints,
            "ops": [op.dump() for op in self.slow_history],
        }

    def dump_histograms(self) -> dict:
        """``perf histogram dump`` (reference
        OSD.cc asok 'perf histogram dump'): per-op-class log2 latency
        histograms, fixed bucket count so clients merge as arrays."""
        return {
            "bucket_count": HIST_BUCKETS,
            "unit": "log2_us",
            "histograms": {
                cls: h.dump() for cls, h in sorted(self.histograms.items())
            },
        }

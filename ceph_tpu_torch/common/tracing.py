"""Span tracing — the blkin/jaeger role (reference §5 aux).

The part of the JAX package's tracer (ceph_tpu/common/tracing.py) that
the device layer needs: named tracers holding a bounded ring of finished
spans, each with a wall-clock start, a duration and free-form tags.  The
recovery-decode aggregator wraps every kernel launch in a span on
:func:`device_tracer`, tagged with the bucket shape, lane occupancy and
upload-launch-download time.  Sampling, export and the wire context
arrive with the daemons.

Usage::

    with device_tracer().span("cuda_launch", w=65536, b=8) as sp:
        ...
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from collections import deque
from dataclasses import dataclass, field

#: default ring capacity
DEFAULT_RING_MAX = 2048

_IDS = itertools.count(1)


@dataclass
class Span:
    name: str
    span_id: int
    start: float                      # wall clock (time.time)
    daemon: str = ""
    tags: dict = field(default_factory=dict)
    duration: float | None = None


class Tracer:
    """One per daemon (the osd_tracer.cc global's role)."""

    def __init__(self, name: str, *, ring_max: int = DEFAULT_RING_MAX):
        self.name = name
        self._ring: deque[Span] = deque(maxlen=ring_max)
        self._lock = threading.Lock()
        self.counters: dict[str, int] = {"spans_recorded": 0, "spans_dropped": 0}

    @contextlib.contextmanager
    def span(self, name: str, **tags):
        sp = Span(name=name, span_id=next(_IDS), start=time.time(),
                  daemon=self.name, tags=dict(tags))
        t0 = time.perf_counter()
        try:
            yield sp
        except BaseException as e:
            sp.tags["error"] = type(e).__name__
            raise
        finally:
            sp.duration = time.perf_counter() - t0
            self.finish(sp)

    def finish(self, sp: Span) -> None:
        with self._lock:
            if len(self._ring) == self._ring.maxlen:
                self.counters["spans_dropped"] += 1
            self._ring.append(sp)
            self.counters["spans_recorded"] += 1

    def find(self, **tags) -> list[Span]:
        """Spans whose tags contain all of ``tags``."""
        with self._lock:
            return [
                s for s in self._ring
                if all(s.tags.get(k) == v for k, v in tags.items())
            ]


_TRACERS: dict[str, Tracer] = {}
_REG_LOCK = threading.Lock()


def get_tracer(name: str) -> Tracer:
    with _REG_LOCK:
        t = _TRACERS.get(name)
        if t is None:
            t = _TRACERS[name] = Tracer(name)
        return t


def device_tracer() -> Tracer:
    """The process-wide device-launch ring: the decode batcher wraps each
    kernel launch in a span here, tagged with bucket shape, occupancy and
    upload-launch-download duration, so batch padding and host<->device
    copy waste are visible."""
    return get_tracer("device")

"""Chaos engine — the OSDThrasher / ``ceph_test_rados`` twin.

The reference ships an entire thrashing and model-checking apparatus
(qa/tasks/thrasher.py OSDThrasher: kill/revive/out/in/reweight/split
under load; src/test/osd/TestRados.cc recording an operation history
and checking every read against it).  This package is that layer for
the mini-cluster:

- :mod:`schedule` — a seeded, deterministic event-schedule generator:
  the same ``(seed, scenario)`` always yields the same event trace,
  hashable for replay assertions;
- :mod:`netem` — a messenger-level network shim with deterministic
  per-peer partitions, one-way drops, fixed delays and bounded
  reordering (the deterministic complement of the probabilistic
  ``ms_inject_socket_failures``/``ms_inject_delay`` knobs);
- :mod:`workload` — a concurrent replicated+EC read/write/snap
  workload that records an operation history;
- :mod:`invariants` — durability checkers run during and after each
  run: no acked write lost or corrupted, convergence to active+clean,
  one agreed mon quorum, zero post-thrash deep-scrub inconsistencies,
  and zero cold launches on the decode/scrub batchers;
- :mod:`runner` — drives scenario configs over seed sweeps against a
  live mini-cluster (the ``python -m ceph_tpu_torch.tools.chaos_run``
  CLI's engine).

Chaos events flow into ``common/tracing`` spans (tracer ``"chaos"``)
and a ``BucketCounters("chaos")`` perf collection, dumped via the
daemons' ``dump_chaos`` admin-socket command.

Counterpart of ``ceph_tpu/chaos/``: the same exports.
"""

from __future__ import annotations

from ceph_tpu_torch.chaos.schedule import (  # noqa: F401
    ChaosEvent,
    EVENT_KINDS,
    generate_schedule,
    trace_hash,
)


def chaos_counters():
    """The process-wide chaos perf collection (BucketCounters role):
    every applied event, netem verdict and invariant outcome counts
    here, labelled by kind."""
    from ceph_tpu_torch.common.metrics import BucketCounters

    return BucketCounters("chaos")


def chaos_tracer():
    """The process-wide chaos span ring (blkin/otel role for thrash
    events): each applied event opens a span tagged with its kind,
    target and virtual time."""
    from ceph_tpu_torch.common.tracing import get_tracer

    return get_tracer("chaos")


def dump_chaos() -> dict:
    """The ``dump_chaos`` admin-socket payload: chaos perf counters +
    the most recent event spans (registered on every daemon; the
    collection is process-global, like the batchers')."""
    return {
        "counters": chaos_counters().dump(),
        "recent_events": chaos_tracer().dump(limit=100),
    }

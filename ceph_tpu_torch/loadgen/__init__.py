"""Load-generation harness: million-user-scale traffic against a
vstart cluster.

The subsystem the ROADMAP's "million-user front end" item calls for —
every subsequent scale/perf PR benches against it:

- :mod:`ceph_tpu_torch.loadgen.schedule` — the WHOLE load trace (client
  streams, op kinds, Zipf object popularity, open-loop arrival times)
  is a pure function of ``(seed, profile)``, the ``chaos/schedule.py``
  discipline: a committed artifact's ``trace_hash`` re-derives
  bit-identically forever, and a failing run replays exactly.
- :mod:`ceph_tpu_torch.loadgen.driver` — boots (or connects to) the
  cluster, multiplexes thousands of simulated clients over a small
  pool of async RadosClient handles (the objecter's completions +
  in-flight window do the heavy lifting), drives RADOS / EC-RMW / S3
  / RBD / FS traffic, and streams its own latency telemetry to the
  mgr as a ``loadgen.*`` daemon.
- :mod:`ceph_tpu_torch.loadgen.report` — client-side p50/p95/p99 +
  throughput, cross-checked against the mgr analytics digest
  (the same series, ingested over the report plane), SLOW_OPS/health,
  and the cold-launch/transfer-guard counters; emits the committed
  ``LOAD_*.json`` artifact.

CLI: ``python -m ceph_tpu_torch.tools.load_run --profile mixed --clients
2000 --seed 1``.

Counterpart of ``ceph_tpu/loadgen/``: the same exports.
"""

from ceph_tpu_torch.loadgen.schedule import (  # noqa: F401
    PROFILES,
    generate_load,
    resolve_profile,
    trace_hash,
)

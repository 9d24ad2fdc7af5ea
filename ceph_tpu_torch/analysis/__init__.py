"""ctlint — AST-based invariant analysis for the ceph_tpu_torch tree.

The runtime already *proves* its hot-path invariants after the fact:
``cold_launches == 0`` counters show the device discipline held, the
transfer guard's ``host_transfers == 0`` shows no implicit copy ran,
chaos trace hashes show schedules were deterministic, and tests show
frames and config keys stayed wired.  This package proves the same
invariants at lint time, before a cold code path ships a violation.
It is plain :mod:`ast`: it imports neither the code it checks nor
``torch``, so a lint run costs no CUDA context.

Six rule families (see :mod:`ceph_tpu_torch.analysis.rules`):

- **device-discipline** — every kernel library loader
  (``ops/_build.py`` ``library()``: nvcc at first use) reachable from
  the I/O-path modules must appear in the declared prewarm registry;
  shapes fed to the shape-keyed wrappers must come from the
  pow2-bucket helpers; no wait for the card (``synchronize``,
  ``.item()``, ``.cpu()``) under a held lock (resolved through the
  call graph — a helper that syncs frames below the critical section
  is caught too).
- **lock-order** — cross-module lock-acquisition graph: cycles, and
  blocking calls (sleep, socket send, store commit) under held locks,
  resolved interprocedurally with the blocking chain named.
- **wire-protocol** — duplicate/unregistered frame ids and
  encode/decode field asymmetry in ``msg/messages.py``.
- **config-registry** — every config key read anywhere must have a
  registered default; dead registered options are reported.
- **determinism** — no wall clock, ``random``-module globals, or
  unordered-set iteration in pure-trace paths (``chaos/schedule.py``,
  ``loadgen/schedule.py``, the fuzz plane's pure half).
- **transfer** — device-residency dataflow
  (:mod:`ceph_tpu_torch.analysis.dataflow`): no device tensor reaching
  a host-materializing op on the I/O path, no redundant
  ``.to(device)``, no undeclared in-out launch buffers, no implicit
  scalar syncs; paired at runtime with ``common/transfer_guard.py``
  (``host_transfers`` counter) the way the prewarm registry pairs
  with ``cold_launches``.

Run via ``python -m ceph_tpu_torch.tools.lint`` (human / ``--json`` /
``--update-baseline``) or through the tier-1 gate
``tests/test_torch_static_analysis.py``.  Suppress a finding inline
with ``# ctlint: disable=<rule>`` and grandfather the remainder in
``ctlint_torch_baseline.json``.
"""

from ceph_tpu_torch.analysis.core import (  # noqa: F401
    Finding,
    Project,
    Rule,
    load_baseline,
    run_analysis,
    split_by_baseline,
)
from ceph_tpu_torch.analysis.rules import ALL_RULES  # noqa: F401

"""Coverage-guided fuzzing over chaos event traces.

The chaos matrix is hand-authored scenarios x seeds; every recent
consistency bug was found by COMPOSING scenarios in ways no author
anticipated.  This package stops hand-writing traces and searches the
trace space instead, steered by what each trace exercises:

- :mod:`ceph_tpu_torch.fuzz.mutate` — deterministic trace mutations, pure
  in ``(parent_trace_hash, mutation_seed)``; every mutant is repaired
  back to schema validity so it can never crash the runner;
- :mod:`ceph_tpu_torch.fuzz.coverage` — the feedback signal: a fingerprint
  of which invariant checkers produced nonzero work, which
  perf-counter families moved, and which lifecycle edges fired;
- :mod:`ceph_tpu_torch.fuzz.corpus` — AFL-style admission: a trace earns a
  corpus slot by surfacing a feature no prior entry produced;
- :mod:`ceph_tpu_torch.fuzz.runner` — the live campaign loop (bounded,
  deterministic given ``--seed``), emitting the FUZZ_rNN artifact;
- :mod:`ceph_tpu_torch.fuzz.minimize` — ddmin + field shrinking, so any
  red reduces to a minimal deterministic regression trace.

Drive it with ``python -m ceph_tpu_torch.tools.chaos_fuzz`` (``--device
cpu`` on the host).

Counterpart of ``ceph_tpu/fuzz/``: the same exports.
"""

from ceph_tpu_torch.fuzz.corpus import Corpus, CorpusEntry
from ceph_tpu_torch.fuzz.coverage import features, fingerprint, fingerprint_key
from ceph_tpu_torch.fuzz.minimize import ddmin, minimize_trace, shrink_fields
from ceph_tpu_torch.fuzz.mutate import MUTATION_KINDS, mutate
from ceph_tpu_torch.fuzz.runner import run_campaign

__all__ = [
    "Corpus", "CorpusEntry", "MUTATION_KINDS", "ddmin", "features",
    "fingerprint", "fingerprint_key", "minimize_trace", "mutate",
    "run_campaign", "shrink_fields",
]

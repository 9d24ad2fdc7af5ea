"""Corpus bookkeeping: which traces earned a slot, and why.

AFL-style admission: an entry joins the corpus only if its coverage
features include at least one token no prior entry produced.  Every
entry records its full lineage — ``(parent trace_hash,
mutation_seed, mutation_kind)`` for mutants, ``(scenario, seed=0)``
for the hand-authored seeds — so a committed FUZZ artifact's traces
re-derive bit-identically: seeds via ``generate_schedule``, mutants
via ``mutate`` replayed over the recorded parent.

Counterpart of ``ceph_tpu/fuzz/corpus.py``: the same results for the same
inputs (``tests/test_torch_fuzz.py``).
"""
# ctlint: pure-trace

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class CorpusEntry:
    """One admitted trace and its provenance."""

    trace_hash: str
    scenario: str            # scenario the trace runs against
    events: list[dict]       # events_to_json form (replayable)
    parent: str | None       # parent trace_hash; None for seeds
    mutation_seed: int | None
    mutation_kind: str       # "seed" for the hand-authored corpus
    fingerprint: dict = field(default_factory=dict)
    new_features: list[str] = field(default_factory=list)

    def to_json(self) -> dict:
        return {
            "trace_hash": self.trace_hash,
            "scenario": self.scenario,
            "events": list(self.events),
            "parent": self.parent,
            "mutation_seed": self.mutation_seed,
            "mutation_kind": self.mutation_kind,
            "fingerprint": dict(self.fingerprint),
            "new_features": list(self.new_features),
        }

    @classmethod
    def from_json(cls, rec: dict) -> "CorpusEntry":
        return cls(
            trace_hash=rec["trace_hash"],
            scenario=rec["scenario"],
            events=list(rec["events"]),
            parent=rec.get("parent"),
            mutation_seed=rec.get("mutation_seed"),
            mutation_kind=rec.get("mutation_kind", "seed"),
            fingerprint=dict(rec.get("fingerprint") or {}),
            new_features=list(rec.get("new_features") or ()),
        )


class Corpus:
    """The admitted-trace set plus the global feature map."""

    def __init__(self) -> None:
        self.entries: list[CorpusEntry] = []
        self.seen_features: set[str] = set()
        self.hashes: set[str] = set()

    def __len__(self) -> int:
        return len(self.entries)

    def has(self, trace_hash: str) -> bool:
        return trace_hash in self.hashes

    def maybe_admit(self, entry: CorpusEntry,
                    feats: set[str]) -> list[str]:
        """Admit ``entry`` iff ``feats`` contains something novel;
        returns the (sorted) novel features, empty on rejection.
        Seeds bypass novelty — the hand-authored matrix IS the
        baseline the mutants must beat."""
        novel = sorted(feats - self.seen_features)
        if entry.mutation_kind != "seed" and not novel:
            return []
        if entry.trace_hash in self.hashes:
            return []
        entry.new_features = novel
        self.entries.append(entry)
        self.seen_features |= feats
        self.hashes.add(entry.trace_hash)
        return novel

    def to_json(self) -> list[dict]:
        return [e.to_json() for e in self.entries]

    @classmethod
    def from_json(cls, recs: list[dict]) -> "Corpus":
        corpus = cls()
        for rec in recs:
            e = CorpusEntry.from_json(rec)
            corpus.entries.append(e)
            corpus.hashes.add(e.trace_hash)
            for f in e.new_features:
                corpus.seen_features.add(f)
        return corpus

"""The live fuzz campaign: seed, mutate, run, admit, repeat.

The loop is bounded and deterministic given ``seed``: the campaign
RNG (parent selection, mutation seeds) derives from it alone, every
mutant derives from ``(parent_trace_hash, mutation_seed)``, and each
run replays on a fresh event loop exactly like ``run_sweep`` — so a
committed FUZZ artifact re-derives its whole corpus from lineage, and
any red replays from its recorded trace.

This module drives live clusters and reads the wall clock for
pacing; the PURE half of the fuzz plane (mutate/coverage/corpus/
minimize) carries the ``ctlint: pure-trace`` determinism contract
instead.

Counterpart of ``ceph_tpu/fuzz/runner.py``: every run goes to
``chaos/runner.py`` ``run_trace`` on ``device`` (the card unless the
caller passes ``device="cpu"``).  The device is resolved before the
first run, so a campaign asked for the card on a machine without one
raises instead of recording every run as a crash.
"""

from __future__ import annotations

import asyncio
import logging
import random
import time

from ceph_tpu_torch.chaos.runner import SCENARIOS, run_trace
from ceph_tpu_torch.chaos.schedule import (
    ChaosEvent,
    events_from_json,
    events_to_json,
    generate_schedule,
    trace_hash,
    validate_trace,
)
from ceph_tpu_torch.fuzz.corpus import Corpus, CorpusEntry
from ceph_tpu_torch.fuzz.coverage import features, fingerprint
from ceph_tpu_torch.fuzz.minimize import minimize_trace
from ceph_tpu_torch.fuzz.mutate import mutate
from ceph_tpu_torch.ops.rs_kernels import resolve_device

log = logging.getLogger("ceph_tpu_torch.fuzz")


def _run_one(scenario: dict, events: list, *, time_scale: float,
             settle_timeout: float, device=None) -> dict:
    """One trace on a fresh event loop; crashes become red records
    (a harness crash is a finding, never a campaign abort)."""
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(run_trace(
            scenario, events, time_scale=time_scale,
            settle_timeout=settle_timeout, device=device))
    except Exception as e:
        log.exception("fuzz run crashed (%s)", scenario["name"])
        return {
            "scenario": scenario["name"], "ok": False,
            "trace_hash": trace_hash(events),
            "n_events": len(events),
            "crash": f"{type(e).__name__}: {e}",
        }
    finally:
        loop.close()


def minimize_demo() -> dict:
    """The minimizer demonstrated end to end on a synthetic planted
    failure: a 10-event trace whose failure kernel is exactly TWO
    events (an ``osd_kill`` of osd 1 and a ``partition``) buried in
    filler.  Pure — the predicate inspects the trace, no cluster —
    so the committed artifact re-derives it bit-identically."""
    sc = SCENARIOS["osd_thrash"]
    ev = ChaosEvent
    planted = [
        ev(0.3, "scrub", {"pool": "rep"}),
        ev(0.6, "reweight", {"osd": 2, "weight": 0.5}),
        ev(0.9, "delay", {"src": ["osd", 0], "dst": ["osd", 2],
                          "seconds": 0.01, "ttl": 0.4}),
        ev(1.0, "osd_kill", {"osd": 1}),          # kernel event A
        ev(1.2, "deep_scrub", {"pool": "ec"}),
        ev(1.5, "partition", {"a": ["osd", 0], "b": ["osd", 3],
                              "ttl": 0.5}),       # kernel event B
        ev(1.8, "balance", {"max_swaps": 8}),
        ev(2.2, "scrub", {"pool": "ec"}),
        ev(2.5, "reweight", {"osd": 4, "weight": 0.75}),
        ev(2.8, "netem_clear", {}),
    ]

    def failing(trace: list) -> bool:
        return (any(e.kind == "osd_kill" and e.args.get("osd") == 1
                    for e in trace)
                and any(e.kind == "partition" for e in trace))

    minimized = minimize_trace(planted, sc, failing)
    duration = float(sc.get("duration", 5.0))
    kernel = [e for e in minimized if e.t <= duration]
    return {
        "input_events": len(planted),
        "minimized_events": len(minimized),
        "kernel": events_to_json(kernel),
        "kernel_kinds": sorted(e.kind for e in kernel),
        "found_exact_kernel": sorted(
            e.kind for e in kernel) == ["osd_kill", "partition"],
        "minimized_trace_hash": trace_hash(minimized),
    }


def run_campaign(
    *, seed: int = 0, budget: int = 16,
    scenario_names: list[str] | None = None,
    time_scale: float = 1.0, settle_timeout: float = 90.0,
    corpus_in: list[dict] | None = None, device=None,
) -> dict:
    """One bounded coverage-guided campaign; returns the FUZZ
    artifact dict.

    Phase 1 seeds the corpus with every scenario's seed-0 trace (or
    resumes from ``corpus_in``, a prior artifact's corpus list —
    those traces are NOT re-run, their recorded fingerprints stand).
    Phase 2 spends ``budget`` mutant runs: pick a parent, derive a
    mutant from ``(parent_hash, mutation_seed)``, replay it, and
    admit it iff its coverage features include a token no corpus
    entry has produced.  Every run is on ``device``."""
    device = resolve_device(device)
    t_wall = time.monotonic()
    names = scenario_names or sorted(SCENARIOS)
    rng = random.Random(f"chaos-fuzz:{seed}")
    corpus = Corpus() if not corpus_in else Corpus.from_json(corpus_in)
    runs: list[dict] = []
    reds: list[dict] = []
    stats: dict[str, int] = {}

    def _note_red(result: dict, entry: CorpusEntry) -> None:
        reds.append({
            "scenario": entry.scenario,
            "trace_hash": entry.trace_hash,
            "parent": entry.parent,
            "mutation_seed": entry.mutation_seed,
            "mutation_kind": entry.mutation_kind,
            "crash": result.get("crash"),
            "violations": {
                name: rec["violations"]
                for name, rec in (result.get("invariants") or {}).items()
                if rec["violations"]
            },
        })

    # -- phase 1: the hand-authored matrix is the baseline ------------
    for name in names:
        sc = SCENARIOS[name]
        events = generate_schedule(0, sc)
        th = trace_hash(events)
        if corpus.has(th):
            continue  # resumed corpus already carries this seed
        log.info("fuzz seed %s (%s)", name, th[:12])
        result = _run_one(sc, events, time_scale=time_scale,
                          settle_timeout=settle_timeout, device=device)
        runs.append(result)
        fp = fingerprint(result)
        entry = CorpusEntry(
            trace_hash=th, scenario=name,
            events=events_to_json(events), parent=None,
            mutation_seed=None, mutation_kind="seed", fingerprint=fp)
        corpus.maybe_admit(entry, features(fp, name))
        if not result.get("ok"):
            _note_red(result, entry)

    # -- phase 2: spend the mutant budget ------------------------------
    for i in range(budget):
        parent = None
        mutant = None
        mkind = None
        mseed = None
        for _draw in range(5):  # re-draw on duplicate hashes
            parent = rng.choice(corpus.entries)
            mseed = rng.randrange(2 ** 32)
            sc = SCENARIOS[parent.scenario]
            mutant, mkind = mutate(
                events_from_json(parent.events), sc,
                parent.trace_hash, mseed)
            if not corpus.has(trace_hash(mutant)):
                break
            mutant = None
        if mutant is None:
            stats["duplicates_skipped"] = stats.get(
                "duplicates_skipped", 0) + 1
            continue
        sc = SCENARIOS[parent.scenario]
        bad = validate_trace(mutant, sc)
        if bad:
            # repair_trace guarantees this never happens; a hit here
            # is a fuzzer bug worth keeping visible in the artifact
            stats["invalid_mutants"] = stats.get(
                "invalid_mutants", 0) + 1
            log.error("invalid mutant (%s/%s): %s",
                      parent.scenario, mseed, bad[:3])
            continue
        th = trace_hash(mutant)
        log.info("fuzz mutant %d/%d %s via %s (%s)",
                 i + 1, budget, parent.scenario, mkind, th[:12])
        result = _run_one(sc, mutant, time_scale=time_scale,
                          settle_timeout=settle_timeout, device=device)
        runs.append(result)
        stats[mkind] = stats.get(mkind, 0) + 1
        fp = fingerprint(result)
        entry = CorpusEntry(
            trace_hash=th, scenario=parent.scenario,
            events=events_to_json(mutant), parent=parent.trace_hash,
            mutation_seed=mseed, mutation_kind=mkind, fingerprint=fp)
        novel = corpus.maybe_admit(entry, features(fp, parent.scenario))
        if novel:
            stats["admitted"] = stats.get("admitted", 0) + 1
            log.info("  admitted: %d novel features", len(novel))
        if not result.get("ok"):
            _note_red(result, entry)

    green = sum(1 for r in runs if r.get("ok"))
    n_seeds = sum(
        1 for e in corpus.entries if e.mutation_kind == "seed")
    return {
        "schema": "ceph_tpu.fuzz/v1",
        "campaign": {
            "seed": seed, "budget": budget, "scenarios": list(names),
            "time_scale": time_scale, "device": str(device),
        },
        "corpus": corpus.to_json(),
        "coverage_map": sorted(corpus.seen_features),
        "mutation_stats": dict(sorted(stats.items())),
        "runs": runs,
        "reds": reds,
        "minimize_demo": minimize_demo(),
        "summary": {
            "runs": len(runs), "green": green,
            "red": len(runs) - green,
            "all_green": green == len(runs),
            "corpus_size": len(corpus),
            "corpus_seeds": n_seeds,
            "corpus_mutants": len(corpus) - n_seeds,
            "features": len(corpus.seen_features),
            "wall_s": round(time.monotonic() - t_wall, 2),
        },
    }

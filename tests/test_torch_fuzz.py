"""The port's fuzz plane (``ceph_tpu_torch/fuzz/``) against the
reference's.

The reference's ``tests/test_fuzz.py`` over the port (mutator
determinism and schema validity, fingerprint stability, corpus
admission, ddmin finding a planted failure kernel exactly, and the
``slow``-marked live mini-campaign on the CPU), then parity: the same
inputs through both packages give the same mutants (trace hash, event
for event), fingerprints, fingerprint keys and features (on every run
record of ``CHAOS_r14.json``), corpus admissions and JSON, ``ddmin``,
``minimize_trace`` and ``minimize_demo`` results; and the perf-counter
families a port chaos run exports are families the reference's daemons
export too, so a trace fingerprints alike in both.
"""

from __future__ import annotations

import pytest

from ceph_tpu_torch.chaos.runner import SCENARIOS
from ceph_tpu_torch.chaos.schedule import (
    ChaosEvent,
    generate_schedule,
    trace_hash,
    validate_trace,
)
from ceph_tpu_torch.fuzz.corpus import Corpus, CorpusEntry
from ceph_tpu_torch.fuzz.coverage import (
    counter_family,
    features,
    fingerprint,
    fingerprint_key,
)
from ceph_tpu_torch.fuzz.minimize import ddmin, minimize_trace
from ceph_tpu_torch.fuzz.mutate import MUTATION_KINDS, mutate
from ceph_tpu_torch.fuzz.runner import minimize_demo

#: every scenario the fuzzer seeds from (compose_load needs a loadgen
#: profile wired in, so the campaign skips it too)
FUZZABLE = sorted(n for n in SCENARIOS if n != "compose_load")


class TestMutator:
    def test_deterministic_in_parent_hash_and_seed(self):
        sc = SCENARIOS["osd_thrash"]
        parent = generate_schedule(0, sc)
        ph = trace_hash(parent)
        for mseed in (0, 1, 7, 12345):
            a, kind_a = mutate(parent, sc, ph, mseed)
            b, kind_b = mutate(parent, sc, ph, mseed)
            assert kind_a == kind_b
            assert trace_hash(a) == trace_hash(b)

    @pytest.mark.parametrize("scenario", FUZZABLE)
    def test_mutants_are_schema_valid(self, scenario):
        sc = SCENARIOS[scenario]
        parent = generate_schedule(0, sc)
        ph = trace_hash(parent)
        for mseed in range(6):
            mutant, kind = mutate(parent, sc, ph, mseed)
            assert kind in MUTATION_KINDS
            bad = validate_trace(mutant, sc)
            assert not bad, f"{scenario}/{mseed} via {kind}: {bad[:3]}"

    def test_mutants_usually_differ_from_parent(self):
        sc = SCENARIOS["netem_storm"]
        parent = generate_schedule(0, sc)
        ph = trace_hash(parent)
        changed = sum(
            1 for mseed in range(8)
            if trace_hash(mutate(parent, sc, ph, mseed)[0]) != ph
        )
        assert changed >= 7

    def test_many_seeds_exercise_several_kinds(self):
        # the artifact guard demands >= 3 distinct kinds among admitted
        # mutants; the mutation draw itself must make that reachable
        sc = SCENARIOS["osd_thrash"]
        parent = generate_schedule(0, sc)
        ph = trace_hash(parent)
        kinds = {mutate(parent, sc, ph, mseed)[1] for mseed in range(24)}
        assert len(kinds) >= 3


class TestCoverage:
    #: a frozen run-result record (the run_trace shape the fingerprint
    #: consumes); tests pin the fingerprint derived from it
    RESULT = {
        "ok": True,
        "scenario": "osd_thrash",
        "events_applied": 5,
        "workload": {"writes": 12, "read_errors": 0},
        "invariants": {
            "history": {"ok": True, "violations": []},
            "converged": {"ok": True, "violations": []},
            "cold_launches": {"ok": True, "violations": []},
        },
        "coverage": {
            "event_kinds": ["osd_kill", "scrub"],
            "perf_deltas": {
                "backfill_started": 2.0,
                "qos_limited_delays": 3.0,
                "tier_flush": 1.0,
            },
            "netem_moved": ["dropped"],
            "deaths": {"osd.1": 1},
        },
    }

    def test_counter_family_collapse(self):
        assert counter_family("backfill_started") == "backfill"
        assert counter_family("qos_limited_delays") == "qos"
        assert counter_family("tier_promote") == "tier"
        assert counter_family("op_w") == "op"

    def test_fingerprint_stable(self):
        fp1 = fingerprint(self.RESULT)
        fp2 = fingerprint(dict(self.RESULT))
        assert fp1 == fp2
        assert fingerprint_key(fp1) == fingerprint_key(fp2)
        assert fp1["counters"] == ["backfill", "qos", "tier"]
        assert fp1["kinds"] == ["osd_kill", "scrub"]
        assert "osd_death" in fp1["edges"]
        assert "netem_dropped" in fp1["edges"]
        assert fp1["red"] is False

    def test_fingerprint_key_tracks_content(self):
        fp = fingerprint(self.RESULT)
        red = dict(self.RESULT, ok=False)
        assert fingerprint_key(fingerprint(red)) != fingerprint_key(fp)

    def test_features_tokens(self):
        fp = fingerprint(self.RESULT)
        feats = features(fp, "osd_thrash")
        assert "counter:backfill" in feats
        assert "kind:osd_kill" in feats
        assert "ctx:osd_thrash:osd_kill" in feats
        assert "edge:osd_death" in feats
        assert "verdict:red" not in feats
        # checker combos are pairwise over the touched checkers
        combos = {f for f in feats if f.startswith("combo:")}
        checkers = {f for f in feats if f.startswith("checker:")}
        n = len(checkers)
        assert len(combos) == n * (n - 1) // 2


class TestCorpus:
    @staticmethod
    def _entry(th, kind="crossbreed", parent="p0"):
        return CorpusEntry(
            trace_hash=th, scenario="osd_thrash", events=[],
            parent=None if kind == "seed" else parent,
            mutation_seed=None if kind == "seed" else 1,
            mutation_kind=kind, fingerprint={})

    def test_seed_bypasses_novelty_mutant_does_not(self):
        c = Corpus()
        assert c.maybe_admit(self._entry("s0", kind="seed"), {"a"}) == ["a"]
        # second seed with NO novel features still lands
        assert c.maybe_admit(self._entry("s1", kind="seed"), {"a"}) == []
        assert len(c) == 2
        # mutant with no novelty is rejected
        assert c.maybe_admit(self._entry("m0"), {"a"}) == []
        assert len(c) == 2
        # mutant with one new token is admitted and records it
        assert c.maybe_admit(self._entry("m1"), {"a", "b"}) == ["b"]
        assert c.entries[-1].new_features == ["b"]
        assert c.has("m1")

    def test_duplicate_hash_rejected(self):
        c = Corpus()
        c.maybe_admit(self._entry("s0", kind="seed"), {"a"})
        assert c.maybe_admit(self._entry("s0", kind="seed"), {"z"}) == []
        assert len(c) == 1

    def test_roundtrip(self):
        c = Corpus()
        c.maybe_admit(self._entry("s0", kind="seed"), {"a"})
        c.maybe_admit(self._entry("m1"), {"a", "b"})
        c2 = Corpus.from_json(c.to_json())
        assert c2.hashes == c.hashes
        assert "b" in c2.seen_features


class TestMinimize:
    def test_ddmin_finds_planted_pair(self):
        # 12 items, failure = {3, 9} both present; ddmin must return
        # exactly that pair (1-minimal at granularity 1)
        items = list(range(12))
        assert ddmin(items, lambda s: 3 in s and 9 in s) == [3, 9]

    def test_ddmin_single_element(self):
        assert ddmin(list(range(8)), lambda s: 5 in s) == [5]

    def test_ddmin_requires_failing_input(self):
        with pytest.raises(ValueError):
            ddmin([1, 2, 3], lambda s: False)

    def test_minimize_trace_planted_kernel(self):
        sc = SCENARIOS["osd_thrash"]
        ev = generate_schedule(0, sc)
        # plant: failure iff the trace kills osd 0 AND scrubs pool rep
        planted = list(ev) + [
            ChaosEvent(1.0, "osd_kill", {"osd": 0}),
            ChaosEvent(2.0, "scrub", {"pool": "rep"}),
        ]

        def failing(trace):
            return (any(e.kind == "osd_kill" and e.args.get("osd") == 0
                        for e in trace)
                    and any(e.kind == "scrub" for e in trace))

        out = minimize_trace(planted, sc, failing)
        assert not validate_trace(out, sc)
        duration = float(sc["duration"])
        kernel = [e for e in out if e.t <= duration]
        assert sorted(e.kind for e in kernel) == ["osd_kill", "scrub"]

    def test_minimize_demo_is_exact_and_stable(self):
        a = minimize_demo()
        b = minimize_demo()
        assert a["found_exact_kernel"]
        assert a["minimized_trace_hash"] == b["minimized_trace_hash"]
        assert a["kernel_kinds"] == ["osd_kill", "partition"]


@pytest.mark.slow
class TestFuzzCampaignSlow:
    def test_mini_campaign_live(self):
        from ceph_tpu_torch.fuzz.runner import run_campaign

        art = run_campaign(seed=0, budget=2,
                           scenario_names=["osd_thrash"],
                           settle_timeout=45.0, device="cpu")
        s = art["summary"]
        assert s["runs"] == 1 + 2 - art["mutation_stats"].get(
            "duplicates_skipped", 0)
        assert s["corpus_seeds"] == 1
        assert art["corpus"][0]["mutation_kind"] == "seed"
        # every run's trace re-derives from its lineage
        from ceph_tpu_torch.chaos.schedule import events_from_json
        from ceph_tpu_torch.fuzz.mutate import mutate as _mut

        by_hash = {e["trace_hash"]: e for e in art["corpus"]}
        for e in art["corpus"]:
            if e["mutation_kind"] == "seed":
                ev = generate_schedule(0, SCENARIOS[e["scenario"]])
            else:
                parent = by_hash[e["parent"]]
                ev, _ = _mut(events_from_json(parent["events"]),
                             SCENARIOS[e["scenario"]],
                             parent["trace_hash"], e["mutation_seed"])
            assert trace_hash(ev) == e["trace_hash"]


# -- parity with the reference ------------------------------------------------

import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import re  # noqa: E402

from ceph_tpu.chaos import runner as ref_runner  # noqa: E402
from ceph_tpu.chaos import schedule as ref_schedule  # noqa: E402
from ceph_tpu.fuzz import corpus as ref_corpus  # noqa: E402
from ceph_tpu.fuzz import coverage as ref_coverage  # noqa: E402
from ceph_tpu.fuzz import minimize as ref_minimize  # noqa: E402
from ceph_tpu.fuzz import runner as ref_fuzz_runner  # noqa: E402
from ceph_tpu_torch.chaos.schedule import events_from_json, events_to_json  # noqa: E402
from ceph_tpu_torch.fuzz import coverage as port_coverage  # noqa: E402

#: the module (the package exports a function of the same name)
ref_mutate = importlib.import_module("ceph_tpu.fuzz.mutate")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _ref_events(events):
    """The same events as the reference's ``ChaosEvent``s."""
    return ref_schedule.events_from_json(events_to_json(events))


def test_fuzzable_scenarios_are_the_references():
    assert FUZZABLE == sorted(n for n in ref_runner.SCENARIOS if n != "compose_load")


@pytest.mark.parametrize("scenario", FUZZABLE)
def test_mutants_equal_the_references(scenario):
    """Every fuzzable scenario's seed-0 trace, mutation seeds 0-7: the
    same mutation kind and the same events (trace hash and JSON)."""
    sc, ref_sc = SCENARIOS[scenario], ref_runner.SCENARIOS[scenario]
    parent = generate_schedule(0, sc)
    ref_parent = ref_schedule.generate_schedule(0, ref_sc)
    ph = trace_hash(parent)
    assert ph == ref_schedule.trace_hash(ref_parent)
    for mseed in range(8):
        got, kind = mutate(parent, sc, ph, mseed)
        want, ref_kind = ref_mutate.mutate(ref_parent, ref_sc, ph, mseed)
        assert kind == ref_kind
        assert trace_hash(got) == ref_schedule.trace_hash(want), (scenario, mseed)
        assert events_to_json(got) == ref_schedule.events_to_json(want)


def test_mutants_of_mutants_equal_the_references():
    """A lineage three mutants deep re-derives alike in both packages."""
    sc, ref_sc = SCENARIOS["netem_storm"], ref_runner.SCENARIOS["netem_storm"]
    ev = generate_schedule(0, sc)
    ref_ev = ref_schedule.generate_schedule(0, ref_sc)
    for mseed in (11, 2 ** 31 + 5, 977):
        ev, _ = mutate(ev, sc, trace_hash(ev), mseed)
        ref_ev, _ = ref_mutate.mutate(ref_ev, ref_sc, ref_schedule.trace_hash(ref_ev), mseed)
        assert trace_hash(ev) == ref_schedule.trace_hash(ref_ev)


def _records() -> list[dict]:
    with open(os.path.join(ROOT, "CHAOS_r14.json")) as f:
        runs = json.load(f)["runs"]
    return runs + [TestCoverage.RESULT, dict(TestCoverage.RESULT, ok=False), {}]


def test_fingerprints_and_features_equal_the_references():
    """Every run record of ``CHAOS_r14.json`` (and the frozen record, red
    and green, and an empty one): the same fingerprint, key and features."""
    for rec in _records():
        fp = fingerprint(rec)
        assert fp == ref_coverage.fingerprint(rec)
        assert fingerprint_key(fp) == ref_coverage.fingerprint_key(fp)
        name = rec.get("scenario", "osd_thrash")
        assert features(fp, name) == ref_coverage.features(fp, name)
    for name in ("backfill_started", "qos_cost_client", "mgr_analytics.launches",
                 "cold_launches", "op_w", "x.y_z", "decode_bytes", "scrub_errors"):
        assert counter_family(name) == ref_coverage.counter_family(name)


def test_corpus_admission_equals_the_references():
    """The same entries offered with the same features: the same novel
    features, admissions and JSON, and the JSON round trip."""
    port, ref = Corpus(), ref_corpus.Corpus()
    for i, rec in enumerate(_records()[:40]):
        fp = fingerprint(rec)
        feats = features(fp, rec.get("scenario", "osd_thrash"))
        kind = "seed" if i % 7 == 0 else "crossbreed"
        args = dict(trace_hash=rec.get("trace_hash", f"h{i}") if i % 9 else "dup",
                    scenario=rec.get("scenario", "osd_thrash"), events=[],
                    parent=None if kind == "seed" else "p", mutation_seed=None if kind == "seed"
                    else i, mutation_kind=kind, fingerprint=fp)
        assert port.maybe_admit(CorpusEntry(**args), feats) == ref.maybe_admit(
            ref_corpus.CorpusEntry(**args), feats)
    assert len(port) == len(ref) and port.seen_features == ref.seen_features
    assert port.to_json() == ref.to_json()
    back = Corpus.from_json(ref.to_json())
    assert back.to_json() == ref.to_json() and back.hashes == ref.hashes


def test_ddmin_equals_the_references():
    cases = [(list(range(12)), lambda s: 3 in s and 9 in s),
             (list(range(40)), lambda s: sum(s) >= 300),
             (list(range(17)), lambda s: {2, 5, 11} <= set(s)),
             (list(range(9)), lambda s: len(s) >= 4)]
    for items, failing in cases:
        assert ddmin(items, failing) == ref_minimize.ddmin(items, failing)


def test_minimize_trace_equals_the_references():
    for scenario, seed in (("osd_thrash", 0), ("netem_storm", 3), ("rack-loss", 1)):
        sc, ref_sc = SCENARIOS[scenario], ref_runner.SCENARIOS[scenario]
        ev = generate_schedule(seed, sc) + [
            ChaosEvent(1.0, "osd_kill", {"osd": 0}), ChaosEvent(2.0, "scrub", {"pool": "rep"})]

        def failing(trace):
            return (any(e.kind == "osd_kill" for e in trace)
                    and any(e.kind == "scrub" for e in trace))

        got = minimize_trace(ev, sc, failing)
        want = ref_minimize.minimize_trace(_ref_events(ev), ref_sc, failing)
        assert events_to_json(got) == ref_schedule.events_to_json(want)


def test_minimize_demo_equals_the_references():
    assert minimize_demo() == ref_fuzz_runner.minimize_demo()


_PERF = re.compile(r"perf\.(?:inc|set|tinc|dec)\(\s*[\"']([A-Za-z0-9_.]+)[\"']")


def _perf_names(pkg: str) -> set[str]:
    names = set()
    for dirpath, _, files in os.walk(os.path.join(ROOT, pkg)):
        for f in files:
            if f.endswith(".py"):
                with open(os.path.join(dirpath, f), encoding="utf-8") as fh:
                    names |= set(_PERF.findall(fh.read()))
    return names


def test_perf_counter_families_are_the_references():
    """A trace's fingerprint takes the families of the OSD and analytics
    perf counters that moved.  The counters the port's daemons name are
    the reference's but one, ``digest_failures``, a mgr daemon's counter
    (``mgr.<name>``), which the chaos runner's totals never read; so no
    family exists only in the port."""
    port, ref = _perf_names("ceph_tpu_torch"), _perf_names("ceph_tpu")
    assert port - ref == {"digest_failures"}
    assert ref - port == set()
    port_fams = {port_coverage.counter_family(n) for n in port - {"digest_failures"}}
    assert port_fams == {ref_coverage.counter_family(n) for n in ref}


def test_a_port_runs_counter_families_are_the_references(tmp_path):
    """One chaos run of the port on the CPU: every key of its
    ``_perf_totals`` is a counter the reference's daemons also name (by
    literal, by the mClock class pattern or by the analytics collection),
    so its fingerprint's families are ones the reference can produce."""
    import asyncio

    from ceph_tpu_torch.chaos import runner as port_runner

    res = asyncio.run(port_runner.run_scenario("netem_storm", 0, device="cpu"))
    assert res["ok"], res.get("crash") or res["invariants"]
    totals = port_runner._perf_totals(SCENARIOS["netem_storm"]["n_osds"])
    ref_names = _perf_names("ceph_tpu")
    ref_fams = {ref_coverage.counter_family(n) for n in ref_names}
    for key in totals:
        fam = counter_family(key)
        assert fam in ref_fams or fam in ("qos", "mgr_analytics", "op"), key
    assert set(fingerprint(res)["counters"]) <= ref_fams | {"qos", "mgr_analytics", "op"}

"""The port's chaos engine and load harness held against the JAX
package's on the CPU (tolerance 0: hashes, bytes and verdicts equal).

- ``chaos/schedule``: the event trace and its ``trace_hash`` for every
  built-in scenario at seeds 0-7;
- ``loadgen/schedule``: the load trace hash for every profile at three
  seeds;
- the payload codecs (``chaos/workload``, ``loadgen/driver``): equal
  bytes, and each package parses the other's;
- ``chaos/invariants``: ``touched_checkers`` over every run record of the
  committed ``CHAOS_r14.json`` (which it judges from the record alone),
  each checker over the observations those records hold, and every
  checker call of a port run replayed through the reference's checker;
- one short scenario (``netem_storm``, seed 0) run in each package: the
  same ``trace_hash``, ``events_applied`` and ``ok``.

The reference's cluster runs its ``jax`` plugin on JAX's CPU backend;
the module compiles privately (tests/xla_private.py).
"""

from __future__ import annotations

import asyncio
import copy
import json
import os

import pytest

from ceph_tpu.chaos import invariants as ref_inv
from ceph_tpu.chaos import runner as ref_runner
from ceph_tpu.chaos import schedule as ref_schedule
from ceph_tpu.chaos import workload as ref_workload
from ceph_tpu.loadgen import driver as ref_driver
from ceph_tpu.loadgen import schedule as ref_lschedule
from ceph_tpu_torch.chaos import invariants as inv
from ceph_tpu_torch.chaos import runner
from ceph_tpu_torch.chaos import schedule
from ceph_tpu_torch.chaos import workload
from ceph_tpu_torch.loadgen import driver
from ceph_tpu_torch.loadgen import schedule as lschedule
from tests.test_torch_mini_cluster import reset_shared
from tests.xla_private import _private_xla_compiles  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDS = range(8)


def _records() -> list[dict]:
    with open(os.path.join(REPO, "CHAOS_r14.json")) as f:
        return json.load(f)["runs"]


def test_the_port_has_the_reference_scenarios():
    assert runner.SCENARIOS.keys() == ref_runner.SCENARIOS.keys()
    assert len(runner.SCENARIOS) == 13
    assert {r["scenario"] for r in _records()} == set(runner.SCENARIOS)


@pytest.mark.parametrize("name", sorted(ref_runner.SCENARIOS))
def test_chaos_traces_equal(name):
    for seed in SEEDS:
        ours = schedule.generate_schedule(seed, runner.SCENARIOS[name])
        ref = ref_schedule.generate_schedule(seed, ref_runner.SCENARIOS[name])
        assert [(e.t, e.kind, e.args) for e in ours] == [
            (e.t, e.kind, e.args) for e in ref], (name, seed)
        assert schedule.trace_hash(ours) == ref_schedule.trace_hash(ref)


def test_chaos_trace_hashes_match_the_committed_record():
    for rec in _records():
        ev = schedule.generate_schedule(
            rec["seed"], runner.SCENARIOS[rec["scenario"]])
        assert schedule.trace_hash(ev) == rec["trace_hash"], (
            rec["scenario"], rec["seed"])


@pytest.mark.parametrize("profile", sorted(ref_lschedule.PROFILES))
def test_load_trace_hashes_equal(profile):
    assert lschedule.PROFILES.keys() == ref_lschedule.PROFILES.keys()
    for seed in (0, 1, 7):
        ours = lschedule.generate_load(seed, lschedule.resolve_profile(profile))
        ref = ref_lschedule.generate_load(
            seed, ref_lschedule.resolve_profile(profile))
        assert len(ours) == len(ref) > 0
        assert lschedule.trace_hash(ours) == ref_lschedule.trace_hash(ref)


def test_payload_codecs_equal():
    for pool, oid, version, size in [
            ("rep", "obj-0", 1, 8192), ("ec", "o", 0, 3), ("ec", "x" * 40, 17, 65536),
            ("tier-base", "hot-3", 255, 4097)]:
        ours = workload.payload_for(pool, oid, version, size)
        assert ours == ref_workload.payload_for(pool, oid, version, size)
        assert workload.parse_payload(ours) == ref_workload.parse_payload(ours)
        assert ref_workload.parse_payload(ours) == (pool, oid, version)
        torn = ours[:-1] + bytes([ours[-1] ^ 1])
        assert workload.parse_payload(torn) is None
        assert ref_workload.parse_payload(torn) is None
    for name, size in [("lg-rep/obj-1", 4096), ("img", 17), ("s3/a/b", 1 << 20), ("x", 0)]:
        assert driver.payload_for(name, size) == ref_driver.payload_for(name, size)


def test_touched_checkers_replay_the_committed_records():
    """``touched_checkers`` judges a run from its record alone, so the
    committed records replay the same answer in both packages."""
    assert inv.ALL_INVARIANTS == ref_inv.ALL_INVARIANTS
    for rec in _records():
        assert inv.touched_checkers(rec) == ref_inv.touched_checkers(rec), (
            rec["scenario"], rec["seed"])


#: a record's observation key -> the checker that judges it
OBS_CHECKERS = {
    "backfill_obs": "check_backfill",
    "slow_osd_obs": "check_slow_osd",
    "events_obs": "check_events",
    "client_netem_obs": "check_client_netem",
    "fullness_obs": "check_fullness",
    "domains_obs": "check_domains",
}


def _mutants(obs):
    """The observation and a few broken copies of it (each leaf flipped
    or zeroed in turn), so red verdicts are compared too."""
    yield obs
    if isinstance(obs, dict):
        for k, v in obs.items():
            if isinstance(v, bool):
                yield {**obs, k: not v}
            elif isinstance(v, (int, float)):
                yield {**obs, k: 0}
                yield {**obs, k: v + 5}
            elif isinstance(v, (dict, list)) and v:
                yield {**obs, k: type(v)()}
    elif isinstance(obs, list) and obs:
        yield obs[:1]
        yield [{**o, "pools": {}} for o in obs if isinstance(o, dict)]


def test_checkers_agree_on_the_committed_observations():
    judged = 0
    for rec in _records():
        for key, name in OBS_CHECKERS.items():
            if key not in rec:
                continue
            for obs in _mutants(rec[key]):
                ours = getattr(inv, name)(copy.deepcopy(obs))
                ref = getattr(ref_inv, name)(copy.deepcopy(obs))
                assert ours == ref, (rec["scenario"], rec["seed"], name, obs)
                judged += 1
        if "load" in rec:
            tenants = sorted(lschedule.resolve_profile(
                rec["load"]["profile"]).get("tenants") or {})
            for obs in _mutants(rec["load"]):
                assert inv.check_load(copy.deepcopy(obs), tenants) == (
                    ref_inv.check_load(copy.deepcopy(obs), tenants))
                judged += 1
    assert judged > 100


def test_hand_built_verdicts_agree():
    cases = [
        ("check_converged", ({"pgs": {"num_pgs": 8, "num_reported": 8,
                                      "by_state": {"active+clean": 8}}},)),
        ("check_converged", ({"pgs": {"num_pgs": 8, "num_reported": 7,
                                      "by_state": {"active+clean": 7,
                                                   "peering": 1}}},)),
        ("check_converged", ({},)),
        ("check_quorum", ([{"rank": 0, "stable": True, "leader": 0, "epoch": 9},
                           {"rank": 1, "stable": True, "leader": 0, "epoch": 9}],)),
        ("check_quorum", ([{"rank": 0, "stable": True, "leader": 0, "epoch": 9},
                           {"rank": 1, "stable": True, "leader": 1, "epoch": 8}],)),
        ("check_quorum", ([{"rank": 0, "stable": False, "leader": 0, "epoch": 9}],)),
        ("check_quorum", ([{"rank": 0, "stable": True, "leader": 1, "epoch": 9},
                           {"rank": 1, "stable": True, "leader": 1, "epoch": 7}],)),
        ("check_scrub_reports", ([{"pg": "1.0"}, {"pg": "1.1", "error": "EIO"},
                                  {"pg": "2.0", "inconsistencies": ["obj"]}],)),
        ("check_disk_faults", ([{"osd": 1, "bad": []}, {"osd": 2, "bad": ["b"]}],)),
        ("check_cold_launches", ({"decode_batch": 1, "mgr_analytics": 0},
                                 {"decode_batch": 1, "mgr_analytics": 2})),
        ("check_mgr", ({"active": "x", "digest_age": 1.0,
                        "reporting": ["osd.0", "osd.1"]}, ["osd.0", "osd.1"])),
        ("check_mgr", ({"active": None}, ["osd.0"])),
        ("check_mgr", ({"active": "x", "digest_age": 50.0,
                        "reporting": ["osd.0"]}, ["osd.0", "osd.2"])),
    ]
    for name, args in cases:
        assert getattr(inv, name)(*copy.deepcopy(args)) == getattr(
            ref_inv, name)(*copy.deepcopy(args)), (name, args)


def _record_checks(monkeypatch) -> list[tuple]:
    """Wrap every ``check_*`` of the port's invariants so a run's calls
    (their arguments, copied, and their verdicts) are kept."""
    calls: list[tuple] = []
    for name in dir(inv):
        fn = getattr(inv, name)
        if not (name.startswith("check_") and callable(fn)):
            continue

        def wrap(*args, _fn=fn, _name=name):
            kept = copy.deepcopy(args)
            out = _fn(*args)
            calls.append((_name, kept, out))
            return out

        monkeypatch.setattr(inv, name, wrap)
    return calls


def _run(pkg_runner, **kw) -> dict:
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(asyncio.wait_for(
            pkg_runner.run_scenario("netem_storm", 0, **kw), 240))
    finally:
        loop.close()


def test_netem_storm_runs_alike_in_both_packages(monkeypatch):
    from ceph_tpu.parallel import decode_batcher, encode_service, scrub_batcher

    calls = _record_checks(monkeypatch)
    reset_shared()
    try:
        ours = _run(runner, device="cpu")
    finally:
        reset_shared()
    for mod in (encode_service, decode_batcher, scrub_batcher):
        mod.reset_shared()
    try:
        ref = _run(ref_runner)
    finally:
        for mod in (encode_service, decode_batcher, scrub_batcher):
            mod.reset_shared()
    assert ours.get("crash") is None and ref.get("crash") is None
    for key in ("trace_hash", "n_events", "events_applied", "ok"):
        assert ours[key] == ref[key], key
    assert ours["ok"] is True
    assert set(ours["invariants"]) == set(ref["invariants"])
    # every checker call of the port's run, replayed by the reference
    assert {name for name, _, _ in calls} >= {
        "check_converged", "check_quorum", "check_history",
        "check_final_reads", "check_scrub_reports", "check_cold_launches"}
    for name, args, verdict in calls:
        assert getattr(ref_inv, name)(*copy.deepcopy(args)) == verdict, name

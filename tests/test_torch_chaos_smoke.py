"""chip_smoke.py's chaos path (phase 17) on the CPU: the port's
``run_scenario`` for three of the chaos engine's scenarios at seed 0, one
line each and the path's launch line, and ``check_chaos`` refusing each
kind of bad line.  ``rack-loss`` is among them because its writers are
paced through a whole rack's outage, so the revived rack's recovery has
shards to decode at any host pace; ``compose_load``'s recovery decodes
only where the mon marks the killed OSD down before it is revived, which
a loaded host can miss.  On the CPU no kernel launches, so the launch check
applies on the card only; the recovery decode's batcher still counts
its launches of the plain version."""

from __future__ import annotations

import copy
import json

import pytest

import chip_smoke


def test_chip_smoke_chaos_path_on_cpu(capsys):
    run = chip_smoke.run_chaos_path(chip_smoke.Config(), "cpu",
                                    scenarios=["compose_load", "netem_storm", "rack-loss"])
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert [ln["phase"] for ln in lines] == ["chaos"] * 3 + ["chaos_path_launches"]
    by_name = {ln["scenario"]: ln for ln in run["chaos"]}
    assert set(by_name) == {"compose_load", "netem_storm", "rack-loss"}
    for ln in run["chaos"]:
        assert ln["ok"] and ln["crash"] is None and all(ln["invariants"].values())
        assert set(ln["cold_launch_deltas"]) == {
            "decode_batch", "scrub_verify_batch", "mgr_analytics",
            "transfer_guard_host_transfers"}
        assert not any(ln["cold_launch_deltas"].values())
        assert ln["guard_windows"] > 0
        assert ln["launches"] == dict.fromkeys(chip_smoke.CHAOS_KERNELS, 0)
    assert by_name["netem_storm"]["trace_hash"].startswith("c30cda3b8270")
    assert by_name["netem_storm"]["events_applied"] == 11
    load = by_name["compose_load"]["load"]
    assert load["agree"] and load["client"]["p50"] > 0
    summary = lines[-1]
    assert summary["scenarios"] == summary["green"] == 3
    assert summary["host_transfers"] == 0 and summary["decode_batch_launches"] > 0


GOOD = {"phase": "chaos", "scenario": "compose_load", "ok": True, "crash": None,
        "cold_launch_deltas": {"decode_batch": 0, "scrub_verify_batch": 0,
                               "mgr_analytics": 0, "transfer_guard_host_transfers": 0},
        "guard_windows": 3, "decode_batch_launches": 2,
        "load": {"agree": True}}
LAUNCHED = {"gf_bitmatmul": 4, "mgr_analytics": 2}


@pytest.mark.parametrize("change,fault", [
    ({"ok": False}, "red"),
    ({"crash": "RuntimeError: boom"}, "red"),
    ({"cold_launch_deltas": {"decode_batch": 1, "transfer_guard_host_transfers": 0}},
     "cold_launches"),
    ({"cold_launch_deltas": {"decode_batch": 0, "transfer_guard_host_transfers": 2}},
     "cold_launches"),
    ({"cold_launch_deltas": {}}, "cold_launches"),
    ({"load": {"agree": False}}, "client_vs_mgr"),
    ({"guard_windows": 0}, "no guard window"),
    ({"decode_batch_launches": 0}, "decode_batch"),
])
def test_chip_smoke_chaos_checks_fail_loudly(change, fault):
    chip_smoke.check_chaos([copy.deepcopy(GOOD)], LAUNCHED)
    bad = {**copy.deepcopy(GOOD), **change}
    with pytest.raises(AssertionError, match=fault):
        chip_smoke.check_chaos([bad], LAUNCHED)
    with pytest.raises(AssertionError, match="mgr_analytics"):
        chip_smoke.check_chaos([copy.deepcopy(GOOD)], {"gf_bitmatmul": 1, "mgr_analytics": 0})

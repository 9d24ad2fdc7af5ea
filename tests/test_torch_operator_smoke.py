"""chip_smoke.py's operator path (phase 18) on the CPU at a small size:
``crushtool`` and ``osdmaptool`` on a 64-OSD map (their ``--device cpu``
references in processes of their own), a one-mutant fuzz campaign, a
``vstart`` cluster of 6 OSDs with the CLI's flow and an EC(2,1) pool, the
cephadm flow on BlockStores, and the recovery config at 8 OSDs; then
``check_operator`` refusing each kind of bad line.  On the CPU no kernel
launches, so the launch checks apply on the card only.

The path runs in a child process with a temporary directory of its own:
its clusters, daemons and workers come and go with that process, so a
test process keeps none of its memory, and a child that dies fails the
fixture with its exit code and output instead of taking the test process
down.  The path must leave no process behind."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
import tempfile

import pytest

import chip_smoke

SMALL = {"OPERATOR_CRUSH_OSDS": 64, "OPERATOR_CRUSH_MAX_X": 1023,
         "OPERATOR_CRUSH_TESTS": ((0, 3), (1, 5)), "OPERATOR_OSDMAP_OSDS": 64,
         "OPERATOR_OSDMAP_PGS": 512, "OPERATOR_VSTART_OSDS": 6, "OPERATOR_EC": (2, 1),
         "OPERATOR_EC_PG_NUM": 8, "OPERATOR_OBJECTS": 4, "OPERATOR_OBJECT_BYTES": 64 * 1024,
         "OPERATOR_OUT_OSD": 5, "OPERATOR_RECOVERY_OSDS": 8, "OPERATOR_RECOVERY_OBJECTS": 8,
         "OPERATOR_FUZZ_ARGS": ("--scenarios", "osd_thrash", "--budget", "1",
                                "--settle-timeout", "45")}


#: the child: phase 18 at ``SMALL`` on the CPU, its result to argv[1]
CHILD = """
import json, sys
import chip_smoke
from tests.test_torch_operator_smoke import SMALL
for name, value in SMALL.items():
    setattr(chip_smoke, name, value)
with open(sys.argv[1], "w") as f:
    json.dump(chip_smoke.run_operator_path(chip_smoke.Config(), "cpu"), f)
"""


def _processes_under(path: str) -> list[str]:
    """The command lines of the processes that name ``path`` in their
    arguments or run in it."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/cmdline", "rb") as f:
                argv = f.read().decode(errors="replace").replace("\0", " ")
            cwd = os.readlink(f"/proc/{pid}/cwd")
        except OSError:
            continue
        if path in argv or cwd.startswith(path):
            found.append(f"{pid}: {argv}")
    return found


@pytest.fixture(scope="module")
def operator_run():
    """Phase 18's result from a child process, with its temporary
    directory and the processes found under it when the child ended;
    ``SMALL`` applies here too, for ``check_operator``.  The directory is
    made where the path would make its own (the daemons' admin sockets
    live in it, and a socket's path has at most 107 bytes)."""
    tmp = tempfile.mkdtemp(prefix="op-")
    try:
        out = os.path.join(tmp, "run.json")
        res = subprocess.run([sys.executable, "-c", CHILD, out], cwd=chip_smoke.REPO_ROOT,
                             env=chip_smoke.child_env(TMPDIR=tmp), capture_output=True,
                             text=True, timeout=900)
        left = _processes_under(tmp)
        if res.returncode != 0:
            pytest.fail(f"the operator path exited {res.returncode}:\n"
                        f"{res.stdout[-4000:]}\n{res.stderr[-4000:]}", pytrace=False)
        with open(out) as f:
            run = json.load(f)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    run["left_behind"] = left
    mp = pytest.MonkeyPatch()
    for name, value in SMALL.items():
        mp.setattr(chip_smoke, name, value)
    try:
        yield run
    finally:
        mp.undo()


def test_chip_smoke_operator_path_on_cpu(operator_run, capsys):
    line = operator_run["operator"]
    assert line["maps"]["roundtrip"]
    for name in ("rule0", "rule1"):
        assert line["crushtool"][name]["statistics"] == line["cpu_reference"][name]
        assert line["crushtool"][name]["statistics"]["devices_used"] == 64
    assert line["osdmaptool"]["map_pgs"]["pg_count"] == 512
    fz = line["fuzz"]
    assert fz["summary"]["runs"] == 2 and not fz["crashed"] and fz["minimize_demo_equal"]
    vs = line["vstart"]
    assert vs["num_up_osds"] == 6 and vs["osd_perf_ids"] == list(range(6))
    assert vs["out_to_clean_s"] > 0 and vs["deep_scrubbed_pgs"] == 8
    assert vs["mgr"]["launches"] > 0  # the engine's passes, on the plain version here
    adm = line["cephadm"]
    assert adm["ls_up_after_add"] == 5 and adm["reboot_read_mismatches"] == 0
    # bench_all's recovery config at 8 OSDs (EC(4,2)): run A reaches clean
    # decoding in batches in the worker processes with no cold launch
    rec = line["recovery"]
    assert (rec["osds"], rec["k"], rec["m"]) == (8, 4, 2)
    run_a = rec["runs"]["A"]
    assert run_a["batch"]["launches"] > 0 and run_a["batch"]["cold_launches"] == 0
    assert run_a["decode_bytes"] > 0 and run_a["seconds_to_clean"] > 0
    assert run_a["batch"]["processes"] > 1
    # the wrappers ran their plain versions: no launch counted
    assert run_a["recovery_launches"] == {} and vs["launches"] == {}
    summary = operator_run["summary"]
    assert set(summary["by_step"]) == {"crushtool", "osdmaptool", "fuzz", "vstart",
                                       "cephadm", "recovery"}
    assert not any(summary[k] for k in ("gf_bitmatmul", "crush_rule", "mgr_analytics"))


@pytest.mark.parametrize("path,value,fault", [
    (("maps", "roundtrip"), False, "crush_roundtrip"),
    (("crushtool", "rule1", "statistics", "max"), -1, "crush_vs_cpu"),
    (("osdmaptool", "map_pgs", "pg_per_osd_max"), -1, "map_pgs_vs_cpu"),
    (("fuzz", "crashed"), ["abc"], "fuzz_crash"),
    (("fuzz", "lineage_mismatches"), ["abc"], "fuzz_lineage"),
    (("fuzz", "rc"), 1, "fuzz_red"),
    (("vstart", "readback_mismatches"), 1, "vstart_io"),
    (("vstart", "osd_perf_ids"), [0], "osd_perf"),
    (("vstart", "mgr", "digest_failures"), 1, "mgr"),
    (("cephadm", "ls_up_at_end"), 1, "cephadm"),
    (("recovery", "runs", "A", "batch", "cold_launches"), 1.0, "recovery"),
    (("recovery", "runs", "B", "recovery_launches"), {"gf_bitmatmul_pallas": 3}, "recovery"),
])
def test_check_operator_refuses(operator_run, path, value, fault):
    line = copy.deepcopy(operator_run["operator"])
    chip_smoke.check_operator(line, on_card=False)
    node = line
    for key in path[:-1]:
        node = node[key]
    node[path[-1]] = value
    with pytest.raises(AssertionError, match=fault):
        chip_smoke.check_operator(line, on_card=False)


def test_operator_path_leaves_no_process_behind(operator_run):
    """Every daemon, worker and reference process the path started had
    ended when it returned (cephadm's daemons run in sessions of their
    own and outlive a process that forgets them)."""
    assert operator_run["left_behind"] == []


def test_check_operator_wants_launches_on_the_card(operator_run):
    """On the card the same CPU line fails: nothing launched."""
    with pytest.raises(AssertionError, match="launches"):
        chip_smoke.check_operator(operator_run["operator"], on_card=True)
    json.dumps(operator_run["summary"])

"""The port's twin of tests/integration/test_cli.py: a ``vstart`` cluster
(``python -m ceph_tpu_torch.tools.vstart --device cpu``) driven by the
port's ``ceph`` CLI over real TCP, each a process of its own, nothing
shared but sockets; the erasure-code profile on the ``cuda`` plugin."""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def cluster_proc():
    proc = subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.vstart", "--mons", "3", "--osds", "6",
         "--beacon", "0.5", "--device", "cpu"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, cwd=ROOT,
    )
    spec = None
    seen = []
    deadline = time.time() + 60
    while time.time() < deadline:
        line = proc.stdout.readline()
        if line == "" and proc.poll() is not None:
            break  # child died at startup
        seen.append(line)
        m = re.search(r"mons at (\S+)", line or "")
        if m:
            spec = m.group(1)
            break
    assert spec, (
        f"vstart never reported its monmap (rc={proc.poll()}):\n"
        + "".join(seen)
    )
    yield spec
    proc.terminate()
    proc.wait(timeout=60)


def ceph(spec, *args, extra_flags=()):
    r = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.ceph", "-m", spec, *extra_flags, *args],
        capture_output=True, text=True, timeout=120, cwd=ROOT,
    )
    return r


class TestCLI:
    def test_full_admin_flow(self, cluster_proc):
        spec = cluster_proc
        r = ceph(spec, "status")
        assert r.returncode == 0, r.stderr
        status = json.loads(r.stdout)
        assert status["num_up_osds"] == 6

        r = ceph(
            spec, "osd", "erasure-code-profile", "set", "cliprof",
            "k=2", "m=1", "plugin=cuda",
        )
        assert r.returncode == 0, r.stderr

        r = ceph(
            spec, "osd", "pool", "create", "clipool",
            extra_flags=("--pg-num", "8", "--pool-type", "erasure",
                         "--erasure-code-profile", "cliprof"),
        )
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["pool_id"] >= 1

        r = ceph(spec, "df")
        assert r.returncode == 0
        assert "clipool" in r.stdout

        r = ceph(spec, "pg", "scrub", "1.0")
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["inconsistencies"] == []

        r = ceph(spec, "osd", "down", "5")
        assert r.returncode == 0, r.stderr
        # the beacon sweep will bring it back up (the daemon is alive);
        # status must remain serviceable throughout
        r = ceph(spec, "status")
        assert r.returncode == 0

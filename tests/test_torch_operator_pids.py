"""No signal for a pid that a daemon of ours no longer holds.

``cephadm`` keeps each daemon's pid in a pid file, and ``chip_smoke.py``'s
operator path records those pids to reap what is left at its end.  A
daemon that exits is reaped (by ``subprocess``, once its ``Popen`` was
dropped), and the kernel may then give its pid to any other process:
under a loaded test run, another test's daemon or a test process.  So
``cephadm`` lists, stops and restarts a pid only while it runs that
daemon of that cluster, and ``_reap`` signals only its running
children."""

from __future__ import annotations

import argparse
import json
import os
import signal
import subprocess
import sys

import chip_smoke
from ceph_tpu_torch.tools import cephadm

SLEEP = [sys.executable, "-c", "import time; time.sleep(120)"]


def _recording_kill(monkeypatch, allowed: set[int]) -> list:
    """os.kill that records every call and delivers only signal 0 and
    signals to ``allowed``."""
    calls: list = []
    real = os.kill

    def kill(pid, sig):
        calls.append((pid, sig))
        if sig == 0 or pid in allowed:
            real(pid, sig)

    monkeypatch.setattr(os, "kill", kill)
    return calls


def test_reap_signals_only_its_running_children(monkeypatch):
    running = subprocess.Popen(SLEEP)
    gone = subprocess.Popen([sys.executable, "-c", "pass"])
    gone.wait()  # reaped: its pid is free for any process now
    calls = _recording_kill(monkeypatch, {running.pid})
    chip_smoke._reap({running.pid, gone.pid, os.getppid()})
    assert calls == [(running.pid, 9)]
    assert running.wait(timeout=10) is not None


def test_cephadm_knows_its_daemon_by_its_command_line(tmp_path, monkeypatch):
    data = str(tmp_path)
    with open(os.path.join(data, "cluster_spec.json"), "w") as f:
        json.dump({"mons": 1, "osds": [0, 1]}, f)
    daemon = subprocess.Popen(SLEEP + ["_daemon", "osd", "--data", data, "--osd-id", "1"])
    try:
        for name, pid in (("osd.0", os.getpid()), ("osd.1", daemon.pid),
                          ("mon.0", daemon.pid)):
            with open(os.path.join(data, f"{name}.pid"), "w") as f:
                f.write(str(pid))
        # this process is alive, but it is no daemon; osd.1's process is
        # no mon
        assert cephadm._daemon_pid(data, "osd.0") is None
        assert cephadm._daemon_pid(data, "mon.0") is None
        assert cephadm._daemon_pid(data, "osd.1") == daemon.pid
        assert not cephadm._runs_daemon(daemon.pid, os.path.join(data, "other"), "osd.1")
        calls = _recording_kill(monkeypatch, {daemon.pid})
        assert cephadm.cmd_stop(argparse.Namespace(data=data)) == 0
        assert [c for c in calls if c[1] != 0] == [(daemon.pid, signal.SIGTERM)]
        assert daemon.wait(timeout=10) is not None
    finally:
        if daemon.poll() is None:
            daemon.kill()
            daemon.wait()

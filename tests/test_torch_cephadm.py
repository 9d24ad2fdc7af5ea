"""The port's twin of tests/integration/test_cephadm.py: cephadm-lite's
multi-process deployment lifecycle (``python -m
ceph_tpu_torch.tools.cephadm``, every daemon with ``--device cpu``) —
bootstrap, I/O through real separate daemon processes, daemon
add/restart, durable stop/re-bootstrap.

Like its reference it is red on a host whose filesystem has less than a
tenth of its blocks available to the daemons: the FileStore reports the
host filesystem's usage (total less available), every OSD then sits at
or past ``mon_osd_backfillfull_ratio`` (0.90) and answers every backfill
reservation REJECT_TOOFULL, so no PG's recovery pass runs and the pool
stays active+peering."""

from __future__ import annotations

import asyncio
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(*argv) -> str:
    if argv[0] == "bootstrap":
        argv = (*argv, "--device", "cpu")
    out = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.cephadm", *argv],
        capture_output=True, text=True,
        timeout=120, env={**os.environ, "PYTHONPATH": REPO}, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr
    return out.stdout


def _mon_addrs(data: str) -> list[tuple[str, int]]:
    spec = json.load(open(os.path.join(data, "cluster_spec.json")))
    return [("127.0.0.1", p) for p in spec["mon_ports"]]


async def _wait_up(addrs, n_osds: int, timeout: float = 60.0):
    from ceph_tpu_torch.client import RadosClient

    cl = RadosClient(client_id=77)
    deadline = time.monotonic() + timeout
    while True:
        try:
            await cl.connect_multi(addrs)
            break
        except Exception:
            if time.monotonic() > deadline:
                raise
            await asyncio.sleep(0.5)
    while time.monotonic() < deadline:
        om = cl.osdmap
        if om and sum(
            1 for o in range(om.max_osd) if om.is_up(o)
        ) >= n_osds:
            return cl
        await cl._wait_new_map(om.epoch if om else 0, timeout=2)
    raise TimeoutError("osds never came up")


class TestCephadmLifecycle:
    def test_bootstrap_io_restart_durability(self, tmp_path):
        data = str(tmp_path / "clus")
        _run("bootstrap", "--data", data, "--osds", "3",
             "--store", "file")
        try:
            addrs = _mon_addrs(data)

            async def io_phase():
                cl = await _wait_up(addrs, 3)
                await cl.pool_create("adm", pg_num=4, size=2)
                io = cl.ioctx("adm")
                for i in range(6):
                    await io.write_full(f"o{i}", bytes([i]) * 2048)
                await cl.wait_clean(timeout=60)
                await cl.shutdown()

            asyncio.new_event_loop().run_until_complete(io_phase())

            out = _run("ls", "--data", data)
            assert out.count("up") == 4  # 1 mon + 3 osds

            _run("add-osd", "--data", data)
            _run("restart", "--data", data, "osd.0")
            time.sleep(2)
            out = _run("ls", "--data", data)
            assert "osd.3" in out and out.count("up") == 5

            async def verify_phase():
                cl = await _wait_up(addrs, 4)
                io = cl.ioctx("adm")
                await cl.wait_clean(timeout=90)
                for i in range(6):
                    assert await io.read(f"o{i}") == bytes([i]) * 2048
                # the added osd got a CRUSH location (add-osd runs the
                # create-or-move step) — it is genuinely placeable,
                # not just 'up'
                crush = cl.osdmap.crush
                h3 = crush.bucket_names.get("host3")
                assert h3 is not None
                assert 3 in crush.buckets[h3].items
                await cl.shutdown()

            asyncio.new_event_loop().run_until_complete(verify_phase())
        finally:
            _run("stop", "--data", data)
        out = _run("ls", "--data", data)
        assert "up" not in out

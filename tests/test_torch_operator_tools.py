"""The operator's command line of the port against the reference's.

- ``crushtool``: ``--build`` and ``-d`` give the reference's text, and
  ``--test`` (the plain version on the CPU) its statistics, mappings and
  bad mappings;
- ``osdmaptool``: ``--createsimple`` writes the reference's bytes, each
  package reads the other's map, ``--print`` and ``--test-map-pgs`` give
  the same JSON apart from ``seconds``;
- ``bench_all``'s ``recovery`` line from canned runs (the config itself
  runs at 8 OSDs in ``tests/test_torch_operator_smoke.py``);
- why the cephadm flow stalls on FileStores on a host whose filesystem
  has under a tenth of its blocks available: a FileStore reports the
  host filesystem's usage, a BlockStore its own (the flow on BlockStores
  runs in ``tests/test_torch_operator_smoke.py``).
"""

from __future__ import annotations

import importlib.util
import json
import os
import pathlib
from types import SimpleNamespace

import pytest

from ceph_tpu_torch.tools import bench_all, crushtool, osdmaptool
from tests.xla_private import _private_xla_compiles  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _both(capsys, argv: list[str], port_main, ref_main) -> tuple[str, str]:
    """The standard output of the port's and the reference's CLI on ``argv``
    (the port's with ``--device cpu`` where it maps)."""
    dev = ["--device", "cpu"] if "--test" in argv or "--test-map-pgs" in argv else []
    assert port_main(argv + dev) == 0
    port = capsys.readouterr().out
    assert ref_main(argv) == 0
    return port, capsys.readouterr().out


@pytest.fixture(scope="module")
def crush_maps(tmp_path_factory):
    d = tmp_path_factory.mktemp("crush")
    port, ref = d / "port.txt", d / "ref.txt"
    assert crushtool.main(["--build", "64", "--osds-per-host", "8", "-o", str(port)]) == 0
    assert _reference_tool("crushtool").main(
        ["--build", "64", "--osds-per-host", "8", "-o", str(ref)]) == 0
    return port, ref


def test_crushtool_build_and_decompile_match_reference(crush_maps, capsys):
    port, ref = crush_maps
    assert port.read_text() == ref.read_text()
    ref_tool = _reference_tool("crushtool")
    got, want = _both(capsys, ["-d", str(port)], crushtool.main, ref_tool.main)
    assert got == want
    # the decompiled text round-trips to the built map's text
    assert got.rstrip("\n") == port.read_text().rstrip("\n")


@pytest.mark.parametrize("rule,num_rep,extra", [
    (0, 3, ["--max-x", "2047"]),
    (1, 5, ["--max-x", "2047", "--show-statistics", "--show-bad-mappings"]),
    (1, 9, ["--min-x", "100", "--max-x", "163", "--show-mappings", "--show-bad-mappings"]),
])
def test_crushtool_test_matches_reference(crush_maps, capsys, rule, num_rep, extra):
    port, _ = crush_maps
    argv = ["--test", "-i", str(port), "--rule", str(rule), "--num-rep", str(num_rep), *extra]
    got, want = _both(capsys, argv, crushtool.main, _reference_tool("crushtool").main)
    assert got == want
    assert got.strip()


def _without_seconds(text: str) -> list[dict]:
    """The JSON documents of an ``osdmaptool`` output, ``seconds`` dropped."""
    docs, dec, i = [], json.JSONDecoder(), 0
    text = text.strip()
    while i < len(text):
        doc, n = dec.raw_decode(text, i)
        doc.pop("seconds", None)
        docs.append(doc)
        i = n
        while i < len(text) and text[i].isspace():
            i += 1
    return docs


def test_osdmaptool_matches_reference(tmp_path, capsys):
    ref_tool = _reference_tool("osdmaptool")
    port_bin, ref_bin = tmp_path / "port.bin", tmp_path / "ref.bin"
    create = ["--createsimple", "64", "--pg-num", "512"]
    assert osdmaptool.main([*create, "-o", str(port_bin)]) == 0
    assert ref_tool.main([*create, "-o", str(ref_bin)]) == 0
    capsys.readouterr()
    assert port_bin.read_bytes() == ref_bin.read_bytes()
    # each package reads the other's file
    for argv in ([str(ref_bin), "--print", "--test-map-pgs"],
                 [str(port_bin), "--test-map-pgs", "--pool", "1"]):
        got, want = _both(capsys, argv, osdmaptool.main, ref_tool.main)
        got_docs, want_docs = _without_seconds(got), _without_seconds(want)
        assert got_docs == want_docs
        assert got_docs[-1]["pg_count"] == 512 and got_docs[-1]["osds_used"] == 64


def test_recovery_line(monkeypatch, capsys):
    """``bench_recovery`` runs A (batched, ``device-min-bytes`` 4096, the
    encode farm on) then B (host, 2^40, the aggregator and the farm off);
    its value is A's decode rate over B's, ``vs_baseline`` that over the
    reference's 10x; no batch or a cold launch in run A fails it, and so
    does a bit-matrix launch in run B."""
    import torch

    calls = []

    def run(a_batch, b_launches=None):
        async def fake(extra, device, decode_batch="on", encode_farm="on"):
            calls.append((extra, decode_batch, encode_farm))
            on = decode_batch == "on"
            return {"seconds_to_clean": 4.0 if on else 8.0, "bytes_written": 1 << 26,
                    "decode_seconds": 0.5 if on else 2.0, "decode_bytes": 1e9,
                    "batch": a_batch if on else {"processes": 0},
                    "recovery_launches": {} if on else dict(b_launches or {})}
        return fake

    good = {"launches": 10.0, "cold_launches": 0.0, "mean_batch": 3.0, "processes": 8}
    monkeypatch.setenv("BENCH_RECOVERY_OSDS", "16")
    monkeypatch.setattr(bench_all, "_recovery_scenario", run(good))
    line = bench_all.bench_recovery(torch.device("cpu"), bench_all.Sizes())
    assert calls == [({"device-min-bytes": "4096"}, "on", "on"),
                     ({"device-min-bytes": str(1 << 40)}, "off", "off")]
    assert line["value"] == 4.0 and line["vs_baseline"] == 0.4 and line["unit"] == "x speedup"
    assert (line["k"], line["m"], line["osds"]) == (8, 3, 16)
    assert line["runs"]["A"]["decode_gbs"] == 2.0 and line["runs"]["B"]["decode_gbs"] == 0.5
    assert json.loads(capsys.readouterr().out.strip()) == line
    for bad in (run({"launches": 0.0, "cold_launches": 0.0}),
                run({"launches": 4.0, "cold_launches": 1.0}),
                run(good, {"gf_bitmatmul_pallas": 17})):
        monkeypatch.setattr(bench_all, "_recovery_scenario", bad)
        with pytest.raises(AssertionError):
            bench_all.bench_recovery(torch.device("cpu"), bench_all.Sizes())


def test_filestore_fullness_is_the_host_filesystems(tmp_path, monkeypatch):
    """Why the cephadm flow stalls on FileStores on a host whose
    filesystem has under a tenth of its blocks available: a FileStore's
    usage is the host filesystem's (total less available), so its OSD is
    past ``mon_osd_backfillfull_ratio`` however little it holds, and
    rejects every backfill reservation; a BlockStore counts its own."""
    from ceph_tpu_torch.osd.daemon import OSDDaemon
    from ceph_tpu_torch.store.blockstore import BlockStore
    from ceph_tpu_torch.store.filestore import FileStore

    real = os.statvfs

    def statvfs(path):
        st = real(path)
        return SimpleNamespace(f_frsize=4096, f_blocks=1000, f_bavail=77,
                               f_bfree=957, **{k: getattr(st, k) for k in ("f_bsize",)})

    fs = FileStore(str(tmp_path / "fs"))
    fs.mount()
    bs = BlockStore(str(tmp_path / "bs"))
    bs.mount()
    monkeypatch.setattr(os, "statvfs", statvfs)
    try:
        ratios = {}
        for name, store in (("file", fs), ("block", bs)):
            osd = OSDDaemon(0, ("127.0.0.1", 1), store=store, device="cpu")
            ratios[name] = osd._full_ratio()
            limit = osd.conf["mon_osd_backfillfull_ratio"]
        assert ratios["file"] == pytest.approx(0.923) and ratios["file"] >= limit
        assert ratios["block"] < 0.01
    finally:
        monkeypatch.undo()
        fs.umount()
        bs.umount()

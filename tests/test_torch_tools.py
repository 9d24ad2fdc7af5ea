"""The port's measurement tools (``ceph_tpu_torch.tools``) against the JAX
package's (CPU, tiny sizes, ``device="cpu"``).

- ``ec_benchmark``: the twin and ``python tools/ec_benchmark.py`` (JAX on
  the CPU, in a subprocess) print the same KiB field for an encode and
  an exhaustive decode of jerasure RS(4,2);
- ``bench_all._big_map``: the same up and acting rows as the reference's
  for a sample of the PGs of each pool;
- ``bench_all``'s decode: the rebuilt chunk equals the reference codec's
  decode of the same numpy input, and the chunk itself;
- ``bench_all.main`` exits non-zero when a config fails;
- ``bench``: one JSON line with the reference's keys.
"""

import importlib.util
import json
import os
import pathlib
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.models import isa_cauchy_matrix as ref_isa_cauchy
from ceph_tpu.ops import rs_kernels as ref_rk
from ceph_tpu.osd.types import pg_t as ref_pg_t
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.osd.types import pg_t
from ceph_tpu_torch.tools import bench, bench_all, ec_benchmark
from tests.xla_private import _private_xla_compiles  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
JERASURE = ["--plugin", "jerasure", "--size", "65536", "--iterations", "4",
            "--parameter", "k=4", "--parameter", "m=2",
            "--parameter", "technique=reed_sol_van"]


def _reference_tool(name: str):
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("workload", [
    ["--workload", "encode"],
    ["--workload", "decode", "--erasures", "2", "--erasures-generation", "exhaustive"],
])
def test_ec_benchmark_matches_reference(capsys, workload):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT))
    ref = subprocess.run([sys.executable, str(ROOT / "tools" / "ec_benchmark.py"),
                          *JERASURE, *workload], cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=600, check=True)
    ref_secs, ref_kib = ref.stdout.strip().splitlines()[-1].split("\t")
    assert ec_benchmark.main(["--device", "cpu", *JERASURE, *workload]) == 0
    out = capsys.readouterr()
    secs, kib = out.out.strip().splitlines()[-1].split("\t")
    assert kib == ref_kib == str(4 * 65536 // 1024)
    assert float(secs) > 0 and float(ref_secs) > 0
    assert "GB/s" in out.err


def test_big_map_matches_reference():
    ref_om = _reference_tool("bench_all")._big_map()
    om = bench_all._big_map()
    assert om.max_osd == ref_om.max_osd == 1024
    for pid in (1, 2):
        pool, ref_pool = om.pools[pid], ref_om.pools[pid]
        assert (pool.size, pool.pg_num, pool.crush_rule) == (
            ref_pool.size, ref_pool.pg_num, ref_pool.crush_rule)
        for ps in range(0, pool.pg_num, 97):
            assert om.pg_to_up_acting_osds(pg_t(pid, ps), folded=True) == \
                ref_om.pg_to_up_acting_osds(ref_pg_t(pid, ps), folded=True), (pid, ps)


def test_bench_all_decode_matches_reference():
    """bench_all's decode at S = 2^16: the chunk rebuilt from the port's
    survivors equals the reference codec's decode of the same numpy
    input (its survivors: the other data chunks and parity 0)."""
    k, m, s, lost = 8, 3, 1 << 16, bench_all.DECODE_LOST
    data = np.random.default_rng(1).integers(0, 256, (k, s), dtype=np.uint8)
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device="cpu")
    sub = bench_all.decode_survivors(codec, torch.from_numpy(data))
    got = bench_all.decode_erased(codec, sub).numpy()
    ref = ref_rk.BitmatrixCodec(ref_isa_cauchy(k, m))
    parity = np.asarray(ref.encode(jnp.asarray(data), pallas=False))
    ref_sub = np.concatenate([data[:lost], data[lost + 1:], parity[0:1]])
    assert np.array_equal(sub.numpy(), ref_sub)
    survivors, dbits = ref.decode_bits((lost,))
    assert survivors == [i for i in range(k + 1) if i != lost]
    want = np.asarray(ref_rk.BitmatrixCodec._apply(dbits, jnp.asarray(ref_sub), None))
    assert got.shape == (1, s)
    assert np.array_equal(got, want)
    assert np.array_equal(got[0], data[lost])


def test_bench_all_exits_nonzero_on_a_failed_config(monkeypatch, capsys):
    def broken(device, sizes):
        raise RuntimeError("kernel launch refused")

    ran = []
    monkeypatch.setattr(bench_all, "CONFIGS", {
        "ok": lambda device, sizes: ran.append(device.type),
        "broken": broken,
    })
    assert bench_all.main(["--device", "cpu"]) == 1
    assert ran == ["cpu"]
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines == [{"metric": "broken", "error": "RuntimeError: kernel launch refused"}]
    assert bench_all.main(["--device", "cpu", "ok"]) == 0
    with pytest.raises(SystemExit):
        bench_all.main(["--device", "cpu", "recovery"])


def test_bench_all_cpu_sizes():
    cpu = bench_all.Sizes.for_device(torch.device("cpu"))
    assert (cpu.decode_cols, cpu.batch_object_bytes) == (1 << 16, 512 * 1024)
    card = bench_all.Sizes()
    assert (card.decode_cols, card.batch_object_bytes, card.clay_chunk) == (
        256 << 20, 8 << 20, 32 << 20)
    assert "recovery" not in bench_all.CONFIGS


def test_bench_prints_one_json_line(capsys):
    assert bench.main(["--device", "cpu", "--check-cols", "4096"]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    # the reference's keys (bench.py:163-170), its accelerator extras too
    assert {"metric", "value", "unit", "vs_baseline", "samples_gb_s", "median_gb_s",
            "min_gb_s"} <= set(line)
    assert line["unit"] == "GB/s" and line["value"] > 0
    # a CPU run is no share of the card's bound
    assert line["device"] == "cpu" and line["vs_baseline"] is None
    assert line["bound_ms_per_iter"] == (8 + 6) * 65536 / 3.35e12 * 1e3


def test_tools_need_a_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main in (bench.main, bench_all.main, ec_benchmark.main):
        with pytest.raises(RuntimeError, match="CUDA"):
            main([])

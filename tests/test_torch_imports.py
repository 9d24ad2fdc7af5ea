"""Import gate of the port.

``ceph_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
JAX package ``ceph_tpu``: a subprocess blocks both in ``sys.modules``
and imports every module; a static scan finds no such import in any
port file; and with CUDA reported unavailable the default-device entry
points raise instead of running elsewhere.
"""

import os
import re
import subprocess
import sys

import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.crush import builder as crush_builder
from ceph_tpu_torch.crush.cudamapper import BatchedRuleMapper, compile_map
from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.plugins.clay_cuda import ClayRepairProgram
import ceph_tpu_torch.common
import ceph_tpu_torch.kv
import ceph_tpu_torch.msg.denc
import ceph_tpu_torch.store
from ceph_tpu_torch.mgr.analytics import AnalyticsEngine
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.parallel import encode_service
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from ceph_tpu_torch.osd.balancer import UpmapBalancer
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.remap import BatchedClusterMapper
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(ROOT, "ceph_tpu_torch")


def _modules() -> list[str]:
    """Every Python module of the package (not the built .so files)."""
    names = []
    for dirpath, _, files in os.walk(PKG):
        rel = os.path.relpath(dirpath, ROOT).replace(os.sep, ".")
        for f in files:
            if f.endswith(".py"):
                names.append(rel if f == "__init__.py" else f"{rel}.{f[:-3]}")
    return sorted(names)


def _sources() -> list[str]:
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files
                if f.endswith((".py", ".cu", ".cc"))]
    return sorted(out)


def test_every_module_imports_with_jax_and_ceph_tpu_blocked():
    mods = _modules()
    assert "ceph_tpu_torch.ops.rs_kernels" in mods
    assert "ceph_tpu_torch.ec.plugins.cuda" in mods
    assert "ceph_tpu_torch.parallel.scrub_batcher" in mods
    assert "ceph_tpu_torch.ops.hashing" in mods
    for name in ("crush.types", "crush._ln_tables", "crush.builder", "crush.mapper",
                 "crush.cudamapper", "crush.tester", "osd.types", "osd.osdmap",
                 "osd.remap", "osd.balancer", "models.bitmatrices", "ec.plugins.isa",
                 "ec.plugins.jerasure", "ec.plugins.shec", "ec.plugins.lrc",
                 "ec.plugins.clay", "ec.plugins.clay_cuda", "ops.lab_kernels", "tools",
                 "tools.perf_lab", "tools.perf_lab2", "tools.perf_lab3", "tools.bench",
                 "tools.ec_benchmark", "tools.bench_all", "mgr", "mgr.analytics",
                 "mgr.daemon", "ops.analytics_kernels", "parallel.encode_farm",
                 "parallel.encode_service", "msg", "msg.denc", "compressor",
                 "common", "common.config", "common.dout", "common.caps",
                 "common.crash", "common.optracker", "common.metrics",
                 "common.tracing", "common.fault_injector", "common.reserver",
                 "common.admin_socket", "common.interleave", "kv", "store",
                 "store.objectstore", "store.memstore", "store.kstore",
                 "store.filestore", "store.bluefs", "store.blockstore"):
        assert f"ceph_tpu_torch.{name}" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        f"for name in {mods!r} + ['chip_smoke']:\n"
        "    importlib.import_module(name)\n"
        "assert not any(m == 'jax' or m.startswith(('jax.', 'ceph_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REF = re.compile(r"\bceph_tpu(\.|\s|$)", re.M)


def test_foundation_loads_without_messages():
    """The host foundation (common/, kv/, store/, msg.denc) stands on its
    own: ``ceph_tpu_torch.common`` exports the reference's names but the
    cluster log's, and no ``msg.messages`` module is needed to load it."""
    assert set(ceph_tpu_torch.common.__all__) == {
        "AdminSocket", "DoutLogger", "OPTIONS", "OpTracker", "TrackedOp",
        "admin_command", "ConfigProxy", "MetricsServer", "Option", "PerfCounters",
        "all_collections", "declare", "get_perf_counters", "prometheus_text",
        "record_crash", "scan_crashes"}
    assert set(ceph_tpu_torch.store.__all__) == {
        "FileStore", "META_COLL", "MemStore", "ObjectStore", "Transaction", "TxOp",
        "coll_t", "ghobject_t"}
    assert ceph_tpu_torch.kv.FileDB and ceph_tpu_torch.msg.denc.Encoder
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "sys.modules['ceph_tpu_torch.msg.messages'] = None\n"
        "for name in ('ceph_tpu_torch.common', 'ceph_tpu_torch.kv',\n"
        "             'ceph_tpu_torch.store', 'ceph_tpu_torch.store.blockstore',\n"
        "             'ceph_tpu_torch.store.bluefs', 'ceph_tpu_torch.msg.denc',\n"
        "             'ceph_tpu_torch.common.fault_injector'):\n"
        "    importlib.import_module(name)\n"
        "assert 'torch' not in sys.modules\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")


def test_static_scan_finds_no_forbidden_import():
    offenders = []
    for path in _sources():
        with open(path, encoding="utf-8") as f:
            text = f.read()
        if _JAX.search(text):
            offenders.append((path, "jax"))
        for line in text.splitlines():
            stripped = line.strip()
            if stripped.startswith(("import ", "from ")) and _REF.search(stripped):
                offenders.append((path, stripped))
    assert not offenders, offenders


def test_static_scan_sees_a_planted_import():
    """The scan's patterns catch what they are meant to catch."""
    assert _JAX.search("import jax.numpy as jnp\n")
    assert _JAX.search("    from jax import lax\n")
    assert not _JAX.search("import jaxlib_like\n")
    assert _REF.search("from ceph_tpu.ops import gf256")
    assert _REF.search("import ceph_tpu")
    assert not _REF.search("from ceph_tpu_torch.ops import gf256")


#: every plugin this port adds beside ``cuda``, with a profile it takes
NEW_PLUGINS = [("isa", {}), ("jerasure", {}), ("jerasure", {"technique": "liberation"}),
               ("shec", {}), ("lrc", {"k": "4", "m": "2", "l": "3"}), ("clay", {}),
               ("clay", {"scalar_mds": "cuda"})]


@pytest.fixture
def no_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def _crush_map() -> tuple[CrushMap, int]:
    m = CrushMap()
    root = crush_builder.build_hierarchy(m, osds_per_host=2, n_hosts=3)
    return m, crush_builder.add_simple_rule(m, root.id, 1, mode="firstn")


def test_default_device_constructors_raise(no_cuda):
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.BitmatrixCodec(isa_cauchy_matrix(8, 3))
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.codec_from_reference(isa_cauchy_matrix(8, 3), device=None)
    with pytest.raises(RuntimeError, match="CUDA"):
        registry.factory("cuda", {"k": "8", "m": "3"})
    with pytest.raises(RuntimeError, match="CUDA"):
        DecodeAggregator()
    with pytest.raises(RuntimeError, match="CUDA"):
        ScrubVerifier()
    with pytest.raises(RuntimeError, match="CUDA"):
        rk.resolve_device("cuda:0")
    m, rule = _crush_map()
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedRuleMapper(compile_map(m), rule, 3)
    with pytest.raises(RuntimeError, match="CUDA"):
        BatchedClusterMapper(OSDMap(crush=m))
    with pytest.raises(RuntimeError, match="CUDA"):
        UpmapBalancer(OSDMap(crush=m))
    with pytest.raises(RuntimeError, match="CUDA"):
        CrushTester(m)
    for plugin, profile in NEW_PLUGINS:
        with pytest.raises(RuntimeError, match="CUDA"):
            registry.factory(plugin, dict(profile))
    clay = registry.factory("clay", {"k": "4", "m": "2"}, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        ClayRepairProgram(clay, 0)
    with pytest.raises(RuntimeError, match="CUDA"):
        AnalyticsEngine(16, 16, 32)
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_service.EncodeService(device="cuda")
    encode_service.reset_shared()
    with pytest.raises(RuntimeError, match="CUDA"):
        encode_service.shared()


def test_cpu_is_only_by_request(no_cuda):
    assert rk.BitmatrixCodec(isa_cauchy_matrix(4, 2), device="cpu").device.type == "cpu"
    assert DecodeAggregator(device="cpu").device.type == "cpu"
    assert ScrubVerifier(device="cpu").device.type == "cpu"
    assert registry.factory("cuda", {}, device="cpu").device.type == "cpu"
    m, rule = _crush_map()
    assert BatchedRuleMapper(compile_map(m), rule, 3, device="cpu").device.type == "cpu"
    assert BatchedClusterMapper(OSDMap(crush=m), device="cpu").device.type == "cpu"
    for plugin, profile in NEW_PLUGINS:
        assert registry.factory(plugin, dict(profile), device="cpu").device.type == "cpu"
    clay = registry.factory("clay", {"k": "4", "m": "2"}, device="cpu")
    assert ClayRepairProgram(clay, 0, device="cpu").device.type == "cpu"
    assert AnalyticsEngine(16, 16, 32, device="cpu").device.type == "cpu"
    assert AnalyticsEngine(16, 16, 32, backend="numpy").device is None
    encode_service.reset_shared()
    assert encode_service.shared(device="cpu").device.type == "cpu"
    encode_service.reset_shared()


def test_version():
    assert ceph_tpu_torch.__version__ == "0.1.0"
    # the plugin handshake checks its version against the package's
    from ceph_tpu_torch.ec.plugins import clay, cuda, isa, jerasure, lrc, shec

    for plugin in (clay, cuda, isa, jerasure, lrc, shec):
        assert plugin.__erasure_code_version__ == ceph_tpu_torch.__version__

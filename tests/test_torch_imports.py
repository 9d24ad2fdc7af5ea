"""Import gate of the port.

``ceph_tpu_torch`` and ``chip_smoke.py`` import neither ``jax`` nor the
JAX package ``ceph_tpu``: a subprocess blocks both in ``sys.modules``,
with ``cryptography`` (absent where the card is), and imports every
module; a static scan finds no such import in any
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
                 "store.filestore", "store.bluefs", "store.blockstore",
                 "msg.frames", "msg.auth", "msg.messenger", "msg.messages", "cls",
                 "cls.rgw", "osd.snaps", "osd.pglog", "osd.pgutil", "osd.scheduler",
                 "osd.opqueue", "osd.mapenc", "common.logclient", "mgr.client",
                 "mgr.modules", "mgr.tracer", "osd.ec_backend", "osd.recovery",
                 "osd.scrubber", "osd.tiering", "osd.daemon", "mon", "mon.store",
                 "mon.paxos", "mon.auth_service", "mon.config_service",
                 "mon.log_service", "mon.mgr_service", "mon.stats_service",
                 "mon.osd_service", "mon.commands", "mon.monitor", "client",
                 "client.striper", "client.objecter", "client.rados",
                 "crush.compiler", "mgr.dashboard", "rbd", "rbd.objectmap",
                 "rbd.journal", "rbd.mirror", "rgw", "rgw.sigv4", "rgw.store",
                 "rgw.frontend", "fs", "fs.journal", "fs.mds", "fs.client",
                 "common.transfer_guard", "chaos", "chaos.schedule", "chaos.netem",
                 "chaos.workload", "chaos.invariants", "chaos.runner", "loadgen",
                 "loadgen.schedule", "loadgen.report", "loadgen.driver",
                 "tools.chaos_run", "tools.load_run", "fuzz", "fuzz.mutate",
                 "fuzz.coverage", "fuzz.corpus", "fuzz.minimize", "fuzz.runner",
                 "tools.chaos_fuzz", "tools.crushtool", "tools.osdmaptool", "tools.vstart",
                 "tools.ceph", "tools.cephadm", "analysis", "analysis.core",
                 "analysis.dataflow", "analysis.prewarm_registry", "analysis.rules",
                 "analysis.rules.common", "analysis.rules.locks", "analysis.rules.wire",
                 "analysis.rules.configrule", "analysis.rules.determinism",
                 "analysis.rules.device", "analysis.rules.transfer", "tools.lint"):
        assert f"ceph_tpu_torch.{name}" in mods
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "sys.modules['cryptography'] = None\n"
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


def test_lint_imports_and_runs_with_torch_blocked(tmp_path):
    """ctlint over the port (``ceph_tpu_torch/analysis/``, 12 modules, and
    ``python -m ceph_tpu_torch.tools.lint``) is plain ``ast``: with torch,
    JAX and the JAX package blocked, every module imports and the lint
    runs (its catalog, and a finding over a one-module tree), so a lint
    run costs no CUDA context."""
    analysis = [m for m in _modules() if m.startswith("ceph_tpu_torch.analysis")]
    assert len(analysis) == 12, analysis
    sched = tmp_path / "ceph_tpu_torch" / "chaos" / "schedule.py"
    sched.parent.mkdir(parents=True)
    sched.write_text("import random\n\n\ndef pick():\n    return random.random()\n")
    code = (
        "import sys, importlib\n"
        "for name in ('torch', 'jax', 'ceph_tpu'):\n"
        "    sys.modules[name] = None\n"
        f"for name in {analysis!r}:\n"
        "    importlib.import_module(name)\n"
        "from ceph_tpu_torch.tools import lint\n"
        "assert lint.main(['--catalog']) == 0\n"
        f"assert lint.main(['--root', {str(tmp_path)!r}, '--no-baseline']) == 1\n"
        "assert not any(m == 'torch' or m.startswith(('torch.', 'jax', 'ceph_tpu.'))\n"
        "               for m in sys.modules if sys.modules[m] is not None)\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "det-random" in res.stdout
    assert res.stdout.strip().endswith("ok")


_JAX = re.compile(r"^\s*(import\s+jax\b|from\s+jax\b)", re.M)
_REF = re.compile(r"\bceph_tpu(\.|\s|$)", re.M)


def test_foundation_loads_without_messages():
    """The host foundation (common/, kv/, store/, msg.denc) stands on its
    own: ``ceph_tpu_torch.common`` exports the reference's names, the
    cluster log's ``LogClient`` and ``format_entry`` included, and no
    ``msg.messages`` module is needed to load it (a ``LogClient`` imports
    ``MLog`` when it first sends)."""
    assert set(ceph_tpu_torch.common.__all__) == {
        "AdminSocket", "DoutLogger", "LogClient", "OPTIONS", "OpTracker", "TrackedOp",
        "admin_command", "ConfigProxy", "MetricsServer", "Option", "PerfCounters",
        "all_collections", "declare", "get_perf_counters", "prometheus_text",
        "record_crash", "scan_crashes", "format_entry"}
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


def test_auth_imports_without_cryptography():
    """On a machine without the ``cryptography`` wheel (the card's) the
    transport still imports and crc-mode messengers need nothing of it,
    but sealing, tickets and secure frames raise ``RuntimeError`` at use:
    there is no authenticate-only fallback."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "sys.modules['cryptography'] = None\n"
        "import ceph_tpu_torch.msg, ceph_tpu_torch.msg.messages\n"
        "from ceph_tpu_torch.msg import auth\n"
        "assert auth.HAVE_AESGCM is False\n"
        "for call in (lambda: auth.seal(auth.make_secret(), b'x'),\n"
        "             lambda: auth.unseal(auth.make_secret(), bytes(40)),\n"
        "             lambda: auth.mint_ticket(auth.make_secret(), 'osd.1', b'k'),\n"
        "             lambda: auth.FrameCrypto.from_session(\n"
        "                 auth.make_secret(), bytes(12), bytes(12), connector=True)):\n"
        "    try:\n"
        "        call()\n"
        "    except RuntimeError as e:\n"
        "        assert 'cryptography' in str(e)\n"
        "    else:\n"
        "        raise AssertionError('sealed without AES-GCM')\n"
        "assert not any(m.startswith('cryptography') for m in sys.modules\n"
        "               if sys.modules[m] is not None)\n"
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


def test_daemons_take_the_card_unless_asked(no_cuda):
    from ceph_tpu_torch.mgr.daemon import MgrDaemon
    from ceph_tpu_torch.mon import Monitor
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    with pytest.raises(RuntimeError, match="CUDA"):
        Monitor()
    with pytest.raises(RuntimeError, match="CUDA"):
        OSDDaemon(0, ("127.0.0.1", 1))
    with pytest.raises(RuntimeError, match="CUDA"):
        MgrDaemon("x", ("127.0.0.1", 1))
    assert Monitor(device="cpu").device.type == "cpu"
    assert OSDDaemon(0, ("127.0.0.1", 1), device="cpu").device.type == "cpu"
    mgr = MgrDaemon("x", ("127.0.0.1", 1), device="cpu")
    assert mgr.device.type == "cpu" and mgr.engine.device.type == "cpu"


def test_chaos_and_load_harness_take_the_card_unless_asked(no_cuda):
    from ceph_tpu_torch.chaos.runner import SCENARIOS, ChaosCluster, run_sweep
    from ceph_tpu_torch.loadgen import resolve_profile
    from ceph_tpu_torch.loadgen.driver import LoadHarness
    from ceph_tpu_torch.tools import chaos_run, load_run

    with pytest.raises(RuntimeError, match="CUDA"):
        ChaosCluster(SCENARIOS["netem_storm"])
    with pytest.raises(RuntimeError, match="CUDA"):
        LoadHarness(resolve_profile("rados_rw"), 1)
    with pytest.raises(RuntimeError, match="CUDA"):
        chaos_run.main(["--scenarios", "netem_storm", "--seed", "0"])
    with pytest.raises(RuntimeError, match="CUDA"):
        load_run.main(["--profile", "rados_rw"])
    # a sweep records a run that could not boot as a crash, not a pass
    art = run_sweep(["netem_storm"], [0])
    assert art["summary"]["green"] == 0
    assert "CUDA" in art["runs"][0]["crash"]
    assert ChaosCluster(SCENARIOS["netem_storm"], device="cpu").device.type == "cpu"
    assert LoadHarness(resolve_profile("rados_rw"), 1, device="cpu").device.type == "cpu"


def test_operator_clis_take_the_card_unless_asked(no_cuda, tmp_path):
    """The fuzz campaign, ``chaos_fuzz``, ``crushtool --test``, ``osdmaptool
    --test-map-pgs``, ``vstart``, ``cephadm bootstrap`` and ``bench_all``'s
    ``recovery`` raise without a card unless asked for the CPU."""
    from ceph_tpu_torch.fuzz.runner import run_campaign
    from ceph_tpu_torch.tools import (bench_all, cephadm, chaos_fuzz, crushtool, osdmaptool,
                                      vstart)

    crush_txt, osdmap_bin = str(tmp_path / "crush.txt"), str(tmp_path / "osdmap.bin")
    assert crushtool.main(["--build", "8", "-o", crush_txt]) == 0
    assert osdmaptool.main(["--createsimple", "8", "--pg-num", "16", "-o", osdmap_bin]) == 0
    for call in (lambda: run_campaign(budget=0, scenario_names=["netem_storm"]),
                 lambda: chaos_fuzz.main(["--scenarios", "netem_storm", "--budget", "0"]),
                 lambda: crushtool.main(["--test", "-i", crush_txt]),
                 lambda: osdmaptool.main([osdmap_bin, "--test-map-pgs"]),
                 lambda: vstart.main(["--osds", "1", "--mgrs", "0"]),
                 lambda: cephadm.main(["bootstrap", "--data", str(tmp_path / "c")]),
                 lambda: bench_all.main(["recovery"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()
    assert not os.path.exists(tmp_path / "c")
    assert crushtool.main(["--test", "-i", crush_txt, "--device", "cpu", "--max-x", "15"]) == 0
    assert osdmaptool.main([osdmap_bin, "--test-map-pgs", "--device", "cpu"]) == 0


#: the processes the operator tools start, as they start them: a cephadm
#: daemon, a recovery-config worker, a vstart cluster, a fuzz campaign
SUBPROCESS_ENTRY_POINTS = (
    ("ceph_tpu_torch.tools.cephadm", ["_daemon", "osd", "--data", "{tmp}", "--mon-ports",
                                      "1", "--device", "cuda"]),
    ("ceph_tpu_torch.tools.bench_all", ["_osd_group", "127.0.0.1", "1", "{tmp}", "0", "cuda"]),
    ("ceph_tpu_torch.tools.vstart", ["--osds", "1", "--mgrs", "0"]),
    ("ceph_tpu_torch.tools.chaos_fuzz", ["--scenarios", "netem_storm", "--budget", "0"]),
)


@pytest.mark.parametrize("module,argv", SUBPROCESS_ENTRY_POINTS,
                         ids=[m.rsplit(".", 1)[1] for m, _ in SUBPROCESS_ENTRY_POINTS])
def test_subprocess_entry_points_import_alone_and_raise_without_a_card(module, argv, tmp_path):
    """Each entry point the operator tools start as a process of its own,
    run as ``python -m`` with ``jax`` and ``ceph_tpu`` blocked and no card:
    it imports nothing of either and stops on the missing card (a
    RuntimeError naming CUDA), never running on the host instead."""
    argv = [a.replace("{tmp}", str(tmp_path)) for a in argv]
    code = (
        "import runpy, sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "import torch\n"
        "torch.cuda.is_available = lambda: False\n"
        f"sys.argv = [{module!r}] + {argv!r}\n"
        f"runpy.run_module({module!r}, run_name='__main__', alter_sys=True)\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode != 0
    assert "RuntimeError" in res.stderr and "CUDA" in res.stderr, res.stderr[-2000:]
    assert "ImportError" not in res.stderr and "ModuleNotFoundError" not in res.stderr


def test_client_import_builds_nothing():
    """``import ceph_tpu_torch.client`` loads the OSD daemon module (the
    client maps objects with its ``object_to_pg``): no kernel is built
    and no device is touched at import."""
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['ceph_tpu'] = None\n"
        "import torch\n"
        "import ceph_tpu_torch.client, ceph_tpu_torch.mon\n"
        "from ceph_tpu_torch.ops import _build\n"
        "assert 'ceph_tpu_torch.osd.daemon' in sys.modules\n"
        "assert _build._libs == {}\n"
        "assert not torch.cuda.is_initialized()\n"
        "print('ok')\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    res = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip().endswith("ok")

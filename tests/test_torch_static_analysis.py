"""ctlint over the port: the tier-1 gate, the torch fixtures, parity.

The twin of ``tests/test_static_analysis.py`` for
``ceph_tpu_torch/analysis/``, in four layers:

1. fixture tests — each device/transfer/lock-interproc fixture of the
   JAX package has a torch twin (``tests/torch_analysis_fixtures/``)
   that mirrors it case for case: the twin fires exactly the rule ids
   its mirror fires under the reference's analyzer, and its ``*_ok``
   twin is silent;
2. parity — the framework-free families (``lock-*``, ``wire-*``,
   ``config-*``, ``det-*``) give the reference's findings: over the
   reference's own fixtures under matching synthetic paths, and over a
   copy of ``ceph_tpu/`` renamed to ``ceph_tpu_torch`` (same evidence
   set), after the same renaming of paths and messages;
3. live-tree gate — the port's tree has ZERO unbaselined findings, no
   stale or dead baseline entries, and every entry is justified (read
   from ``chip_smoke.py``'s phase 19 run on the CPU, which runs
   ``python -m ceph_tpu_torch.tools.lint --json`` once, with torch
   blocked); the prewarm registry covers every loader, and the
   ``chaos_run --lint`` preflight aborts on a dirty tree;
4. determinism regression — the CHAOS_r11 trace hashes re-derive
   through the port's schedule, which stays free of det-* findings.
"""

from __future__ import annotations

import json
import re
import shutil
from pathlib import Path

import pytest

import chip_smoke
from ceph_tpu.analysis.core import Project as RefProject
from ceph_tpu.analysis.core import SourceFile as RefSourceFile
from ceph_tpu.analysis.core import run_analysis as ref_run_analysis
from ceph_tpu.analysis.rules import RULE_CATALOG as REF_CATALOG
from ceph_tpu.analysis.rules.configrule import ConfigRegistryRule as RefConfigRule
from ceph_tpu.analysis.rules.determinism import DeterminismRule as RefDeterminismRule
from ceph_tpu.analysis.rules.device import DeviceDisciplineRule as RefDeviceRule
from ceph_tpu.analysis.rules.locks import LockOrderRule as RefLockRule
from ceph_tpu.analysis.rules.transfer import TransferRule as RefTransferRule
from ceph_tpu.analysis.rules.wire import WireProtocolRule as RefWireRule
from ceph_tpu_torch.analysis.core import (
    Project,
    SourceFile,
    baseline_integrity,
    load_baseline,
    run_analysis,
)
from ceph_tpu_torch.analysis.dataflow import CallGraph
from ceph_tpu_torch.analysis.rules import ALL_RULES, RULE_CATALOG
from ceph_tpu_torch.analysis.rules.configrule import ConfigRegistryRule
from ceph_tpu_torch.analysis.rules.determinism import DeterminismRule
from ceph_tpu_torch.analysis.rules.device import DeviceDisciplineRule, prewarm_findings
from ceph_tpu_torch.analysis.rules.locks import LockOrderRule
from ceph_tpu_torch.analysis.rules.transfer import TransferRule
from ceph_tpu_torch.analysis.rules.wire import WireProtocolRule

REPO = Path(__file__).resolve().parent.parent
FIXTURES = Path(__file__).parent / "torch_analysis_fixtures"
REF_FIXTURES = Path(__file__).parent / "analysis_fixtures"
BASELINE = REPO / "ctlint_torch_baseline.json"


def rename(text: str) -> str:
    """The JAX package's names as the port spells them."""
    return re.sub(r"\bceph_tpu\b", "ceph_tpu_torch", text)


def fixture_project(name: str, fake_path: str, folder: Path = FIXTURES) -> Project:
    """Parse one fixture under a synthetic repo path (so path-scoped
    rules — I/O-path roots, pure-trace — see it in scope)."""
    sf = SourceFile(fake_path, (folder / name).read_text())
    return Project(root=REPO, files=[sf], aux_files=[])


def ref_fixture_project(name: str, fake_path: str) -> RefProject:
    sf = RefSourceFile(fake_path, (REF_FIXTURES / name).read_text())
    return RefProject(root=REPO, files=[sf], aux_files=[])


def rule_ids(project: Project, rule) -> list[str]:
    return [f.rule for f in run_analysis(REPO, rules=[rule], project=project)]


def ref_rule_ids(project: RefProject, rule) -> list[str]:
    return [f.rule for f in ref_run_analysis(REPO, rules=[rule], project=project)]


def mirrored(name: str, path: str, port_rule, ref_rule,
             folder: Path = FIXTURES) -> tuple[list[str], list[str]]:
    """(the torch twin's rule ids, its mirror's under the reference's
    analyzer), each sorted, the twin under the port's spelling of
    ``path``.  A framework-free family's twin is the reference's own
    fixture (``folder=REF_FIXTURES``)."""
    port = rule_ids(fixture_project(name, rename(path), folder=folder), port_rule)
    ref = ref_rule_ids(ref_fixture_project(name, path), ref_rule)
    return sorted(port), sorted(ref)


@pytest.fixture(scope="module")
def live_project() -> Project:
    return Project.load(REPO)


@pytest.fixture(scope="module")
def graph(live_project) -> CallGraph:
    return CallGraph(live_project)


@pytest.fixture(scope="module")
def lint_phase() -> dict:
    """chip_smoke.py's phase 19 on the CPU: every launch count 0 (the
    wrappers run their plain versions here), so the registry check
    holds no kernel; the lint itself runs once, over the whole tree."""
    return chip_smoke.run_lint_path({name: 0 for name in chip_smoke.entry_point_ids()})


# -- 1. fixtures --------------------------------------------------------------


class TestDeviceRule:
    def test_bad_fixture_fires_all_three(self):
        port, ref = mirrored("device_bad.py", "ceph_tpu/osd/_fixture_device.py",
                             DeviceDisciplineRule(), RefDeviceRule())
        assert set(port) == {
            "device-prewarm", "device-raw-shape", "device-sync-under-lock",
        }
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("device_ok.py", "ceph_tpu_torch/osd/_fixture_device.py")
        assert rule_ids(proj, DeviceDisciplineRule()) == []

    def test_registry_removal_fires(self, live_project, monkeypatch):
        """The live tree passes ONLY because every reachable loader is
        declared: removing one registry entry must fire."""
        from ceph_tpu_torch.analysis import prewarm_registry

        assert prewarm_findings(live_project) == []
        monkeypatch.delitem(prewarm_registry.PREWARMED,
                            "ceph_tpu_torch.ops.rs_kernels:_library_entry")
        findings = prewarm_findings(live_project)
        assert [f.rule for f in findings] == ["device-prewarm"]
        assert "rs_kernels:_library_entry" in findings[0].message
        assert findings[0].path == "ceph_tpu_torch/ops/rs_kernels.py"

    def test_io_path_fully_accounted(self, live_project):
        """Acceptance: every kernel loader reachable from parallel/, osd/
        and mgr/analytics.py is registered — the static twin of the
        runtime cold_launches == 0 gate."""
        from ceph_tpu_torch.analysis.prewarm_registry import PREWARMED
        from ceph_tpu_torch.analysis.rules.device import _io_path_roots, library_sites

        roots = _io_path_roots(live_project)
        reach = live_project.reachable_from(roots) | roots
        mods = live_project.by_module()
        sites = sorted(f"{mod}:{q}" for mod in reach for q, _ in library_sites(mods[mod]))
        assert "ceph_tpu_torch.ops.rs_kernels:_library_entry" in sites
        assert "ceph_tpu_torch.ops.hashing:_kernel" in sites
        missing = [s for s in sites if s not in PREWARMED]
        assert not missing, f"unregistered kernel loaders: {missing}"


class TestLockRule:
    def test_bad_fixture(self):
        port, ref = mirrored("lock_bad.py", "ceph_tpu/osd/_fixture.py",
                             LockOrderRule(), RefLockRule(), folder=REF_FIXTURES)
        assert "lock-cycle" in port
        assert "lock-blocking" in port
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("lock_ok.py", "ceph_tpu_torch/osd/_fixture.py",
                               folder=REF_FIXTURES)
        assert rule_ids(proj, LockOrderRule()) == []


class TestInterprocLockRules:
    """The lock rules see through the call graph — a helper that blocks
    (or waits for the card) two frames below the critical section is
    caught."""

    def test_blocking_two_frames_below_the_lock(self):
        proj = fixture_project("lock_interproc_bad.py", "ceph_tpu_torch/osd/_fixture_ip.py")
        fs = run_analysis(REPO, rules=[LockOrderRule()], project=proj)
        msgs = [f.message for f in fs if f.rule == "lock-blocking"]
        assert any("via the call graph" in m and "flush()" in m and "refresh()" in m
                   for m in msgs), msgs
        port, ref = mirrored("lock_interproc_bad.py", "ceph_tpu/osd/_fixture_ip.py",
                             LockOrderRule(), RefLockRule())
        assert port == ref

    def test_sync_two_frames_below_the_lock(self):
        proj = fixture_project("lock_interproc_bad.py", "ceph_tpu_torch/osd/_fixture_ip.py")
        fs = run_analysis(REPO, rules=[DeviceDisciplineRule()], project=proj)
        msgs = [f.message for f in fs if f.rule == "device-sync-under-lock"]
        assert any("via the call graph" in m and "finish()" in m and "synchronize" in m
                   for m in msgs), msgs
        port, ref = mirrored("lock_interproc_bad.py", "ceph_tpu/osd/_fixture_ip.py",
                             DeviceDisciplineRule(), RefDeviceRule())
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("lock_interproc_ok.py", "ceph_tpu_torch/osd/_fixture_ip.py")
        assert rule_ids(proj, LockOrderRule()) == []
        assert "device-sync-under-lock" not in rule_ids(proj, DeviceDisciplineRule())


class TestTransferRule:
    def test_bad_fixture_fires_all_four(self):
        port, ref = mirrored("transfer_bad.py", "ceph_tpu/parallel/_fixture_transfer.py",
                             TransferRule(), RefTransferRule())
        assert set(port) == {
            "device-host-sink", "device-redundant-put",
            "device-nondonated-inout", "device-implicit-sync",
        }, port
        assert port == ref

    def test_interprocedural_sink_two_calls_away(self):
        """A .cpu() inside a helper fires at the device-valued call site
        two frames above."""
        proj = fixture_project("transfer_bad.py", "ceph_tpu_torch/parallel/_fixture_transfer.py")
        fs = run_analysis(REPO, rules=[TransferRule()], project=proj)
        assert any(f.rule == "device-host-sink" and "_persist()" in f.message
                   and ".cpu()" in f.message for f in fs), [f.message for f in fs]

    def test_ok_fixture_silent(self):
        proj = fixture_project("transfer_ok.py", "ceph_tpu_torch/parallel/_fixture_transfer.py")
        assert rule_ids(proj, TransferRule()) == []

    def test_host_sink_scoped_to_io_path(self):
        """The same violations OUTSIDE the I/O-path module set: the local
        rules still fire but host-sink (an I/O-path budget rule) stays
        quiet — as the mirror does."""
        port, ref = mirrored("transfer_bad.py", "ceph_tpu/client/_fixture_transfer.py",
                             TransferRule(), RefTransferRule())
        assert "device-host-sink" not in port
        assert "device-implicit-sync" in port
        assert "device-redundant-put" in port
        assert port == ref

    def test_donated_entries_point_at_live_wrappers(self, graph):
        """Every DONATED key names a kernel wrapper that still exists,
        and its declared positions are parameters of it."""
        from ceph_tpu_torch.analysis.prewarm_registry import DONATED, JIT_ENTRYPOINTS

        assert DONATED
        for key, positions in DONATED.items():
            fn = graph.functions.get(key)
            assert fn is not None, key
            assert fn.name in JIT_ENTRYPOINTS, key
            assert all(0 <= ix < len(fn.params) for ix in positions), key
            assert fn.params[positions[0]] == "carry", key


class TestDataflowEngine:
    """Unit coverage of the interprocedural engine on tiny synthetic
    projects (cross-module call resolution + summary propagation)."""

    def _proj(self, **mods):
        files = [SourceFile(f"ceph_tpu_torch/{name.replace('__', '/')}.py", text)
                 for name, text in mods.items()]
        return Project(root=REPO, files=files, aux_files=[])

    def test_cross_module_blocking_summary(self):
        from ceph_tpu_torch.analysis.dataflow import DataflowEngine

        proj = self._proj(
            x__a="import time\n\ndef slow():\n    time.sleep(1)\n",
            x__b=("from ceph_tpu_torch.x.a import slow\n\n"
                  "def outer():\n    slow()\n"),
        )
        eng = DataflowEngine(proj)
        hit = eng.may_block("ceph_tpu_torch.x.b:outer")
        assert hit is not None
        reason, chain = hit
        assert reason == "sleeps" and "slow" in chain

    def test_device_summary_through_wrappers(self):
        from ceph_tpu_torch.analysis.dataflow import DataflowEngine

        proj = self._proj(
            x__c=("import torch\n"
                  "from ceph_tpu_torch.ops import _build\n"
                  "from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul\n\n"
                  "def wrap(b, y, dev):\n"
                  "    return gf_bitmatmul(b, torch.as_tensor(y, device=dev))\n\n"
                  "def fact():\n"
                  "    return _build.library('x').ceph_x\n\n"
                  "def use(z):\n    return fact()(z)\n\n"
                  "def up(y):\n    return y.to('cuda')\n\n"
                  "def down(y):\n    return up(y).cpu()\n"),
        )
        eng = DataflowEngine(proj)
        assert eng.summaries["ceph_tpu_torch.x.c:wrap"].returns_device
        assert eng.summaries["ceph_tpu_torch.x.c:fact"].returns_device_fn
        assert "ceph_tpu_torch.x.c:fact" in eng.graph.loader_defs
        # a kernel handle returns its cudaError status, not a tensor
        assert not eng.summaries["ceph_tpu_torch.x.c:use"].returns_device
        assert eng.summaries["ceph_tpu_torch.x.c:up"].returns_device
        assert not eng.summaries["ceph_tpu_torch.x.c:down"].returns_device
        assert eng.may_sync("ceph_tpu_torch.x.c:down") == ("cpu", ("cpu",))

    def test_method_resolution_and_passthrough(self):
        from ceph_tpu_torch.analysis.dataflow import DataflowEngine

        proj = self._proj(
            x__d=("import torch\n\n"
                  "def ident(v):\n    return v\n\n"
                  "class Eng:\n"
                  "    def make(self):\n"
                  "        return torch.zeros(4, device='cuda')\n"
                  "    def host(self):\n"
                  "        return torch.zeros(4, device='cpu')\n"
                  "    def get(self):\n"
                  "        return ident(self.make())\n"),
        )
        eng = DataflowEngine(proj)
        assert 0 in eng.summaries["ceph_tpu_torch.x.d:ident"].passthrough
        assert eng.summaries["ceph_tpu_torch.x.d:Eng.get"].returns_device
        assert not eng.summaries["ceph_tpu_torch.x.d:Eng.host"].returns_device


class TestWireRule:
    def test_bad_fixture(self):
        port, ref = mirrored("wire_bad.py", "ceph_tpu/msg/_fixture.py",
                             WireProtocolRule(), RefWireRule(), folder=REF_FIXTURES)
        assert port.count("wire-frame-id") == 2  # dup TYPE + missing TYPE
        assert port.count("wire-asymmetry") == 1
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("wire_ok.py", "ceph_tpu_torch/msg/_fixture.py",
                               folder=REF_FIXTURES)
        assert rule_ids(proj, WireProtocolRule()) == []


class TestConfigRule:
    def test_bad_fixture(self):
        port, ref = mirrored("config_bad.py", "ceph_tpu/common/_fixture.py",
                             ConfigRegistryRule(), RefConfigRule(), folder=REF_FIXTURES)
        assert port == ["config-dead", "config-undeclared"]
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("config_ok.py", "ceph_tpu_torch/common/_fixture.py",
                               folder=REF_FIXTURES)
        assert rule_ids(proj, ConfigRegistryRule()) == []


class TestDeterminismRule:
    def test_bad_fixture(self):
        port, ref = mirrored("det_bad.py", "ceph_tpu/chaos/_fixture.py",
                             DeterminismRule(), RefDeterminismRule(), folder=REF_FIXTURES)
        assert set(port) == {"det-wallclock", "det-random", "det-set-iter"}
        assert port == ref

    def test_ok_fixture_silent(self):
        proj = fixture_project("det_ok.py", "ceph_tpu_torch/chaos/_fixture.py",
                               folder=REF_FIXTURES)
        assert rule_ids(proj, DeterminismRule()) == []

    def test_inline_suppression(self):
        text = (REF_FIXTURES / "det_bad.py").read_text().replace(
            "events.append((\"kill\", osd, time.time()))",
            "events.append((\"kill\", osd, time.time()))"
            "  # ctlint: disable=det-wallclock",
        )
        sf = SourceFile("ceph_tpu_torch/chaos/_fixture.py", text)
        proj = Project(root=REPO, files=[sf], aux_files=[])
        ids = rule_ids(proj, DeterminismRule())
        assert "det-wallclock" not in ids
        assert "det-set-iter" in ids  # other findings untouched

    def test_pure_trace_scope_is_the_ports(self):
        from ceph_tpu.analysis.rules.determinism import PURE_TRACE_PATHS as REF_PATHS
        from ceph_tpu_torch.analysis.rules.determinism import PURE_TRACE_PATHS

        assert list(PURE_TRACE_PATHS) == [rename(p) for p in REF_PATHS]
        assert all((REPO / p).is_file() for p in PURE_TRACE_PATHS)


# -- 2. parity of the framework-free families -----------------------------------

FRAMEWORK_FREE = [
    (LockOrderRule, RefLockRule), (WireProtocolRule, RefWireRule),
    (ConfigRegistryRule, RefConfigRule), (DeterminismRule, RefDeterminismRule),
]


def _keyed(findings, ren=lambda s: s) -> list[tuple]:
    return [(f.rule, ren(f.path), f.line, ren(f.message)) for f in findings]


@pytest.mark.parametrize("name, path", [
    ("lock_bad.py", "ceph_tpu/osd/_fixture.py"),
    ("lock_ok.py", "ceph_tpu/osd/_fixture.py"),
    ("lock_interproc_bad.py", "ceph_tpu/osd/_fixture_ip.py"),
    ("lock_interproc_ok.py", "ceph_tpu/osd/_fixture_ip.py"),
    ("wire_bad.py", "ceph_tpu/msg/_fixture.py"),
    ("wire_ok.py", "ceph_tpu/msg/_fixture.py"),
    ("config_bad.py", "ceph_tpu/common/_fixture.py"),
    ("config_ok.py", "ceph_tpu/common/_fixture.py"),
    ("det_bad.py", "ceph_tpu/chaos/_fixture.py"),
    ("det_ok.py", "ceph_tpu/chaos/_fixture.py"),
])
def test_reference_fixture_parity(name, path):
    """Both analyzers over the reference's own fixture, the port's under
    the renamed path: the same findings, line for line, message for
    message (after the renaming)."""
    ref = ref_run_analysis(REPO, rules=[r() for _, r in FRAMEWORK_FREE],
                           project=ref_fixture_project(name, path))
    port = run_analysis(REPO, rules=[p() for p, _ in FRAMEWORK_FREE],
                        project=fixture_project(name, rename(path), folder=REF_FIXTURES))
    assert _keyed(port) == _keyed(ref, rename)


def test_renamed_reference_tree_parity(tmp_path):
    """The port's analyzer over a copy of ceph_tpu/ renamed to
    ceph_tpu_torch (every \\bceph_tpu\\b rewritten, line numbers kept),
    with the reference's own evidence set: exactly the reference's
    lock-*, wire-*, config-* and det-* findings over ceph_tpu/, its 14
    lock-blocking findings among them."""
    for src in sorted((REPO / "ceph_tpu").rglob("*.py")):
        if "__pycache__" in src.parts:
            continue
        dst = tmp_path / "ceph_tpu_torch" / src.relative_to(REPO / "ceph_tpu")
        dst.parent.mkdir(parents=True, exist_ok=True)
        dst.write_text(rename(src.read_text()))
    ref_proj = RefProject.load(REPO)
    ref = ref_run_analysis(REPO, rules=[r() for _, r in FRAMEWORK_FREE], project=ref_proj)
    port_proj = Project.load(tmp_path, include=("ceph_tpu_torch",), aux=())
    assert len(port_proj.files) == len(ref_proj.files)
    port_proj.aux_files = [SourceFile(sf.path, sf.text) for sf in ref_proj.aux_files]
    port = run_analysis(tmp_path, rules=[p() for p, _ in FRAMEWORK_FREE], project=port_proj)
    assert _keyed(port) == _keyed(ref, rename)
    assert sum(f.rule == "lock-blocking" for f in port) == 14


# -- 3. the live tree -----------------------------------------------------------


class TestLiveTree:
    def test_zero_unbaselined_findings(self, lint_phase):
        """The tier-1 ctlint gate: new findings fail the build."""
        report = lint_phase["report"]
        assert report["new"] == [], "unbaselined ctlint findings:\n" + "\n".join(
            f"{f['file']}:{f['line']}: [{f['rule']}] {f['message']}" for f in report["new"])
        assert report["stale_baseline"] == [], (
            "stale baseline entries (run python -m ceph_tpu_torch.tools.lint "
            "--update-baseline): %r" % (report["stale_baseline"],))

    def test_baseline_entries_justified(self):
        data = json.loads(BASELINE.read_text())
        assert data["findings"]
        bad = [e for e in data["findings"]
               if not e.get("justification") or "TODO" in e["justification"]]
        assert not bad, f"baseline entries without justification: {bad}"

    def test_baseline_integrity(self, live_project, lint_phase):
        """No dead grandfather entries: every baselined (rule, file) pair
        still exists in the catalog and the tree."""
        rot = baseline_integrity(load_baseline(BASELINE), live_project, set(RULE_CATALOG))
        assert rot == [], rot
        assert lint_phase["report"]["baseline_rot"] == []

    def test_catalog_covers_every_rule(self):
        for cls in ALL_RULES:
            for rid in cls.rules:
                assert rid in RULE_CATALOG
        assert sorted(RULE_CATALOG) == sorted(REF_CATALOG)
        assert len(RULE_CATALOG) == 16

    def test_cli_json_mode(self, lint_phase):
        """``python -m ceph_tpu_torch.tools.lint --json`` exits 0 on the
        committed tree (phase 19 raises otherwise), with torch blocked."""
        payload = lint_phase["report"]
        assert payload["new"] == []
        assert payload["stale_baseline"] == []
        assert payload["summary"]["files"] == lint_phase["lint"]["files"] > 100
        assert sorted(payload["catalog"]) == sorted(RULE_CATALOG)

    def test_planted_cpu_under_the_warm_lock_fires(self, tmp_path):
        """A .cpu() planted under decode_batcher's _warm_lock in a copied
        tree fires device-sync-under-lock (the live tree has none)."""
        shutil.copytree(REPO / "ceph_tpu_torch", tmp_path / "ceph_tpu_torch",
                        ignore=shutil.ignore_patterns("__pycache__", "_build", "*.so"))
        path = tmp_path / "ceph_tpu_torch" / "parallel" / "decode_batcher.py"
        text = path.read_text()
        anchor = ("                    cold = shape_key not in self._warm\n"
                  "                    self._warm.add(shape_key)\n")
        assert text.count(anchor) == 1
        path.write_text(text.replace(anchor, anchor + "                    bits.cpu()\n"))
        proj = Project.load(tmp_path, include=("ceph_tpu_torch",), aux=())
        fs = [f for f in DeviceDisciplineRule().run(proj)
              if f.rule == "device-sync-under-lock"
              and f.path == "ceph_tpu_torch/parallel/decode_batcher.py"]
        assert len(fs) == 1 and "cpu()" in fs[0].message, fs
        assert "DecodeAggregator._run_group" in fs[0].message

    def test_counts_by_rule_match_the_baseline(self, lint_phase):
        by_rule: dict[str, int] = {}
        for e in json.loads(BASELINE.read_text())["findings"]:
            by_rule[e["rule"]] = by_rule.get(e["rule"], 0) + 1
        assert lint_phase["lint"]["findings_by_rule"] == by_rule


class TestLintPhase:
    """chip_smoke.py's phase 19 on the CPU."""

    def test_phase_on_cpu_with_no_launches(self, lint_phase):
        line = lint_phase["lint"]
        assert line["phase"] == "lint"
        assert line["launched"] == {} and line["loaders"] == {}
        assert line["findings"] == line["baselined"] == sum(line["findings_by_rule"].values())
        assert line["lint_seconds"] > 0

    def test_every_launched_kernel_reaches_a_prewarmed_loader(self, graph):
        launched = {name: 1 for name in chip_smoke.entry_point_ids()}
        launched["gf_stage_cut:load"] = 1
        loaders = chip_smoke.check_prewarmed(launched, graph)
        assert set(loaders) == set(launched)
        assert loaders["gf_bitmatmul"] == ["ceph_tpu_torch.ops.rs_kernels:_library_entry"]
        assert loaders["gf_fold"] == ["ceph_tpu_torch.ops.rs_kernels:_fold_kernel"]
        assert loaders["crush_rule"] == ["ceph_tpu_torch.crush.cudamapper:_kernel"]
        assert loaders["mgr_analytics"] == ["ceph_tpu_torch.ops.analytics_kernels:_kernel"]

    def test_registry_check_fails_loudly(self, graph, monkeypatch):
        from ceph_tpu_torch.analysis import prewarm_registry

        monkeypatch.delitem(prewarm_registry.PREWARMED, "ceph_tpu_torch.ops.hashing:_kernel")
        with pytest.raises(AssertionError, match="hashing:_kernel"):
            chip_smoke.check_prewarmed({"batched_crc32c_device": 3}, graph)
        # a kernel not launched is not held to the registry
        assert chip_smoke.check_prewarmed({"batched_crc32c_device": 0}, graph) == {}
        with pytest.raises(AssertionError, match="not a kernel entry point"):
            chip_smoke.check_prewarmed({"no_such_kernel": 1}, graph)

    def test_lint_failure_fails_the_phase(self, tmp_path, monkeypatch):
        _tiny_tree(tmp_path, dirty=True)
        monkeypatch.setenv("PYTHONPATH", str(REPO))
        with pytest.raises(AssertionError, match="the lint exited 1"):
            chip_smoke.run_lint(str(tmp_path))


def _tiny_tree(root: Path, *, dirty: bool) -> None:
    """A one-module tree whose pure-trace schedule reads the wall clock
    (dirty) or does not; it has no baseline."""
    sched = root / "ceph_tpu_torch" / "chaos" / "schedule.py"
    sched.parent.mkdir(parents=True, exist_ok=True)
    sched.write_text("import time\n\n\ndef stamp():\n    return time.time()\n" if dirty
                     else "def stamp():\n    return 0\n")


@pytest.mark.parametrize("dirty", [True, False])
def test_chaos_run_lint_preflight(tmp_path, monkeypatch, capfd, dirty):
    """chaos_run --lint runs the lint in a subprocess: a dirty tree aborts
    the sweep with the lint's exit code before anything runs, a clean one
    goes on (here: to the trace-only replay)."""
    import sys

    from ceph_tpu_torch.tools import chaos_run

    _tiny_tree(tmp_path, dirty=dirty)
    monkeypatch.setattr(chaos_run, "LINT_COMMAND", [
        sys.executable, "-m", "ceph_tpu_torch.tools.lint", "--root", str(tmp_path),
        "--baseline", str(tmp_path / "ctlint_torch_baseline.json")])
    rc = chaos_run.main(["--lint", "--trace-only", "--scenarios", "osd_thrash", "--seed", "0"])
    out = capfd.readouterr()
    if dirty:
        assert rc == 1
        assert "ctlint preflight failed (exit 1)" in out.err
        assert "det-wallclock" in out.out and "osd_thrash" not in out.out
    else:
        assert rc == 0
        assert "ctlint clean" in out.out and "osd_thrash" in out.out


# -- 4. determinism regression ----------------------------------------------------


class TestChaosDeterminismRegression:
    """The static determinism rule tied to the committed chaos artifact:
    the CHAOS_r11 hashes re-derive through the port's schedule, and the
    schedule generator stays statically clean."""

    @pytest.fixture(scope="class")
    def artifact(self):
        return json.loads((REPO / "CHAOS_r11.json").read_text())

    def test_trace_hashes_rederive(self, artifact):
        from ceph_tpu_torch.chaos.runner import SCENARIOS
        from ceph_tpu_torch.chaos.schedule import generate_schedule, trace_hash

        checked = 0
        for run in artifact["runs"]:
            sc = SCENARIOS.get(run["scenario"])
            if sc is None:
                continue
            events = generate_schedule(run["seed"], sc)
            assert trace_hash(events) == run["trace_hash"], (run["scenario"], run["seed"])
            checked += 1
        assert checked >= 8, "artifact unexpectedly thin"

    def test_schedule_has_no_nondeterminism_findings(self, lint_phase):
        rel = "ceph_tpu_torch/chaos/schedule.py"
        assert [f for f in lint_phase["report"]["findings"] if f["file"] == rel] == []
        sf = SourceFile(rel, (REPO / rel).read_text())
        proj = Project(root=REPO, files=[sf], aux_files=[])
        assert rule_ids(proj, DeterminismRule()) == []

"""The whole slice — write, recover, degraded read — against ceph_tpu.

8 objects of 64 KiB and 2 of 96 KiB under RS(8,3) cauchy with a 4 KiB
stripe unit and ``device-min-bytes=0`` (so every matmul takes the device
seam), through the port on the CPU and through the JAX package: every
shard, crc and read-back byte must be equal (tolerance 0).  Then the
phases of chip_smoke.py run on the CPU at a tiny size, so its control
flow is exercised here before it meets the card.
"""

import asyncio
import os
import tempfile
from pathlib import Path

import numpy as np
import pytest

import chip_smoke
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu.parallel.decode_batcher import DecodeAggregator as RefAggregator
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from tests.xla_private import _private_xla_compiles  # noqa: F401

PROFILE = {"k": "8", "m": "3", "technique": "cauchy", "device-min-bytes": "0"}
STRIPE_UNIT = 4096
LOSSES = [(2,), (2, 9)]
DEGRADED = [(2,), (2, 9), (0, 5, 10)]


def _flow(ecutil_mod, ec, aggregator, objects):
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    sinfo = ecutil_mod.StripeInfo(k, k * ec.get_chunk_size(STRIPE_UNIT * k))
    written = []
    for obj in objects:
        shards = ecutil_mod.encode(sinfo, ec, obj)
        hinfo = ecutil_mod.HashInfo(n)
        hinfo.append(0, shards)
        written.append((shards, hinfo))

    rebuilt = {}
    for lost in LOSSES:
        async def go():
            return await asyncio.gather(*(
                ecutil_mod.decode_shards_async(
                    sinfo, ec, {s: c for s, c in sh.items() if s not in lost},
                    set(lost), aggregator=aggregator)
                for sh, _ in written))

        rebuilt[lost] = asyncio.run(go())

    reads = {
        missing: [
            ecutil_mod.decode_concat(
                sinfo, ec, {s: c for s, c in sh.items() if s not in missing})
            for sh, _ in written
        ]
        for missing in DEGRADED
    }
    return sinfo, written, rebuilt, reads


def test_slice_matches_reference():
    rng = np.random.default_rng(2026)
    objects = ([rng.integers(0, 256, 64 * 1024, dtype=np.uint8) for _ in range(8)]
               + [rng.integers(0, 256, 96 * 1024, dtype=np.uint8) for _ in range(2)])
    ec = registry.factory("cuda", dict(PROFILE), device="cpu")
    agg = DecodeAggregator(device="cpu", window_s=0.005)
    agg.prewarm(ec, erasure_counts=(1, 2))
    rk.reset_launch_counts()
    sinfo, written, rebuilt, reads = _flow(ecutil, ec, agg, objects)
    ref = ref_registry.factory("jax", dict(PROFILE))
    _, ref_written, ref_rebuilt, ref_reads = _flow(
        ref_ecutil, ref, RefAggregator(window_s=0.005), objects)

    assert sinfo.chunk_size == 4096 and sinfo.stripe_width == 32768
    for (sh, hi), (rsh, rhi) in zip(written, ref_written):
        assert set(sh) == set(rsh) == set(range(11))
        for s in sh:
            assert np.array_equal(sh[s], rsh[s])
        assert hi.to_bytes() == rhi.to_bytes()
    for lost in LOSSES:
        for (sh, hi), got, want in zip(written, rebuilt[lost], ref_rebuilt[lost]):
            assert set(got) == set(want) == set(lost)
            for s in lost:
                assert np.array_equal(got[s], want[s])
                assert np.array_equal(got[s], sh[s])
                assert chip_smoke.native.crc32c(got[s]) == hi.get_chunk_hash(s)
    for missing in DEGRADED:
        for obj, got, want in zip(objects, reads[missing], ref_reads[missing]):
            assert np.array_equal(got, want)
            assert np.array_equal(got, obj)
    # recovery went through the aggregator's batched launches, warm
    assert agg.stats["launches"] >= 2
    assert agg.stats["batched_requests"] == 10 * len(LOSSES)
    assert agg.stats["cold_launches"] == 0
    # on the CPU the entry points take the plain version: nothing launched
    assert set(rk.launch_counts().values()) == {0}


#: chip_smoke's CLAY and plugin sizes cut for the CPU: 64 KiB objects
#: (8 KiB CLAY(8,4,11) chunks, 128 B sub-chunks), a 32 KiB big chunk
TINY_CLAY = dict(clay_objects=3, clay_object_bytes=64 * 1024, clay_degraded_objects=2,
                 clay_big_chunk=32 * 1024, clay_big_repeats=2, clay_small_objects=1,
                 clay_traced_objects=1, plugin_object_bytes=64 * 1024)


def test_chip_smoke_phases_on_cpu():
    """chip_smoke's phases 1-6 at a tiny size on the CPU: the scrub phase
    verifies 6 objects in chunks of 4 (crc == HashInfo, the rebuilt
    shards included, no parity flagged, no cold launch) and flags two
    planted corruptions exactly as the host re-encode does; the remap
    phase maps 64 + 16 + 16 PGs of 12 hosts x 2 OSDs over three epochs,
    every row of the first and last equal to the scalar pipeline, with
    one map upload and no scalar pool."""
    cfg = chip_smoke.Config(
        object_bytes=64 * 1024, objects=4, small_object_bytes=32 * 1024,
        small_objects=2, kernel_cols=4096, oracle_cols=4096, batch_cols=512,
        wide_cols=512, plan_cols=(16, 4096 + 13), plan_batch_cols=(512,),
        crc_cols=(4096,), compare_cols=(512,), crc_lanes=8, scrub_chunk=4,
        scrub_corrupt=1, remap_hosts=12, remap_osds_per_host=2, remap_rep_pgs=64,
        remap_ec_pgs=16, remap_epochs=2, remap_sample=4, crush_seeds=(1, 8),
        balancer_swaps=4, **TINY_CLAY)
    worst = chip_smoke.phase_kernels(cfg, "cpu")
    assert worst == {name: 0 for name in chip_smoke.REPLACES}
    run = chip_smoke.run_main_path(cfg, "cpu")
    assert len(run["written"]) == 6
    scrub = run["scrub"]
    assert scrub["objects"] == 6 and scrub["cold_launches"] == 0
    assert scrub["rebuilt_shards"] == [2, 9]
    assert scrub["shard_bytes"] == 11 * (4 * 8192 + 2 * 4096)
    # 6 objects of 11 shards: 66 crc lanes in two chunks (4 + 2 objects)
    assert scrub["crc_launches"] == 6 + 3 and scrub["enc_launches"] == 1 + 1
    assert [c["parity_bad"] for c in scrub["corruption"]] == [[8, 9, 10], [8]]
    remapped = run["remap"]
    assert (remapped["pools"], remapped["pgs"], remapped["osds"]) == (3, 96, 24)
    assert remapped["counters"] == {"batched_pools": 9, "scalar_pools": 0, "map_uploads": 1}
    assert [e["rows_checked"] for e in remapped["epochs"]] == [96, 12, 96]
    assert all(e["rows_mismatched"] == 0 for e in remapped["epochs"])
    assert remapped["balancer"]["pg_spread_after"] <= remapped["balancer"]["pg_spread_before"]
    # each CRUSH entry point's main-path case, held against the scalar mapper
    cases = chip_smoke.crush_main_path(cfg, "cpu")
    assert sorted(cases) == sorted(chip_smoke.CRUSH_ENTRIES.values())
    assert all(draws > 0 for _, _, _, draws in cases.values())
    assert chip_smoke.crush_bound_ms(10 ** 6)[1] == "operations"
    assert chip_smoke.bound_ms(8, 3, 256 << 20, carry=True)[1] == "bytes"
    assert chip_smoke.crc_bound_ms(32, 65536)[1] == "bytes"


def test_chip_smoke_crush_lab_variant_source():
    """The lab's yardstick build differs from crush_rule.cu in the draw's
    division alone."""
    src = (Path(chip_smoke.__file__).parent / chip_smoke.CRUSH_SOURCE).read_text()
    variant = chip_smoke.crush_emulated_division_source()
    assert src.count(chip_smoke.CRUSH_DIV[0]) == 1 and chip_smoke.CRUSH_DIV[0] not in variant
    assert variant == src.replace(*chip_smoke.CRUSH_DIV)
    assert chip_smoke.CRUSH_SWEEP[0] == 4 * 132
    assert chip_smoke.main(["--crush-lab", "--bogus"]) == 2


def test_chip_smoke_refuses_without_cuda(monkeypatch, capsys):
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    assert chip_smoke.main() == 1
    assert capsys.readouterr().out == ""


def test_chip_smoke_busy_union():
    assert chip_smoke._busy_us([(0, 10), (5, 12), (20, 25), (21, 22)]) == 17
    assert chip_smoke._busy_us([]) == 0


def test_chip_smoke_plugin_phases_on_cpu():
    """chip_smoke's phases 8-9 at a tiny size on the CPU: all 19 plugin
    profiles match their golden bytes and decode; the CLAY pool rebuilds
    shards 3 and 9 both ways from 11 x 16 of 64 sub-chunks (11/32 of an
    RS(8,4) read), degraded-reads without shards 3 and 9, repairs the
    bench shape's stripe and the 4 KiB stripe unit's; on the CPU no
    kernel launches."""
    from ceph_tpu_torch.ec.plugins import clay_cuda

    cfg = chip_smoke.Config(**TINY_CLAY)
    rk.reset_launch_counts()
    clay_cuda.reset_launch_counts()
    run = chip_smoke.run_plugin_path(cfg, "cpu")
    plugins, clay = run["plugins"], run["clay"]
    assert plugins["profiles"] == 19
    assert all(r["decoded"] and r["gf_launches"] == 0 for r in plugins["rows"])
    assert [r["decoded"][0] for r in plugins["rows"]] == [[0]] * 19
    assert clay["chunk_size"] == 8192 and clay["sub_chunk"] == 128
    for r, lost in zip(clay["rounds"], chip_smoke.CLAY_LOST):
        assert r["lost"] == lost and r["objects"] == 3
        assert r["helper_bytes_read"] == 3 * 11 * 16 * 128
        assert r["read_share_of_rs"] == 11 * 16 / 64 / 8
        assert r["program"]["clay_repair_launches"] == 0
        assert r["bound_per_object"]["bound_by"] == "bytes"
    big = clay["bench_shape"]
    assert big["chunk_size"] == 32 * 1024 and big["H"] == [11, 16, 512]
    assert big["bound_by"] == "bytes" and big["bytes_ms"] > big["operations_ms"]
    assert clay["stripe_unit"]["chunk_size"] == 4096 and clay["stripe_unit"]["stripes"] == 2
    assert clay["stripe_unit"]["gf_launches"] == clay["stripe_unit"]["clay_repair_launches"] == 0
    assert set(rk.launch_counts().values()) == {0}
    assert clay_cuda.launch_counts() == {"clay_repair": 0}
    prog, bufs = chip_smoke.clay_main_path(cfg, "cpu")
    assert tuple(bufs[0].shape) == (11, 16, 128)
    b = chip_smoke.clay_bounds_ms(prog.schedule, 8192)
    assert b["bound_by"] == "bytes" and b["bound_ms"] == b["bytes_ms"]
    assert b["bytes_ms"] == (11 * 16 + 64) * 8192 / chip_smoke.PEAK_BYTES_PER_S * 1e3


#: chip_smoke's tools path cut for the CPU: the probes' kernels at 4 KiB
#: rows, the twins at KiB sizes with one repeat, bench_all on a 24-OSD map
TINY_TOOLS = dict(
    tools_cols=4096, fat_rows=64, fat_keep=24, fat_cols=4096, acc_cols=8192,
    tools_ragged_cols=4096 + 13, tools_calls=2,
    perf_lab_args=("--cols", "4096", "--tile", "1024", "--tiles", "1024,2048", "--fat-rows", "64",
                   "--fat-keep", "24", "--fat-cols", "4096", "--calls", "2", "--reps", "1"),
    perf_lab2_args=("--sizes", "4,8", "--unit", "1024", "--ns", "1,2", "--cols", "8192",
                    "--tile", "1024", "--groups", "1024:1,512:2", "--repeat-tiles", "1024,2048",
                    "--check-cols", "4096", "--calls", "2", "--reps", "1"),
    perf_lab3_args=("--check-cols", "4096", "--sizes", "4,8", "--unit", "1024", "--ns", "1,2",
                    "--reps", "1"),
    bench_args=("--cols", "8192", "--iters", "2", "--rounds", "1", "--check-cols", "4096"),
    ec_bench_size=65536, ec_bench_iterations=4,
    bench_all_sizes=(("jerasure_bytes", 256 * 1024), ("jerasure_calls", 2),
                     ("clay_chunk", 65536), ("batch_objects", 8), ("batch_object_bytes", 65536),
                     ("remap_hosts", 12), ("remap_osds_per_host", 2), ("remap_rep_pgs", 64),
                     ("remap_ec_pgs", 16), ("remap_check_stride", 7),
                     ("remap_scalar_sample", 8)))


def test_chip_smoke_tools_path_on_cpu():
    """chip_smoke's phase 10 at a tiny size on the CPU: every tools kernel
    case equals its plain version; the twins run through their ``main``
    functions and their lines parse: perf_lab's eight kinds of timed line,
    perf_lab2's ablation of all four stages and its repeat-variant checks
    (False against the encode, True against the folded product),
    perf_lab3's two checks, bench's JSON line, four ec_benchmark runs and
    bench_all's six configs; on the CPU no kernel launches."""
    from ceph_tpu_torch.ops import lab_kernels as lk

    cfg = chip_smoke.Config(**TINY_TOOLS)
    worst = chip_smoke.phase_kernel_tools(cfg, "cpu")
    assert worst == {name: 0 for name in chip_smoke.TOOL_ROWS}
    run = chip_smoke.run_tools_path(cfg, "cpu")
    tools = run["tools"]
    assert "fat copy (24x4096 r+w traffic GB/s)" in tools["perf_lab"]["timed"]
    assert len(tools["perf_lab"]["timed"]) == 9
    assert {f"ablate:{st}" for st in ("load", "extract", "matmul", "full")} <= set(
        tools["perf_lab2"]["timed"])
    assert tools["perf_lab2"]["checks"] == {"repeat variant bit-exact": False,
                                            "repeat variant equals the folded product": True}
    assert list(tools["perf_lab3"]["checks"].values()) == [True, True]
    assert len(tools["perf_lab3"]["timed"]) == 4
    assert tools["bench"]["device"] == "cpu" and tools["bench"]["vs_baseline"] is None
    assert [(r["plugin"], r["workload"], r["KiB"]) for r in tools["ec_benchmark"]] == [
        (p, w, 256) for p in ("cuda", "jerasure") for w in ("encode", "decode")]
    assert len(tools["bench_all"]) == 6
    assert all("error" not in ln and ln["device"] == "cpu" for ln in tools["bench_all"])
    assert set(run["launches"].values()) == {0}
    assert set(run["launches"]) == {"row_copy", "repeat_variant", "acc_encode",
                                    "gf_stage_cut:load", "gf_stage_cut:extract",
                                    "gf_stage_cut:matmul"}
    assert lk.launch_counts() == {"row_copy": 0, "repeat_variant": 0, "acc_encode": 0}


def test_chip_smoke_tools_bounds():
    """The tools rows' bounds at the probes' shapes, by bytes at 3.35 TB/s:
    402,653,184 B for either copy and the load and extract cuts,
    (k + m) S for the matmul cut and the repeat variant at (8, 64 MiB),
    (k + 2m) S for the acc form at (8, 256 MiB); the load and extract
    cuts' probe bound, all k rows read, (k + m) S beside it."""
    bounds = chip_smoke.tool_bounds(chip_smoke.Config())
    assert set(bounds) == set(chip_smoke.TOOL_ROWS)
    assert all(by == "bytes" for _, by in bounds.values())
    want = {"row_copy:copy_fn": 0.1202, "row_copy:fat_copy": 0.1202,
            "gf_stage_cut:load": 0.1202, "gf_stage_cut:extract": 0.1202,
            "gf_stage_cut:matmul": 0.2204, "repeat_variant": 0.2204, "acc_encode": 1.1218}
    for name, ms in want.items():
        assert round(bounds[name][0], 4) == ms, name
    probe = chip_smoke.probe_bounds(chip_smoke.Config())
    assert {name: round(ms, 4) for name, ms in probe.items()} == {
        "gf_stage_cut:load": 0.2204, "gf_stage_cut:extract": 0.2204}
    assert bounds["row_copy:copy_fn"][0] == 402653184 / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert {replaces for _, replaces, _, _ in chip_smoke.TOOL_ROWS.values()} == {
        "tools/perf_lab.py:61", "tools/perf_lab.py:101", "tools/perf_lab2.py:76",
        "tools/perf_lab2.py:113", "tools/perf_lab3.py:52"}


def test_chip_smoke_tools_rows_on_cpu(monkeypatch):
    """The kernels line's new rows, built on the CPU with the card-only
    timers (CUDA events, the profiler) stubbed: every tools row and the
    CLAY bench-shape row has the contract's keys, its plain version's
    bytes and its library call where one exists."""
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, calls, repeats: (fn(0), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "per_launch",
                        lambda fn, calls, shape, kernel: {
                            "device_us_mean": 1.0,
                            "device_ops_per_call": {"kernel": 1.0, "memset": 0.0, "other": 0.0}})
    cfg = chip_smoke.Config(**TINY_TOOLS, clay_big_chunk=32 * 1024)
    launches = {**{name: 3 for name in ("row_copy", "repeat_variant", "acc_encode")},
                **{f"gf_stage_cut:{st}": 2 for st in chip_smoke.CUT_STAGES}}
    rows = chip_smoke.tools_kernel_rows(cfg, "cpu", {n: 0 for n in chip_smoke.TOOL_ROWS},
                                        launches)
    rows.append(chip_smoke.clay_bench_row(cfg, "cpu", 7))
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == [*chip_smoke.TOOL_ROWS, "clay_repair:bench_shape"]
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda" and r["max_abs_err"] == 0
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
    with_library = {r["name"] for r in rows if r["library_ms"] is not None}
    assert with_library == {"row_copy:copy_fn", "row_copy:fat_copy", "gf_stage_cut:load",
                            "gf_stage_cut:extract"}
    by_name = {r["name"]: r for r in rows}
    assert all("device_ops_per_call" in by_name[n] for n in chip_smoke.TOOL_ROWS)
    # the load and extract cuts: the function's m rows in and out, and
    # beside it the probe's bound with all k rows read
    k, m, s = cfg.k, cfg.m, cfg.tools_cols
    for st in ("load", "extract"):
        row = by_name[f"gf_stage_cut:{st}"]
        assert row["bound_ms"] == 2 * m * s / chip_smoke.PEAK_BYTES_PER_S * 1e3
        assert row["probe_bound_ms"] == (k + m) * s / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert sum("probe_bound_ms" in r for r in rows) == 2
    assert by_name["row_copy:fat_copy"]["launches"] == 3
    assert by_name["gf_stage_cut:matmul"]["launches"] == 2
    assert by_name["clay_repair:bench_shape"]["launches"] == 7
    assert by_name["clay_repair:bench_shape"]["shape"].endswith("(11, 16, 512)")


def test_chip_smoke_crc_sweep_on_cpu(monkeypatch):
    """The crc_sweep line on the CPU with the card-only timers stubbed:
    every case equals its oracle (the plain version, or native crc32c
    past the widest bucket) and carries its geometry, bound and device
    operations a call."""
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, calls, repeats: (fn(0), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "per_launch", lambda fn, calls, shape, kernel: {
        "device_us_mean": 1.0, "device_ops_per_call": {"kernel": 1.0, "memset": 0.0, "other": 0.0}})
    cfg = chip_smoke.Config(batch_cols=4096, crc_sweep=((1, 1024), (3, 4096), (2, 8192)))
    out = chip_smoke.phase_crc_sweep(cfg, "cpu")
    assert [(c["lanes"], c["width"]) for c in out["cases"]] == [(1, 1024), (3, 4096), (2, 8192)]
    assert [c["oracle"] for c in out["cases"]] == ["batched_crc32c_plain"] * 2 + ["native.crc32c"]
    for c in out["cases"]:
        assert c["mismatched_lanes"] == 0 and c["bound_by"] == "bytes"
        assert (c["loads_per_pass"], c["cluster"], c["passes"]) == \
            chip_smoke.hashing.crc_geometry(c["width"])
        assert c["device_ops_per_call"]["memset"] == 0


#: chip_smoke's mgr and farm paths cut for the CPU: a 4-daemon store and
#: a 130-daemon one (two blocks a metric on the card), 64 KiB objects
TINY_MGR_FARM = dict(mgr_shapes=((4, 3, 8), (130, 2, 4)), mgr_check_shapes=((3, 2, 33),),
                     mgr_reports=10, mgr_passes=2,
                     farm_writers=4, object_bytes=64 * 1024, farm_sweep_bytes=(32 * 1024,),
                     farm_reps=1,
                     fold_shapes=((2, 3, 8192), (4, 3, 8192), (2, 3, 8192 + 13), (8, 3, 8192)),
                     fold_check_shapes=((1, 3, 8192), (3, 3, 8192 + 7)),
                     mgr_staged_shapes=((40, 2, 3),))


def _stub_card_timers(monkeypatch):
    """chip_smoke's card-only timers stubbed for the CPU: CUDA-event ms,
    the profile pass's device µs of a kernel and of a library call."""
    monkeypatch.setattr(chip_smoke, "time_ms", lambda fn, calls, repeats: (fn(0), 1.0)[1])
    monkeypatch.setattr(chip_smoke, "per_launch", lambda fn, calls, shape, kernel: {
        "device_us_mean": 1.0, "device_ops_per_call": {"kernel": 1.0, "memset": 0.0, "other": 0.0}})
    monkeypatch.setattr(chip_smoke, "library_launch", lambda fn, calls: (fn(0), {
        "device_us_per_call": 1.0, "kernels_per_call": 1.0, "kernel_names": ["xor"]})[1])


def test_chip_smoke_mgr_and_farm_paths_on_cpu():
    """chip_smoke's phases 11-12 at a tiny size on the CPU: the analytics
    kernel's cases equal its plain version; the mgr path's passes equal
    the numpy host path with no cold launch and flag the slow OSD; four
    concurrent writers through the service are one dispatch, byte-equal
    to the per-op encode and to the host gf_matmul (also at a smaller
    object); the dp, tp and service-tp paths on a (2, 2)
    mesh equal gf_matmul; on the CPU no kernel launches."""
    from ceph_tpu_torch.ops import analytics_kernels as ak

    cfg = chip_smoke.Config(**TINY_MGR_FARM)
    assert chip_smoke.phase_kernel_mgr(cfg, "cpu") == {"4x3x8": 0, "130x2x4": 0, "3x2x33": 0}
    mgr = chip_smoke.phase_mgr(cfg, "cpu")
    assert mgr["launches"] == {"4x3x8": 0, "130x2x4": 0}
    for row in mgr["shapes"]:
        assert row["mismatches_vs_numpy"] == 0 and "osd.3" in row["flagged"]
        assert row["stats"] == {"prewarmed_shapes": 1, "passes": 2, "launches": 2}
    assert ak.geometry(130, 4) == (2, 65, False)
    assert chip_smoke.phase_kernel_fold(cfg, "cpu") == 0
    run = chip_smoke.run_farm_path(cfg, "cpu")
    single, mesh = run["farm"]["single_device"], run["farm"]["mesh_paths"]
    assert single["single_dispatches"] == 1 and single["coalesced"] == 4
    assert single["mismatched_bytes"] == 0 and single["cold_launches"] == 0
    for row in (single, *run["farm"]["single_device_sweep"]):
        assert row["mismatched_vs_host_gf_matmul"] == 0 and row["single_dispatches"] == 1
    assert mesh["mesh"] == {"pg": 2, "shard": 2} and mesh["service_tp_dispatches"] == 1
    assert mesh["dp_mismatched"] == mesh["tp_mismatched"] == mesh["service_tp_mismatched"] == 0
    assert set(run["launches"].values()) == {0}


def test_chip_smoke_mgr_and_farm_rows_on_cpu(monkeypatch):
    """The kernels line's new rows and the fold sweep, built on the CPU
    with the card-only timers stubbed: the contract's keys, the byte
    bounds, and the library call of the fold at n = 2."""
    _stub_card_timers(monkeypatch)
    cfg = chip_smoke.Config(**TINY_MGR_FARM)
    rows = chip_smoke.mgr_kernel_rows(cfg, "cpu", {"4x3x8": 0, "130x2x4": 0},
                                      {"4x3x8": 2, "130x2x4": 2})
    rows.append(chip_smoke.fold_kernel_row(cfg, "cpu", 0, 3))
    keys = {"name", "route", "source", "replaces", "launches", "max_abs_err", "ms", "plain_ms",
            "bound_ms", "bound_by", "library_ms"}
    assert [r["name"] for r in rows] == ["mgr_analytics:4x3x8", "mgr_analytics:130x2x4",
                                         "farm_fold"]
    for r in rows:
        assert keys <= set(r) and r["route"] == "cuda" and r["max_abs_err"] == 0
        assert r["bound_by"] == "bytes" and r["bound_ms"] > 0
    assert [r["library_ms"] is None for r in rows] == [True, True, False]
    assert rows[2]["launches"] == 3 and rows[2]["replaces"] == chip_smoke.FOLD_REPLACES
    assert rows[0]["device_us_clamp"] == 1.0 and rows[2]["library_device_us"] == 1.0
    sweep = chip_smoke.phase_fold_sweep(cfg, "cpu")
    assert [c["shape"] for c in sweep["cases"]] == [list(s) for s in cfg.fold_shapes]
    assert all(c["mismatched_bytes"] == 0 for c in sweep["cases"])
    assert [c["shape"][0] for c in sweep["cases"] if "library" in c] == [2, 2]


def test_chip_smoke_mgr_fold_lab_on_cpu(monkeypatch):
    """The A/B lab of the two kernels (``--mgr-fold-lab``) on the CPU with
    the card-only timers stubbed: latency and clamp stores at each mgr and
    staged shape, every fold shape and the odd-offset folds at n = 2; no
    mismatch."""
    _stub_card_timers(monkeypatch)
    cfg = chip_smoke.Config(**TINY_MGR_FARM)
    lab = chip_smoke.phase_mgr_fold_lab(cfg, "cpu")
    assert [(c["shape"], c["kind"]) for c in lab["mgr"]] == [
        (list(s), k) for s in (*cfg.mgr_shapes, *cfg.mgr_staged_shapes)
        for k in ("latency", "clamp")]
    assert all(c["mismatched_values"] == 0 for c in lab["mgr"])
    shapes = [c["shape"] for c in lab["fold"]]
    assert shapes == [list(s) for s in (*cfg.fold_shapes, *cfg.fold_check_shapes)] + [
        [2, 3, 8192], [2, 3, 8192 + 13]]
    assert all(c["mismatched_bytes"] == 0 for c in lab["fold"])
    assert chip_smoke.phase_mgr_staged(cfg, "cpu")["cases"][0]["geometry"] == [1, 40, False]


def test_chip_smoke_mgr_and_fold_bounds():
    """The byte bounds at 3.35 TB/s: about 81 KB (0.024 µs) at the
    mgr's configured (16, 16, 32), 5.14 MB (1.53 µs) at (1024, 16, 32);
    (n + 1) m S for the fold."""
    small, by = chip_smoke.mgr_bound_ms((16, 16, 32))
    assert by == "bytes" and small == 80768 / chip_smoke.PEAK_BYTES_PER_S * 1e3
    big, by = chip_smoke.mgr_bound_ms((1024, 16, 32))
    assert by == "bytes" and big == 5136896 / chip_smoke.PEAK_BYTES_PER_S * 1e3
    assert round(small * 1e3, 3) == 0.024 and round(big * 1e3, 2) == 1.53
    assert chip_smoke.fold_bound_ms(2, 3, 524288) == (
        3 * 3 * 524288 / chip_smoke.PEAK_BYTES_PER_S * 1e3, "bytes")


def test_chip_smoke_retakes_an_empty_trace(monkeypatch):
    """A profiler trace that caught no device event lost its window: the
    smoke takes it again (up to three times) instead of reading zero
    launches; a trace with events is kept as it is."""
    takes = []

    def fake_traced(fn):
        fn()
        takes.append(1)
        return 1.0, [] if len(takes) < 2 else [{"name": "k", "cat": "kernel", "dur": 2.0}]
    monkeypatch.setattr(chip_smoke, "traced", fake_traced)
    calls = []
    wall, dev = chip_smoke.traced_calls(calls.append, 3)
    assert len(takes) == 2 and dev == [{"name": "k", "cat": "kernel", "dur": 2.0}]
    assert calls == [0, 1, 2] * 2
    monkeypatch.setattr(chip_smoke, "traced", lambda fn: (fn(), (1.0, []))[1])
    assert chip_smoke.traced_calls(lambda i: None, 2) == (1.0, [])



#: chip_smoke's store path cut for the CPU: 4 objects of 64 KiB (8 KiB
#: shards, one 64 KiB allocation unit a blob), every matmul on the
#: device seam
TINY_STORE = dict(store_objects=4, store_object_bytes=64 * 1024, store_device_min_bytes=0,
                  scrub_chunk=3, crc_lanes=8)


def test_chip_smoke_store_path_on_cpu(monkeypatch, tmp_path):
    """chip_smoke's phase 13 at a tiny size on the CPU: 44 shards persisted
    in 11 BlockStores on FileDBs, remounted with a clean fsck, read back
    and deep-scrubbed equal to what was encoded and to the stored hinfo;
    shard 2's store lost and rebuilt equal; a planted bitflip answers EIO
    (and fsck finds its blob) while a degraded read without that shard
    returns the object.  On the CPU nothing launches, so the launch check
    names every kernel of the path; the temporary directory is gone."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    cfg = chip_smoke.Config(**TINY_STORE)
    run = chip_smoke.run_store_path(cfg, "cpu")
    line = run["store"]
    assert (line["objects"], line["shards"], line["chunk_size"]) == (4, 11, 4096)
    assert line["mismatches"] == 0 and line["read_mismatches"] == 0
    assert line["fsck_after_remount"] == 0 and line["fsck_rebuilt_store"] == 0
    # each 8 KiB shard a blob of one 64 KiB allocation unit
    assert line["shard_bytes"] == 4 * 11 * 8192
    assert line["bytes_at_rest"] == 4 * 11 * 65536
    assert line["lost_shard"] == 2 and line["rebuilt_mismatches"] == 0
    assert line["decode_launches"] > 0
    # the flipped object is the last where there are fewer than 8
    assert line["bitflip"] == {"shard": 5, "object": 3, "read_errno": 5,
                               "degraded_read_equal": True, "fsck_after_flip": 1}
    assert set(line["seconds"]) == {"encode", "persist", "remount_fsck", "read", "scrub",
                                    "rebuild", "persist_rebuilt", "bitflip_degraded_read"}
    assert set(run["launches"].values()) == {0}
    assert list(line["launches_by_step"]) == ["encode", "scrub_prewarm", "scrub",
                                              "decode_prewarm", "rebuild", "degraded_read"]
    assert all(set(c.values()) == {0} for c in line["launches_by_step"].values())
    assert run["idle"] == ["batched_crc32c_device:scrub", "gf_bitmatmul:encode",
                           "gf_bitmatmul:rebuild", "gf_encode_compare:scrub"]
    assert os.listdir(tmp_path) == []
    assert not chip_smoke.FAULTS.dump()


def test_chip_smoke_store_checks_fail_loudly():
    """A mismatch, a dirty fsck, a read that returns instead of EIO or a
    degraded read that differs each fail the store line's check; and on
    the card an idle kernel of the path is named."""
    good = {"mismatches": 0, "fsck_after_remount": 0, "fsck_rebuilt_store": 0,
            "bitflip": {"read_errno": 5, "degraded_read_equal": True, "fsck_after_flip": 1}}
    chip_smoke.check_store(good)
    bad_lines = [{**good, "mismatches": 1}, {**good, "fsck_after_remount": 2},
                 {**good, "fsck_rebuilt_store": 1},
                 {**good, "bitflip": {**good["bitflip"], "read_errno": None}},
                 {**good, "bitflip": {**good["bitflip"], "degraded_read_equal": False}},
                 {**good, "bitflip": {**good["bitflip"], "fsck_after_flip": 0}}]
    for line in bad_lines:
        with pytest.raises(AssertionError, match="store path"):
            chip_smoke.check_store(line)
    busy = {"gf_bitmatmul": 4, "batched_crc32c_device": 3, "gf_encode_compare": 2}
    steps = {"encode": busy, "scrub": {**busy, "gf_encode_compare": 0}, "rebuild": busy}
    assert chip_smoke.store_path_idle(steps) == ["gf_encode_compare:scrub"]
    assert chip_smoke.store_path_idle({**steps, "scrub": busy}) == []


@pytest.mark.parametrize("scrub_launches", [False, True], ids=["prewarm-only", "scrub"])
def test_chip_smoke_store_scrub_counted_apart_from_its_prewarm(monkeypatch, tmp_path,
                                                               scrub_launches):
    """The crc and the compare count for the store path only where the
    scrub itself launches them: launches in the ``ScrubVerifier``'s
    prewarm (every bucket, batch 1 and max) land in ``scrub_prewarm`` and
    leave both kernels named idle at the scrub.  The launches are stood in
    for on the CPU by adding to the wrappers' counts."""
    from ceph_tpu_torch.ops import hashing, rs_kernels

    def launch():
        hashing.batched_crc32c_device.launches += 1
        rs_kernels.gf_encode_compare.launches += 1

    prewarm, verify = chip_smoke.ScrubVerifier.prewarm, chip_smoke.ScrubVerifier.verify_object

    def counted_prewarm(self, *a, **kw):
        launch()
        return prewarm(self, *a, **kw)

    async def counted_verify(self, *a, **kw):
        if scrub_launches:
            launch()
        return await verify(self, *a, **kw)

    monkeypatch.setattr(chip_smoke.ScrubVerifier, "prewarm", counted_prewarm)
    monkeypatch.setattr(chip_smoke.ScrubVerifier, "verify_object", counted_verify)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    run = chip_smoke.run_store_path(chip_smoke.Config(**TINY_STORE), "cpu")
    steps = run["store"]["launches_by_step"]
    scrub = 4 if scrub_launches else 0
    assert steps["scrub_prewarm"] == {"gf_bitmatmul": 0, "batched_crc32c_device": 1,
                                      "gf_encode_compare": 1}
    assert steps["scrub"] == {"gf_bitmatmul": 0, "batched_crc32c_device": scrub,
                              "gf_encode_compare": scrub}
    assert run["launches"]["batched_crc32c_device"] == 1 + scrub
    scrub_idle = [] if scrub_launches else ["batched_crc32c_device:scrub",
                                            "gf_encode_compare:scrub"]
    assert run["idle"] == sorted(scrub_idle + ["gf_bitmatmul:encode", "gf_bitmatmul:rebuild"])

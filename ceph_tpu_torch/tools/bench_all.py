"""The BASELINE.md bench configurations on the port, one JSON line each.

Twin of the JAX package's ``tools/bench_all.py``:

- ceph_erasure_code_benchmark (src/test/erasure-code/
  ceph_erasure_code_benchmark.cc): encode and decode workloads;
- osdmaptool --test-map-pgs / ParallelPGMapper for the whole-map remap;
- the recovery-decode aggregator and the deep-scrub verifier against
  their per-object host paths;
- the thrash suites' recovery measurement (qa/tasks/ceph_manager.py):
  end-to-end single-OSD recovery with the OSD daemons in worker
  processes of their own (``recovery``).

Run on the card:

  python -m ceph_tpu_torch.tools.bench_all            # every config
  python -m ceph_tpu_torch.tools.bench_all <config>   # one of CONFIGS

Each config is a function of a device: the card unless ``--device cpu``
asks for the CPU; the CPU baselines (``jerasure_cpu``, ``_clay_cpu``)
always run on the CPU.  Sizes are the reference's for the device's kind
(its TPU sizes on the card).  Two departures from the reference:

- a failed config prints an error line and makes the run exit non-zero
  (the reference printed the error and still exited 0);
- no rate taken on a TPU is a yardstick: where the reference divided by
  a TPU rate (decode's ``/ 40``), ``vs_baseline`` is the share of the
  card's own byte bound for the same loop, as its metric string says.
  The ratio targets that are not rates (``/ 10`` of a speedup) stay.

``recovery`` runs ``BENCH_RECOVERY_OSDS`` OSDs (default 64; EC(8,3), or
EC(4,2) below 12 OSDs) in up to eight worker processes, the victim in one
of its own, each worker on the same device as the bench; it kills the
victim and times the cluster back to active+clean twice: run A with the
batched recovery decode (``device-min-bytes`` 4096, the aggregator on),
run B with the per-object host decode (``device-min-bytes`` 2^40, the
aggregator and the encode farm off, so no bit-matrix kernel launches in
its workers from the kill to clean), as the reference measures them.  Its value is run A's
in-daemon decode rate over run B's, against the reference's 10x target.
"""

from __future__ import annotations

import argparse
import asyncio
import dataclasses
import json
import os
import shutil
import signal
import subprocess
import sys
import tempfile
import time
import traceback

import numpy as np
import torch

from ceph_tpu_torch.crush import builder as B
from ceph_tpu_torch.crush.types import CrushMap
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.plugins import clay_cuda
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.native import crc32c
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.common.launches import sum_launches
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.remap import BatchedClusterMapper
from ceph_tpu_torch.osd.types import PgPool, PoolType, pg_t
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier
from ceph_tpu_torch.tools import (MiB, PEAK_BYTES_PER_S, child_env, device_label,
                                  random_bytes, resolve_device, size_label, sync)

#: payloads past this many bytes would leave the host path: the host
#: baselines pin their plugins below it (the reference's
#: CEPH_TPU_EC_DEVICE_MIN_BYTES=2**62)
HOST_ONLY = 1 << 62


@dataclasses.dataclass
class Sizes:
    """The configs' sizes and repeats.  The defaults are the reference's
    sizes with an accelerator; :meth:`for_device` takes its CPU sizes on
    the CPU."""
    jerasure_bytes: int = 4 * MiB
    jerasure_calls: int = 8
    decode_cols: int = 256 * MiB        # 2 GiB of survivor input
    decode_iters: int = 32
    clay_chunk: int = 32 * MiB
    batch_objects: int = 16
    batch_object_bytes: int = 8 * MiB
    remap_hosts: int = 128
    remap_osds_per_host: int = 8
    remap_rep_pgs: int = 8192
    remap_ec_pgs: int = 2048
    remap_check_stride: int = 257
    remap_scalar_sample: int = 128
    #: best-of repeats of the host-clock timings, and the samples and
    #: seconds between them of the card's timed loops
    reps: int = 3
    rounds: int = 6
    pause: float = 3.0

    @classmethod
    def for_device(cls, device: torch.device, **changes) -> "Sizes":
        if device.type != "cuda":
            changes = {"decode_cols": 1 << 16, "batch_object_bytes": 512 * 1024, **changes}
        return cls(**changes)


def _emit(metric: str, value: float, unit: str, vs_baseline, device, **extra) -> dict:
    line = {"metric": metric, "value": value, "unit": unit, "vs_baseline": vs_baseline,
            "device": device_label(device), **extra}
    print(json.dumps(line), flush=True)
    return line


# -- config 1: jerasure RS(4,2), 4 MiB stripes, host CPU reference ----------

def bench_jerasure_cpu(device, sizes: Sizes) -> dict:
    cpu = torch.device("cpu")
    ec = registry.factory("jerasure", {"k": "4", "m": "2", "technique": "reed_sol_van"},
                          device=cpu)
    cs = ec.get_chunk_size(sizes.jerasure_bytes)
    data = np.random.default_rng(0).integers(0, 256, 4 * cs, dtype=np.uint8)
    best = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        for _ in range(sizes.jerasure_calls):
            ec.encode(set(range(6)), data)
        best = min(best, (time.perf_counter() - t0) / sizes.jerasure_calls)
    return _emit(f"jerasure RS(4,2) {size_label(sizes.jerasure_bytes)} stripe encode, "
                 "host CPU reference", data.nbytes / best / 1e6, "MB/s", 1.0, cpu)


# -- config 2b: RS(8,3) 1-erasure decode on the card -------------------------

#: the erased data chunk of the decode config
DECODE_LOST = 3


def decode_survivors(codec: rk.BitmatrixCodec, data: torch.Tensor) -> torch.Tensor:
    """The 8 survivor payloads, in codec order, of the (k, S) ``data``
    with chunk ``DECODE_LOST`` erased: the other data chunks and parity 0."""
    parity = codec.encode(data)
    return torch.cat([data[:DECODE_LOST], data[DECODE_LOST + 1:], parity[0:1]]).contiguous()


def decode_erased(codec: rk.BitmatrixCodec, sub: torch.Tensor) -> torch.Tensor:
    """Chunk ``DECODE_LOST`` rebuilt from the survivors, (1, S)."""
    _, dbits = codec.decode_bits((DECODE_LOST,))
    return rk.BitmatrixCodec._apply(dbits, sub, None)


def bench_decode(device, sizes: Sizes) -> dict:
    k, m = 8, 3
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device)
    s = sizes.decode_cols
    data = random_bytes((k, s), 1, device)
    sub = decode_survivors(codec, data)
    ref = data[DECODE_LOST, :4096].cpu()
    del data
    out = decode_erased(codec, sub)
    if not torch.equal(out[0, :4096].cpu(), ref):
        raise AssertionError("decode mismatch")
    del out
    cuda = device.type == "cuda"
    if not cuda:
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            decode_erased(codec, sub)
            best = min(best, time.perf_counter() - t0)
        gbs, share = k * s / best / 1e9, None
    else:
        # the reference's timed loop: carry ^= decode(survivors ^ i)
        _, dbits = codec.decode_bits((DECODE_LOST,))
        tile = rk._pick_tile(s) or s

        def loop_decode(n: int) -> torch.Tensor:
            acc = torch.zeros((1, s), dtype=torch.uint8, device=device)
            for i in range(n):
                rk.gf_bitmatmul_pallas_acc(dbits, sub, acc, i, tile_s=tile)
            return acc

        loop_decode(sizes.decode_iters)
        sync(device)
        best = float("inf")
        for r in range(sizes.rounds):
            t0 = time.perf_counter()
            loop_decode(sizes.decode_iters)[0, :8].cpu()
            best = min(best, time.perf_counter() - t0)
            if r < sizes.rounds - 1 and sizes.pause:
                time.sleep(sizes.pause)
        gbs = k * s * sizes.decode_iters / best / 1e9
        # survivors read, the carry read and written: (k + 2) S bytes
        bound_s = (k + 2) * s / PEAK_BYTES_PER_S
        share = bound_s / (best / sizes.decode_iters)
    return _emit("RS(8,3) 1-erasure decode throughput, 1 "
                 f"{'card' if cuda else 'CPU'} (vs_baseline: share of the H100's byte bound, "
                 "(k+2)S bytes an iteration at 3.35 TB/s)",
                 gbs, "GB/s (survivor bytes)", share, device)


# -- config 3: CLAY (8,4,11) repair, card vs CPU -----------------------------

CLAY_PROFILE = {"k": "8", "m": "4", "d": "11", "scalar_mds": "cuda"}
CLAY_LOST = 3


def _clay_stripe(device, chunk: int) -> tuple:
    """(clay code on ``device``, chunk size, the encoded stripe, the
    minimum helper reads of chunk ``CLAY_LOST``) of one 8 x ``chunk``
    stripe (rng seed 2, as the reference)."""
    ec = registry.factory("clay", dict(CLAY_PROFILE), device=device)
    cs = ec.get_chunk_size(8 * chunk)
    data = np.random.default_rng(2).integers(0, 256, 8 * cs, dtype=np.uint8)
    enc = ec.encode(set(range(12)), data)
    minimum = ec.minimum_to_decode({CLAY_LOST}, set(range(12)) - {CLAY_LOST})
    sub = cs // ec.get_sub_chunk_count()
    helpers = {c: np.concatenate([enc[c][o * sub:(o + n) * sub] for o, n in runs])
               for c, runs in minimum.items()}
    return ec, cs, enc, helpers


def _clay_cpu_seconds(cs: int, helpers: dict, want: np.ndarray, reps: int) -> float:
    """Best seconds of a host repair of chunk ``CLAY_LOST``: the plugin on
    the CPU with every product on the host GF path."""
    ec = registry.factory("clay", dict(CLAY_PROFILE), device="cpu")
    ec.mds.device_min_bytes = ec.pft.device_min_bytes = HOST_ONLY
    out = ec.decode({CLAY_LOST}, helpers, cs)
    if not np.array_equal(out[CLAY_LOST], want):
        raise AssertionError("host repair mismatch")
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        ec.decode({CLAY_LOST}, helpers, cs)
        best = min(best, time.perf_counter() - t0)
    return best


def bench_clay_cpu_probe(device, sizes: Sizes) -> dict:
    """The CPU half of ``clay_repair`` alone (the stripe made on the CPU)."""
    _, cs, enc, helpers = _clay_stripe(torch.device("cpu"), sizes.clay_chunk)
    line = {"seconds": _clay_cpu_seconds(cs, helpers, enc[CLAY_LOST], sizes.reps),
            "chunk": cs, "device": "cpu"}
    print(json.dumps(line), flush=True)
    return line


def bench_clay_repair(device, sizes: Sizes) -> dict:
    ec, cs, enc, helpers = _clay_stripe(device, sizes.clay_chunk)
    cpu_s = _clay_cpu_seconds(cs, helpers, enc[CLAY_LOST], sizes.reps)
    # the single-launch repair over staged helpers (ClayRepairProgram)
    prog = clay_cuda.ClayRepairProgram(ec, clay_cuda.chunk_node(ec, CLAY_LOST), device=device)
    if not np.array_equal(prog.repair(helpers), enc[CLAY_LOST]):
        raise AssertionError("program repair mismatch")
    H = prog.stage(helpers)
    sync(device)
    best = float("inf")
    for r in range(sizes.rounds):
        t0 = time.perf_counter()
        prog.repair_device(H)[0, :8].cpu()
        best = min(best, time.perf_counter() - t0)
        if r < sizes.rounds - 1 and sizes.pause:
            time.sleep(min(sizes.pause, 2.0))
    speedup = cpu_s / best
    return _emit(f"CLAY(8,4,11) single-chunk repair, {size_label(cs)} chunk: single-launch "
                 f"program on {device_label(device)} ({best * 1e3:.4f} ms) vs CPU "
                 f"({cpu_s:.4f} s)", speedup, "x speedup", speedup / 10.0, device)


# -- config 3b: batched recovery decode vs per-object host plugin decode ----

def _objects(ec, sinfo, n: int, nbytes: int, seed: int) -> list[dict]:
    rng = np.random.default_rng(seed)
    return [ecutil.encode(sinfo, ec, rng.integers(
        0, 256, sinfo.logical_to_next_stripe_offset(nbytes), dtype=np.uint8))
        for _ in range(n)]


def bench_decode_batch(device, sizes: Sizes) -> dict:
    """The recovery-decode aggregator's bucketed batched decode against
    the per-object host plugin decode on the same stripes; it must
    coalesce at least 4 objects a launch, with no cold launch, and match
    the per-object decode byte for byte."""
    k, m = 8, 3
    n_obj, obj_bytes = sizes.batch_objects, sizes.batch_object_bytes
    ec = registry.factory("cuda", {"k": str(k), "m": str(m)}, device=device)
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(obj_bytes) * k)
    objs = [{s: c for s, c in sh.items() if s != 2}
            for sh in _objects(ec, sinfo, n_obj, obj_bytes, 7)]
    ec_host = registry.factory("cuda", {"k": str(k), "m": str(m)}, device="cpu")
    ec_host.device_min_bytes = HOST_ONLY
    best_host = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        host_out = [ecutil.decode_shards(sinfo, ec_host, avail, {2}) for avail in objs]
        best_host = min(best_host, time.perf_counter() - t0)

    agg = DecodeAggregator(device=device, window_s=0.002)
    cs = len(next(iter(objs[0].values())))
    agg.prewarm(ec, [cs], erasure_counts=(1,))

    async def batched_once():
        return await asyncio.gather(*(
            ecutil.decode_shards_async(sinfo, ec, avail, {2}, aggregator=agg)
            for avail in objs))

    for got, ref in zip(asyncio.run(batched_once()), host_out):
        if not np.array_equal(got[2], ref[2]):
            raise AssertionError("batched decode mismatch")
    best_batch = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        asyncio.run(batched_once())
        best_batch = min(best_batch, time.perf_counter() - t0)
    launches = agg.stats["launches"]
    mean_batch = agg.stats["batched_requests"] / max(launches, 1)
    if mean_batch < 4:
        raise AssertionError(f"aggregator batched only {mean_batch:.1f} obj/launch")
    if agg.stats["cold_launches"]:
        raise AssertionError(f"cold launches: {dict(agg.stats)}")
    ratio = best_host / best_batch
    survivor_bytes = sum(sum(c.nbytes for c in o.values()) for o in objs)
    return _emit(
        f"batched recovery decode, {n_obj} x {obj_bytes >> 10} KiB objects EC({k},{m}) "
        f"1-erasure on {device_label(device)}: aggregator ({mean_batch:.1f} obj/launch, "
        f"0 cold launches, {survivor_bytes / best_batch / 1e6:.0f} MB/s survivor bytes) "
        "vs per-object CPU plugin decode", ratio, "x speedup", ratio / 10.0, device)


# -- config 3c: batched deep-scrub verification vs per-object host ----------

def bench_scrub_verify(device, sizes: Sizes) -> dict:
    """The scrub verifier's batched verification (crc32c of every shard
    and the parity re-encode compare) against the per-object path on the
    same chunks: native crc32c a shard, then decode and re-encode through
    the same plugin (on the card past ``device_min_bytes``, as in the
    reference).  It must fill each re-encode launch with at least 4
    compare lanes (the reference gates on 4 objects a launch, which is
    the same while an object's chunk fits one lane, as at its CPU size;
    at its accelerator size an 8 MiB object's 1 MiB chunks are 16 lanes,
    two full launches, 0.5 objects a launch), report the same crcs and
    flagged parity, with no cold launch."""
    k, m = 8, 3
    n_obj, obj_bytes = sizes.batch_objects, sizes.batch_object_bytes
    ec = registry.factory("cuda", {"k": str(k), "m": str(m)}, device=device)
    sinfo = ecutil.StripeInfo(k, ec.get_chunk_size(obj_bytes) * k)
    objs = _objects(ec, sinfo, n_obj, obj_bytes, 12)
    # silent rot to detect: one data shard and one parity shard
    objs[3][1] = objs[3][1].copy()
    objs[3][1][100] ^= 0x5A
    objs[7][k + 1] = objs[7][k + 1].copy()
    objs[7][k + 1][9] ^= 0xA5

    def host_verify(shards):
        crcs = {s: crc32c(p) for s, p in shards.items()}
        logical = ecutil.decode_concat(sinfo, ec, {s: shards[s] for s in range(k)})
        expect = ecutil.encode(sinfo, ec, logical)
        bad = frozenset(s for s, p in shards.items()
                        if s in expect and expect[s].tobytes() != p.tobytes())
        return crcs, bad

    best_host = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        host_out = [host_verify(o) for o in objs]
        best_host = min(best_host, time.perf_counter() - t0)

    ver = ScrubVerifier(device=device, window_s=0.002)
    cs = len(objs[0][0])
    ver.prewarm(ec, [cs])

    async def batched_once():
        return await asyncio.gather(*(ver.verify_object(ec, o) for o in objs))

    for (h_crcs, h_bad), ch in zip(host_out, asyncio.run(batched_once())):
        if ch.crcs != h_crcs:
            raise AssertionError("crc mismatch")
        if ch.parity_bad != h_bad:
            raise AssertionError(f"parity flags {ch.parity_bad} != host {h_bad}")
    best_batch = float("inf")
    for _ in range(sizes.reps):
        t0 = time.perf_counter()
        asyncio.run(batched_once())
        best_batch = min(best_batch, time.perf_counter() - t0)
    # 1 + reps rounds of n_obj objects ran; an object's compare spans
    # ceil(chunk / tile_cap) lanes, so past one lane an object alone fills
    # launches and the gate is on lanes a launch (objects a launch at one
    # lane, as the reference's CPU size has)
    enc = max(ver.stats["enc_launches"], 1)
    mean_batch = (1 + sizes.reps) * n_obj / enc
    mean_lanes = mean_batch * -(-cs // ver.tile_cap)
    if mean_lanes < 4:
        raise AssertionError(f"verifier batched only {mean_lanes:.1f} lanes/launch")
    if ver.stats["cold_launches"]:
        raise AssertionError(f"cold launches: {dict(ver.stats)}")
    shard_bytes = sum(sum(p.nbytes for p in o.values()) for o in objs)
    ratio = best_host / best_batch
    return _emit(
        f"batched deep-scrub verify, {n_obj} x {obj_bytes >> 10} KiB objects EC({k},{m}) "
        f"crc32c+parity-re-encode on {device_label(device)}: verifier "
        f"({mean_batch:.1f} obj/launch, {mean_lanes:.1f} compare lanes/launch, 0 cold launches, "
        f"{shard_bytes / best_batch / 1e6:.0f} MB/s shard bytes) vs per-object host "
        f"crc+re-encode ({shard_bytes / best_host / 1e6:.0f} MB/s)",
        ratio, "x speedup", ratio / 10.0, device)


# -- config 4: 10k PGs x 1024 OSDs whole-map remap --------------------------

def _big_map(hosts: int = 128, osds_per_host: int = 8, rep_pgs: int = 8192,
             ec_pgs: int = 2048) -> OSDMap:
    """BASELINE.md's "10k PGs x 1024-OSD map": ``hosts`` hosts of
    ``osds_per_host`` OSDs, pool 1 replicated size 3 on ``chooseleaf
    firstn host`` with ``rep_pgs`` PGs, pool 2 EC 8+3 on the MSR rule of
    11 hosts x 1 OSD with ``ec_pgs`` PGs (the reference's own copy of
    this map, tools/bench_all.py:_big_map)."""
    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=osds_per_host, n_hosts=hosts)
    om = OSDMap(crush=crush)
    for osd in range(hosts * osds_per_host):
        om.new_osd(osd, weight=0x10000, up=True)
    root = om.crush.bucket_names["default"]
    fd = om.crush.type_id("host")
    rule = B.add_simple_rule(om.crush, root, fd, mode="firstn")
    om.pools[1] = PgPool(id=1, type=PoolType.REPLICATED, size=3, min_size=2,
                         crush_rule=rule, pg_num=rep_pgs, pgp_num=rep_pgs)
    om.pool_names[1] = "bench"
    # wide-EC MSR pool (crush_msr_do_rule): 11 failure domains, 1 OSD each
    msr_rule = B.add_osd_multi_per_domain_rule(om.crush, root, fd, num_per_domain=1,
                                               num_domains=11)
    om.pools[2] = PgPool(id=2, type=PoolType.ERASURE, size=11, min_size=8,
                         crush_rule=msr_rule, pg_num=ec_pgs, pgp_num=ec_pgs)
    om.pool_names[2] = "bench-ec-msr"
    return om


def bench_remap(device, sizes: Sizes) -> dict:
    om = _big_map(sizes.remap_hosts, sizes.remap_osds_per_host, sizes.remap_rep_pgs,
                  sizes.remap_ec_pgs)
    n_pgs = sizes.remap_rep_pgs + sizes.remap_ec_pgs
    n_osds = sizes.remap_hosts * sizes.remap_osds_per_host
    mapper = BatchedClusterMapper(om, device=device)
    t0 = time.perf_counter()
    res = mapper.map_cluster()
    t_warm = time.perf_counter() - t0  # includes the map's compile and upload
    if sum(len(pm.up_cnt) for pm in res.values()) != n_pgs:
        raise AssertionError("remap lost PGs")
    # the batched rows equal the scalar pipeline on a sample of both pools
    for pid in (1, 2):
        pm = res[pid]
        for ps in range(0, om.pools[pid].pg_num, sizes.remap_check_stride):
            ref = om.pg_to_up_acting_osds(pg_t(pid, ps), folded=True)
            if pm.rows(ps) != ref:
                raise AssertionError(f"pool {pid} pg {ps}: {pm.rows(ps)} != {ref}")
    # steady state: new epochs with changed OSD state and weights
    best = float("inf")
    for i in range(3):
        om.epoch += 1
        om.mark_down((17 + i) % n_osds)
        om.osd_weight[(40 + i) % n_osds] = 0x8000
        mapper2 = BatchedClusterMapper(om, device=device)
        t0 = time.perf_counter()
        res2 = mapper2.map_cluster()
        best = min(best, time.perf_counter() - t0)
    if sum(len(pm.up_cnt) for pm in res2.values()) != n_pgs:
        raise AssertionError("remap lost PGs")
    # the scalar mapper on a PG sample, extrapolated over both pools
    sample = sizes.remap_scalar_sample
    per_pg = {}
    for pid in (1, 2):
        t0 = time.perf_counter()
        for ps in range(sample):
            om.pg_to_up_acting_osds(pg_t(pid, ps))
        per_pg[pid] = (time.perf_counter() - t0) / sample
    t_scalar = per_pg[1] * sizes.remap_rep_pgs + per_pg[2] * sizes.remap_ec_pgs
    return _emit(
        f"whole-map remap {n_pgs} PGs ({sizes.remap_rep_pgs} rep + {sizes.remap_ec_pgs} "
        f"EC-MSR) x {n_osds} OSDs on "
        f"{device_label(device)}: per-epoch batched vs scalar (batched {best * 1e3:.1f} ms "
        f"a steady epoch, first epoch {t_warm:.3f} s with the map's upload)",
        t_scalar / best, "x speedup", 1.0, device)


# -- config 5: e2e 1-OSD-down recovery (multi-process) -----------------------
#
# The OSDs run in worker processes (up to eight OSDs a worker, the victim
# alone), so the kill is a real process kill; the decode stage is timed
# inside the daemons (the recovery_decode_seconds / _bytes perf counters)
# and read back over their admin sockets, with the aggregator's batch
# stats; the device-versus-host ratio comes from running the same
# scenario twice with the profile's device-min-bytes and the workers'
# osd_recovery_decode_batch and osd_ec_encode_farm flipping the decode
# between the batched kernel and the per-object host path.

#: the workers read osd_recovery_decode_batch and osd_ec_encode_farm from
#: the environment (``common/config.py``: CEPH_TPU_<OPTION>)
DECODE_BATCH_ENV = "CEPH_TPU_OSD_RECOVERY_DECODE_BATCH"
ENCODE_FARM_ENV = "CEPH_TPU_OSD_EC_ENCODE_FARM"


def recovery_osds() -> int:
    return int(os.environ.get("BENCH_RECOVERY_OSDS", "64"))


def recovery_objects() -> int:
    return int(os.environ.get("BENCH_RECOVERY_OBJECTS", "128"))


def _bench_ec_profile() -> tuple[int, int]:
    """EC(k, m) of the recovery config, scaled to the cluster: EC(8,3) on
    64 OSDs (BASELINE.md), but a small debug cluster (fewer than 12 OSDs)
    cannot host 11 distinct shards across single-OSD failure domains, so
    it takes EC(4,2)."""
    return (8, 3) if recovery_osds() >= 12 else (4, 2)


def _warm_worker(device, conf) -> None:
    """Build and launch everything this worker's daemons will need before
    any op exists: a real encode and a 1-erasure decode at the bench's
    chunk scale, then, where ``conf`` turns them on, the decode
    aggregator's and the encode service's prewarm of every bucket the
    profile can launch.  A failure raises: the worker dies and the run
    fails."""
    from ceph_tpu_torch.parallel import decode_batcher, encode_service

    k, m = _bench_ec_profile()
    ec = registry.factory("cuda", {"k": str(k), "m": str(m)}, device=device)
    enc = ec.encode(set(range(k + m)), np.zeros(512 * 1024, dtype=np.uint8))
    cs = len(enc[0])
    ec.decode({2}, {i: enc[i] for i in range(k + m) if i != 2}, cs)
    if conf["osd_recovery_decode_batch"] != "off":
        decode_batcher.shared(device).prewarm(ec, [max(cs >> 2, 1), cs, cs << 2])
    if conf["osd_ec_encode_farm"] == "on":
        encode_service.shared(device).prewarm(ec.coding_matrix, [cs])


def _osd_group_main(argv: list[str]) -> int:
    """Worker process: host a group of OSDs on a device until SIGTERM.
    ``argv``: mon host, mon port, admin socket directory, OSD ids
    (comma-separated), device."""
    from ceph_tpu_torch.common import ConfigProxy
    from ceph_tpu_torch.osd.daemon import OSDDaemon

    host, port, admin_dir, ids, dev = argv[0], int(argv[1]), argv[2], argv[3], argv[4]
    osd_ids = [int(s) for s in ids.split(",")]
    device = resolve_device(dev)
    # the decode batch and the encode farm come from the environment
    conf = {
        "admin_socket": os.path.join(admin_dir, "osd.$id.asok"),
        # the bench drives the failure itself (osd down / out), so
        # failure detection is out of scope: peer pings off, beacons on
        "osd_heartbeat_interval": 0.0,
        # a co-hosted loop stalls for seconds under load; a short
        # handshake budget would turn that into false failures
        "ms_connection_ready_timeout": 120.0,
    }
    _warm_worker(device, ConfigProxy(dict(conf)))

    async def run() -> None:
        osds = []
        for i in osd_ids:
            o = OSDDaemon(i, (host, port), conf=ConfigProxy(dict(conf)), device=device)
            await o.start()
            osds.append(o)
        stop = asyncio.Event()
        asyncio.get_running_loop().add_signal_handler(signal.SIGTERM, stop.set)
        await stop.wait()
        for o in osds:
            await o.stop()

    asyncio.run(run())
    return 0


async def _sum_decode_counters(admin_dir: str, osd_ids) -> tuple[float, float]:
    """In-daemon recovery decode seconds and bytes, summed over the OSDs."""
    from ceph_tpu_torch.common import admin_command

    secs = byts = 0.0
    for i, path in zip(osd_ids, _osd_sockets(admin_dir, osd_ids)):
        try:
            perf = await admin_command(path, "perf dump")
        except (OSError, ConnectionError):
            continue
        c = perf.get(f"osd.{i}", perf)
        if isinstance(c, dict):
            secs += float(c.get("recovery_decode_seconds", 0.0))
            byts += float(c.get("recovery_decode_bytes", 0.0))
    return secs, byts


def _osd_sockets(admin_dir: str, osd_ids) -> list[str]:
    return [os.path.join(admin_dir, f"osd.{i}.asok") for i in osd_ids]


async def sum_batch_stats(socket_paths) -> dict:
    """The recovery-decode aggregators' stats (``dump_decode_batch``)
    summed over the OSD processes behind ``socket_paths`` (co-hosted
    daemons share one aggregator, so the sockets are deduped by pid), with
    the mean batch and the process count."""
    from ceph_tpu_torch.common import admin_command

    seen_pids: set[int] = set()
    total: dict[str, float] = {}
    for path in socket_paths:
        try:
            d = await admin_command(path, "dump_decode_batch")
        except (OSError, ConnectionError):
            continue
        if not isinstance(d, dict) or not d.get("active") or d.get("pid") in seen_pids:
            continue
        seen_pids.add(d.get("pid"))
        for k, v in (d.get("stats") or {}).items():
            total[k] = total.get(k, 0.0) + float(v)
    out = dict(total)
    out["processes"] = len(seen_pids)
    if total.get("launches"):
        out["mean_batch"] = total.get("batched_requests", 0.0) / total["launches"]
    return out


async def _recovery_scenario(profile_extra: dict, device, decode_batch: str = "on",
                             encode_farm: str = "on") -> dict:
    """One multi-process 1-OSD-down run on ``device``: a mon in this
    process, the OSDs in workers, the victim alone.  Returns its seconds
    to clean, bytes written, in-daemon decode seconds and bytes, and the
    aggregators' stats; ``decode_batch`` and ``encode_farm`` are the
    workers' osd_recovery_decode_batch and osd_ec_encode_farm."""
    from ceph_tpu_torch.client import RadosClient
    from ceph_tpu_torch.common import ConfigProxy
    from ceph_tpu_torch.mon import Monitor

    n_osds = recovery_osds()
    # workers scale with the machine; the victim is always its own
    # process so the failure is a real process kill
    workers = max(1, min(8, os.cpu_count() or 1))
    group = max(1, -(-(n_osds - 1) // workers))
    crush = CrushMap()
    B.build_hierarchy(crush, osds_per_host=1, n_hosts=n_osds)
    mon = Monitor(crush=crush, conf=ConfigProxy({"ms_connection_ready_timeout": 120.0}),
                  device=device)
    await mon.start()
    admin_dir = tempfile.mkdtemp(prefix="bench-recovery-asok-")
    victim = n_osds - 1
    groups = [list(range(g, min(g + group, n_osds - 1)))
              for g in range(0, n_osds - 1, group)] + [[victim]]
    env = child_env(**{DECODE_BATCH_ENV: decode_batch, ENCODE_FARM_ENV: encode_farm})
    procs = [subprocess.Popen(
        [sys.executable, "-m", "ceph_tpu_torch.tools.bench_all", "_osd_group",
         mon.addr[0], str(mon.addr[1]), admin_dir, ",".join(map(str, ids)), str(device)],
        env=env) for ids in groups]
    cl = RadosClient(client_id=55, handshake_timeout=120.0)
    t_boot = time.perf_counter()
    try:
        deadline = t_boot + 300
        await cl.connect(*mon.addr)
        while True:
            om = cl.osdmap
            if om is not None and sum(om.max_osd > o and om.is_up(o)
                                      for o in range(n_osds)) == n_osds:
                break
            dead = [p.args[-2] for p in procs if p.poll() is not None]
            if dead or time.perf_counter() > deadline:
                raise RuntimeError(f"OSDs did not come up (workers exited: {dead})")
            await cl._wait_new_map(om.epoch if om else 0, timeout=1)
        boot_s = time.perf_counter() - t_boot
        out = await _recovery_run(cl, procs[-1], victim, admin_dir, n_osds, profile_extra)
        return {"boot_s": boot_s, **out}
    finally:
        for p in procs:
            if p.poll() is None:
                p.send_signal(signal.SIGTERM)
        for p in procs:
            try:
                p.wait(timeout=30)
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
        await cl.shutdown()
        await mon.stop()
        shutil.rmtree(admin_dir, ignore_errors=True)


async def _recovery_run(cl, victim_proc, victim: int, admin_dir: str, n_osds: int,
                        profile_extra: dict) -> dict:
    import random

    k, m = _bench_ec_profile()
    await cl.ec_profile_set("p", {"plugin": "cuda", "k": str(k), "m": str(m), **profile_extra})
    await cl.pool_create("bench", pg_num=32, pool_type="erasure", erasure_code_profile="p")
    io = cl.ioctx("bench")
    rng = random.Random(9)
    total = 0
    t0 = time.perf_counter()
    for i in range(recovery_objects()):
        data = rng.randbytes(512 * 1024)
        await io.write_full(f"o{i}", data)
        total += len(data)
    write_s = time.perf_counter() - t0
    await cl.wait_clean(timeout=600)
    clean_s = time.perf_counter() - t0 - write_s
    survivors = range(n_osds - 1)
    socks = _osd_sockets(admin_dir, survivors)
    launches_before = await sum_launches(socks)
    victim_proc.send_signal(signal.SIGKILL)
    t0 = time.perf_counter()
    await cl.command({"prefix": "osd down", "id": str(victim)})
    await cl.command({"prefix": "osd out", "id": str(victim)})
    # every pg report must post-date the out epoch: stale pre-kill
    # active+clean reports would otherwise satisfy the wait at once
    code, _rs, data = await cl.command({"prefix": "status"})
    kill_epoch = json.loads(data)["epoch"] if code == 0 else 0
    await cl.wait_clean(timeout=900, min_epoch=kill_epoch)
    seconds = time.perf_counter() - t0
    dsec, dbytes = await _sum_decode_counters(admin_dir, survivors)
    launches = await sum_launches(socks)
    return {"write_s": write_s, "first_clean_s": clean_s,
            "seconds_to_clean": seconds, "bytes_written": total, "decode_seconds": dsec,
            "decode_bytes": dbytes, "batch": await sum_batch_stats(socks),
            # the survivors' kernel launches from the kill to clean
            "recovery_launches": {k: v - launches_before.get(k, 0)
                                  for k, v in launches.items() if v - launches_before.get(k, 0)}}


def bench_recovery(device, sizes: Sizes) -> dict:
    """Run A (the batched decode on ``device``, the encode farm on) and
    run B (the per-object host decode: the plugin's device path past
    2^40 bytes, the aggregator and the farm off) of the same scenario.
    Run A must decode in batches with no cold launch, run B launch no
    bit-matrix kernel from the kill to clean; its value is A's decode
    rate over B's."""
    runs = {}
    for name, extra, on in (("A", {"device-min-bytes": "4096"}, "on"),
                            ("B", {"device-min-bytes": str(1 << 40)}, "off")):
        r = asyncio.run(_recovery_scenario(extra, device, decode_batch=on, encode_farm=on))
        r["decode_gbs"] = r["decode_bytes"] / r["decode_seconds"] / 1e9 if r["decode_seconds"] else 0.0
        r["to_clean_gbs"] = r["bytes_written"] / r["seconds_to_clean"] / 1e9
        runs[name] = r
    a, b = runs["A"], runs["B"]
    if a["batch"].get("launches", 0) <= 0:
        raise AssertionError(f"run A decoded in no batch: {a['batch']}")
    if a["batch"].get("cold_launches", 0):
        raise AssertionError(f"run A's aggregators launched cold: {a['batch']}")
    if device.type == "cuda" and a["recovery_launches"].get("gf_bitmatmul", 0) <= 0:
        raise AssertionError(f"run A's recovery launched no batched decode: {a}")
    if any(name.startswith("gf_bitmatmul") for name in b["recovery_launches"]):
        raise AssertionError(f"run B's host decode launched on the card: {b['recovery_launches']}")
    ratio = a["decode_gbs"] / b["decode_gbs"] if b["decode_gbs"] else 0.0
    k, m = _bench_ec_profile()
    n_osds = recovery_osds()
    return _emit(
        f"e2e 1-OSD-down recovery, {n_osds} OSDs in worker processes, EC({k},{m}), "
        f"{a['bytes_written'] >> 20} MiB user data on {device_label(device)}: in-daemon "
        f"decode, batched ({a['decode_gbs'] * 1e3:.1f} MB/s, mean batch "
        f"{a['batch'].get('mean_batch', 0.0):.1f}) vs per-object host "
        f"({b['decode_gbs'] * 1e3:.1f} MB/s); to clean {a['seconds_to_clean']:.2f} s vs "
        f"{b['seconds_to_clean']:.2f} s", ratio, "x speedup", ratio / 10.0, device,
        osds=n_osds, k=k, m=m, runs=runs)


CONFIGS = {
    "jerasure_cpu": bench_jerasure_cpu,
    "decode": bench_decode,
    "clay_repair": bench_clay_repair,
    "_clay_cpu": bench_clay_cpu_probe,
    "decode_batch": bench_decode_batch,
    "scrub_verify": bench_scrub_verify,
    "remap": bench_remap,
    "recovery": bench_recovery,
}


def main(argv=None, sizes: Sizes | None = None) -> int:
    """Run the configs named in ``argv`` (default: every config whose
    name does not start with ``_``; ``clay_repair`` runs ``_clay_cpu``'s
    measurement itself).  Returns 1 if any config failed.  ``_osd_group``
    is the recovery config's worker process."""
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["_osd_group"]:
        return _osd_group_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("configs", nargs="*", help=f"any of {', '.join(CONFIGS)}")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, help="best-of repeats of host timings")
    ap.add_argument("--rounds", type=int, help="samples of the card's timed loops")
    ap.add_argument("--pause", type=float, help="seconds between those samples")
    args = ap.parse_args(argv)
    unknown = [n for n in args.configs if n not in CONFIGS]
    if unknown:
        ap.error(f"unknown configs {unknown}; choose from {list(CONFIGS)}")
    device = resolve_device(args.device)
    changes = {name: getattr(args, name) for name in ("reps", "rounds", "pause")
               if getattr(args, name) is not None}
    sizes = dataclasses.replace(sizes or Sizes.for_device(device), **changes)
    names = args.configs or [n for n in CONFIGS if not n.startswith("_")]
    failed = []
    for name in names:
        try:
            CONFIGS[name](device, sizes)
        except Exception as e:  # reported below; the run exits non-zero
            traceback.print_exc(file=sys.stderr)
            print(json.dumps({"metric": name, "error": f"{type(e).__name__}: {e}"}),
                  flush=True)
            failed.append(name)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())

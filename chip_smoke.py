#!/usr/bin/env python3
"""Drive ceph_tpu_torch's erasure-code data path on one NVIDIA GPU.

    python3 chip_smoke.py
    python3 chip_smoke.py --crush-lab      # the CRUSH lab line alone
    python3 chip_smoke.py --mgr-fold-lab   # the analytics and fold lab line alone

Builds the CUDA kernels from ``ceph_tpu_torch/ops/csrc`` (first use, one
``nvcc`` per source, all started together), then runs one RS(8,3) pool
through the port's entry points:

1. kernels — every kernel entry point against its plain PyTorch version
   on the card, and the plain version against the numpy GF(2^8) oracle
   or the native crc32c, at the main path's shapes plus a k=16 code, a
   k+m=256 code and a ragged S, and at every form of the bit-matrix
   kernel's launch plan (S where it changes columns per thread or starts
   to stride, batches of 1 and 8, m = 1, each instantiation forced);
   the batched crc32c at every bucket width, 1 and 32 lanes, some
   zero-padded; the re-encode compare clean, with one flipped byte and
   with every byte wrong; mismatched values must be 0;
2. write — 256 objects of 4 MiB and 16 of 2 MiB through
   ``registry.factory("cuda", ...)`` -> ``ecutil.encode`` + ``HashInfo``;
3. recover — lose the OSD of shard 2, then also shard 9; rebuild every
   object's lost shards with ``decode_shards_async`` through a prewarmed
   ``DecodeAggregator``; each rebuilt shard's crc32c must equal HashInfo;
4. degraded read — ``decode_concat`` with 1, 2 and 3 shards missing must
   return the written bytes;
5. scrub — deep-scrub every object, with the shards the last recover
   round rebuilt in place of the written ones, through a prewarmed
   ``ScrubVerifier`` in chunks of 25 objects verified concurrently
   (``osd_scrub_chunk_max``): every shard's crc32c must equal HashInfo
   and no parity may be flagged; then on copies of a few objects one
   flipped byte in a data shard and one in a parity shard must be
   flagged exactly as a host re-encode (``gf_matmul``) flags them;
6. remap — the whole-cluster PG remap (``BatchedClusterMapper``) of a
   1024-OSD map (128 hosts of 8, straw2) with three pools: replicated
   size 3 over 8192 PGs, EC 8+3 MSR over 2048 PGs, and EC 8+3 over
   2048 PGs on the indep rule the smoke's profile creates
   (``create_rule``); a first epoch, then epochs that each mark an OSD
   down and one out, reweight one, add upmap entries, a pg_temp, a
   primary_temp and primary affinities.  Every row of every pool must
   equal the scalar ``pg_to_up_acting_osds`` in the first and the last
   epoch (a sample in between), with one map upload and no pool on the
   scalar pipeline; then an ``UpmapBalancer`` pass;
7. throughput — the timed ``carry ^= encode(data ^ seed)`` loop of
   bench.py on (8, 256 MiB), and a 1-erasure decode at the same S;
8. plugins — every non-``jax`` profile of ``tests/golden/ec_kats.json``
   (isa, jerasure with its packet codes, shec, lrc, clay) on the card:
   the KAT payloads' chunks equal the golden bytes, then a 4 MiB object
   (past ``device_min_bytes``, so ``gf_bitmatmul.cu`` runs) encoded and
   decoded with 1 and up to m erasures, equal to the same plugin on
   ``device="cpu"``;
9. clay — a CLAY(8,4,11) pool (Ceph's default inner code,
   ``scalar_mds=jerasure``): 64 objects of 4 MiB, each one stripe, lose
   shard 3, then shard 9, and rebuild each object from the minimum
   sub-chunk reads twice, through ``ecutil.decode_shards(...,
   packed_repair=True)`` (the host traversal, its products through the
   inner codes) and through ``ClayRepairProgram`` (one ``clay_repair``
   launch per object), both equal to the lost shard; a 2-erasure
   degraded read through the layered decode; ``tools/bench_all.py``'s
   shape with ``scalar_mds=cuda`` (one 256 MiB stripe, 32 MiB chunks)
   repaired by the program, timed by CUDA events, and by the host
   traversal; two 4 MiB objects at the 4 KiB stripe unit rebuilt through
   ``ecutil`` (every inner solve below ``device_min_bytes``: no launch);
10. tools — the measurement twins of ``ceph_tpu_torch.tools`` driven
   through their ``main`` functions at the reference's widths with fewer
   repeats: ``perf_lab`` (the copy probes through ``row_copy``, encode
   chains, a tile sweep), ``perf_lab2`` (dispatch sweep, grouped launches,
   the four-stage ablation through ``gf_stage_cut``, the repeat variant),
   ``perf_lab3`` (``acc_encode`` loops), ``bench`` (the north-star acc
   loop), ``ec_benchmark`` (encode and an exhaustive decode for ``cuda``
   RS(8,3) and jerasure RS(4,2)) and ``bench_all``'s configs; their lines
   are parsed, checked and emitted.  Before it, each tools kernel is held
   against its plain version at the probe's shape and at ragged ones;
11. mgr analytics — at the mgr's configured store (16, 16, 32) and at the
   remap map's 1024 OSDs (1024, 16, 32): ``mgr_analytics.cu`` against its
   plain version on random stores (op latencies, the whole clamp range,
   full-range int64 with negatives, ties, one sample a metric, none;
   wrapped and negative cursors), also at (130, 3, 7), (1000, 2, 5),
   (20, 2, 40) (clusters of 2 and 8 with a ragged last block, odd and
   two-chunk windows), (3000, 2, 32) and (16, 2, 1000) (rows staged in
   global scratch), then 40 report rounds into a
   ``TimeSeriesStore``, an ``AnalyticsEngine`` prewarmed and four passes,
   each equal to ``analyze_numpy``, one launch a pass, no cold launch,
   the slow OSD flagged by ``analytics_summary``;
12. encode farm — 16 concurrent ``encode_async`` writers of 4 MiB objects
   through a prewarmed single-device ``EncodeService`` (fewer dispatches
   than ops, byte-equal to the host ``gf_matmul`` and to the per-op
   ``ecutil.encode``, GB/s beside it), again at 512 KiB and 64 KiB, then ``batch_encode_dp``, ``sharded_encode_tp`` (its partials
   folded by ``farm_fold.cu``) and the service's tp path for a lone
   request on a (2, 2) mesh of the one card, byte-equal to ``gf_matmul``;
   before it ``farm_fold.cu`` against its plain version at (2, 3, 524288),
   (4, 3, 524288), (8, 3, 524288), one partial, two ragged S, each also
   on a view that starts one byte into its buffer;
13. store — the card's shards persisted as an OSD persists them: 64
   objects of 4 MiB encoded through ``registry.factory("cuda", ...)`` ->
   ``ecutil.encode`` + ``HashInfo``, each of the 11 shards written with
   one ``Transaction`` (``coll_t(pool, ps, shard)``,
   ``ghobject_t(oid, shard=shard)``, the bytes and a ``hinfo`` xattr)
   into the ``BlockStore`` of its OSD, each on its own ``FileDB``, in a
   temporary directory removed at the end; every store unmounted and
   mounted again with a clean ``fsck()``; every shard and hinfo read back
   equal; the read-back shards deep-scrubbed through a prewarmed
   ``ScrubVerifier`` in chunks of 25 (crc == the stored HashInfo, no
   parity flagged); shard 2's store lost (unmounted, its directory
   removed) and rebuilt with ``decode_shards_async`` through a prewarmed
   ``DecodeAggregator`` into a fresh store, remounted and read back equal;
   a ``bitflip`` data fault armed through ``FAULTS`` on ``osd.5``: the next
   read of that object answers EIO, fsck finds the blob, and
   ``decode_concat`` without that shard returns the object.

Phase 1 also holds the CRUSH kernel against its plain version and the
scalar ``crush_do_rule``: each pool's rule at 1 seed, 1000 seeds and the
whole pool, all in and with zero and partial reweights; a device-class
rule, a choose_args weight set, one past 2^32 (against the plain version
alone) and legacy tunables; and the CLAY repair
kernel against its plain version for every lost node of CLAY(4,2,5),
(8,4,11), (8,3,10) and (4,5,8) at the 4 MiB object's sub-chunk, at a
ragged sub-chunk and at the 32 MiB-chunk shape.  The re-encode compare
is also held at a ragged S at batch 1, at more batch entries than the
card has SMs (one block an entry) and for a wide code.

Kernel launch counts are reset just before phases 2-7 and read just
after; every kernel of that path must have been launched there.  They
are reset again before phases 8-9 and read after: ``clay_repair`` and
the bit-matrix kernel must have been launched there; and again before
phase 10: ``row_copy``, the three stage cuts of ``gf_stage_cut``,
``repeat_variant`` and ``acc_encode`` must have been launched there
(``cuobjdump -sass`` then counts the global loads of each instantiation
of the bit-matrix kernel, the cuts' included); after each mgr shape's
prewarm and again after its passes: ``mgr_analytics`` once a pass;
before and after phase 12: ``farm_fold`` and the bit-matrix kernel; and
before and after phase 13, and around each of its steps: the bit-matrix
kernel at the encode and at the rebuild, the crc and the compare at the
scrub, the scrub's and the decode's prewarms counted apart (the
``store_path_launches`` line, with the launches of each step).  A
``wall`` line gives the smoke's seconds from the build to the kernel
rows and the store path's share of them.  Then a
torch.profiler pass over phases 2-6 gives the device's busy and idle
share, the main path's memset µs, and the device time per launch at
each kernel's main-path shape (and at each forced width of the launch
plan); each kernel is timed
there by CUDA events and held there against its plain version (a CRUSH
row also gives its launch: warps per block and blocks); the tools
kernels likewise at their probes' shapes.  Each
phase prints one JSON line; then a ``kernels`` line, the card's name
and power limit, and last ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; with no CUDA device it exits 1
before doing anything.

After the kernel rows are measured, a ``crc_sweep`` line holds the crc
kernel against its plain version over the scrub path's lane counts and
widths and two throughput shapes, with device µs a launch, CUDA-event
ms, device operations a call and the byte bound of each; an
``mgr_staged`` line gives the analytics kernel's staged instantiation
(rows in global scratch) at (3000, 2, 32) and (16, 2, 1000) on latency
and clamp-range stores; a ``fold_sweep`` line does the same for the fold
at its four shapes (n = 2, 4 and 8, and a ragged S), beside
``torch.bitwise_xor`` in device µs and ms at n = 2.  The
``mgr_analytics:*`` kernel rows also give the device µs on clamp-range
stores, the ``farm_fold`` row the library call's device µs.

``--crush-lab`` builds the kernels and prints only a ``crush_lab`` line:
the CRUSH kernels launched directly at the main path's shapes, in turns
with a build of ``crush_rule.cu`` whose draws use nvcc's emulated 64-bit
division (the yardstick of its FP64-reciprocal division), and over a
sweep of seed counts (where a launch stops being latency-bound).  The
smoke itself does not run it.

``--mgr-fold-lab`` builds the analytics and fold kernels only and prints
only an ``mgr_fold_lab`` line (each kernel held against its plain version
first): the analytics kernel at the mgr shapes and the staged shapes on
latency and clamp-range stores, the fold at every shape and on
odd-offset views, beside ``torch.bitwise_xor``.  It uses only what the
wrappers of earlier trees also take, so an A/B runs this script from the
root of each tree (``_archive/parent``) in one call.
"""

from __future__ import annotations

import asyncio
import contextlib
import ctypes
import dataclasses
import errno
import hashlib
import io
import json
import os
import pathlib
import re
import statistics
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from ceph_tpu_torch import native
from ceph_tpu_torch.common.fault_injector import FAULTS
from ceph_tpu_torch.crush import builder as crush_builder
from ceph_tpu_torch.crush import cudamapper as cm
from ceph_tpu_torch.crush import mapper as crush_mapper
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    ChooseArg,
    CrushMap,
    Tunables,
)
from ceph_tpu_torch.ec import ECError, registry
from ceph_tpu_torch.kv import FileDB
from ceph_tpu_torch.ec.plugins import clay_cuda
from ceph_tpu_torch.ec.plugins.clay_cuda import ClayRepairProgram
from ceph_tpu_torch.mgr import analytics as mgr_analytics
from ceph_tpu_torch.mgr import daemon as mgr_daemon
from ceph_tpu_torch.models.matrices import decode_matrix_for, isa_cauchy_matrix
from ceph_tpu_torch.ops import analytics_kernels as ak
from ceph_tpu_torch.ops import hashing
from ceph_tpu_torch.ops import lab_kernels as lk
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.ops.gf256 import gf_matmul, gf_matrix_to_bitmatrix
from ceph_tpu_torch.osd import ecutil, remap
from ceph_tpu_torch.osd.balancer import UpmapBalancer
from ceph_tpu_torch.osd.osdmap import OSDMap
from ceph_tpu_torch.osd.types import FLAG_HASHPSPOOL, PgPool, PoolType, pg_t
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from ceph_tpu_torch.parallel.encode_farm import Mesh, batch_encode_dp, sharded_encode_tp
from ceph_tpu_torch.parallel.encode_service import EncodeService
from ceph_tpu_torch.parallel.scrub_batcher import ScrubVerifier
from ceph_tpu_torch.store import Transaction, coll_t, ghobject_t
from ceph_tpu_torch.store.blockstore import BlobError, BlockStore
from ceph_tpu_torch.tools import bench as t_bench
from ceph_tpu_torch.tools import bench_all as t_bench_all
from ceph_tpu_torch.tools import ec_benchmark as t_ec_benchmark
from ceph_tpu_torch.tools import perf_lab as t_perf_lab
from ceph_tpu_torch.tools import perf_lab2 as t_perf_lab2
from ceph_tpu_torch.tools import perf_lab3 as t_perf_lab3

#: NVIDIA H100 SXM data sheet: HBM3 rate and dense int8 tensor-core rate
PEAK_BYTES_PER_S = 3.35e12
PEAK_INT8_OPS_PER_S = 1979e12
#: H100 SXM: 132 SMs of 64 INT32 lanes at the 1.98 GHz boost clock
PEAK_INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: the least integer work of one straw2 draw, counted from the function
#: (bucket_straw2_choose) with each op one fused instruction (IADD3 for
#: a - b - c, LOP3 for a three-input logic op, IMAD for a product plus a
#: sum, LEA for a shift plus a sum):
#: - the hash, 137: 5 Jenkins mixes of 9 statements a = (a - b - c) ^
#:   (c >> k) at 3 ops (IADD3, SHF, LOP3), the item id's xor into the
#:   seed's (hoisted out of the bucket's loop) and the 16-bit mask;
#: - crush_ln, 18: the increment, the clz test, clz, shift and exponent,
#:   the table index and its address, the 32 x 64-bit product's two IMADs,
#:   its byte, the second address, the 64-bit sum and shift, the exponent;
#: - the numerator 2^48 - ln, 2;
#: - the division's integer part, 9: q * w (three IMADs), the remainder,
#:   its compare with w and the increment;
#: - the zero-weight test, 2; keeping the larger draw, 5 (a 64-bit
#:   compare, three selects); the weight's and id's addresses, 2.
#: The loop's own counter is left out.  The division's quotient estimate
#: runs on the FP64 pipe (two conversions at 16 a clock per SM, one product
#: at 64; 1/w is the map's, not the draw's): 0.14 clocks a draw per SM
#: beside the 2.73 of this count, so it does not raise the bound.
INT32_OPS_PER_DRAW = 137 + 18 + 2 + 9 + 2 + 5 + 2

MiB = 1 << 20
GF_SOURCE = "ceph_tpu_torch/ops/csrc/gf_bitmatmul.cu"
CRC_SOURCE = "ceph_tpu_torch/ops/csrc/crc32c_lanes.cu"
CRUSH_SOURCE = "ceph_tpu_torch/ops/csrc/crush_rule.cu"
CLAY_SOURCE = "ceph_tpu_torch/ops/csrc/clay_repair.cu"
COPY_SOURCE = "ceph_tpu_torch/ops/csrc/lab_copy.cu"
#: the stage cuts of the ablation probe with a mode of their own ("full"
#: is the store)
CUT_STAGES = ("load", "extract", "matmul")
#: the CRUSH entry points, by rule kind
CRUSH_ENTRIES = {"firstn": "crush_rule_firstn", "indep": "crush_rule_indep",
                 "msr": "crush_rule_msr"}
#: each entry point and the TPU kernel (or jitted XLA code) it replaces
REPLACES = {
    "gf_bitmatmul_pallas": "ceph_tpu/ops/rs_kernels.py:276",
    "gf_bitmatmul_pallas_grouped": "ceph_tpu/ops/rs_kernels.py:230",
    "gf_bitmatmul_pallas_acc": "ceph_tpu/ops/rs_kernels.py:327",
    "gf_bitmatmul": "ceph_tpu/ops/rs_kernels.py:59",
    "gf_encode_compare": "ceph_tpu/ops/rs_kernels.py:73",
    "batched_crc32c_device": "ceph_tpu/ops/hashing.py:376",
    **{name: "ceph_tpu/crush/jaxmapper.py:1015" for name in CRUSH_ENTRIES.values()},
    "clay_repair": "ceph_tpu/ec/plugins/clay_jit.py:69",
}
#: each entry point's kernel source and the kernel's name in a trace
KERNELS = {name: (GF_SOURCE, "gf_bitmatmul_kernel") for name in REPLACES}
KERNELS["gf_encode_compare"] = (GF_SOURCE, "gf_encode_compare_kernel")
KERNELS["batched_crc32c_device"] = (CRC_SOURCE, "crc32c_lanes_kernel")
KERNELS.update({name: (CRUSH_SOURCE, f"{name}_kernel") for name in CRUSH_ENTRIES.values()})
KERNELS["clay_repair"] = (CLAY_SOURCE, "clay_repair_kernel")
#: why no PyTorch call is timed beside each kernel
NO_LIBRARY = {name: "no PyTorch call computes a GF(2^8) bit-matrix product"
              for name in REPLACES}
NO_LIBRARY["batched_crc32c_device"] = "no PyTorch call computes crc32c"
NO_LIBRARY.update({name: "no PyTorch call computes CRUSH placement"
                   for name in CRUSH_ENTRIES.values()})
NO_LIBRARY["clay_repair"] = "no PyTorch call computes a GF(2^8) linear combination"
#: the PyTorch call timed beside each tools kernel, or why there is none
TOOL_LIBRARY = {
    "row_copy:copy_fn": "src[:rows].clone()", "row_copy:fat_copy": "src[:rows].clone()",
    "gf_stage_cut:load": "d[:m].clone(), which reads m of the k rows the probe reads "
                         "(tools/perf_lab2.py:81)",
    "gf_stage_cut:extract": "torch.bitwise_and(d[:m], 1), which reads m of the k rows the "
                            "probe reads (tools/perf_lab2.py:81)",
    "gf_stage_cut:matmul": "no PyTorch call computes a GF(2^8) bit-matrix product",
    "repeat_variant": "no PyTorch call computes a GF(2^8) bit-matrix product",
    "acc_encode": "no PyTorch call computes a GF(2^8) bit-matrix product",
}
#: the golden chunk bytes of every plugin profile (tools/gen_ec_golden.py)
GOLDEN = "tests/golden/ec_kats.json"
#: CLAY: the phase-1 geometries (every lost node of each; (4, 5, 8) has
#: q = 5, 25 sub-chunks) and ragged sub-chunk; the pool's lost shards,
#: one at a time, and the shards its degraded read goes without
CLAY_GEOMETRIES = ((4, 2, 5), (8, 4, 11), (8, 3, 10), (4, 5, 8))
CLAY_RAGGED_SC = 4096 + 13
CLAY_LOST = (3, 9)
CLAY_DEGRADED = (3, 9)


@dataclasses.dataclass
class Config:
    """The smoke's pool.  RS(8,3) ISA Cauchy (the JAX plugin's default),
    stripe unit 4096 B (osd/pgutil.py STRIPE_UNIT, Ceph's
    osd_pool_erasure_code_stripe_unit default), 4 MiB objects (RBD's and
    RGW's default object size).  Reduced: one PG's worth of 1 GiB (256
    objects) instead of a PG's tens of GB."""
    k: int = 8
    m: int = 3
    technique: str = "cauchy"
    stripe_unit: int = 4096
    object_bytes: int = 4 * MiB
    objects: int = 256
    small_object_bytes: int = 2 * MiB
    small_objects: int = 16
    lost: tuple = ((2,), (2, 9))
    degraded: tuple = ((2,), (2, 9), (2, 5, 9))
    kernel_cols: int = 1 * MiB
    oracle_cols: int = 1 * MiB
    batch_cols: int = 65536      # the aggregator's widest bucket
    wide_cols: int = 65536
    throughput_cols: int = 256 * MiB
    fold_cols: int = 256 * 1024
    #: S where the launch plan changes form (columns per thread, grid
    #: cap), one ragged; and the batched widths at batch 1 and 8
    plan_cols: tuple = (16, 4096, 65536, 262144, 524288, 262144 + 13,
                        3 << 19, 8 << 20)
    plan_batch_cols: tuple = (4096, 65536)
    #: the scrub verifier's bucket widths, for the crc and compare cases
    crc_cols: tuple = (4096, 8192, 16384, 32768, 65536)
    compare_cols: tuple = (4096, 65536)
    #: objects verified concurrently (osd_scrub_chunk_max), and objects
    #: corrupted on copies
    scrub_chunk: int = 25
    scrub_corrupt: int = 3
    crc_lanes: int = 32
    #: the crc sweep: (lanes, width) at the scrub path's lane counts and
    #: bucket widths, then two throughput shapes
    crc_sweep: tuple = ((1, 4096), (1, 16384), (1, 65536), (32, 4096), (32, 16384),
                        (32, 65536), (256, 65536), (32, 1 << 20))
    #: the remap map: tools/bench_all.py:_big_map (BASELINE.md's "10k PGs
    #: x 1024-OSD map") plus a pool on the profile's create_rule rule
    remap_hosts: int = 128
    remap_osds_per_host: int = 8
    remap_rep_pgs: int = 8192
    remap_ec_pgs: int = 2048
    #: epochs after the first, each with OSD, weight and table changes;
    #: PGs a pool checked against the scalar pipeline in the middle ones
    remap_epochs: int = 3
    remap_sample: int = 256
    #: seeds of the phase-1 CRUSH cases besides the whole pool
    crush_seeds: tuple = (1, 1000)
    balancer_swaps: int = 64
    #: CLAY: the pool, CLAY(8,4,11) as tools/bench_all.py runs it, with
    #: one stripe per object (512 KiB chunks, 8 KiB sub-chunks)
    clay_objects: int = 64
    clay_object_bytes: int = 4 * MiB
    clay_degraded_objects: int = 8
    #: tools/bench_all.py's chunk (one stripe of 8 x 32 MiB), its timed
    #: repeats, and objects at the OSD's default stripe unit
    clay_big_chunk: int = 32 * MiB
    clay_big_repeats: int = 10
    clay_small_objects: int = 2
    #: objects of the profile pass's traced CLAY rebuild
    clay_traced_objects: int = 8
    #: objects of the plugins phase, each one stripe
    plugin_object_bytes: int = 4 * MiB
    #: the tools path: the probes' own shapes (tools/perf_lab*.py): an
    #: (8, 64 MiB) input, the fat copy's (1024, 512 Ki) -> 384 rows, the
    #: acc loop's (8, 256 MiB); a ragged S for the checks
    tools_cols: int = 64 * MiB
    fat_rows: int = 1024
    fat_keep: int = 384
    fat_cols: int = 512 * 1024
    acc_cols: int = 256 * MiB
    tools_ragged_cols: int = MiB + 13
    tools_calls: int = 16
    #: the twins' arguments: the reference's widths, fewer repeats
    perf_lab_args: tuple = ("--calls", "4", "--reps", "2")
    perf_lab2_args: tuple = ("--calls", "8", "--reps", "2")
    perf_lab3_args: tuple = ("--reps", "2")
    bench_args: tuple = ("--rounds", "3", "--pause", "0")
    ec_bench_size: int = 4 * MiB
    ec_bench_iterations: int = 16
    bench_all_args: tuple = ("--reps", "1", "--rounds", "2", "--pause", "0")
    #: (field, value) changes to bench_all's sizes for the device
    bench_all_sizes: tuple = ()
    #: the mgr's store: its configured (mgr_stats_max_daemons,
    #: mgr_stats_max_metrics, mgr_stats_window) and the remap map's 1024
    #: OSDs; report rounds (more than the window: rings wrap) and passes
    mgr_shapes: tuple = ((16, 16, 32), (1024, 16, 32))
    #: more stores for the kernel's checks alone: clusters of 2 and 8 with
    #: a ragged last block and odd windows, a window of two 32-column
    #: chunks a row, and two stores whose rows do not fit a block's shared
    #: memory (staged in global scratch): 3000 daemons, and a window of 1000
    mgr_check_shapes: tuple = ((130, 3, 7), (1000, 2, 5), (20, 2, 40), (3000, 2, 32),
                               (16, 2, 1000))
    mgr_reports: int = 40
    mgr_passes: int = 4
    #: the encode farm: concurrent writers of the write phase's objects,
    #: the mesh of the one card, and the fold's (n, m, S): the tp path's
    #: two partials of a 4 MiB object's rows, four, and a ragged S
    farm_writers: int = 16
    #: smaller objects the service and the per-op path also write (the
    #: service's single-device gate is read from where it wins), and the
    #: timed runs of each path a size, interleaved
    farm_sweep_bytes: tuple = (64 * 1024, 512 * 1024)
    farm_reps: int = 3
    farm_mesh: tuple = (2, 2)
    fold_shapes: tuple = ((2, 3, 524288), (4, 3, 524288), (2, 3, 524288 + 13), (8, 3, 524288))
    #: more folds for the kernel's checks alone: one partial, and a ragged
    #: S of another residue; every fold is also checked on a view that
    #: starts one byte into its buffer (no partial aligned to 16)
    fold_check_shapes: tuple = ((1, 3, 524288), (3, 3, 524288 + 7))
    #: the analytics stores timed in the staged instantiation (rows in
    #: global scratch): the check shapes past 2632 daemons and past a
    #: window of 701
    mgr_staged_shapes: tuple = ((3000, 2, 32), (16, 2, 1000))
    #: the store path: objects of the write phase's size, each shard in the
    #: BlockStore of its OSD; the profile's device-min-bytes where it is
    #: not the plugin's
    store_objects: int = 64
    store_object_bytes: int = 4 * MiB
    store_device_min_bytes: int | None = None
    iters: int = 32
    repeats: int = 5
    seed: int = 20261016

    def profile(self) -> dict:
        return {"k": str(self.k), "m": str(self.m), "technique": self.technique}


def emit(obj: dict) -> None:
    print(json.dumps(obj), flush=True)


def _rand(shape, gen: torch.Generator, device) -> torch.Tensor:
    return torch.randint(0, 256, shape, dtype=torch.uint8, device=device,
                         generator=gen)


def _wide(t: torch.Tensor) -> torch.Tensor:
    """int64 copy of a uint8, bool or uint32 tensor, values unchanged."""
    if t.dtype == torch.uint32:
        return t.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return t.to(torch.int64)


def _errors(a: torch.Tensor, b: torch.Tensor) -> tuple[int, int]:
    """(mismatched values, largest absolute difference)."""
    assert a.shape == b.shape, (a.shape, b.shape)
    diff = (_wide(a) - _wide(b)).abs()
    return int((diff != 0).sum()), int(diff.max()) if diff.numel() else 0


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _bound(nbytes: int, ops: int) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / PEAK_BYTES_PER_S, ops / PEAK_INT8_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations")


def bound_ms(k: int, m: int, cols: int, *, carry: bool = False) -> tuple[float, str]:
    """Least time for one product: (k + m) S bytes moved ((k + 2m) S for
    the acc form, which also reads the carry; the compare reads the same
    bytes and writes a flag a row) over the HBM rate, or
    2 * 8m * 8k * S operations over the int8 tensor-core rate."""
    return _bound((k + (2 if carry else 1) * m) * cols, 2 * (8 * m) * (8 * k) * cols)


def crush_bound_ms(draws: int) -> tuple[float, str]:
    """Least time for a batch of placements: the straw2 draws its seeds
    need (counted by the scalar mapper) at ``INT32_OPS_PER_DRAW`` integer
    instructions each over the card's INT32 rate.  The bytes (a 0.3 MB
    map, 4 B a seed in, 4 B a result out) are far below."""
    return draws * INT32_OPS_PER_DRAW / PEAK_INT32_OPS_PER_S * 1e3, "operations"


def clay_bounds_ms(sched, sc: int) -> dict:
    """Least time for one CLAY repair, both ways: the helpers read once
    and the chunk written once, (n_helpers * P + sub_chunk_no) * sc bytes
    over the HBM rate (the kernel keeps U in registers: no scratch); and
    the repair's GF(2^8) products, each term of the schedule with a
    nonzero coefficient as an 8x8 bit-matrix product of every byte
    (2 * 8 * 8 operations), over the int8 tensor-core rate, as
    ``bound_ms`` counts the EC products."""
    terms = (np.count_nonzero(sched.a_c) + np.count_nonzero(sched.b_c)
             + sched.P * np.count_nonzero(sched.d)
             + np.count_nonzero(sched.c_h) + np.count_nonzero(sched.c_u))
    nbytes = (sched.n_helpers * sched.P + sched.sub_chunk_no) * sc
    ops = 2 * 8 * 8 * int(terms) * sc
    bms, by = _bound(nbytes, ops)
    return {"bytes_ms": nbytes / PEAK_BYTES_PER_S * 1e3,
            "operations_ms": ops / PEAK_INT8_OPS_PER_S * 1e3, "bound_ms": bms, "bound_by": by}


def crc_bound_ms(lanes: int, width: int) -> tuple[float, str]:
    """Least time for one batched crc32c: the lanes read and a word each
    written, or the (32, 8W) GF(2) product per lane at the int8
    tensor-core rate (2 * 32 * 8W operations a lane)."""
    return _bound(lanes * (width + 4), 2 * 32 * 8 * width * lanes)


# ---------------------------------------------------------------------------
# Phase 1: every kernel against its plain version
# ---------------------------------------------------------------------------

def phase_kernels(cfg: Config, device) -> dict[str, int]:
    """Returns the largest absolute byte error per entry point."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed)
    worst = {name: 0 for name in REPLACES}
    cases = []

    def check(name: str, got: torch.Tensor, want: torch.Tensor, case: str) -> None:
        bad, err = _errors(got, want)
        if name in worst:
            worst[name] = max(worst[name], err)
        cases.append({"case": case, "entry": name, "mismatched_bytes": bad})
        if bad:
            raise AssertionError(f"{case}: {name} differs from its plain "
                                 f"version in {bad} bytes")

    def two_d(case: str, C: np.ndarray, bits: torch.Tensor, data: torch.Tensor) -> None:
        s = data.shape[1]
        want = rk.gf_bitmatmul_plain(bits, data)
        # the plain version against the numpy oracle on a leading slice
        # (narrower for wide codes: the oracle holds m*k*n products)
        n = min(s, cfg.oracle_cols * 32 // C.size)
        oracle = gf_matmul(C, data[:, :n].cpu().numpy())
        bad = int((want[:, :n].cpu().numpy() != oracle).sum())
        cases.append({"case": case, "entry": "plain_vs_numpy", "mismatched_bytes": bad})
        if bad:
            raise AssertionError(f"{case}: plain version differs from numpy in {bad} bytes")
        tile = rk._pick_tile(s) or 1
        check("gf_bitmatmul_pallas",
              rk.gf_bitmatmul_pallas(bits, data, tile_s=tile), want, case)
        for g in (2, 4, 8):
            if tile // g >= 16 and s % tile == 0:
                check("gf_bitmatmul_pallas_grouped",
                      rk.gf_bitmatmul_pallas_grouped(bits, data, tile_s=tile // g, groups=g),
                      want, f"{case} g={g}")
        check("gf_bitmatmul", rk.gf_bitmatmul(bits, data[None])[0], want, case)
        carry = _rand(want.shape, gen, device)
        want_acc = carry ^ rk.gf_bitmatmul_plain(bits, data ^ 5)
        check("gf_bitmatmul_pallas_acc",
              rk.gf_bitmatmul_pallas_acc(bits, data, carry, 261, tile_s=tile),
              want_acc, f"{case} seed=261")

    k, m, s = cfg.k, cfg.m, cfg.kernel_cols
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device)
    data = _rand((k, s), gen, device)
    two_d(f"encode RS({k},{m}) S={s}", codec.C, codec.encode_bits, data)
    full = torch.cat([data, codec.encode(data)])
    for erasures in cfg.degraded:
        survivors, dbits = codec.decode_bits(erasures)
        D = decode_matrix_for(codec.C, list(erasures))
        sub = full[survivors].contiguous()
        two_d(f"decode {len(erasures)}-erasure {erasures} S={s}", D, dbits, sub)
        # erasures in unsorted order come back in the requested order
        order = tuple(reversed(erasures))
        check("codec.decode", codec.decode(full, order), full[list(order)],
              f"decode {order} round trip")
    # the aggregator's batched launch shape
    for erasures in cfg.lost:
        _, dbits = codec.decode_bits(erasures)
        batch = _rand((8, k, cfg.batch_cols), gen, device)
        check("gf_bitmatmul", rk.gf_bitmatmul(dbits, batch),
              rk.gf_bitmatmul_plain(dbits, batch),
              f"batched (8, {k}, {cfg.batch_cols}) {erasures}")
    # a k=16 code, a k+m=256 code (131 KB of masks), and a ragged S
    c16 = rk.BitmatrixCodec(isa_cauchy_matrix(16, 4), device=device)
    two_d(f"encode RS(16,4) S={s}", c16.C, c16.encode_bits, _rand((16, s), gen, device))
    cw = rk.BitmatrixCodec(isa_cauchy_matrix(128, 128), device=device)
    two_d(f"encode RS(128,128) S={cfg.wide_cols}", cw.C, cw.encode_bits,
          _rand((128, cfg.wide_cols), gen, device))
    two_d(f"encode RS({k},{m}) ragged S={s + 13}", codec.C, codec.encode_bits,
          _rand((k, s + 13), gen, device))
    plans = phase_kernel_plans(cfg, device, gen, codec, check)
    phase_kernel_scrub(cfg, device, gen, check)
    phase_kernel_crush(cfg, device, check)
    phase_kernel_clay(cfg, device, gen, check)
    _sync(device)
    emit({"phase": "kernels", "cases": len(cases),
          "mismatched_bytes": sum(c["mismatched_bytes"] for c in cases),
          "worst": worst, "plans": plans})
    return worst


def phase_kernel_scrub(cfg: Config, device, gen, check) -> None:
    """The scrub kernels.  The batched crc32c at each bucket width with 1
    and ``crc_lanes`` lanes, every other lane's tail zero-padded as the
    verifier pads short lanes, against its plain version and the native
    crc32c.  The re-encode compare for m = 3 and m = 1 at batches 1 and 8
    of each width of ``compare_cols`` and at a ragged S at batches 1 and
    8: clean, one parity byte flipped, one data byte flipped, every
    parity byte wrong (every thread sets a flag), against its plain
    version, and the plain version against the flags expected; 160
    entries of the narrowest width (more than the SMs: one block an entry,
    no slots); a wide code (packed masks, rows past the four loaded early,
    four row groups)."""
    for w in cfg.crc_cols:
        for b in (1, cfg.crc_lanes):
            x = _rand((b, w), gen, device)
            for j in range(0, b, 2):
                x[j, w - (j * 4099 + 13) % w:] = 0
            case = f"crc ({b}, {w})"
            plain = hashing.batched_crc32c_plain(x)
            check("batched_crc32c_device", hashing.batched_crc32c_device(x), plain, case)
            host = torch.tensor([native.crc32c(row, 0) for row in x.cpu().numpy()],
                                dtype=torch.int64)
            check("plain_vs_native", _wide(plain).cpu(), host, case)
    # lanes that start off a 16-byte boundary (the byte loads), and lanes
    # twice the widest bucket (eight blocks a lane at 131072)
    w, wide = cfg.crc_cols[0], 2 * max(cfg.crc_cols)
    flat = _rand((3 * w + 1,), gen, device)
    for case, x in ((f"crc (3, {w}) misaligned", flat[1:].view(3, w)),
                    (f"crc (2, {wide})", _rand((2, wide), gen, device))):
        check("batched_crc32c_device", hashing.batched_crc32c_device(x),
              hashing.batched_crc32c_plain(x), case)
    k = cfg.k
    for m in (cfg.m, 1):
        bits = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device).encode_bits
        shapes = [(b, s) for b in (1, 8) for s in cfg.compare_cols]
        for b, s in shapes + [(8, cfg.compare_cols[0] + 13), (1, cfg.compare_cols[0] + 13),
                              (160, cfg.compare_cols[0])]:
            data = _rand((b, k, s), gen, device)
            parity = rk.gf_bitmatmul_plain(bits, data)
            pflip, dflip = parity.clone(), data.clone()
            pflip[b - 1, m - 1, s // 2] ^= 1
            dflip[0, k - 1, s - 1] ^= 0x80
            none = torch.zeros((b, m), dtype=torch.bool, device=device)
            want_p, want_d = none.clone(), none.clone()
            want_p[b - 1, m - 1] = True
            want_d[0] = True  # Cauchy: every parity row reads every data byte
            for what, d, p, flags in (("clean", data, parity, none),
                                      ("parity flip", data, pflip, want_p),
                                      ("data flip", dflip, parity, want_d),
                                      ("all wrong", data, parity ^ 0xFF, ~none)):
                case = f"compare {what} ({b}, {k}, {s}) m={m}"
                plain = rk.gf_encode_compare_plain(bits, d, p)
                check("gf_encode_compare", rk.gf_encode_compare(bits, d, p), plain, case)
                check("plain_vs_expected", plain, flags, case)
    wide = rk.BitmatrixCodec(isa_cauchy_matrix(128, 128), device=device).encode_bits
    data = _rand((2, 128, cfg.compare_cols[0]), gen, device)
    parity = rk.gf_bitmatmul_plain(wide, data)
    parity[1, 77, 5] ^= 4
    for what, p in (("one flip", parity), ("all wrong", parity ^ 0xFF)):
        check("gf_encode_compare", rk.gf_encode_compare(wide, data, p),
              rk.gf_encode_compare_plain(wide, data, p),
              f"compare {what} (2, 128, {cfg.compare_cols[0]}) m=128")


def clay_code(k: int, m: int, d: int, device, scalar_mds: str = "jerasure"):
    return registry.factory("clay", {"k": str(k), "m": str(m), "d": str(d),
                                     "scalar_mds": scalar_mds}, device=device)


def clay_program(ec, chunk: int, device) -> ClayRepairProgram:
    """The repair program of chunk id ``chunk``."""
    return ClayRepairProgram(ec, clay_cuda.chunk_node(ec, chunk), device=device)


def staged_random(prog: ClayRepairProgram, sc: int, gen, device) -> torch.Tensor:
    """Random staged helpers (n_helpers, P, sc), the shortened nodes as
    the zero rows ``stage`` lays out."""
    H = _rand((prog.schedule.n_helpers, prog.schedule.P, sc), gen, device)
    H[prog.shortened] = 0
    return H


def phase_kernel_clay(cfg: Config, device, gen, check) -> None:
    """The CLAY repair kernel against its plain version: every lost node
    of each geometry of ``CLAY_GEOMETRIES`` at the sub-chunk of a
    ``clay_object_bytes`` object written as one stripe; for CLAY(8,4,11)
    lost node 3 also a ragged sub-chunk (``repair_device`` directly) and
    tools/bench_all.py's 32 MiB chunk."""
    for k, m, d in CLAY_GEOMETRIES:
        ec = clay_code(k, m, d, device)
        sc = ec.get_chunk_size(cfg.clay_object_bytes) // ec.sub_chunk_no
        scs = [sc]
        for lost in range(k + m):
            prog = clay_program(ec, lost, device)
            if (k, m, d) == (8, 4, 11) and lost == 3:
                scs = [sc, CLAY_RAGGED_SC, cfg.clay_big_chunk // ec.sub_chunk_no]
            for width in scs:
                H = staged_random(prog, width, gen, device)
                check("clay_repair", prog.repair_device(H),
                      clay_cuda.clay_repair_plain(H, prog.schedule),
                      f"clay({k},{m},{d}) lost {lost} H {tuple(H.shape)}")
            scs = [sc]


def remap_map(cfg: Config, device) -> OSDMap:
    """The remap phase's cluster: ``remap_hosts`` hosts of
    ``remap_osds_per_host`` OSDs (straw2, rjenkins1, all up and in) under
    one root; pool 1 replicated size 3 on ``chooseleaf firstn host``,
    pool 2 EC k+m on the MSR rule of k+m hosts x 1 OSD, pool 3 EC k+m
    (min_size k+1, Ceph's default) on the indep rule that the smoke's
    ``cuda`` profile creates with ``crush-failure-domain=host``."""
    crush = CrushMap()
    crush_builder.build_hierarchy(crush, osds_per_host=cfg.remap_osds_per_host,
                                  n_hosts=cfg.remap_hosts)
    om = OSDMap(crush=crush)
    for osd in range(cfg.remap_hosts * cfg.remap_osds_per_host):
        om.new_osd(osd, weight=0x10000, up=True)
    root, fd = crush.bucket_names["default"], crush.type_id("host")
    n = cfg.k + cfg.m
    rep = crush_builder.add_simple_rule(crush, root, fd, mode="firstn")
    msr = crush_builder.add_osd_multi_per_domain_rule(crush, root, fd, num_per_domain=1,
                                                      num_domains=n)
    ec = registry.factory("cuda", {**cfg.profile(), "crush-failure-domain": "host"},
                          device=device)
    ec_rule = ec.create_rule("ecpool", crush)
    om.pools[1] = PgPool(id=1, type=PoolType.REPLICATED, size=3, min_size=2, crush_rule=rep,
                         pg_num=cfg.remap_rep_pgs, pgp_num=cfg.remap_rep_pgs)
    om.pools[2] = PgPool(id=2, type=PoolType.ERASURE, size=n, min_size=cfg.k, crush_rule=msr,
                         pg_num=cfg.remap_ec_pgs, pgp_num=cfg.remap_ec_pgs)
    om.pools[3] = PgPool(id=3, type=PoolType.ERASURE, size=n, min_size=cfg.k + 1,
                         crush_rule=ec_rule, pg_num=cfg.remap_ec_pgs, pgp_num=cfg.remap_ec_pgs,
                         erasure_code_profile="ecpool")
    om.pool_names.update({1: "rbd", 2: "ec-msr", 3: "ecpool"})
    return om


def pool_seeds(pool: PgPool) -> np.ndarray:
    """Every PG's placement seed (pps) of a pool, as the remap hashes them."""
    return np.array([pool.raw_pg_to_pps(pg_t(pool.id, ps)) for ps in range(pool.pg_num)],
                    dtype=np.uint32)


def _crush_rows(vals: torch.Tensor, counts: torch.Tensor) -> torch.Tensor:
    """(B, result_max + 1): the placements and the count, one tensor."""
    return torch.cat([vals, counts[:, None]], dim=1)


def _scalar_rows(crush, ruleno: int, xs: np.ndarray, rm: int, weights,
                 choose_args=None) -> torch.Tensor:
    """crush_do_rule per seed, laid out as _crush_rows lays out a batch."""
    out = np.full((len(xs), rm + 1), CRUSH_ITEM_NONE, np.int64)
    for i, x in enumerate(xs):
        r = crush_mapper.crush_do_rule(crush, ruleno, int(x), rm, weights, choose_args)
        out[i, :len(r)] = r
        out[i, rm] = len(r)
    return torch.from_numpy(out)


def phase_kernel_crush(cfg: Config, device, check) -> None:
    """The CRUSH kernel on the remap map: each pool's rule at each seed
    count of ``crush_seeds`` and at the whole pool, all in and with zero
    and partial reweights; then a device-class rule, a choose_args weight
    set on the root, one past 2^32 and legacy tunables at the largest seed
    count.  Each launch against the plain version on the same inputs, and
    (but past 2^32) against the scalar crush_do_rule up to the largest
    seed count."""
    om = remap_map(cfg, "cpu")
    crush = om.crush
    n_osd = crush.max_devices
    rng = np.random.default_rng(cfg.seed)
    degraded = np.full(n_osd, 0x10000, np.int64)
    degraded[rng.choice(n_osd, n_osd // 64 + 1, replace=False)] = 0
    part = rng.choice(n_osd, n_osd // 64 + 1, replace=False)
    degraded[part] = rng.integers(1, 0x10000, len(part))
    degraded = [int(w) for w in degraded]
    most = max(cfg.crush_seeds)

    def case(cc, ruleno, rm, xs, weights, what, crush_=crush, choose_args=None, scalar=True):
        mapper = cm.BatchedRuleMapper(cc, ruleno, rm, device=device)
        x = torch.from_numpy(xs.astype(np.int32)).to(device)
        rew = torch.from_numpy(mapper.reweights(weights)).to(device)
        got = _crush_rows(*mapper.map_tensors(x, rew))
        want = _crush_rows(*cm.batched_rule_plain(mapper, x, mapper.class_masked(rew)))
        name = CRUSH_ENTRIES[mapper.kind]
        label = f"crush {what} rule {ruleno} ({len(xs)}, {rm})"
        check(name, got, want, label)
        if scalar and len(xs) <= most:
            check("plain_vs_scalar", want.cpu(),
                  _scalar_rows(crush_, ruleno, xs, rm, weights, choose_args), label)

    cc = cm.compile_map(crush)
    for pool in om.pools.values():
        seeds = pool_seeds(pool)
        for weights, what in ((None, "all in"), (degraded, "reweighted")):
            for n in (*cfg.crush_seeds, len(seeds)):
                case(cc, pool.crush_rule, pool.size, seeds[:n], weights,
                     f"pool {pool.id} {what}")
    xs = pool_seeds(om.pools[1])[:most]
    root = crush.bucket_names["default"]
    fd = crush.type_id("host")
    # device classes: every fourth OSD an ssd, the rule takes the hdds
    classed = crush.copy()
    for osd in range(n_osd):
        crush_builder.set_device_class(classed, osd, "ssd" if osd % 4 == 0 else "hdd")
    rid = crush_builder.add_simple_rule(classed, root, fd, mode="firstn")
    classed.rules[rid].device_class = "hdd"
    case(cm.compile_map(classed), rid, 3, xs, degraded, "device class", classed)
    # a two-position weight set on the root (the balancer's choose_args)
    hosts = len(crush.buckets[root].items)
    ca = {root: ChooseArg(root, weight_set=[
        [int(w) for w in rng.integers(0x8000, 0x30000, hosts)] for _ in range(2)])}
    case(cm.compile_map(crush, choose_args=ca), 0, 3, xs, None, "choose_args", crush, ca)
    # a weight set past 2^32, as the int64 weights of the batched engine
    # allow: the kernel's FP64-reciprocal division at large divisors.  The
    # scalar oracle takes Ceph's u32 weights, so only the plain version
    # (int64, as ceph_tpu's engine) is held beside it.
    big = {root: ChooseArg(root, weight_set=[
        [int(w) for w in rng.integers(1 << 32, 1 << 44, hosts)] for _ in range(2)])}
    case(cm.compile_map(crush, choose_args=big), om.pools[3].crush_rule, cfg.k + cfg.m, xs,
         degraded, "choose_args past 2^32", scalar=False)
    # legacy tunables (pre-jewel): local retries, no descend_once, vary_r, stable
    legacy = crush.copy()
    legacy.tunables = Tunables(choose_local_tries=2, choose_total_tries=19,
                               chooseleaf_descend_once=0, chooseleaf_vary_r=0,
                               chooseleaf_stable=0)
    for ruleno, rm in ((0, 3), (om.pools[3].crush_rule, cfg.k + cfg.m)):
        case(cm.compile_map(legacy), ruleno, rm, xs, degraded, "legacy tunables", legacy)


def phase_kernel_plans(cfg: Config, device, gen, codec, check) -> list:
    """The kernel at every form of its launch plan: an encode (m = 3), a
    1-erasure decode (m = 1) and an acc step at each S of
    ``cfg.plan_cols``, batches of 1 and 8 of the decode; on the card
    also every (acc, columns per thread) instantiation, forced, at an
    aligned and a ragged S.  Returns the (S, batch, words, blocks) seen."""
    k = cfg.k
    _, d1 = codec.decode_bits((2,))
    cuda = torch.device(device).type == "cuda"
    sms = rk._sm_count(torch.cuda.current_device()) if cuda else 132
    plans = set()
    for s in cfg.plan_cols:
        plans.add((s, 1, *rk._launch_plan(s, 1, sms)))
        x = _rand((k, s), gen, device)
        for what, bits in (("encode", codec.encode_bits), ("1-erasure decode", d1)):
            check("gf_bitmatmul", rk.gf_bitmatmul(bits, x[None])[0],
                  rk.gf_bitmatmul_plain(bits, x), f"plan {what} S={s}")
        carry = _rand((cfg.m, s), gen, device)
        want = carry ^ rk.gf_bitmatmul_plain(codec.encode_bits, x ^ 9)
        check("gf_bitmatmul_pallas_acc",
              rk.gf_bitmatmul_pallas_acc(codec.encode_bits, x, carry, 9, tile_s=1),
              want, f"plan acc S={s}")
    for width in cfg.plan_batch_cols:
        for batch in (1, 8):
            plans.add((width, batch, *rk._launch_plan(width, batch, sms)))
            x = _rand((batch, k, width), gen, device)
            check("gf_bitmatmul", rk.gf_bitmatmul(d1, x), rk.gf_bitmatmul_plain(d1, x),
                  f"plan batched ({batch}, {k}, {width})")
    if cuda:
        for s in (12288, 4096 + 5):
            x = _rand((k, s), gen, device)
            want = rk.gf_bitmatmul_plain(codec.encode_bits, x)
            carry = _rand(want.shape, gen, device)
            want_acc = carry ^ rk.gf_bitmatmul_plain(codec.encode_bits, x ^ 3)
            for words in (2, 4):
                out = torch.empty_like(want)
                rk._launch(codec.encode_bits, x, out, words=words)
                check("forced", out, want, f"forced words={words} S={s}")
                c = carry.clone()
                rk._launch(codec.encode_bits, x, c, acc=True, seed=3, words=words)
                check("forced", c, want_acc, f"forced acc words={words} S={s}")
    return sorted(plans)


# ---------------------------------------------------------------------------
# Phases 2-4: write, recover, degraded read through the port's entry points
# ---------------------------------------------------------------------------

def make_pool(cfg: Config, device):
    ec = registry.factory("cuda", cfg.profile(), device=device)
    k = ec.get_data_chunk_count()
    # OSDDaemon._sinfo: StripeInfo(k, k * get_chunk_size(stripe_unit * k))
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(cfg.stripe_unit * k))
    return ec, sinfo


def phase_write(cfg: Config, device, ec, sinfo):
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 1)
    sizes = [cfg.object_bytes] * cfg.objects + [cfg.small_object_bytes] * cfg.small_objects
    objects = [_rand((n,), gen, device).cpu().numpy() for n in sizes]
    n = ec.get_chunk_count()
    written = []
    t0 = time.perf_counter()
    for obj in objects:
        shards = ecutil.encode(sinfo, ec, obj)
        hinfo = ecutil.HashInfo(n)
        hinfo.append(0, shards)
        written.append((shards, hinfo))
    dt = time.perf_counter() - t0
    total = sum(sizes)
    emit({"phase": "write", "objects": len(objects), "logical_bytes": total,
          "chunk_size": sinfo.chunk_size, "stripe_width": sinfo.stripe_width,
          "seconds": dt, "logical_GB_per_s": total / dt / 1e9})
    return objects, written


def phase_recover(cfg: Config, device, ec, sinfo, written) -> list[dict]:
    """Returns the shards the last round rebuilt, per object."""
    agg = DecodeAggregator(device=device)
    warmed = agg.prewarm(ec, erasure_counts=tuple(sorted({len(l) for l in cfg.lost})))
    out = {"phase": "recover", "prewarmed_shapes": warmed, "rounds": []}
    for lost in cfg.lost:
        async def rebuild_all():
            return await asyncio.gather(*(
                ecutil.decode_shards_async(
                    sinfo, ec, {s: c for s, c in shards.items() if s not in lost},
                    set(lost), aggregator=agg)
                for shards, _ in written))

        launches0 = agg.stats["launches"]
        t0 = time.perf_counter()
        rebuilt = asyncio.run(rebuild_all())
        dt = time.perf_counter() - t0
        nbytes = 0
        for (shards, hinfo), got in zip(written, rebuilt):
            assert set(got) == set(lost), (set(got), lost)
            for s in lost:
                crc = native.crc32c(got[s])
                if crc != hinfo.get_chunk_hash(s):
                    raise AssertionError(f"shard {s}: rebuilt crc {crc:#x} != "
                                         f"HashInfo {hinfo.get_chunk_hash(s):#x}")
                nbytes += got[s].nbytes
        out["rounds"].append({"lost": list(lost), "rebuilt_bytes": nbytes,
                              "seconds": dt, "rebuilt_GB_per_s": nbytes / dt / 1e9,
                              "launches": agg.stats["launches"] - launches0})
    out["stats"] = dict(agg.stats)
    if agg.stats["launches"] <= 0:
        raise AssertionError("the aggregator launched nothing")
    if agg.stats["cold_launches"] != 0:
        raise AssertionError(f"cold launches after prewarm: {dict(agg.stats)}")
    emit(out)
    return rebuilt


def phase_degraded_read(cfg: Config, ec, sinfo, objects, written) -> dict:
    out = {"phase": "degraded_read", "rounds": []}
    for missing in cfg.degraded:
        t0 = time.perf_counter()
        for obj, (shards, _) in zip(objects, written):
            avail = {s: c for s, c in shards.items() if s not in missing}
            got = ecutil.decode_concat(sinfo, ec, avail)
            if not np.array_equal(got, obj):
                raise AssertionError(f"degraded read with {missing} missing differs")
        dt = time.perf_counter() - t0
        total = sum(o.nbytes for o in objects)
        out["rounds"].append({"missing": list(missing), "seconds": dt,
                              "logical_GB_per_s": total / dt / 1e9})
    emit(out)
    return out


def host_parity_bad(ec, shards: dict) -> set[int]:
    """The scrub oracle: parity shards that differ from a host re-encode
    (``gf_matmul``) of the data shards."""
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    data = np.stack([shards[ec.chunk_index(c)] for c in range(k)])
    expect = gf_matmul(ec.coding_matrix, data)
    return {ec.chunk_index(k + j) for j in range(n - k)
            if not np.array_equal(expect[j], shards[ec.chunk_index(k + j)])}


def phase_scrub(cfg: Config, device, ec, written, rebuilt) -> dict:
    """Deep scrub of every object as stored after recovery (the last
    round's rebuilt shards in place of the written ones), then a
    corruption round on copies of ``scrub_corrupt`` objects."""
    ver = ScrubVerifier(device=device, crc_lanes=cfg.crc_lanes)  # 2 ms window
    warmed = ver.prewarm(ec)
    stored = [{**shards, **got} for (shards, _), got in zip(written, rebuilt)]

    def scrub(objs: list[dict]) -> list:
        async def chunks():
            out = []
            for at in range(0, len(objs), cfg.scrub_chunk):
                out += await asyncio.gather(*(
                    ver.verify_object(ec, o) for o in objs[at:at + cfg.scrub_chunk]))
            return out

        return asyncio.run(chunks())

    before = dict(ver.stats), ver.metrics.dump()
    t0 = time.perf_counter()
    checks = scrub(stored)
    dt = time.perf_counter() - t0
    nbytes = 0
    for i, (obj, (_, hinfo), ch) in enumerate(zip(stored, written, checks)):
        for s, payload in obj.items():
            if ch.crcs[s] != hinfo.get_chunk_hash(s):
                raise AssertionError(f"object {i} shard {s}: scrub crc {ch.crcs[s]:#x} "
                                     f"!= HashInfo {hinfo.get_chunk_hash(s):#x}")
            nbytes += payload.nbytes
        if ch.parity_bad != frozenset():
            raise AssertionError(f"object {i}: clean parity flagged {ch.parity_bad}")
    stats, metrics = dict(ver.stats), ver.metrics.dump()
    if stats["cold_launches"] != 0:
        raise AssertionError(f"cold launches after prewarm: {stats}")

    def delta(key: str) -> float:
        return metrics.get(key, 0.0) - before[1].get(key, 0.0)

    out = {"phase": "scrub", "prewarmed_shapes": warmed, "objects": len(stored),
           "shard_bytes": nbytes, "seconds": dt, "shard_GB_per_s": nbytes / dt / 1e9,
           "rebuilt_shards": sorted({s for got in rebuilt for s in got}),
           "crc_launches": stats["crc_launches"] - before[0]["crc_launches"],
           "enc_launches": stats["enc_launches"] - before[0]["enc_launches"],
           "lane_occupancy": delta("occupied_lanes") / delta("padded_lanes"),
           "byte_occupancy": delta("occupied_bytes") / delta("padded_bytes"),
           "cold_launches": stats["cold_launches"]}

    # the corruption round: one flipped byte in a data shard, then in a
    # parity shard, on copies of objects spread over the pool
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    cases = []
    for i in range(cfg.scrub_corrupt):
        at = i * (len(stored) // cfg.scrub_corrupt)
        obj, hinfo = stored[at], written[at][1]
        size = len(obj[0])
        for victim in (ec.chunk_index(i % k), ec.chunk_index(k + i % (n - k))):
            bad = dict(obj)
            bad[victim] = obj[victim].copy()
            bad[victim][(i * 104729 + 7) % size] ^= 0x5A
            cases.append((at, victim, bad, hinfo))
    got = scrub([bad for _, _, bad, _ in cases])
    for (at, victim, bad, hinfo), ch in zip(cases, got):
        wrong = {s for s in bad if ch.crcs[s] != hinfo.get_chunk_hash(s)}
        want = host_parity_bad(ec, bad)
        if wrong != {victim} or ch.parity_bad != want or not want or (
                victim >= k and want != {victim}):
            raise AssertionError(
                f"object {at}, byte flipped in shard {victim}: crc differs in "
                f"{sorted(wrong)}, parity_bad {sorted(ch.parity_bad)}, host "
                f"re-encode {sorted(want)}")
    out["corruption"] = [{"object": at, "shard": victim, "parity_bad": sorted(ch.parity_bad)}
                         for (at, victim, _, _), ch in zip(cases, got)]
    out["stats"] = dict(ver.stats)
    emit(out)
    return out


def _remap_mismatches(om: OSDMap, res: dict, sample: int | None) -> tuple[int, int]:
    """(rows checked, rows that differ from the scalar pipeline): every
    row of every pool, or ``sample`` rows spread over each pool."""
    checked = bad = 0
    for pid, pm in res.items():
        n = om.pools[pid].pg_num
        step = 1 if sample is None else max(n // sample, 1)
        for ps in range(0, n, step):
            checked += 1
            bad += pm.rows(ps) != om.pg_to_up_acting_osds(pg_t(pid, ps), folded=True)
    return checked, bad


def _change_epoch(om: OSDMap, res: dict, i: int) -> None:
    """One epoch's changes: an OSD down, one out, one reweighted to half,
    upmap items on two PGs, an explicit upmap, a pg_temp, a primary_temp
    and the primary affinity of two OSDs."""
    n_osd = om.max_osd
    om.epoch += 1
    om.mark_down((17 + 101 * i) % n_osd)
    om.mark_out((40 + 211 * i) % n_osd)
    om.osd_weight[(60 + 307 * i) % n_osd] = 0x8000
    def pg(pid: int, ps: int) -> pg_t:
        return pg_t(pid, ps % om.pools[pid].pg_num)

    for p in (pg(1, 10 + i), pg(3, 20 + i)):
        up = res[p.pool].up[p.ps, :res[p.pool].up_cnt[p.ps]]
        row = [int(o) for o in up if o != CRUSH_ITEM_NONE]
        om.pg_upmap_items[p] = [(row[0], (row[0] + 8 * (i + 1) + 1) % n_osd)]
    om.pg_upmap[pg(1, 30 + i)] = [(5 + 97 * i + 8 * j) % n_osd for j in range(3)]
    size3 = om.pools[3].size
    om.pg_temp[pg(3, 40 + i)] = [(3 + 89 * i + 8 * j) % n_osd for j in range(size3)]
    om.primary_temp[pg(1, 50 + i)] = (7 + 13 * i) % n_osd
    om.set_primary_affinity((70 + 31 * i) % n_osd, 0x4000)
    om.set_primary_affinity((90 + 37 * i) % n_osd, 0)


def phase_remap(cfg: Config, device, full_check: bool = True) -> dict:
    """The whole-cluster remap of ``remap_map`` over a first epoch and
    ``remap_epochs`` changed ones, a new ``BatchedClusterMapper`` each
    epoch as the mon makes one.  Every row of every pool against the
    scalar pipeline in the first and the last epoch (a sample of rows in
    between, and in every epoch when ``full_check`` is off); one map upload
    and no scalar pool; then an upmap balancer pass."""
    om = remap_map(cfg, device)
    pgs = sum(p.pg_num for p in om.pools.values())
    remap.reset_counters()
    epochs = []
    res = None
    for e in range(1 + cfg.remap_epochs):
        if e:
            _change_epoch(om, res, e)
        t0 = time.perf_counter()
        bcm = remap.BatchedClusterMapper(om, device=device)
        res = bcm.map_cluster()
        dt = time.perf_counter() - t0
        last = e == cfg.remap_epochs
        full = full_check and (e == 0 or last)
        t1 = time.perf_counter()
        checked, bad = _remap_mismatches(om, res, None if full else cfg.remap_sample)
        if bad:
            raise AssertionError(f"remap epoch {om.epoch}: {bad} of {checked} rows differ "
                                 "from the scalar pipeline")
        kernel_s = [t["kernel_s"] for t in bcm.timings.values()]
        epochs.append({
            "epoch": om.epoch, "seconds": dt, "pgs_per_s": pgs / dt,
            "pps_s": sum(t["pps_s"] for t in bcm.timings.values()),
            "crush_call_s": sum(t["crush_s"] for t in bcm.timings.values()),
            "kernel_s": None if None in kernel_s else sum(kernel_s),
            "host_pipeline_s": sum(t["pipeline_s"] for t in bcm.timings.values()),
            "pools": {pid: {"kernel_s": t["kernel_s"], "host_pipeline_s": t["pipeline_s"]}
                      for pid, t in bcm.timings.items()},
            "rows_checked": checked, "rows_mismatched": bad,
            "check_s": time.perf_counter() - t1})
    counters = remap.counters()
    if counters["map_uploads"] != 1 or counters["scalar_pools"] != 0:
        raise AssertionError(f"remap counters: {counters}")
    # the mgr balancer's consumer of the census: one optimize pass
    fd = om.crush.type_id("host")
    bal = UpmapBalancer(om, failure_domain_type=fd, device=device)
    before, _ = bal.census()
    t0 = time.perf_counter()
    items = bal.optimize(max_swaps=cfg.balancer_swaps)
    opt_s = time.perf_counter() - t0
    bal.apply(items)
    after, _ = bal.census()
    live = [o for o in range(om.max_osd) if om.is_up(o) and not om.is_out(o)]

    def spread(counts: dict) -> int:
        return max(counts.get(o, 0) for o in live) - min(counts.get(o, 0) for o in live)

    steady = [ep["seconds"] for ep in epochs[1:]]
    out = {"phase": "remap", "pools": len(om.pools), "pgs": pgs, "osds": om.max_osd,
           "epoch1_s": epochs[0]["seconds"], "steady_s": steady,
           "steady_pgs_per_s": pgs / statistics.median(steady) if steady else None,
           "epochs": epochs, "counters": counters,
           "balancer": {"upmap_items": len(items), "optimize_s": opt_s,
                        "pg_spread_before": spread(before), "pg_spread_after": spread(after)}}
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 7 and the kernels line: timing on the card
# ---------------------------------------------------------------------------

def time_ms(fn, n_calls: int, repeats: int) -> float:
    """Median over ``repeats`` of (CUDA-event time of ``n_calls`` calls of
    ``fn(i)``) / n_calls, after one warm-up call."""
    fn(0)
    samples = []
    for _ in range(repeats):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(n_calls):
            fn(i)
        end.record()
        end.synchronize()
        samples.append(start.elapsed_time(end) / n_calls)
    return statistics.median(samples)


def phase_throughput(cfg: Config, device) -> dict:
    k, m = cfg.k, cfg.m
    codec = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 2)
    data = _rand((k, cfg.throughput_cols), gen, device)
    s = data.shape[1]
    tile = rk._pick_tile(s)

    # fold check on a small buffer, as bench.py does: two iterations
    # give r0 ^ r1
    small = data[:, :cfg.fold_cols].contiguous()
    c = torch.zeros((m, small.shape[1]), dtype=torch.uint8, device=device)
    for i in range(2):
        rk.gf_bitmatmul_pallas_acc(codec.encode_bits, small, c, i,
                                   tile_s=rk._pick_tile(small.shape[1]))
    host = small.cpu().numpy()
    want = gf_matmul(codec.C, host) ^ gf_matmul(codec.C, host ^ np.uint8(1))
    if not np.array_equal(c.cpu().numpy(), want):
        raise AssertionError("acc loop fold mismatch")

    carry = torch.zeros((m, s), dtype=torch.uint8, device=device)
    acc_ms = time_ms(lambda i: rk.gf_bitmatmul_pallas_acc(
        codec.encode_bits, data, carry, i, tile_s=tile), cfg.iters, cfg.repeats)
    _, dbits = codec.decode_bits((2,))
    dec_ms = time_ms(lambda i: rk.BitmatrixCodec._apply(dbits, data, None),
                     cfg.iters, cfg.repeats)
    out = {
        "phase": "throughput", "k": k, "m": m, "S": s, "iters": cfg.iters,
        "repeats": cfg.repeats,
        "encode_acc_ms_per_iter": acc_ms,
        "encode_acc_GB_per_s": k * s / (acc_ms * 1e-3) / 1e9,
        "encode_acc_bound_ms": bound_ms(k, m, s, carry=True)[0],
        "decode_1_erasure_ms_per_iter": dec_ms,
        "decode_1_erasure_GB_per_s": k * s / (dec_ms * 1e-3) / 1e9,
        "decode_1_erasure_bound_ms": bound_ms(k, 1, s)[0],
    }
    emit(out)
    return {"data": data, "carry": carry, "codec": codec, "acc_ms": acc_ms}


# ---------------------------------------------------------------------------
# Phases 8-9: the rest of the plugin family and the CLAY pool
# ---------------------------------------------------------------------------

def kat_payloads() -> dict[str, bytes]:
    """tools/gen_ec_golden.py's two payloads."""
    ramp = bytes(range(256)) * 17 + b"\x00\x01\x02"
    rnd = np.random.default_rng(0xCEF).integers(0, 256, 8192, dtype=np.uint8).tobytes()
    return {"ramp4355": ramp, "rand8192": rnd}


def _gf_launches() -> int:
    return sum(rk.launch_counts().values())


def _decodable_set(ec, n: int, e: int) -> tuple | None:
    """The largest erasure set of at most e chunks, spread over the
    chunk ids, that ``ec``'s minimum_to_decode can serve (SHEC and LRC
    are not MDS)."""
    for size in range(e, 0, -1):
        lost = tuple(sorted({(i * n) // size for i in range(size)}))
        try:
            ec.minimum_to_decode(set(lost), set(range(n)) - set(lost))
        except ECError:
            continue
        return lost
    return None


def phase_plugins(cfg: Config, device) -> dict:
    """Every non-``jax`` profile of the golden corpus on ``device``: the
    KAT payloads' chunks equal the golden bytes; one object of
    ``plugin_object_bytes`` (one stripe) encoded, and decoded with one
    erasure and with the largest spread set of up to m erasures, equal to
    the same plugin on the CPU and to the written chunks."""
    with open(GOLDEN) as f:
        corpus = {k: v for k, v in json.load(f).items() if v["plugin"] != "jax"}
    payloads = kat_payloads()
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 5)
    rows = []
    t0 = time.perf_counter()
    for key in sorted(corpus):
        entry = corpus[key]
        ec = registry.factory(entry["plugin"], dict(entry["profile"]), device=device)
        cpu = registry.factory(entry["plugin"], dict(entry["profile"]), device="cpu")
        n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
        for pname, payload in payloads.items():
            enc = ec.encode(set(range(n)), payload)
            for i, chunk in enc.items():
                want = entry["chunks"][pname][str(i)]["sha256"]
                if hashlib.sha256(chunk.tobytes()).hexdigest() != want:
                    raise AssertionError(f"{key} {pname} chunk {i} differs from the golden bytes")
        obj = _rand((cfg.plugin_object_bytes,), gen, device).cpu().numpy()
        launches0 = _gf_launches()
        t1 = time.perf_counter()
        enc = ec.encode(set(range(n)), obj)
        encode_s = time.perf_counter() - t1
        want = cpu.encode(set(range(n)), obj)
        for i in range(n):
            if not np.array_equal(enc[i], want[i]):
                raise AssertionError(f"{key}: chunk {i} differs from the CPU plugin's")
        cs = len(enc[0])
        decoded = []
        for e in (1, n - k):
            lost = _decodable_set(cpu, n, e)
            if lost is None or lost in decoded:
                continue
            avail = {i: c for i, c in enc.items() if i not in lost}
            got = ec.decode(set(lost), avail, cs)
            if e > 1:
                ref = cpu.decode(set(lost), avail, cs)
            for i in lost:
                if not np.array_equal(got[i], enc[i]) or (e > 1 and not np.array_equal(
                        got[i], ref[i])):
                    raise AssertionError(f"{key}: decode of {lost} differs in chunk {i}")
            decoded.append(lost)
        rows.append({"profile": key, "chunk_size": cs, "encode_s": encode_s,
                     "decoded": [list(x) for x in decoded],
                     "gf_launches": _gf_launches() - launches0})
    out = {"phase": "plugins", "profiles": len(rows), "seconds": time.perf_counter() - t0,
           "object_bytes": cfg.plugin_object_bytes, "rows": rows}
    if len(rows) != 19:
        raise AssertionError(f"{len(rows)} non-jax profiles in the corpus, want 19")
    emit(out)
    return out


def _repair_reads(ec, shards: dict, lost: int, sc: int, stripes: int = 1) -> dict:
    """The helpers' minimum sub-chunk runs of every stripe, stripe-major
    (the OSD's ranged reads of a CLAY repair)."""
    cs = ec.sub_chunk_no * sc
    minimum = ec.minimum_to_decode({lost}, set(range(ec.k + ec.m)) - {lost})
    return {s: np.concatenate([shards[s][t * cs + o * sc: t * cs + (o + c) * sc]
                               for t in range(stripes) for o, c in runs])
            for s, runs in minimum.items()}


def clay_rebuild(ec, sinfo, written: list[dict], lost: int, device,
                 ways: tuple = ("host_traversal", "program")) -> dict:
    """Rebuild shard ``lost`` of every object from the minimum reads, each
    of ``ways`` (``ecutil`` host traversal, ``ClayRepairProgram``); each
    must equal the lost shard.  Seconds, rebuilt and read bytes, the
    launches of each way, and the bound of one object's repair."""
    sc = sinfo.chunk_size // ec.sub_chunk_no
    reads = [_repair_reads(ec, sh, lost, sc) for sh in written]
    prog = clay_program(ec, lost, device)
    out = {"lost": lost, "objects": len(written), "rebuilt_bytes": sinfo.chunk_size * len(written),
           "helper_bytes_read": sum(v.nbytes for r in reads for v in r.values()),
           "rs_bytes_read": ec.k * sinfo.chunk_size * len(written),
           "bound_per_object": clay_bounds_ms(prog.schedule, sc)}
    out["read_share_of_rs"] = out["helper_bytes_read"] / out["rs_bytes_read"]
    for way in ways:
        g0, c0 = _gf_launches(), clay_repair_launches()
        t0 = time.perf_counter()
        for sh, pl in zip(written, reads):
            if way == "program":
                got = prog.repair_device(prog.stage(pl)).cpu().numpy().reshape(-1)
            else:
                got = ecutil.decode_shards(sinfo, ec, pl, {lost}, packed_repair=True)[lost]
            if not np.array_equal(got, sh[lost]):
                raise AssertionError(f"CLAY shard {lost} rebuilt by the {way} differs")
        dt = time.perf_counter() - t0
        out[way] = {"seconds": dt, "rebuilt_GB_per_s": out["rebuilt_bytes"] / dt / 1e9,
                    "gf_launches": _gf_launches() - g0,
                    "clay_repair_launches": clay_repair_launches() - c0}
    return out


def clay_repair_launches() -> int:
    return clay_cuda.launch_counts()["clay_repair"]


def phase_clay(cfg: Config, device) -> dict:
    """The CLAY(8,4,11) pool: (i) ``clay_objects`` objects, one stripe
    each, rebuilt both ways for each lost shard, and a 2-erasure degraded
    read; (ii) tools/bench_all.py's 32 MiB-chunk stripe with
    ``scalar_mds=cuda``, repaired by the program (CUDA events, warm) and
    by the host traversal; (iii) ``clay_small_objects`` objects at the
    OSD's stripe unit rebuilt through ``ecutil`` (no launch expected)."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 6)
    cuda = torch.device(device).type == "cuda"
    ec = clay_code(8, 4, 11, device)
    n, k = ec.get_chunk_count(), ec.get_data_chunk_count()
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(cfg.clay_object_bytes))
    objects = [_rand((sinfo.stripe_width,), gen, device).cpu().numpy()
               for _ in range(cfg.clay_objects)]
    g0 = _gf_launches()
    t0 = time.perf_counter()
    written = [ecutil.encode(sinfo, ec, obj) for obj in objects]
    write_s = time.perf_counter() - t0
    out = {"phase": "clay", "profile": ec.get_profile(), "objects": len(objects),
           "logical_bytes": sum(o.nbytes for o in objects), "chunk_size": sinfo.chunk_size,
           "sub_chunk": sinfo.chunk_size // ec.sub_chunk_no, "write_s": write_s,
           "write_gf_launches": _gf_launches() - g0,
           "rounds": [clay_rebuild(ec, sinfo, written, lost, device) for lost in CLAY_LOST]}
    t0 = time.perf_counter()
    for obj, sh in list(zip(objects, written))[:cfg.clay_degraded_objects]:
        got = ecutil.decode_concat(sinfo, ec, {s: c for s, c in sh.items()
                                               if s not in CLAY_DEGRADED})
        if not np.array_equal(got, obj):
            raise AssertionError(f"CLAY degraded read without {CLAY_DEGRADED} differs")
    out["degraded_read"] = {"missing": list(CLAY_DEGRADED),
                            "objects": min(cfg.clay_degraded_objects, len(objects)),
                            "seconds": time.perf_counter() - t0}
    del written, objects

    # (ii) tools/bench_all.py's shape, its inner code scalar_mds=jax -> cuda
    big = clay_code(8, 4, 11, device, scalar_mds="cuda")
    cs = big.get_chunk_size(k * cfg.clay_big_chunk)
    bsinfo = ecutil.StripeInfo(k, k * cs)
    data = _rand((k * cs,), gen, device).cpu().numpy()
    t0 = time.perf_counter()
    shards = ecutil.encode(bsinfo, big, data)
    encode_s = time.perf_counter() - t0
    lost = CLAY_LOST[0]
    sc = cs // big.sub_chunk_no
    reads = _repair_reads(big, shards, lost, sc)
    prog = clay_program(big, lost, device)
    H = prog.stage(reads)
    got = prog.repair_device(H)
    if not np.array_equal(got.cpu().numpy().reshape(-1), shards[lost]):
        raise AssertionError("CLAY 32 MiB-chunk repair by the program differs")
    if cuda:
        prog_ms = time_ms(lambda i: prog.repair_device(H), cfg.clay_big_repeats, cfg.repeats)
    else:
        t0 = time.perf_counter()
        prog.repair_device(H)
        prog_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    host = ecutil.decode_shards(bsinfo, big, reads, {lost}, packed_repair=True)[lost]
    host_s = time.perf_counter() - t0
    if not np.array_equal(host, shards[lost]):
        raise AssertionError("CLAY 32 MiB-chunk repair by the host traversal differs")
    out["bench_shape"] = {
        "profile": big.get_profile(), "chunk_size": cs, "H": list(H.shape),
        "encode_s": encode_s, "lost": lost, "program_ms": prog_ms,
        "program_GB_per_s": cs / (prog_ms * 1e-3) / 1e9,
        "host_traversal_s": host_s, "host_GB_per_s": cs / host_s / 1e9,
        **clay_bounds_ms(prog.schedule, sc)}
    del H, got, shards, reads, host, data

    # (iii) the OSD's default stripe unit: 4096 B chunks, 64 B sub-chunks
    ssinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(cfg.stripe_unit * k))
    g0, c0 = _gf_launches(), clay_repair_launches()
    t0 = time.perf_counter()
    small = []
    for _ in range(cfg.clay_small_objects):
        obj = _rand((cfg.clay_object_bytes,), gen, device).cpu().numpy()
        shards = ecutil.encode(ssinfo, ec, obj)
        stripes = obj.nbytes // ssinfo.stripe_width
        sc = ssinfo.chunk_size // ec.sub_chunk_no
        for lost in CLAY_LOST:
            reads = _repair_reads(ec, shards, lost, sc, stripes)
            got = ecutil.decode_shards(ssinfo, ec, reads, {lost}, packed_repair=True)[lost]
            if not np.array_equal(got, shards[lost]):
                raise AssertionError(f"CLAY shard {lost} at the 4 KiB stripe unit differs")
        small.append(stripes)
    out["stripe_unit"] = {"chunk_size": ssinfo.chunk_size, "objects": len(small),
                          "stripes": sum(small), "seconds": time.perf_counter() - t0,
                          "gf_launches": _gf_launches() - g0,
                          "clay_repair_launches": clay_repair_launches() - c0}
    emit(out)
    return out


#: device -> the CRUSH kernels' main-path cases (crush_main_path)
_CRUSH_CASES: dict = {}


def crush_main_path(cfg: Config, device) -> dict:
    """Each CRUSH entry point at its main-path shape: the remap map's
    first epoch (all in), pool 1 for firstn, pool 3 (create_rule) for
    indep, pool 2 for MSR.  Per entry: (mapper, seeds, reweights on the
    card, straw2 draws the seeds need).  The draws are counted by the
    scalar mapper over every seed, and its rows must equal the kernel's."""
    cases = _CRUSH_CASES.get(str(device))
    if cases is not None:
        return cases
    om = remap_map(cfg, "cpu")
    cc = cm.compile_map(om.crush)
    cases = {}
    for pid in (1, 3, 2):
        pool = om.pools[pid]
        seeds = pool_seeds(pool)
        mapper = cm.BatchedRuleMapper(cc, pool.crush_rule, pool.size, device=device)
        x = torch.from_numpy(seeds.astype(np.int32)).to(device)
        rew = torch.from_numpy(mapper.reweights(om.osd_weight)).to(device)
        crush_mapper.straw2_draws = 0
        want = _scalar_rows(om.crush, pool.crush_rule, seeds, pool.size, om.osd_weight)
        draws = crush_mapper.straw2_draws
        bad, _ = _errors(_crush_rows(*mapper.map_tensors(x, rew)).cpu(), want)
        if bad:
            raise AssertionError(f"pool {pid}: the kernel differs from crush_do_rule "
                                 f"in {bad} values")
        cases[CRUSH_ENTRIES[mapper.kind]] = (mapper, x, rew, draws)
    _CRUSH_CASES[str(device)] = cases
    return cases


#: device -> the CLAY repair's main-path case (clay_main_path)
_CLAY_CASES: dict = {}


def clay_main_path(cfg: Config, device) -> tuple:
    """The CLAY repair at phase 9's shape (CLAY(8,4,11), lost shard
    ``CLAY_LOST[0]``, one 4 MiB object's sub-chunks): the program and
    random staged helpers for it, rotated over more than the 50 MB L2."""
    hit = _CLAY_CASES.get(str(device))
    if hit is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 7)
        ec = clay_code(8, 4, 11, device)
        prog = clay_program(ec, CLAY_LOST[0], device)
        sc = ec.get_chunk_size(cfg.clay_object_bytes) // ec.sub_chunk_no
        per = prog.schedule.n_helpers * prog.schedule.P * sc
        hit = _CLAY_CASES[str(device)] = (prog, [
            staged_random(prog, sc, gen, device) for _ in range(max(2, -(-64 * MiB // per)))])
    return hit


def main_path_shapes(cfg: Config, device, codec) -> dict:
    """For each entry point but acc: (kernel call, plain call, bound,
    shape, (bit-matrix, one input) of a bit-matrix product or None) at
    the main path's shape, with inputs rotated over more than the 50 MB
    L2, as a caller uploading fresh objects finds them.  Call i of the
    kernel and of the plain version take the same input.  The compare
    gets clean parity and the crc full lanes, as deep scrub of sound
    shards does."""
    k, m = cfg.k, cfg.m
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 3)
    s4 = cfg.object_bytes // k          # 4 MiB object -> grouped kernel
    s2 = cfg.small_object_bytes // k    # 2 MiB object -> plain-layout kernel
    _, d1 = codec.decode_bits((2,))
    bufs4 = [_rand((k, s4), gen, device) for _ in range(24)]
    bufs2 = [_rand((k, s2), gen, device) for _ in range(48)]
    bufsb = [_rand((8, k, cfg.batch_cols), gen, device) for _ in range(24)]
    bufsp = [rk.gf_bitmatmul_plain(codec.encode_bits, x) for x in bufsb]
    lanes = cfg.crc_lanes
    bufsc = [_rand((lanes, cfg.batch_cols), gen, device) for _ in range(32)]
    t4, t2 = rk._pick_tile(s4), rk._pick_tile(s2)
    g4 = rk._pick_groups(k, m, s4, t4)
    bits = codec.encode_bits
    out = {
        "gf_bitmatmul_pallas": (
            lambda i: rk.gf_bitmatmul_pallas(bits, bufs2[i % 48], tile_s=t2),
            lambda i: rk.gf_bitmatmul_plain(bits, bufs2[i % 48]),
            bound_ms(k, m, s2), f"encode ({k}, {s2})", (bits, bufs2[0])),
        "gf_bitmatmul_pallas_grouped": (
            lambda i: rk.gf_bitmatmul_pallas_grouped(bits, bufs4[i % 24],
                                                     tile_s=t4 // g4, groups=g4),
            lambda i: rk.gf_bitmatmul_plain(bits, bufs4[i % 24]),
            bound_ms(k, m, s4), f"encode ({k}, {s4}) groups={g4}", (bits, bufs4[0])),
        "gf_bitmatmul": (
            lambda i: rk.gf_bitmatmul(d1, bufsb[i % 24]),
            lambda i: rk.gf_bitmatmul_plain(d1, bufsb[i % 24]),
            bound_ms(k, 1, 8 * cfg.batch_cols), f"1-erasure decode (8, {k}, {cfg.batch_cols})",
            (d1, bufsb[0])),
        "gf_encode_compare": (
            lambda i: rk.gf_encode_compare(bits, bufsb[i % 24], bufsp[i % 24]),
            lambda i: rk.gf_encode_compare_plain(bits, bufsb[i % 24], bufsp[i % 24]),
            bound_ms(k, m, 8 * cfg.batch_cols),
            f"compare (8, {k}, {cfg.batch_cols}) with (8, {m}, {cfg.batch_cols})", None),
        "batched_crc32c_device": (
            lambda i: hashing.batched_crc32c_device(bufsc[i % 32]),
            lambda i: hashing.batched_crc32c_plain(bufsc[i % 32]),
            crc_bound_ms(lanes, cfg.batch_cols), f"crc ({lanes}, {cfg.batch_cols})", None),
    }
    clay, H_bufs = clay_main_path(cfg, device)
    sched = clay.schedule
    cb = clay_bounds_ms(sched, H_bufs[0].shape[-1])
    out["clay_repair"] = (
        lambda i: clay.repair_device(H_bufs[i % len(H_bufs)]),
        lambda i: clay_cuda.clay_repair_plain(H_bufs[i % len(H_bufs)], sched),
        (cb["bound_ms"], cb["bound_by"]),
        f"CLAY(8,4,11) lost {clay.lost}, H {tuple(H_bufs[0].shape)}", None)
    for name, (mapper, x, rew, draws) in crush_main_path(cfg, device).items():
        masked = mapper.class_masked(rew)
        out[name] = (
            lambda i, mapper=mapper, x=x, rew=rew: _crush_rows(*mapper.map_tensors(x, rew)),
            lambda i, mapper=mapper, x=x, masked=masked: _crush_rows(
                *cm.batched_rule_plain(mapper, x, masked)),
            crush_bound_ms(draws), f"{mapper.kind} ({x.shape[0]}, {mapper.result_max}), "
            f"{draws} draws", None)
    return out


def kernel_rows(cfg: Config, device, worst: dict, launches: dict, tp: dict,
                per_launch: dict) -> list[dict]:
    """One row per kernel entry point: its time at the main path's
    shape (CUDA events per call, and device time per launch from the
    profile pass), its plain version's time, its bound and the bound's
    share of the time, and its error against the plain version on the
    same input at that shape (raises unless 0)."""
    k, m = cfg.k, cfg.m
    bits = tp["codec"].encode_bits
    shapes = main_path_shapes(cfg, device, tp["codec"])
    rows = []
    for name in REPLACES:
        if name == "gf_bitmatmul_pallas_acc":
            data, carry = tp["data"], tp["carry"]
            s = data.shape[1]
            seed = 7
            got = rk.gf_bitmatmul_pallas_acc(bits, data, carry.clone(), seed,
                                             tile_s=rk._pick_tile(s))
            bad, err = _errors(got, carry ^ rk.gf_bitmatmul_plain(bits, data ^ seed))
            del got
            ms = tp["acc_ms"]
            plain_ms = time_ms(lambda i: carry.bitwise_xor_(
                rk.gf_bitmatmul_plain(bits, data ^ (i & 0xFF))), 1, 3)
            bms, by = bound_ms(k, m, s, carry=True)
            shape = f"acc ({k}, {s})"
        else:
            fn, plain, (bms, by), shape, _ = shapes[name]
            bad, err = _errors(fn(0), plain(0))
            ms = time_ms(fn, 48, cfg.repeats)
            # the plain CRUSH mapper loops in Python over its lanes' retries
            plain_ms = time_ms(plain, 1 if name in CRUSH_ENTRIES.values() else 4, 3)
        if bad:
            raise AssertionError(f"{name} at {shape}: differs from its plain "
                                 f"version in {bad} bytes")
        rows.append({
            "name": name, "route": "cuda", "source": KERNELS[name][0],
            "replaces": REPLACES[name], "launches": launches[name],
            "max_abs_err": max(worst[name], err), "mismatched_bytes": bad,
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms, "library_ms": None,
            "library_note": NO_LIBRARY[name], "shape": shape,
            "device_us": per_launch[name]["device_us_mean"],
            "device_ops_per_call": per_launch[name]["device_ops_per_call"],
        })
        if name in CRUSH_ENTRIES.values():
            # a warp per seed: the launch's warps per block and blocks
            rows[-1].update(cm.launch_geometry(crush_main_path(cfg, device)[name][1].shape[0]))
    return rows


def clay_bench_case(cfg: Config, device) -> tuple:
    """tools/bench_all.py's CLAY shape (one 8 x 32 MiB stripe,
    ``scalar_mds=cuda``): the program of lost shard ``CLAY_LOST[0]`` and
    random staged helpers for it."""
    hit = _CLAY_CASES.get(f"{device} bench")
    if hit is None:
        gen = torch.Generator(device=device).manual_seed(cfg.seed + 12)
        ec = clay_code(8, 4, 11, device, scalar_mds="cuda")
        prog = clay_program(ec, CLAY_LOST[0], device)
        sc = ec.get_chunk_size(8 * cfg.clay_big_chunk) // ec.sub_chunk_no
        hit = _CLAY_CASES[f"{device} bench"] = (prog, staged_random(prog, sc, gen, device))
    return hit


def clay_bench_row(cfg: Config, device, launches: int) -> dict:
    """``clay_repair``'s row at tools/bench_all.py's shape
    (:func:`clay_bench_case`): CUDA-event ms, device µs, plain ms and
    bound, as ``kernel_rows`` gives them at the object shape.
    ``launches``: the plugin path's, this shape's among them."""
    prog, H = clay_bench_case(cfg, device)
    sc = H.shape[-1]
    sched = prog.schedule
    shape = f"CLAY(8,4,11) lost {prog.lost}, H {tuple(H.shape)}"
    bad, err = _errors(prog.repair_device(H), clay_cuda.clay_repair_plain(H, sched))
    if bad:
        raise AssertionError(f"clay_repair at {shape}: differs from its plain version "
                             f"in {bad} bytes")
    cb = clay_bounds_ms(sched, sc)
    ms = time_ms(lambda i: prog.repair_device(H), cfg.clay_big_repeats, cfg.repeats)
    return {
        "name": "clay_repair:bench_shape", "route": "cuda", "source": CLAY_SOURCE,
        "replaces": REPLACES["clay_repair"], "launches": launches, "max_abs_err": err,
        "mismatched_bytes": bad, "ms": ms,
        "plain_ms": time_ms(lambda i: clay_cuda.clay_repair_plain(H, sched), 1, 3),
        "bound_ms": cb["bound_ms"], "bound_by": cb["bound_by"],
        "bound_share": cb["bound_ms"] / ms, "library_ms": None,
        "library_note": NO_LIBRARY["clay_repair"], "shape": shape,
        "device_us": per_launch(lambda i: prog.repair_device(H), cfg.clay_big_repeats, shape,
                                KERNELS["clay_repair"][1])["device_us_mean"],
    }


#: seed counts of the CRUSH sweep: 4 warps an SM (one a scheduler) up to
#: twice the largest pool
CRUSH_SWEEP = (528, 2048, 8192, 16384)
#: crush_rule.cu's division of a draw, and nvcc's emulated one in its place
CRUSH_DIV = ("draw = -(int64_t)div_weight(num, wi);", "draw = -(int64_t)(num / (uint64_t)wi);")


def crush_emulated_division_source() -> str:
    """``crush_rule.cu`` with the emulated 64-bit division in place of
    its FP64-reciprocal ``div_weight``: the yardstick of that choice."""
    src = (pathlib.Path(__file__).resolve().parent / CRUSH_SOURCE).read_text()
    if src.count(CRUSH_DIV[0]) != 1:
        raise AssertionError("crush_rule.cu: the draw's division is not where the lab expects it")
    return src.replace(*CRUSH_DIV)


def phase_crush_lab(cfg: Config, device) -> dict:
    """The CRUSH kernels launched directly (CUDA events, no wrapper): at
    each main-path shape in turns with a build of the source whose draws
    divide as nvcc emulates it (kernel, emulated, emulated, kernel; both
    must give the same rows), and over ``CRUSH_SWEEP`` random seeds of
    each rule, which shows where a launch stops being latency-bound."""
    from ceph_tpu_torch.ops import _build

    src = os.path.join(_build.BUILD_DIR, "crush_rule_emudiv.cu")
    so = os.path.join(_build.BUILD_DIR, "libcrush_rule_emudiv.so")
    with open(src, "w") as f:
        f.write(crush_emulated_division_source())
    subprocess.run([_build.nvcc(), *_build.NVCC_FLAGS, "-o", so, src], check=True,
                   capture_output=True, timeout=600)
    emulated = ctypes.CDLL(so).ceph_crush_rule
    emulated.restype = ctypes.c_int
    emulated.argtypes = [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p]
    stream = torch.cuda.current_stream().cuda_stream
    rng = np.random.default_rng(cfg.seed + 13)

    def launcher(fn, mapper, x, rew):
        masked = mapper.class_masked(rew).contiguous()
        vals = torch.empty((x.shape[0], mapper.result_max), dtype=torch.int32, device=device)
        counts = torch.empty((x.shape[0],), dtype=torch.int32, device=device)
        args = cm.kernel_args(mapper, x, masked, vals, counts)
        mode = cm.MODES[mapper.kind]
        held = (x, masked, vals, counts)  # the argument block has only their addresses

        def launch(i):
            if fn(mode, ctypes.byref(args), stream):
                raise RuntimeError("crush_rule launch refused")
            return held[2:]
        return launch

    out = {"phase": "crush_lab", "division_ms": {}, "sweep_ms": {}}
    for name, (mapper, x, rew, _) in crush_main_path(cfg, device).items():
        ours, theirs = launcher(cm._kernel(), mapper, x, rew), launcher(emulated, mapper, x, rew)
        bad, _ = _errors(_crush_rows(*ours(0)), _crush_rows(*theirs(0)))
        if bad:
            raise AssertionError(f"{name}: the emulated division differs in {bad} values")
        turns = [time_ms(fn, 24, cfg.repeats) for fn in (ours, theirs, theirs, ours)]
        out["division_ms"][name] = {"reciprocal": [turns[0], turns[3]],
                                    "emulated": [turns[1], turns[2]]}
        out["sweep_ms"][name] = {
            n: time_ms(launcher(cm._kernel(), mapper, torch.from_numpy(
                rng.integers(0, 2 ** 31, n).astype(np.int32)).to(device), rew), 24, cfg.repeats)
            for n in CRUSH_SWEEP}
    return out


def phase_crc_sweep(cfg: Config, device) -> dict:
    """The crc kernel over ``cfg.crc_sweep``: each shape against its plain
    version on the card (the 1 MiB lanes against the host's native crc32c:
    the plain version's M_W there is a 256 MB host build), then device µs a
    launch (profile pass), CUDA-event ms a call and device operations a
    call, beside the byte bound.  Inputs rotate over more than the 50 MB
    L2 where the shape allows."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 14)
    out = {"phase": "crc_sweep", "cases": []}
    for b, w in cfg.crc_sweep:
        bufs = [_rand((b, w), gen, device) for _ in range(min(32, -(-64 * MiB // (b * w))))]
        x = bufs[0]
        if w <= cfg.batch_cols:
            oracle, want = "batched_crc32c_plain", hashing.batched_crc32c_plain(x)
        else:
            oracle = "native.crc32c"
            want = torch.tensor([native.crc32c(row, 0) for row in x.cpu().numpy()],
                                dtype=torch.int64)
        bad, _ = _errors(_wide(hashing.batched_crc32c_device(x)).cpu(), _wide(want).cpu())
        if bad:
            raise AssertionError(f"crc ({b}, {w}): {bad} lanes differ from {oracle}")

        def fn(i, bufs=bufs):
            return hashing.batched_crc32c_device(bufs[i % len(bufs)])
        prof = per_launch(fn, 48, f"crc ({b}, {w})", KERNELS["batched_crc32c_device"][1])
        bms, by = crc_bound_ms(b, w)
        vec, cluster, passes = hashing.crc_geometry(w)
        out["cases"].append({
            "lanes": b, "width": w, "oracle": oracle, "mismatched_lanes": bad,
            "loads_per_pass": vec, "cluster": cluster, "passes": passes,
            "device_us": prof["device_us_mean"],
            "ms": time_ms(fn, 48, cfg.repeats), "bound_ms": bms, "bound_by": by,
            "bound_share_device": bms * 1e3 / prof["device_us_mean"],
            "device_ops_per_call": prof["device_ops_per_call"]})
        del bufs
    return out


def gpu_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60,
    ).stdout.strip().splitlines()[0]


def _busy_us(intervals: list[tuple[float, float]]) -> float:
    """Length of the union of (start, end) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def traced(fn) -> tuple[float, list[dict]]:
    """Run ``fn()`` under torch.profiler: (wall seconds to its end on the
    device, the trace's device events: kernels, copies, memsets)."""
    import os
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return wall, [e for e in events if e.get("ph") == "X"
                  and e.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]


def ours(e: dict, kernel: str) -> bool:
    return kernel in e.get("name", "")


def traced_calls(fn, calls: int) -> tuple[float, list[dict]]:
    """``traced`` over ``calls`` calls of ``fn(i)``.  A trace that holds no
    device event at all lost its window (the calls launched kernels, or
    raised): it is taken again, up to three times."""
    for _ in range(3):
        wall, dev = traced(lambda: [fn(i) for i in range(calls)])
        if dev:
            break
    return wall, dev


def per_launch(fn, calls: int, shape: str, kernel: str = "gf_bitmatmul_kernel") -> dict:
    """Device time per launch of ``kernel`` over ``calls`` calls of
    ``fn(i)`` (one warm-up call first), beside the wall time per call."""
    fn(0)
    wall_c, dev_c = traced_calls(fn, calls)
    kern = [e["dur"] for e in dev_c if ours(e, kernel)]
    memsets = sum(e["cat"] == "gpu_memset" for e in dev_c)
    return {"shape": shape, "launches": len(kern),
            "device_us_mean": sum(kern) / max(len(kern), 1),
            "wall_us_per_call": wall_c / calls * 1e6,
            "device_ops_per_call": {"kernel": len(kern) / calls, "memset": memsets / calls,
                                    "other": (len(dev_c) - len(kern) - memsets) / calls}}


def phase_profile(cfg: Config, device, tp: dict) -> dict:
    """Phases 2-6 again under torch.profiler (the remap checked on a
    sample of rows), reporting
    the device's busy and idle share of the phases' wall time, the
    device time per kernel and the memsets' (the compare must add none:
    one device operation a call); then each main-path launch shape, for
    the kernel's own device time beside the CUDA-event time per call,
    each shape again at each forced width of the launch plan (8 and 16
    columns per thread)."""
    wall, dev = traced(lambda: run_main_path(cfg, device, full_check=False))
    busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
    by_cat: dict[str, float] = {}
    for e in dev:
        cat = next((kn for _, kn in KERNELS.values() if ours(e, kn)), e["cat"])
        by_cat[cat] = by_cat.get(cat, 0.0) + e["dur"]
    out = {"phase": "profile", "main_path_wall_s": wall,
           "device_busy_s": busy * 1e-6, "device_idle_share": 1 - busy * 1e-6 / wall,
           "device_us_by_kind": by_cat, "device_events": len(dev),
           "main_path_memset_us": by_cat.get("gpu_memset", 0.0), "per_launch": {}}
    shapes = main_path_shapes(cfg, device, tp["codec"])
    for name, (fn, _, _, shape, _x) in shapes.items():
        out["per_launch"][name] = per_launch(fn, 48, shape, KERNELS[name][1])
    # the compare writes its mask itself: no memset, no other kernel
    ops = out["per_launch"]["gf_encode_compare"]["device_ops_per_call"]
    if ops["memset"] or ops["other"] or not ops["kernel"]:
        raise AssertionError(f"gf_encode_compare is not one device operation a call: {ops}")
    # the compare's launch plan at its main-path shape: (parts, threads)
    out["compare_plan"] = rk.compare_plan(cfg.batch_cols, 8, cfg.m, rk._sm_count(
        torch.cuda.current_device()))
    # phase 9's rebuild of a few objects, each way alone
    ec = clay_code(8, 4, 11, device)
    sinfo = ecutil.StripeInfo(ec.k, ec.k * ec.get_chunk_size(cfg.clay_object_bytes))
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 8)
    written = [ecutil.encode(sinfo, ec, _rand((sinfo.stripe_width,), gen, device).cpu().numpy())
               for _ in range(cfg.clay_traced_objects)]
    out["clay_rebuild"] = {}
    for way in ("host_traversal", "program"):
        wall, dev = traced(lambda way=way: clay_rebuild(ec, sinfo, written, CLAY_LOST[0],
                                                        device, ways=(way,)))
        busy = _busy_us([(e["ts"], e["ts"] + e["dur"]) for e in dev])
        kinds: dict[str, float] = {}
        for e in dev:
            kind = next((kn for _, kn in KERNELS.values() if ours(e, kn)), e["cat"])
            kinds[kind] = kinds.get(kind, 0.0) + e["dur"]
        out["clay_rebuild"][way] = {"objects": len(written), "wall_s": wall,
                                    "device_busy_s": busy * 1e-6,
                                    "device_idle_share": 1 - busy * 1e-6 / wall,
                                    "device_us_by_kind": kinds}
    bits, data, carry = tp["codec"].encode_bits, tp["data"], tp["carry"]
    out["per_launch"]["gf_bitmatmul_pallas_acc"] = per_launch(
        lambda i: rk.gf_bitmatmul_pallas_acc(bits, data, carry, i,
                                             tile_s=rk._pick_tile(data.shape[1])),
        4, f"acc ({cfg.k}, {data.shape[1]})")
    out["by_words"] = {}
    for name, (_, _, _, shape, plan_input) in shapes.items():
        if plan_input is None:
            continue
        b, x = plan_input
        for words in (2, 4):
            def launch(i, b=b, x=x, words=words):
                o = torch.empty((*x.shape[:-2], b.shape[0] // 8, x.shape[-1]),
                                dtype=torch.uint8, device=device)
                rk._launch(b, x, o, words=words)
            out["by_words"][f"{shape} words={words}"] = per_launch(launch, 48, shape)
    _, d1 = tp["codec"].decode_bits((2,))
    rec = torch.empty((1, data.shape[1]), dtype=torch.uint8, device=device)
    for words in (2, 4):
        out["by_words"][f"acc ({cfg.k}, {data.shape[1]}) words={words}"] = per_launch(
            lambda i, words=words: rk._launch(bits, data, carry, acc=True, seed=i,
                                              words=words),
            4, f"acc ({cfg.k}, {data.shape[1]})")
        out["by_words"][f"1-erasure decode ({cfg.k}, {data.shape[1]}) words={words}"] = (
            per_launch(lambda i, words=words: rk._launch(d1, data, rec, words=words),
                       4, f"1-erasure decode ({cfg.k}, {data.shape[1]})"))
    emit(out)
    return out


# ---------------------------------------------------------------------------
# Phase 10: the measurement tools (ceph_tpu_torch.tools) and their kernels
# ---------------------------------------------------------------------------

#: each kernel row of the tools path: (entry point, TPU kernel it
#: replaces, kernel source, the kernel's name in a trace)
TOOL_ROWS = {
    "row_copy:copy_fn": ("row_copy", "tools/perf_lab.py:61", COPY_SOURCE, "lab_row_copy"),
    "row_copy:fat_copy": ("row_copy", "tools/perf_lab.py:101", COPY_SOURCE, "lab_row_copy"),
    **{f"gf_stage_cut:{st}": ("gf_stage_cut", "tools/perf_lab2.py:76", GF_SOURCE,
                              "gf_bitmatmul_kernel") for st in CUT_STAGES},
    "repeat_variant": ("repeat_variant", "tools/perf_lab2.py:113", GF_SOURCE,
                       "gf_bitmatmul_kernel"),
    "acc_encode": ("acc_encode", "tools/perf_lab3.py:52", GF_SOURCE, "gf_bitmatmul_kernel"),
}


def tools_launches() -> dict[str, int]:
    """Launches of the tools path's six entry points (the stage cuts by
    stage)."""
    return {**lk.launch_counts(),
            **{f"gf_stage_cut:{st}": rk.gf_stage_cut.by_stage[st] for st in CUT_STAGES}}


def tool_bounds(cfg: Config) -> dict[str, tuple[float, str]]:
    """Each tools row's bound at its probe's shape, from the function's
    bytes (each input byte it needs read once, each output byte written
    once) or its operations: a copy of r rows and the load and extract
    cuts 2 r S bytes (their output is m rows of m read); the matmul cut
    and the repeat variant an (m, S) product of (k, S) data, as
    ``bound_ms``; the acc form with its carry."""
    k, m, s = cfg.k, cfg.m, cfg.tools_cols
    return {
        "row_copy:copy_fn": _bound(2 * m * s, 0),
        "row_copy:fat_copy": _bound(2 * cfg.fat_keep * cfg.fat_cols, 0),
        "gf_stage_cut:load": _bound(2 * m * s, 0),
        "gf_stage_cut:extract": _bound(2 * m * s, 0),
        "gf_stage_cut:matmul": bound_ms(k, m, s),
        "repeat_variant": bound_ms(k, m, s),
        "acc_encode": bound_ms(k, m, cfg.acc_cols, carry=True),
    }


def probe_bounds(cfg: Config) -> dict[str, float]:
    """The load and extract cuts' bound in ms for the probe's work rather
    than the function's: (k + m) S bytes, since the probe's BlockSpec
    brings all k rows in before it stores m (tools/perf_lab2.py:81)."""
    ms = _bound((cfg.k + cfg.m) * cfg.tools_cols, 0)[0]
    return {"gf_stage_cut:load": ms, "gf_stage_cut:extract": ms}


def tool_cases(cfg: Config, device) -> dict:
    """Each tools row at its probe's shape: (kernel call, plain call,
    library call or None, shape).  The library call is one PyTorch call computing the same
    function; the port never calls it."""
    k, m = cfg.k, cfg.m
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 10)
    bits = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device).encode_bits
    s, sa = cfg.tools_cols, cfg.acc_cols
    d = _rand((k, s), gen, device)
    big = _rand((cfg.fat_rows, cfg.fat_cols), gen, device)
    da = _rand((k, sa), gen, device)
    carry, carry_plain = (torch.zeros((m, sa), dtype=torch.uint8, device=device)
                          for _ in range(2))
    keep, fat = cfg.fat_keep, cfg.fat_cols
    out = {
        "row_copy:copy_fn": (lambda i: lk.row_copy(d, m), lambda i: lk.row_copy_plain(d, m),
                             lambda i: d[:m].clone(), f"({k}, {s}) -> {m} rows"),
        "row_copy:fat_copy": (lambda i: lk.row_copy(big, keep),
                              lambda i: lk.row_copy_plain(big, keep),
                              lambda i: big[:keep].clone(),
                              f"({cfg.fat_rows}, {fat}) -> {keep} rows"),
        "gf_stage_cut:load": (lambda i: rk.gf_stage_cut(bits, d, "load"),
                              lambda i: rk.gf_stage_cut_plain(bits, d, "load"),
                              lambda i: d[:m].clone(), f"load ({k}, {s}) -> ({m}, {s})"),
        "gf_stage_cut:extract": (lambda i: rk.gf_stage_cut(bits, d, "extract"),
                                 lambda i: rk.gf_stage_cut_plain(bits, d, "extract"),
                                 lambda i: torch.bitwise_and(d[:m], 1),
                                 f"extract ({k}, {s}) -> ({m}, {s})"),
        "gf_stage_cut:matmul": (lambda i: rk.gf_stage_cut(bits, d, "matmul"),
                                lambda i: rk.gf_stage_cut_plain(bits, d, "matmul"),
                                None, f"matmul ({k}, {s}) -> ({m}, {s})"),
        "repeat_variant": (lambda i: lk.repeat_variant(bits, d),
                           lambda i: lk.repeat_variant_plain(bits, d),
                           None, f"folded product ({k}, {s}) -> ({m}, {s})"),
        "acc_encode": (lambda i: lk.acc_encode(bits, da, carry, i),
                       lambda i: lk.acc_encode_plain(bits, da, carry_plain, i),
                       None, f"acc ({k}, {sa})"),
    }
    return out


def phase_kernel_tools(cfg: Config, device) -> dict[str, int]:
    """Each tools kernel against its plain version on the same inputs, at
    the probe's shape and at ragged ones (a ragged S; a copy whose
    start is not 16-byte aligned; k = 16 and a packed k + m = 256 code
    for the stage cuts; seeds 0, 3 and 255 and a nonzero carry for the
    acc form).  Returns the largest absolute byte error per row; raises
    on any mismatched byte."""
    k, m = cfg.k, cfg.m
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 11)
    worst = {name: 0 for name in TOOL_ROWS}
    cases = []

    def check(name: str, got: torch.Tensor, want: torch.Tensor, case: str) -> None:
        bad, err = _errors(got, want)
        worst[name] = max(worst[name], err)
        cases.append({"row": name, "case": case, "mismatched_bytes": bad})
        if bad:
            raise AssertionError(f"{name} {case}: {bad} bytes differ from the plain version")

    codes = {(k, m): rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device=device).encode_bits}
    for kk, mm in ((16, 4), (128, 128), (4, 2)):
        codes[(kk, mm)] = rk.BitmatrixCodec(isa_cauchy_matrix(kk, mm), device=device).encode_bits
    ragged = cfg.tools_ragged_cols
    for s in (cfg.tools_cols, ragged):
        d = _rand((k, s), gen, device)
        check("row_copy:copy_fn", lk.row_copy(d, m), lk.row_copy_plain(d, m), f"({k}, {s})")
        for st in CUT_STAGES:
            check(f"gf_stage_cut:{st}", rk.gf_stage_cut(codes[(k, m)], d, st),
                  rk.gf_stage_cut_plain(codes[(k, m)], d, st), f"({k}, {s})")
        check("repeat_variant", lk.repeat_variant(codes[(k, m)], d),
              lk.repeat_variant_plain(codes[(k, m)], d), f"({k}, {s})")
        del d
    for kk, mm in ((16, 4), (128, 128), (4, 2)):
        d = _rand((kk, 4096 + 13), gen, device)
        for st in CUT_STAGES:
            if st != "matmul" and mm > kk:
                continue
            check(f"gf_stage_cut:{st}", rk.gf_stage_cut(codes[(kk, mm)], d, st),
                  rk.gf_stage_cut_plain(codes[(kk, mm)], d, st), f"({kk}, {mm}) S=4109")
        check("repeat_variant", lk.repeat_variant(codes[(kk, mm)], d),
              lk.repeat_variant_plain(codes[(kk, mm)], d), f"({kk}, {mm}) S=4109")
    for shape, keep, off in (((cfg.fat_rows, cfg.fat_cols), cfg.fat_keep, 0),
                             ((cfg.fat_rows, 4096 + 13), cfg.fat_keep, 0),
                             ((cfg.fat_rows + 1, 4096 + 13), cfg.fat_keep, 1)):
        src = _rand(shape, gen, device)[off:]
        check("row_copy:fat_copy", lk.row_copy(src, keep), lk.row_copy_plain(src, keep),
              f"{tuple(src.shape)} -> {keep}" + (" unaligned" if off else ""))
    for s in (cfg.tools_cols, ragged, cfg.acc_cols):
        d = _rand((k, s), gen, device)
        c0 = _rand((m, s), gen, device)
        for seed in (0, 3, 255):
            got = lk.acc_encode(codes[(k, m)], d, c0.clone(), seed)
            check("acc_encode", got, lk.acc_encode_plain(codes[(k, m)], d, c0.clone(), seed),
                  f"({k}, {s}) seed {seed}")
            del got
        del d, c0
    _sync(device)
    emit({"phase": "kernels_tools", "cases": len(cases),
          "mismatched_bytes": sum(c["mismatched_bytes"] for c in cases), "worst": worst})
    return worst


_TIMED_LINE = re.compile(r"^(?P<name>.+?)\s+(?P<ms>[\d.]+) ms\s+(?P<gbs>[\d.]+) GB/s$")


def _run_twin(main_fn, argv: list[str]) -> tuple[float, list[str]]:
    """Run a twin's ``main(argv)``: (seconds, its stdout lines); raises
    unless it returns 0."""
    buf = io.StringIO()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(buf):
        rc = main_fn(argv)
    if rc != 0:
        raise AssertionError(f"{main_fn.__module__} {argv} exited {rc}:\n{buf.getvalue()}")
    return time.perf_counter() - t0, buf.getvalue().splitlines()


def _parse_lab(lines: list[str]) -> dict:
    """A perf_lab twin's lines: timed lines as {name: [ms, GB/s]}, the
    check lines as {name: bool}, section headers dropped."""
    timed, checks = {}, {}
    for ln in lines:
        hit = _TIMED_LINE.match(ln.strip())
        if hit:
            timed[hit["name"]] = [float(hit["ms"]), float(hit["gbs"])]
        elif ln.rstrip().endswith(("True", "False")):
            name, _, val = ln.rpartition(":")
            checks[name.strip()] = val.strip() == "True"
        elif not ln.startswith("=="):
            raise AssertionError(f"unparsed line: {ln!r}")
    return {"timed": timed, "checks": checks}


def phase_tools(cfg: Config, device) -> dict:
    """Drive the measurement twins through their ``main`` functions on
    ``device``: perf_lab, perf_lab2, perf_lab3, bench, ec_benchmark
    (encode and an exhaustive decode for ``cuda`` RS(8,3) and jerasure
    RS(4,2) reed_sol_van) and bench_all's configs.  Their output lines are
    parsed and checked: the acc probe's checks True, the repeat variant's
    check against the encode False (a reference fact: it is not the
    encode) and against its folded product True, every bench_all config
    without error.  Emits one line a twin, and returns their results."""
    dev = ["--device", str(device)]
    out = {}

    def done(twin: str, seconds: float, result) -> None:
        out[twin] = result
        emit({"phase": "tools", "twin": twin, "seconds": seconds, "result": result})

    for name, fn, args in (("perf_lab", t_perf_lab.main, cfg.perf_lab_args),
                           ("perf_lab2", t_perf_lab2.main, cfg.perf_lab2_args),
                           ("perf_lab3", t_perf_lab3.main, cfg.perf_lab3_args)):
        secs, lines = _run_twin(fn, dev + list(args))
        done(name, secs, _parse_lab(lines))
    if not all(out["perf_lab3"]["checks"].values()) or len(out["perf_lab3"]["checks"]) != 2:
        raise AssertionError(f"perf_lab3 checks: {out['perf_lab3']['checks']}")
    want = {"repeat variant bit-exact": False, "repeat variant equals the folded product": True}
    if out["perf_lab2"]["checks"] != want:
        raise AssertionError(f"perf_lab2 checks: {out['perf_lab2']['checks']}")
    secs, lines = _run_twin(t_bench.main, dev + list(cfg.bench_args))
    done("bench", secs, json.loads(lines[-1]))
    runs = []
    t0 = time.perf_counter()
    for plugin, params in (("cuda", ("k=8", "m=3")),
                           ("jerasure", ("k=4", "m=2", "technique=reed_sol_van"))):
        common = dev + ["--plugin", plugin, "--size", str(cfg.ec_bench_size),
                        "--iterations", str(cfg.ec_bench_iterations)]
        for p in params:
            common += ["--parameter", p]
        m = 3 if plugin == "cuda" else 2
        for workload in (["--workload", "encode"],
                         ["--workload", "decode", "--erasures", str(m),
                          "--erasures-generation", "exhaustive"]):
            _, lines = _run_twin(t_ec_benchmark.main, common + workload)
            secs, kib = lines[-1].split("\t")
            runs.append({"plugin": plugin, "workload": workload[1], "seconds": float(secs),
                         "KiB": int(kib), "GB_per_s": int(kib) * 1024 / float(secs) / 1e9})
    done("ec_benchmark", time.perf_counter() - t0, runs)
    sizes = t_bench_all.Sizes.for_device(torch.device(device), **dict(cfg.bench_all_sizes))
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = t_bench_all.main(dev + list(cfg.bench_all_args), sizes=sizes)
    done("bench_all", time.perf_counter() - t0,
         [json.loads(ln) for ln in buf.getvalue().splitlines() if ln.startswith("{")])
    if rc != 0 or any("error" in ln for ln in out["bench_all"]):
        raise AssertionError(f"bench_all failed: {out['bench_all']}")
    return out


def sass_ldg_counts() -> dict:
    """Global loads (LDG) in each instantiation of ``gf_bitmatmul.cu``'s
    kernels and in the copy kernels, from ``cuobjdump -sass`` of the built
    libraries: that the stage cuts still load every input row is read
    here.  Keys ``mode<M>_W<W>`` (modes 3-5 the cuts), ``gf_encode_compare``
    and the copy kernels'; values (all LDG, vector LDG.128 / .64)."""
    from ceph_tpu_torch.ops import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    out = {}
    for lib, pattern, key in (
            ("gf_bitmatmul", r"gf_bitmatmul_kernelILi(\d)ELi(\d)E", "mode{}_W{}"),
            ("gf_bitmatmul", r"(gf_encode_compare)_kernel", "{}"),
            ("lab_copy", r"(lab_row_copy\w*kernel)", "{}")):
        sass = subprocess.run([exe, "-sass", os.path.join(_build.BUILD_DIR, f"lib{lib}.so")],
                              check=True, capture_output=True, text=True, timeout=300).stdout
        name = None
        for ln in sass.splitlines():
            if "Function :" in ln:
                hit = re.search(pattern, ln)
                name = key.format(*hit.groups()) if hit else None
                if name:
                    out[name] = [0, 0]
            elif name and re.search(r"\bLDG\b|\bLDG\.", ln):
                out[name][0] += 1
                out[name][1] += bool(re.search(r"LDG\.\S*(128|64)\b", ln))
    return out


#: the integer-pipe opcodes counted in ``sass_clay_ops``
INT_OPCODES = ("LOP3", "PRMT", "SHF", "LEA", "IADD3", "IMAD", "ISETP", "SEL", "IADD", "LOP")


def sass_clay_ops() -> dict:
    """Instructions of each aligned ``clay_repair_kernel<4, W, true>``
    (q = 4, CLAY(8,4,11)'s) by opcode, from ``cuobjdump -sass``: the
    integer ones of ``INT_OPCODES`` and the shared and global loads and
    stores.  The body holds ``kChunk`` = 16 shared inputs unrolled (S = 14
    run) and the 4 private ones."""
    from ceph_tpu_torch.ops import _build

    exe = os.path.join(os.path.dirname(_build.nvcc()), "cuobjdump")
    sass = subprocess.run([exe, "-sass", os.path.join(_build.BUILD_DIR, "libclay_repair.so")],
                          check=True, capture_output=True, text=True, timeout=300).stdout
    out, name = {}, None
    for ln in sass.splitlines():
        if "Function :" in ln:
            hit = re.search(r"clay_repair_kernelILi4ELi(\d)ELb1E", ln)
            name = f"Q4_W{hit[1]}" if hit else None
            if name:
                out[name] = dict.fromkeys((*INT_OPCODES, "LDS", "LDG", "STG", "all"), 0)
        elif name:
            op = re.match(r"\s*/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9]*)", ln)
            if op:
                out[name]["all"] += 1
                if op[1] in out[name]:
                    out[name][op[1]] += 1
    return out


def tools_kernel_rows(cfg: Config, device, worst: dict, launches: dict) -> list[dict]:
    """One row per tools kernel at its probe's shape: CUDA-event ms per
    call, device µs per launch (profile pass), plain and library ms, the
    bound and its share; raises unless it equals its plain version
    there."""
    rows = []
    bounds, probe = tool_bounds(cfg), probe_bounds(cfg)
    for name, (fn, plain, lib, shape) in tool_cases(cfg, device).items():
        entry, replaces, source, kernel = TOOL_ROWS[name]
        bms, by = bounds[name]
        bad, err = _errors(fn(0), plain(0))
        if bad:
            raise AssertionError(f"{name} at {shape}: differs from its plain version "
                                 f"in {bad} bytes")
        calls = 4 if name == "acc_encode" else cfg.tools_calls
        ms = time_ms(fn, calls, cfg.repeats)
        prof = per_launch(fn, calls, shape, kernel)
        rows.append({
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name if name in launches else entry],
            "max_abs_err": max(worst[name], err), "mismatched_bytes": bad,
            "ms": ms, "plain_ms": time_ms(plain, 1, 3), "bound_ms": bms, "bound_by": by,
            "bound_share": bms / ms,
            "library_ms": time_ms(lib, calls, cfg.repeats) if lib is not None else None,
            "library_note": TOOL_LIBRARY[name], "shape": shape,
            "device_us": prof["device_us_mean"],
            "device_ops_per_call": prof["device_ops_per_call"],
        })
        if name in probe:
            rows[-1]["probe_bound_ms"] = probe[name]
    return rows


# ---------------------------------------------------------------------------
# Phases 11-12: the mgr's analytics and the encode service / farm
# ---------------------------------------------------------------------------

MGR_SOURCE = "ceph_tpu_torch/ops/csrc/mgr_analytics.cu"
FOLD_SOURCE = "ceph_tpu_torch/ops/csrc/farm_fold.cu"
#: the jitted XLA code each new kernel replaces
MGR_REPLACES = "ceph_tpu/mgr/analytics.py:213"
FOLD_REPLACES = "ceph_tpu/parallel/encode_farm.py:113"
#: the kinds of random store the analytics kernel is held on: op
#: latencies as the mgr path reports them (the kernel rows' inputs),
#: samples over the store's whole clamp range (one metric never
#: reported), the full int64 range (negatives, wrapping sums and shifts),
#: small values with ties, one sample a metric (n = 1), no sample at all
MGR_KINDS = ("latency", "clamp", "full", "ties", "single", "empty")


def mgr_store(rng: np.random.Generator, shape: tuple, kind: str) -> tuple:
    """A (values, valid, cursor) store of ``kind``; but for ``latency``
    (the mgr's own cursors, in the window) its cursors mix in-window,
    past-the-window, negative and next-to-INT64_MAX values (the ring's
    floor modulo of a wrapped sum)."""
    D, M, W = shape
    i64 = np.iinfo(np.int64)
    if kind == "latency":  # as mgr_reports: 150-2050 µs, a slow daemon, 1 in 8 left out
        vals = rng.integers(150, 2051, size=shape).astype(np.int64)
        vals[3 % D] += 20000
        valid = rng.random(shape) >= 0.125
        return vals, valid, rng.integers(0, W, size=D).astype(np.int64)
    if kind == "full":
        vals = rng.integers(i64.min, i64.max, size=shape, dtype=np.int64, endpoint=True)
        valid = rng.random(shape) < 0.6
    elif kind == "ties":
        vals = rng.integers(-4, 5, size=shape).astype(np.int64)
        valid = rng.random(shape) < 0.8
    else:
        vals = rng.integers(0, (1 << 40) + 1, size=shape).astype(np.int64)
        valid = rng.random(shape) < rng.uniform(0.2, 0.9)
        if kind == "single":
            valid[:] = False
            for m in range(M):
                valid[rng.integers(D), m, rng.integers(W)] = True
        elif kind == "empty":
            valid[:] = False
        else:
            valid[:, 0, :] = False
    cursor = rng.integers(0, W, size=D).astype(np.int64)
    cursor[::3] += W * rng.integers(1, 5)
    cursor[1::5] -= 7 * W
    cursor[: min(D, 2)] = [i64.max, i64.max - 1][: min(D, 2)]
    return vals, valid, cursor


def _mgr_errors(got: dict, want: dict) -> tuple[int, int]:
    """(mismatched values, largest absolute difference) over the six
    outputs, compared on the host as Python ints (no int64 wrap)."""
    bad, err = 0, 0
    for name in ak.OUTPUTS:
        g = got[name].cpu().numpy().astype(np.int64)
        w = want[name].cpu().numpy().astype(np.int64)
        diff = g != w
        bad += int(diff.sum())
        if diff.any():
            err = max(err, max(abs(int(a) - int(b)) for a, b in zip(g[diff], w[diff])))
    return bad, err


def mgr_bound_ms(shape: tuple) -> tuple[float, str]:
    """Least time for one analytics pass: each sample's 8 + 1 bytes and the
    cursors read once, the six outputs written once, over the HBM rate;
    or the EWMA walk's 8 INT32 instructions a sample (the 64-bit shift,
    difference, shift and sum) over the INT32 rate."""
    D, M, W = shape
    nbytes = D * M * W * 9 + D * 8 + (4 * M + 3 * D * M) * 8 + D * M
    t_bytes = nbytes / PEAK_BYTES_PER_S
    t_ops = 8 * D * M * W / PEAK_INT32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes >= t_ops else "operations"


def fold_bound_ms(n: int, m: int, s: int) -> tuple[float, str]:
    """Least time for one fold: n partials read, the parity written,
    (n + 1) m S bytes over the HBM rate (its n - 1 XORs a word are far
    below the INT32 rate)."""
    return (n + 1) * m * s / PEAK_BYTES_PER_S * 1e3, "bytes"


def _shape_name(shape: tuple) -> str:
    return "x".join(map(str, shape))


def phase_kernel_mgr(cfg: Config, device) -> dict[str, int]:
    """The analytics kernel against its plain version on the same
    tensors, every kind of store at each shape of the path and of
    ``cfg.mgr_check_shapes``; returns the largest absolute error a shape
    (raises unless 0)."""
    rng = np.random.default_rng(cfg.seed + 21)
    worst, cases = {}, []
    shapes = (*cfg.mgr_shapes, *cfg.mgr_check_shapes)
    for shape in shapes:
        worst[_shape_name(shape)] = 0
        for kind in MGR_KINDS:
            t = [torch.from_numpy(x).to(device) for x in mgr_store(rng, shape, kind)]
            bad, err = _mgr_errors(ak.analyze(*t), ak.analyze_plain(*t))
            if bad:
                raise AssertionError(f"mgr_analytics {shape} {kind}: {bad} values differ "
                                     "from the plain version")
            cases.append({"shape": list(shape), "kind": kind, "mismatches": bad,
                          "samples": int(t[1].sum())})
    emit({"phase": "kernels_mgr", "cases": cases,
          "geometry": {_shape_name(s): ak.geometry(s[0], s[2]) for s in shapes}})
    return worst


def mgr_reports(store, shape: tuple, reports: int, rng: np.random.Generator) -> None:
    """``reports`` report rounds into ``store``: every daemon ``osd.<d>``
    reports each metric (an op latency in µs, about 1 in 8 left out) once
    a round, osd.3 20 ms slower; more rounds than the window, so every
    ring wraps."""
    D, M, _ = shape
    names = [f"m{m}" for m in range(M)]
    store.reserve(names)
    base = rng.integers(200, 2000, size=(D, M))
    base[3 % D] += 20000
    for r in range(reports):
        keep = rng.random((D, M)) >= 0.125
        noise = rng.integers(-50, 51, size=(D, M))
        for d in range(D):
            store.ingest(f"osd.{d}", {names[m]: float(base[d, m] + noise[d, m])
                                      for m in range(M) if keep[d, m]}, float(r))


def phase_mgr(cfg: Config, device) -> dict:
    """The mgr's digest path at each shape: reports into a
    ``TimeSeriesStore``, an ``AnalyticsEngine`` prewarmed, then
    ``cfg.mgr_passes`` passes over the store's snapshot, each equal to
    the mgr's numpy host path, one kernel launch a pass and no cold
    launch; the summary must flag osd.3.  Launches are counted a shape:
    reset after its prewarm (mgr start), read after its passes."""
    rng = np.random.default_rng(cfg.seed + 22)
    out = {"phase": "mgr_analytics", "shapes": [], "launches": {}}
    for shape in cfg.mgr_shapes:
        store = mgr_daemon.TimeSeriesStore(*shape)
        t0 = time.perf_counter()
        mgr_reports(store, shape, cfg.mgr_reports, rng)
        ingest_s = time.perf_counter() - t0
        engine = mgr_analytics.AnalyticsEngine(*shape, device=device)
        prewarmed = engine.prewarm()
        _sync(device)
        ak.reset_launch_counts()
        pass_s, bad = [], 0
        for _ in range(cfg.mgr_passes):
            snap = store.snapshot()
            t0 = time.perf_counter()
            res = engine.analyze(*snap)
            pass_s.append(time.perf_counter() - t0)
            want = mgr_analytics.analyze_numpy(*snap)
            bad += sum(int((np.asarray(res[k]) != want[k]).sum()) for k in want)
        _sync(device)
        launches = ak.launch_counts()["mgr_analytics"]
        summary = mgr_daemon.analytics_summary(store, res)
        flagged = sorted({d for ds in summary["outliers"].values() for d in ds})
        out["shapes"].append({
            "shape": list(shape), "reports": cfg.mgr_reports * shape[0], "ingest_s": ingest_s,
            "prewarmed_shapes": prewarmed, "passes": cfg.mgr_passes,
            "pass_ms": [s * 1e3 for s in pass_s], "mismatches_vs_numpy": bad,
            "stats": dict(engine.stats), "kernel_launches": launches, "flagged": flagged[:8]})
        out["launches"][_shape_name(shape)] = launches
        if bad:
            raise AssertionError(f"analytics {shape}: {bad} values differ from analyze_numpy")
        if engine.stats["cold_launches"] or prewarmed != 1:
            raise AssertionError(f"analytics {shape}: cold launches {dict(engine.stats)}")
        want_launches = cfg.mgr_passes if torch.device(device).type == "cuda" else 0
        if launches != want_launches or engine.stats["launches"] != cfg.mgr_passes:
            raise AssertionError(f"analytics {shape}: {launches} kernel launches for "
                                 f"{cfg.mgr_passes} passes")
        if f"osd.{3 % shape[0]}" not in flagged:
            raise AssertionError(f"analytics {shape}: the slow osd is not flagged: {flagged}")
    emit(out)
    return out


def _writers(ec, sinfo, svc, objects) -> list:
    async def go():
        return await asyncio.gather(*(ecutil.encode_async(sinfo, ec, o, service=svc)
                                      for o in objects))

    return asyncio.run(go())


def _one_device_mesh(shape: tuple, device) -> Mesh:
    grid = np.array([torch.device(device)] * int(np.prod(shape)), dtype=object).reshape(shape)
    return Mesh(grid, ("pg", "shard"))


def _host_shards(ec, sinfo, C: np.ndarray, obj: np.ndarray) -> dict[int, np.ndarray]:
    """An object's shards on the host: its data shards, and the parity
    ``gf_matmul(C, data)`` (numpy, independent of the kernels)."""
    k, cs = C.shape[1], sinfo.chunk_size
    ns = obj.size // sinfo.stripe_width
    data = obj.reshape(ns, k, cs).transpose(1, 0, 2).reshape(k, ns * cs)
    rows = np.concatenate([data, gf_matmul(C, data)])
    return {ec.chunk_index(i): rows[i] for i in range(rows.shape[0])}


def _service_vs_per_op(cfg: Config, device, ec, sinfo, C, nbytes: int, gen) -> dict:
    """``cfg.farm_writers`` objects of ``nbytes`` written ``cfg.farm_reps``
    times by each path, interleaved: the per-op ``ecutil.encode`` one by
    one, and concurrent ``encode_async`` writers through a prewarmed
    single-device ``EncodeService``.  Every writer's shards are held
    against the host's ``gf_matmul`` and the per-op path's; the
    dispatches and kernel launches are those of the service's timed runs."""
    objects = [_rand((nbytes,), gen, device).cpu().numpy() for _ in range(cfg.farm_writers)]
    s_obj = nbytes // sinfo.stripe_width * sinfo.chunk_size
    svc = EncodeService(device=device, min_bytes=0, window_s=0.002)
    prewarmed = svc.prewarm(C, [s_obj], coalesce=cfg.farm_writers)
    per_op = [ecutil.encode(sinfo, ec, o) for o in objects]   # warm
    farm = _writers(ec, sinfo, svc, objects)
    stats0 = dict(svc.stats)
    per_op_s, farm_s, launches = [], [], 0
    for _ in range(cfg.farm_reps):
        t0 = time.perf_counter()
        per_op = [ecutil.encode(sinfo, ec, o) for o in objects]
        per_op_s.append(time.perf_counter() - t0)
        launches0 = sum(rk.launch_counts().values())
        t0 = time.perf_counter()
        farm = _writers(ec, sinfo, svc, objects)
        farm_s.append(time.perf_counter() - t0)
        launches += sum(rk.launch_counts().values()) - launches0
    host = [_host_shards(ec, sinfo, C, o) for o in objects]
    bad = sum(int((farm[i][sh] != per_op[i][sh]).sum()) for i in range(len(objects))
              for sh in per_op[i])
    host_bad = sum(int((farm[i][sh] != host[i][sh]).sum()) + int(set(farm[i]) != set(host[i]))
                   for i in range(len(objects)) for sh in host[i])
    logical = cfg.farm_writers * nbytes
    dispatches = svc.stats["single_dispatches"] - stats0["single_dispatches"]
    out = {"writers": cfg.farm_writers, "object_bytes": nbytes, "prewarmed_shapes": prewarmed,
           "runs": cfg.farm_reps, "single_dispatches": dispatches,
           "coalesced": svc.stats["coalesced"] - stats0["coalesced"],
           "kernel_launches": launches,
           "launches_per_op": launches / (cfg.farm_reps * cfg.farm_writers),
           "cold_launches": svc.stats["cold_launches"],
           "farm_s": farm_s, "farm_GB_per_s": logical / statistics.median(farm_s) / 1e9,
           "per_op_s": per_op_s, "per_op_GB_per_s": logical / statistics.median(per_op_s) / 1e9,
           "mismatched_bytes": bad, "mismatched_vs_host_gf_matmul": host_bad}
    if bad or host_bad or dispatches >= cfg.farm_reps * cfg.farm_writers \
            or svc.stats["cold_launches"]:
        raise AssertionError(f"encode service: {out}")
    return out


def phase_encode_farm(cfg: Config, device) -> dict:
    """The encode service and farm at the write phase's objects (RS(8,3),
    4 MiB, rows of (8, 524288)): (a) ``cfg.farm_writers`` concurrent
    ``encode_async`` writers through a prewarmed single-device
    ``EncodeService``, byte-equal to the host ``gf_matmul`` and to the
    per-op ``ecutil.encode``, with the dispatches, launches an op and
    logical GB/s beside the per-op path's, at these objects and at
    ``cfg.farm_sweep_bytes``; (b) ``batch_encode_dp`` and
    ``sharded_encode_tp`` on a ``cfg.farm_mesh`` mesh of the one device,
    and the service's tp path for a lone request, byte-equal to the host
    ``gf_matmul``.  Returns the line."""
    ec, sinfo = make_pool(cfg, device)
    k, m = ec.get_data_chunk_count(), ec.get_chunk_count() - ec.get_data_chunk_count()
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 23)
    s_obj = cfg.object_bytes // sinfo.stripe_width * sinfo.chunk_size
    C = np.asarray(ec.coding_matrix, np.uint8)
    single = _service_vs_per_op(cfg, device, ec, sinfo, C, cfg.object_bytes, gen)
    sweep = [_service_vs_per_op(cfg, device, ec, sinfo, C, n, gen)
             for n in cfg.farm_sweep_bytes]

    # (b) the farm's mesh paths on one repeated device
    mesh = _one_device_mesh(cfg.farm_mesh, device)
    bits = torch.as_tensor(gf_matrix_to_bitmatrix(C), device=device)
    rng = np.random.default_rng(cfg.seed + 24)
    batch = rng.integers(0, 256, (mesh.size, k, s_obj), dtype=np.uint8)
    dp = batch_encode_dp(mesh, bits, torch.from_numpy(batch), axis=("pg", "shard")).cpu().numpy()
    dp_bad = sum(int((dp[i] != gf_matmul(C, batch[i])).sum()) for i in range(mesh.size))
    data = rng.integers(0, 256, (k, s_obj), dtype=np.uint8)
    want = gf_matmul(C, data)
    tp_bad = int((sharded_encode_tp(mesh, bits, torch.from_numpy(data)).cpu().numpy()
                  != want).sum())
    msvc = EncodeService(mesh, min_bytes=0, window_s=0.002)
    svc_tp_bad = int((asyncio.run(msvc.apply(C, data)) != want).sum())
    _sync(device)
    mesh_line = {"mesh": mesh.shape, "dp_batch": list(batch.shape), "dp_mismatched": dp_bad,
                 "tp_data": list(data.shape), "tp_mismatched": tp_bad,
                 "service_tp_dispatches": msvc.stats["tp_dispatches"],
                 "service_tp_mismatched": svc_tp_bad}
    out = {"phase": "encode_farm", "k": k, "m": m, "single_device": single,
           "single_device_sweep": sweep, "mesh_paths": mesh_line}
    emit(out)
    if dp_bad or tp_bad or svc_tp_bad or msvc.stats["tp_dispatches"] != 1:
        raise AssertionError(f"encode farm mesh paths: {mesh_line}")
    return out


def run_farm_path(cfg: Config, device) -> dict:
    """Phase 12 with the bit-matrix and fold launches counted alone:
    reset just before, read just after; on the card the fold and the
    store kernel must have been launched."""
    rk.reset_launch_counts()
    farm = phase_encode_farm(cfg, device)
    _sync(device)
    launches = rk.launch_counts()
    store = sum(launches[n] for n in ("gf_bitmatmul", "gf_bitmatmul_pallas",
                                      "gf_bitmatmul_pallas_grouped"))
    if torch.device(device).type == "cuda" and (launches["gf_fold"] <= 0 or store <= 0):
        raise AssertionError(f"kernels not launched on the farm path: {launches}")
    return {"farm": farm, "launches": launches}


def odd_view(t: torch.Tensor) -> torch.Tensor:
    """A copy of ``t`` in a contiguous view that starts one byte into its
    buffer (so none of a fold's partials is 16-byte aligned)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    view = buf[1:].view(t.shape)
    view.copy_(t)
    return view


def phase_kernel_fold(cfg: Config, device) -> int:
    """``gf_fold`` against its plain version at every ``cfg.fold_shapes``
    and ``cfg.fold_check_shapes``, each also on an odd-offset view; emits
    the cases and returns the largest absolute error (raises unless 0)."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 25)
    cases = []
    for n, m, s in (*cfg.fold_shapes, *cfg.fold_check_shapes):
        parts = _rand((n, m, s), gen, device)
        for view in (parts, odd_view(parts)):
            bad, _ = _errors(rk.gf_fold(view), rk.gf_fold_plain(view))
            if bad:
                raise AssertionError(f"gf_fold ({n}, {m}, {s}) at offset "
                                     f"{view.data_ptr() % 16}: {bad} bytes differ")
            cases.append({"shape": [n, m, s], "offset_mod_16": view.data_ptr() % 16,
                          "mismatched_bytes": bad})
    emit({"phase": "kernels_fold", "cases": cases})
    return 0


def _rotated(make, nbytes: int) -> list:
    """Inputs of a timed kernel, enough of them to exceed the 50 MB L2."""
    return [make() for _ in range(max(2, min(16, -(-64 * MiB // max(nbytes, 1)))))]


def mgr_case(cfg: Config, device, rng: np.random.Generator, shape: tuple, kind: str,
             plain_ms: bool = False) -> dict:
    """The analytics kernel on ``kind`` stores of ``shape``, rotated over
    more than the L2: held against its plain version, then device µs a
    launch and device operations a call (profile pass), CUDA-event ms a
    call and the byte bound; the plain version's ms where ``plain_ms``."""
    D, M, W = shape
    bufs = _rotated(lambda: [torch.from_numpy(x).to(device)
                             for x in mgr_store(rng, shape, kind)], D * M * W * 9)
    bad, err = _mgr_errors(ak.unpack(ak.analyze_packed(*bufs[0]), D, M),
                           ak.analyze_plain(*bufs[0]))
    if bad:
        raise AssertionError(f"mgr_analytics {shape} {kind}: {bad} values differ")

    def fn(i):
        return ak.analyze_packed(*bufs[i % len(bufs)])
    prof = per_launch(fn, 48, f"analytics {shape} {kind}", "mgr_analytics_kernel")
    bms, by = mgr_bound_ms(shape)
    out = {"shape": list(shape), "kind": kind, "geometry": list(ak.geometry(D, W)),
           "mismatched_values": bad, "max_abs_err": err,
           "device_us": prof["device_us_mean"], "device_ops_per_call": prof["device_ops_per_call"],
           "ms": time_ms(fn, 48, cfg.repeats), "bound_ms": bms, "bound_by": by}
    if plain_ms:
        out["plain_ms"] = time_ms(lambda i: ak.analyze_plain(*bufs[i % len(bufs)]), 2, 3)
    return out


def mgr_kernel_rows(cfg: Config, device, worst: dict, launches: dict) -> list[dict]:
    """One row a mgr shape: CUDA-event ms a call of ``analyze_packed`` and
    of the plain version, device µs a launch and device operations a call
    (profile pass) and the bound, on latency stores as the mgr path's;
    beside them the device µs on clamp-range stores."""
    rng = np.random.default_rng(cfg.seed + 26)
    rows = []
    for shape in cfg.mgr_shapes:
        D, M, W = shape
        case = mgr_case(cfg, device, rng, shape, "latency", plain_ms=True)
        clamp = mgr_case(cfg, device, rng, shape, "clamp")
        name = _shape_name(shape)
        rows.append({
            "name": f"mgr_analytics:{name}", "route": "cuda", "source": MGR_SOURCE,
            "replaces": MGR_REPLACES, "launches": launches[name],
            "max_abs_err": max(worst[name], case["max_abs_err"], clamp["max_abs_err"]),
            "mismatched_values": case["mismatched_values"] + clamp["mismatched_values"],
            "ms": case["ms"], "plain_ms": case["plain_ms"],
            "bound_ms": case["bound_ms"], "bound_by": case["bound_by"],
            "bound_share": case["bound_ms"] / case["ms"], "library_ms": None,
            "library_note": "no PyTorch call computes the digest (percentiles, EWMA, "
                            "means and outliers)",
            "shape": f"store {shape}", "cluster_and_daemons_a_block": ak.geometry(D, W)[:2],
            "device_us": case["device_us"], "device_ops_per_call": case["device_ops_per_call"],
            "device_us_clamp": clamp["device_us"], "ms_clamp": clamp["ms"]})
    return rows


def phase_mgr_staged(cfg: Config, device) -> dict:
    """The analytics kernel's staged instantiation (rows in global
    scratch) at ``cfg.mgr_staged_shapes``, on latency and clamp-range
    stores: device µs a launch, CUDA-event ms and the byte bound."""
    rng = np.random.default_rng(cfg.seed + 29)
    return {"phase": "mgr_staged",
            "cases": [mgr_case(cfg, device, rng, shape, kind)
                      for shape in cfg.mgr_staged_shapes for kind in ("latency", "clamp")]}


def library_launch(fn, calls: int) -> dict:
    """Device µs a call of a PyTorch call ``fn(i)`` over ``calls`` calls
    (one warm-up first; profile pass): every kernel it launched, and their
    names."""
    fn(0)
    _, dev = traced_calls(fn, calls)
    kern = [e for e in dev if e["cat"] == "kernel"]
    return {"device_us_per_call": sum(e["dur"] for e in kern) / calls,
            "kernels_per_call": len(kern) / calls,
            "kernel_names": sorted({e["name"][:120] for e in kern})}


def fold_case(cfg: Config, device, gen, shape: tuple, *, odd: bool = False) -> dict:
    """The fold at ``shape`` (on odd-offset views where ``odd``), rotated
    over more than the L2: held against its plain version, device µs a launch and device
    operations a call (profile pass), CUDA-event ms, the byte bound; at
    n = 2 beside ``torch.bitwise_xor(p[0], p[1])``, the same function,
    in device µs and ms."""
    n, m, s = shape
    bufs = _rotated(lambda: _rand((n, m, s), gen, device), n * m * s)
    if odd:
        bufs = [odd_view(b) for b in bufs]
    def fn(i):
        return rk.gf_fold(bufs[i % len(bufs)])
    bad, err = _errors(fn(0), rk.gf_fold_plain(bufs[0]))
    if bad:
        raise AssertionError(f"gf_fold {shape} odd={odd}: {bad} bytes differ")
    prof = per_launch(fn, 48, f"fold {shape}", "farm_fold")
    bms, by = fold_bound_ms(n, m, s)
    out = {"shape": list(shape), "offset_mod_16": bufs[0].data_ptr() % 16,
           "mismatched_bytes": bad, "max_abs_err": err,
           "device_us": prof["device_us_mean"], "device_ops_per_call": prof["device_ops_per_call"],
           "ms": time_ms(fn, 48, cfg.repeats), "bound_ms": bms, "bound_by": by,
           "bound_share_device": bms * 1e3 / max(prof["device_us_mean"], 1e-9)}
    if n == 2:
        def lib(i):
            return torch.bitwise_xor(bufs[i % len(bufs)][0], bufs[i % len(bufs)][1])
        out["library"] = {**library_launch(lib, 48), "ms": time_ms(lib, 48, cfg.repeats)}
    out["plain_ms"] = time_ms(lambda i: rk.gf_fold_plain(bufs[i % len(bufs)]), 4, 3)
    return out


def phase_mgr_fold_lab(cfg: Config, device) -> dict:
    """The analytics and fold kernels alone, for an A/B of two trees (run
    this script from each tree's root; it uses only what both wrappers
    take): the analytics kernel at ``cfg.mgr_shapes`` and
    ``cfg.mgr_staged_shapes`` on latency and clamp-range stores; the fold
    at every ``cfg.fold_shapes`` and ``cfg.fold_check_shapes``, and on
    odd-offset views at n = 2."""
    rng = np.random.default_rng(cfg.seed + 30)
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 31)
    out = {"phase": "mgr_fold_lab",
           "mgr": [mgr_case(cfg, device, rng, shape, kind)
                   for shape in (*cfg.mgr_shapes, *cfg.mgr_staged_shapes)
                   for kind in ("latency", "clamp")],
           "fold": [fold_case(cfg, device, gen, shape)
                    for shape in (*cfg.fold_shapes, *cfg.fold_check_shapes)]}
    out["fold"] += [fold_case(cfg, device, gen, shape, odd=True)
                    for shape in cfg.fold_shapes if shape[0] == 2]
    return out


def fold_kernel_row(cfg: Config, device, worst: int, launches: int) -> dict:
    """``farm_fold``'s row at the farm's tp shape, (2, m, S) of the write
    phase's object: CUDA-event ms, device µs, plain ms, the bound, and
    ``torch.bitwise_xor`` of the two partials, the same function at
    n = 2, in ms and device µs."""
    n, m, s = cfg.fold_shapes[0]
    case = fold_case(cfg, device, torch.Generator(device=device).manual_seed(cfg.seed + 27),
                     (n, m, s))
    lib = case.get("library")
    return {"name": "farm_fold", "route": "cuda", "source": FOLD_SOURCE,
            "replaces": FOLD_REPLACES, "launches": launches,
            "max_abs_err": max(worst, case["max_abs_err"]),
            "mismatched_bytes": case["mismatched_bytes"], "ms": case["ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "bound_share": case["bound_ms"] / case["ms"],
            "library_ms": lib["ms"] if lib else None,
            "library_device_us": lib["device_us_per_call"] if lib else None,
            "library_note": "torch.bitwise_xor(p[0], p[1]): the same function at n = 2; "
                            "no PyTorch call XORs n > 2 partials",
            "shape": f"fold ({n}, {m}, {s})", "device_us": case["device_us"],
            "device_ops_per_call": case["device_ops_per_call"]}


def phase_fold_sweep(cfg: Config, device) -> dict:
    """``farm_fold`` at every ``cfg.fold_shapes`` (n = 2, 4 and 8 partials
    of the write phase's rows, and a ragged S): device µs a launch,
    CUDA-event ms a call and the byte bound; at n = 2 beside
    ``torch.bitwise_xor``."""
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 28)
    return {"phase": "fold_sweep",
            "cases": [fold_case(cfg, device, gen, shape) for shape in cfg.fold_shapes]}


def run_main_path(cfg: Config, device, full_check: bool = True) -> dict:
    """Phases 2-6 on ``device``; returns the pool, what was written and
    the scrub and remap phases' lines."""
    ec, sinfo = make_pool(cfg, device)
    objects, written = phase_write(cfg, device, ec, sinfo)
    rebuilt = phase_recover(cfg, device, ec, sinfo, written)
    phase_degraded_read(cfg, ec, sinfo, objects, written)
    scrub = phase_scrub(cfg, device, ec, written, rebuilt)
    remapped = phase_remap(cfg, device, full_check)
    return {"ec": ec, "sinfo": sinfo, "objects": objects, "written": written,
            "scrub": scrub, "remap": remapped}


def run_plugin_path(cfg: Config, device) -> dict:
    """Phases 8-9 on ``device``; returns their lines."""
    return {"plugins": phase_plugins(cfg, device), "clay": phase_clay(cfg, device)}


def run_tools_path(cfg: Config, device) -> dict:
    """Phase 10 on ``device`` with the six tools entry points' launches
    counted alone: reset just before the twins run, read just after.
    Returns the tools line and the launches."""
    rk.reset_launch_counts()
    lk.reset_launch_counts()
    tools = phase_tools(cfg, device)
    _sync(device)
    return {"tools": tools, "launches": tools_launches()}


# ---------------------------------------------------------------------------
# Phase 13: the store path, the card's EC shards persisted in BlockStores
# ---------------------------------------------------------------------------

#: the store pool's id and PG, and the xattr that carries HashInfo
#: (osd/pgutil.py HINFO_ATTR)
STORE_POOL = 1
STORE_PS = 0
HINFO_ATTR = "hinfo"
#: the shard whose store is lost and rebuilt; the shard, and the object
#: (the last one where there are fewer), whose bit flips at rest
STORE_LOST_SHARD = 2
STORE_FLIP_SHARD = 5
STORE_FLIP_OBJECT = 7
#: the kernels that each step of the store path must launch on the card
STORE_STEP_KERNELS = (("encode", "gf_bitmatmul"), ("scrub", "batched_crc32c_device"),
                      ("scrub", "gf_encode_compare"), ("rebuild", "gf_bitmatmul"))


def store_counts() -> dict:
    """The store path's kernel counts as they stand: the bit-matrix
    kernel (every entry point), the crc and the compare."""
    rc = rk.launch_counts()
    return {"gf_bitmatmul": sum(c for name, c in rc.items() if name.startswith("gf_bitmatmul")),
            "batched_crc32c_device": hashing.launch_counts()["batched_crc32c_device"],
            "gf_encode_compare": rc["gf_encode_compare"]}


def counts_since(before: dict) -> dict:
    now = store_counts()
    return {name: now[name] - before[name] for name in now}


def store_profile(cfg: Config) -> dict:
    prof = cfg.profile()
    if cfg.store_device_min_bytes is not None:
        prof["device-min-bytes"] = str(cfg.store_device_min_bytes)
    return prof


def open_store(path: str, osd: int) -> BlockStore:
    """One OSD's BlockStore on its own FileDB, mounted; ``fault_domain``
    is what the OSD daemon sets (``osd.<id>``)."""
    store = BlockStore(path, db=FileDB(os.path.join(path, "kv")))
    store.fault_domain = f"osd.{osd}"
    store.mount()
    return store


def shard_coll(shard: int) -> coll_t:
    return coll_t(STORE_POOL, STORE_PS, shard)


def persist_shard(store: BlockStore, shard: int, oid: str, payload: np.ndarray,
                  hinfo: bytes) -> None:
    """One shard as the OSD's ECTransaction writes it: the collection on
    first use, touch, write, truncate to the shard's length, the hinfo
    xattr; one transaction."""
    c, o = shard_coll(shard), ghobject_t(oid, shard=shard)
    t = Transaction()
    if not store.collection_exists(c):
        t.create_collection(c)
    t.touch(c, o)
    t.write(c, o, 0, payload.tobytes())
    t.truncate(c, o, payload.nbytes)
    t.setattrs(c, o, {HINFO_ATTR: hinfo})
    store.queue_transaction(t)


def read_shard(store: BlockStore, shard: int, oid: str) -> tuple[np.ndarray, bytes]:
    c, o = shard_coll(shard), ghobject_t(oid, shard=shard)
    return (np.frombuffer(store.read(c, o), np.uint8),
            store.getattr(c, o, HINFO_ATTR))


def remount(stores: dict, paths: dict) -> dict:
    """Unmount every store and mount it again from its directory."""
    for s in sorted(stores):
        stores[s].umount()
    return {s: open_store(paths[s], s) for s in sorted(stores)}


def phase_store(cfg: Config, device, root: str) -> dict:
    """The store path under ``root``: ``cfg.store_objects`` objects of
    ``cfg.store_object_bytes`` encoded on ``device``, each shard persisted
    in the BlockStore of its OSD, remounted, fsck'd, read back, deep-
    scrubbed, one store lost and rebuilt, one bit flipped at rest.
    Returns the line with each step's kernel launches beside it (the
    prewarms' apart from the steps'); raises on any mismatch or missing
    EIO."""
    ec = registry.factory("cuda", store_profile(cfg), device=device)
    k, n = ec.get_data_chunk_count(), ec.get_chunk_count()
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(cfg.stripe_unit * k))
    gen = torch.Generator(device=device).manual_seed(cfg.seed + 40)
    objects = [_rand((cfg.store_object_bytes,), gen, device).cpu().numpy()
               for _ in range(cfg.store_objects)]
    oids = [f"rbd_data.{i:016x}" for i in range(cfg.store_objects)]
    paths = {s: os.path.join(root, f"osd.{s}") for s in range(n)}
    out = {"phase": "store", "objects": cfg.store_objects,
           "object_bytes": cfg.store_object_bytes, "shards": n,
           "chunk_size": sinfo.chunk_size, "seconds": {}, "launches_by_step": {}}
    secs, steps = out["seconds"], out["launches_by_step"]
    stores = {s: open_store(paths[s], s) for s in range(n)}
    try:
        # 1. encode on the card, one transaction a shard
        c0, t0 = store_counts(), time.perf_counter()
        written = []
        for obj in objects:
            shards = ecutil.encode(sinfo, ec, obj)
            hinfo = ecutil.HashInfo(n)
            hinfo.append(0, shards)
            written.append((shards, hinfo))
        secs["encode"] = time.perf_counter() - t0
        steps["encode"] = counts_since(c0)
        t0 = time.perf_counter()
        for oid, (shards, hinfo) in zip(oids, written):
            raw = hinfo.to_bytes()
            for s in range(n):
                persist_shard(stores[s], s, oid, shards[s], raw)
        secs["persist"] = time.perf_counter() - t0

        # 2. unmount, mount, fsck
        t0 = time.perf_counter()
        stores = remount(stores, paths)
        fsck = {s: stores[s].fsck() for s in range(n)}
        secs["remount_fsck"] = time.perf_counter() - t0
        out["shard_bytes"] = sum(sh[s].nbytes for sh, _ in written for s in range(n))
        out["bytes_at_rest"] = sum(stores[s].statfs()["used"] for s in range(n))
        out["fsck_after_remount"] = sum(len(v) for v in fsck.values())

        # 3. read every shard and its hinfo back
        t0 = time.perf_counter()
        readback, stored_hinfo, mismatches = [], [], 0
        for oid, (shards, hinfo) in zip(oids, written):
            got = {}
            for s in range(n):
                got[s], raw = read_shard(stores[s], s, oid)
                mismatches += (not np.array_equal(got[s], shards[s])) + (raw != hinfo.to_bytes())
            readback.append(got)
            stored_hinfo.append(ecutil.HashInfo.from_bytes(raw))
        secs["read"] = time.perf_counter() - t0
        out["read_mismatches"] = mismatches

        # 4. deep scrub of the read-back shards, against the stored hinfo
        ver = ScrubVerifier(device=device, crc_lanes=cfg.crc_lanes)
        c0 = store_counts()
        out["scrub_prewarmed_shapes"] = ver.prewarm(ec)
        steps["scrub_prewarm"] = counts_since(c0)

        async def scrub():
            res = []
            for at in range(0, len(readback), cfg.scrub_chunk):
                res += await asyncio.gather(*(
                    ver.verify_object(ec, o) for o in readback[at:at + cfg.scrub_chunk]))
            return res

        c0, t0 = store_counts(), time.perf_counter()
        checks = asyncio.run(scrub())
        secs["scrub"] = time.perf_counter() - t0
        steps["scrub"] = counts_since(c0)
        scrub_bad = 0
        for ch, hinfo in zip(checks, stored_hinfo):
            scrub_bad += sum(ch.crcs[s] != hinfo.get_chunk_hash(s) for s in range(n))
            scrub_bad += len(ch.parity_bad)
        out["scrub_mismatches"] = scrub_bad
        if ver.stats["cold_launches"] != 0:
            raise AssertionError(f"scrub cold launches after prewarm: {dict(ver.stats)}")

        # 5. lose the store of one shard, rebuild it on the card, persist it
        lost = STORE_LOST_SHARD
        stores.pop(lost).umount()
        shutil.rmtree(paths[lost])
        agg = DecodeAggregator(device=device)
        c0 = store_counts()
        out["decode_prewarmed_shapes"] = agg.prewarm(ec, erasure_counts=(1,))
        steps["decode_prewarm"] = counts_since(c0)

        async def rebuild():
            return await asyncio.gather(*(
                ecutil.decode_shards_async(
                    sinfo, ec, {s: c for s, c in got.items() if s != lost}, {lost},
                    aggregator=agg)
                for got in readback))

        c0, t0 = store_counts(), time.perf_counter()
        rebuilt = asyncio.run(rebuild())
        secs["rebuild"] = time.perf_counter() - t0
        steps["rebuild"] = counts_since(c0)
        if agg.stats["cold_launches"] != 0:
            raise AssertionError(f"decode cold launches after prewarm: {dict(agg.stats)}")
        t0 = time.perf_counter()
        stores[lost] = open_store(paths[lost], lost)
        for oid, got, (_, hinfo) in zip(oids, rebuilt, written):
            persist_shard(stores[lost], lost, oid, got[lost], hinfo.to_bytes())
        stores[lost].umount()
        stores[lost] = open_store(paths[lost], lost)
        rebuilt_bad = 0
        for oid, (shards, _) in zip(oids, written):
            rebuilt_bad += not np.array_equal(read_shard(stores[lost], lost, oid)[0],
                                              shards[lost])
        out["fsck_rebuilt_store"] = len(stores[lost].fsck())
        secs["persist_rebuilt"] = time.perf_counter() - t0
        out["lost_shard"] = lost
        out["rebuilt_mismatches"] = rebuilt_bad
        out["decode_launches"] = agg.stats["launches"]

        # 6. a bit flipped at rest: EIO, then a degraded read without it
        victim, at = STORE_FLIP_SHARD, min(STORE_FLIP_OBJECT, cfg.store_objects - 1)
        key = f"store.read.osd.{victim}"
        FAULTS.inject(key, bitflip=True, count=1)
        c0, t0 = store_counts(), time.perf_counter()
        try:
            stores[victim].read(shard_coll(victim), ghobject_t(oids[at], shard=victim))
            eio = None
        except BlobError as e:
            eio = e.errno
        finally:
            FAULTS.clear(key)
        avail = {s: read_shard(stores[s], s, oids[at])[0] for s in range(n) if s != victim}
        degraded_ok = bool(np.array_equal(ecutil.decode_concat(sinfo, ec, avail), objects[at]))
        secs["bitflip_degraded_read"] = time.perf_counter() - t0
        steps["degraded_read"] = counts_since(c0)
        out["bitflip"] = {"shard": victim, "object": at, "read_errno": eio,
                          "degraded_read_equal": degraded_ok,
                          "fsck_after_flip": len(stores[victim].fsck())}
    finally:
        for store in stores.values():
            store.umount()
    out["mismatches"] = (out["read_mismatches"] + out["scrub_mismatches"]
                         + out["rebuilt_mismatches"])
    out["total_seconds"] = sum(secs.values())
    return out


def check_store(line: dict) -> None:
    """What the store line must show: no mismatch, clean fsck after the
    remount and after the rebuild, EIO on the planted bitflip and a
    degraded read equal to the object without that shard."""
    flip = line["bitflip"]
    bad = {k: line[k] for k in ("mismatches", "fsck_after_remount", "fsck_rebuilt_store")
           if line[k] != 0}
    if bad or flip["read_errno"] != errno.EIO or not flip["degraded_read_equal"] \
            or flip["fsck_after_flip"] != 1:
        raise AssertionError(f"store path: {bad or flip}")


def store_path_idle(steps: dict) -> list[str]:
    """The store path's kernels that a step launched no time: the
    bit-matrix kernel at the encode and at the rebuild, the crc and the
    compare at the scrub (its prewarm's launches do not count)."""
    return sorted(f"{kernel}:{step}" for step, kernel in STORE_STEP_KERNELS
                  if steps[step][kernel] <= 0)


def run_store_path(cfg: Config, device) -> dict:
    """Phase 13 with its launches counted alone: reset just before, read
    just after, in a temporary directory removed at the end.  On the card
    each step must have launched its kernels (``STORE_STEP_KERNELS``)."""
    root = tempfile.mkdtemp(prefix="chip_smoke_store_")
    rk.reset_launch_counts()
    hashing.reset_launch_counts()
    try:
        line = phase_store(cfg, device, root)
        _sync(device)
    finally:
        shutil.rmtree(root)
    launches = {**rk.launch_counts(), **hashing.launch_counts()}
    emit(line)
    check_store(line)
    idle = store_path_idle(line["launches_by_step"])
    if torch.device(device).type == "cuda" and idle:
        raise AssertionError(f"kernels not launched on the store path: {idle}")
    return {"store": line, "launches": launches, "idle": idle}


def ptxas_lines(log: str) -> list[str]:
    """What ``ptxas -v`` says of each function: its name, then its stack
    frame and spills, then its registers."""
    return [ln.strip() for ln in log.splitlines()
            if "Function properties for" in ln or "registers" in ln or "spill" in ln]


def main(argv: list[str] | None = None) -> int:
    argv = argv or []
    if argv not in ([], ["--crush-lab"], ["--mgr-fold-lab"]):
        print(f"chip_smoke: unknown arguments {argv}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs only on a GPU",
              file=sys.stderr)
        return 1
    if argv == ["--mgr-fold-lab"]:
        # the two kernels alone: no path is driven, no result line
        from ceph_tpu_torch.ops import _build

        _build.build(["mgr_analytics", "farm_fold"])
        emit(phase_mgr_fold_lab(Config(), torch.device("cuda")))
        print(gpu_name_and_power_limit(), flush=True)
        return 0
    if not native.available():
        raise RuntimeError("the native crc32c library did not build (g++)")
    device = torch.device("cuda")
    cfg = Config()
    from ceph_tpu_torch.ops import _build

    t0 = time.perf_counter()
    _build.build()
    emit({"phase": "build", "seconds": time.perf_counter() - t0,
          "ptxas": {n: ptxas_lines(log) for n, log in _build.BUILD_LOG.items()}})
    emit({"config": dataclasses.asdict(cfg), "plugin": "cuda",
          "torch": torch.__version__, "cuda": torch.version.cuda})
    if argv:
        # the CRUSH lab alone: no path is driven, no result line
        emit(phase_crush_lab(cfg, device))
        print(gpu_name_and_power_limit(), flush=True)
        return 0

    worst = phase_kernels(cfg, device)

    rk.reset_launch_counts()
    hashing.reset_launch_counts()
    cm.reset_launch_counts()
    run_main_path(cfg, device)
    tp = phase_throughput(cfg, device)
    torch.cuda.synchronize()
    launches = {**rk.launch_counts(), **hashing.launch_counts(), **cm.launch_counts()}
    emit({"phase": "main_path_launches", **launches})
    missing = [n for n, c in launches.items() if c <= 0 and n in REPLACES]
    if missing:
        raise AssertionError(f"kernels not launched on the main path: {missing}")

    # the plugin family and the CLAY pool: a path of its own, counted alone
    rk.reset_launch_counts()
    clay_cuda.reset_launch_counts()
    run_plugin_path(cfg, device)
    torch.cuda.synchronize()
    plugin_launches = {**rk.launch_counts(), **clay_cuda.launch_counts()}
    emit({"phase": "plugin_path_launches", **plugin_launches})
    if plugin_launches["clay_repair"] <= 0 or sum(rk.launch_counts().values()) <= 0:
        raise AssertionError(f"kernels not launched on the plugin path: {plugin_launches}")
    launches["clay_repair"] = plugin_launches["clay_repair"]

    # the measurement tools: a path of their own, counted alone; their
    # kernels are first held against their plain versions (not counted)
    tool_worst = phase_kernel_tools(cfg, device)
    tools = run_tools_path(cfg, device)
    emit({"phase": "tools_path_launches", **tools["launches"]})
    idle = [n for n, c in tools["launches"].items() if c <= 0]
    if idle:
        raise AssertionError(f"kernels not launched on the tools path: {idle}")
    emit({"phase": "sass_ldg", **sass_ldg_counts()})
    emit({"phase": "sass_clay_ops", **sass_clay_ops()})

    # the mgr's digest path and the encode farm: paths of their own, each
    # counted alone; their kernels are first held against their plain
    # versions (not counted)
    mgr_worst = phase_kernel_mgr(cfg, device)
    mgr = phase_mgr(cfg, device)
    emit({"phase": "mgr_path_launches", **mgr["launches"]})
    fold_worst = phase_kernel_fold(cfg, device)
    farm = run_farm_path(cfg, device)
    emit({"phase": "farm_path_launches", **farm["launches"]})

    # the store path: the card's shards persisted in BlockStores, counted alone
    t_store = time.perf_counter()
    store = run_store_path(cfg, device)
    store_s = time.perf_counter() - t_store
    emit({"phase": "store_path_launches", **store["launches"],
          "by_step": store["store"]["launches_by_step"]})

    prof = phase_profile(cfg, device, tp)
    rows = kernel_rows(cfg, device, worst, launches, tp, prof["per_launch"])
    for row in rows:
        if row["name"] in rk.launch_counts():
            row["plugin_path_launches"] = plugin_launches[row["name"]]
    rows.append(clay_bench_row(cfg, device, launches["clay_repair"]))
    rows += tools_kernel_rows(cfg, device, tool_worst, tools["launches"])
    rows += mgr_kernel_rows(cfg, device, mgr_worst, mgr["launches"])
    rows.append(fold_kernel_row(cfg, device, fold_worst, farm["launches"]["gf_fold"]))
    emit(phase_crc_sweep(cfg, device))
    emit(phase_mgr_staged(cfg, device))
    emit(phase_fold_sweep(cfg, device))
    wall = time.perf_counter() - t0
    emit({"phase": "wall", "seconds": wall, "store_path_seconds": store_s,
          "store_path_share": store_s / wall})
    emit({"kernels": rows})
    print(gpu_name_and_power_limit(), flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))

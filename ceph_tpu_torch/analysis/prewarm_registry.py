"""Declared prewarm registry — the static twin of ``cold_launches == 0``.

The port's program-creating site is a kernel loader: a function that
calls ``ops/_build.py``'s ``library()``, which compiles
``ops/csrc/<name>.cu`` with nvcc on first use (seconds to minutes)
and loads it with ``dlopen``.  Every loader reachable from the I/O-path
modules (``osd/``, ``parallel/``, ``mgr/analytics.py``) must appear
here, keyed ``module:qualname``, with a note saying WHICH warmup
builds and loads the library before the I/O path can reach it.  The
device-discipline rule (``device-prewarm``) fails the lint when a
reachable loader is missing — so adding a new kernel forces the
author to either wire it into a warmup or consciously register why
it cannot build mid-I/O.

Keep the runtime invariant in mind when editing: an entry here is a
*claim* that the batchers' ``cold_launches`` stay 0; the claim is
checked by the chaos runs, the batcher tests and ``chip_smoke.py``'s
lint phase (every kernel the card launched has its loader here), not
by ctlint.
"""

from __future__ import annotations

#: ``module:qualname`` of the loader -> which warmup builds its library
#: (or why it is allowed to build outside the I/O path).
PREWARMED: dict[str, str] = {
    "ceph_tpu_torch.ops.rs_kernels:_library_entry":
        "gf_bitmatmul.cu (encode/decode/acc, the stage cuts, the "
        "re-encode compare): decode_batcher.prewarm(), "
        "scrub_batcher.prewarm() and encode_service.prewarm() launch "
        "every (signature, batch, bucket) shape at EC map-install "
        "warmup (osd/daemon.py _warm_ec_profiles); the per-op path "
        "(matrix_base._apply_device) reaches the same library, built "
        "by then",
    "ceph_tpu_torch.ops.rs_kernels:_fold_kernel":
        "farm_fold.cu: encode_service.prewarm() launches "
        "sharded_encode_tp (its gf_fold) for every width when the "
        "service's mesh has a shard axis, at EC map-install warmup",
    "ceph_tpu_torch.ops.hashing:_kernel":
        "crc32c_lanes.cu: scrub_batcher.prewarm() launches the crc "
        "over the whole bucket ladder at batch 1 and crc_lanes at EC "
        "map-install warmup",
    "ceph_tpu_torch.ops.analytics_kernels:_kernel":
        "mgr_analytics.cu: AnalyticsEngine.prewarm() launches the one "
        "fixed (D, M, W) shape at mgr start (mgr/daemon.py), before "
        "any digest pass",
    "ceph_tpu_torch.crush.cudamapper:_kernel":
        "crush_rule.cu: built at the first batched mapping, which "
        "remap (BatchedClusterMapper.map_pool) and the balancer run "
        "at map install and planning, never per op",
    "ceph_tpu_torch.crush.cudamapper:launch_geometry":
        "crush_rule.cu's geometry query: the same library as the "
        "mapper's launch, asked for by tools and the smoke after it "
        "is built",
    "ceph_tpu_torch.ec.plugins.clay_cuda:_kernel":
        "clay_repair.cu: a ClayRepairProgram is built per (profile, "
        "lost node) at recovery planning, outside the shard-read "
        "critical path; its first launch builds the library",
    "ceph_tpu_torch.ops.lab_kernels:_copy_kernel":
        "lab_copy.cu: the perf labs' copy probe only (tools/perf_lab*); "
        "each lab launches it once before it times anything, and no "
        "I/O path reaches it",
}

#: the kernel wrappers: their result is a device tensor (the dataflow
#: engine's sources) and their launches are what ``launches.py``
#: counts.
JIT_ENTRYPOINTS: frozenset[str] = frozenset({
    "gf_bitmatmul",
    "gf_encode_compare",
    "gf_bitmatmul_pallas",
    "gf_bitmatmul_pallas_acc",
    "gf_bitmatmul_pallas_grouped",
    "gf_stage_cut",
    "gf_fold",
    "batched_crc32c_device",
    "crush_rule_firstn",
    "crush_rule_indep",
    "crush_rule_msr",
    "clay_repair",
    "analyze_packed",
    "row_copy",
    "repeat_variant",
    "acc_encode",
    "batch_encode_dp",
    "sharded_encode_tp",
})

#: the wrappers that the batchers launch under a warm set keyed by
#: shape (``parallel/decode_batcher.py`` ``_warm``, the scrub
#: verifier's and the encode service's): the device-shape rule
#: (``device-raw-shape``) flags call sites in I/O-path modules that feed
#: these a raw ``len()``/``.shape`` derived dimension instead of a
#: pow2-bucketed one — a shape outside the warmed ladder is a cold
#: launch.
SHAPE_KEYED_ENTRYPOINTS: frozenset[str] = frozenset({
    "gf_bitmatmul",
    "gf_encode_compare",
    "batched_crc32c_device",
    "batch_encode_dp",
    "sharded_encode_tp",
})

#: the pow2-bucket helpers whose outputs are legitimate launch
#: dimensions (the shape-discipline allowlist)
BUCKET_HELPERS: frozenset[str] = frozenset({
    "pow2_bucket",
    "bucket_lanes",
})

#: in-place declarations: ``module:qualname`` of a kernel wrapper ->
#: positional-arg indices of the buffers it updates in place and
#: returns.  The transfer rule ``device-nondonated-inout`` flags an
#: in-place update pattern (``x = wrapper(..., x, ...)``) whose arg is
#: NOT declared here: such a wrapper allocates a second output buffer
#: every call.  An entry is a *claim* that the wrapper really writes
#: the argument's own storage — keep the two in sync.
DONATED: dict[str, tuple[int, ...]] = {
    # carry ^= encode(data ^ seed) in place, and carry returned (the
    # port's twin of the TPU kernel's input_output_aliases={3: 0})
    "ceph_tpu_torch.ops.rs_kernels:gf_bitmatmul_pallas_acc": (2,),
    # the perf lab's looped-encode body: the same acc mode, the same carry
    "ceph_tpu_torch.ops.lab_kernels:acc_encode": (2,),
}

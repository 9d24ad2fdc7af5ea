"""The encode service, its farm and ecutil's async twins against ceph_tpu.

The port's farm runs on an in-process mesh of devices; here a (4, 2)
mesh of ``cpu`` (every rank the kernels' plain versions), beside the
reference's ``jax.sharding.Mesh`` over the virtual 8-device CPU platform
(tests/conftest.py).  Outputs are compared byte for byte (tolerance 0)
and the services' stats key for key.
"""

import asyncio

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JaxMesh

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ops.gf256 import gf_matrix_to_bitmatrix as ref_bitmatrix
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu.parallel import encode_farm as ref_farm
from ceph_tpu.parallel import encode_service as ref_es
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import rs_kernels as rk
from ceph_tpu_torch.ops.gf256 import gf_matmul, gf_matrix_to_bitmatrix
from ceph_tpu_torch.osd import ecutil
from ceph_tpu_torch.parallel import encode_farm as ef
from ceph_tpu_torch.parallel import encode_service as es
from ceph_tpu_torch.parallel.decode_batcher import DecodeAggregator
from tests.xla_private import _private_xla_compiles  # noqa: F401


def _cpu_mesh(shape=(4, 2)) -> ef.Mesh:
    grid = np.array([torch.device("cpu")] * int(np.prod(shape)), dtype=object).reshape(shape)
    return ef.Mesh(grid, ("pg", "shard"))


def _ref_mesh(shape=(4, 2)) -> JaxMesh:
    return JaxMesh(np.asarray(jax.devices()[:int(np.prod(shape))]).reshape(shape),
                   ("pg", "shard"))


@pytest.fixture(autouse=True)
def fresh_service():
    es.reset_shared()
    ref_es.reset_shared()
    yield
    es.reset_shared()
    ref_es.reset_shared()


# ---------------------------------------------------------------------------
# Twins of tests/integration/test_encode_farm_path.py
# ---------------------------------------------------------------------------

def test_apply_matches_host_and_batches():
    async def go():
        svc = es.EncodeService(_cpu_mesh(), min_bytes=0)
        M = isa_cauchy_matrix(4, 2)
        rng = np.random.default_rng(0)
        rows = [rng.integers(0, 256, (4, 1024 + 512 * i), dtype=np.uint8) for i in range(5)]
        outs = await asyncio.gather(*(svc.apply(M, r) for r in rows))
        for r, o in zip(rows, outs):
            assert np.array_equal(o, gf_matmul(M, r))
        assert svc.stats["dp_dispatches"] >= 1
        assert svc.stats["coalesced"] == 5
        # a lone request takes the chunk-sharded tp path (k = 4, 4 % 2 == 0)
        one = rng.integers(0, 256, (4, 4096), dtype=np.uint8)
        out = await svc.apply(M, one)
        assert np.array_equal(out, gf_matmul(M, one))
        assert svc.stats["tp_dispatches"] == 1

    asyncio.run(go())


def test_unit_coalesce_one_dispatch():
    async def go():
        svc = es.EncodeService(device="cpu", min_bytes=1, window_s=0.01)
        assert svc.active()
        rng = np.random.default_rng(3)
        M = rng.integers(0, 256, (3, 4), dtype=np.uint8)
        reqs = [rng.integers(0, 256, (4, 4096 + 512 * i), dtype=np.uint8) for i in range(8)]
        outs = await asyncio.gather(*(svc.apply(M, r) for r in reqs))
        for r, out in zip(reqs, outs):
            assert np.array_equal(out, gf_matmul(M, r))
        # all 8 landed in the window: one launch
        assert svc.stats["single_dispatches"] == 1, dict(svc.stats)
        assert svc.stats["coalesced"] == 8

    asyncio.run(go())


# ---------------------------------------------------------------------------
# The farm's functions against the reference's shard_map programs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,m", [(4, 2), (8, 3), (6, 4)])
def test_farm_functions_match_reference(k, m):
    rng = np.random.default_rng(k * 10 + m)
    C = rng.integers(0, 256, (m, k), dtype=np.uint8)
    bits = ref_bitmatrix(C)
    assert np.array_equal(gf_matrix_to_bitmatrix(C), bits)
    pmesh, jmesh = _cpu_mesh(), _ref_mesh()
    tbits = torch.from_numpy(bits)
    for axis, B in ((("pg", "shard"), 8), ("pg", 4), (("pg", "shard"), 16)):
        batch = rng.integers(0, 256, (B, k, 1024), dtype=np.uint8)
        want = np.asarray(ref_farm.batch_encode_dp(
            jmesh, jax.device_put(bits, ref_farm.replicated_sharding(jmesh)),
            jax.device_put(batch, ref_farm.dp_batch_sharding(jmesh, axis)), axis=axis))
        got = ef.batch_encode_dp(pmesh, tbits, torch.from_numpy(batch), axis=axis)
        assert np.array_equal(got.numpy(), want), axis
    data = rng.integers(0, 256, (k, 2048), dtype=np.uint8)
    want = np.asarray(ref_farm.sharded_encode_tp(
        jmesh, jax.device_put(bits), jax.device_put(data, ref_farm.tp_data_sharding(jmesh))))
    got = ef.sharded_encode_tp(pmesh, tbits, torch.from_numpy(data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, gf_matmul(C, data))


def test_mesh_ranks():
    grid = np.array([torch.device("cpu")] * 8, dtype=object).reshape(4, 2)
    mesh = ef.Mesh(grid, ("pg", "shard"))
    assert mesh.shape == {"pg": 4, "shard": 2} and mesh.size == 8
    assert len(mesh.ranks("pg")) == 4 and len(mesh.ranks("shard")) == 2
    assert len(mesh.ranks(("pg", "shard"))) == 8
    with pytest.raises(ValueError, match="no axis"):
        mesh.ranks("tp")
    with pytest.raises(ValueError, match="axis names"):
        ef.Mesh(grid, ("pg",))
    with pytest.raises(ValueError, match="does not split"):
        ef.batch_encode_dp(mesh, torch.zeros((16, 32), dtype=torch.uint8),
                           torch.zeros((3, 4, 64), dtype=torch.uint8))


def test_tp_columns_follow_the_matrix():
    """The rank's column block is cached while its bit-matrix lives and
    made again when the matrix changes in place."""
    mesh = _cpu_mesh()
    rng = np.random.default_rng(4)
    C = rng.integers(0, 256, (2, 4), dtype=np.uint8)
    bits = torch.from_numpy(gf_matrix_to_bitmatrix(C))
    data = rng.integers(0, 256, (4, 512), dtype=np.uint8)
    assert np.array_equal(ef.sharded_encode_tp(mesh, bits, torch.from_numpy(data)).numpy(),
                          gf_matmul(C, data))
    C2 = rng.integers(0, 256, (2, 4), dtype=np.uint8)
    bits.copy_(torch.from_numpy(gf_matrix_to_bitmatrix(C2)))
    assert np.array_equal(ef.sharded_encode_tp(mesh, bits, torch.from_numpy(data)).numpy(),
                          gf_matmul(C2, data))


def test_gf_fold_plain_matches_numpy():
    rng = np.random.default_rng(8)
    for n, m, s in ((1, 3, 64), (2, 3, 4096), (4, 2, 4096 + 13), (7, 1, 100)):
        parts = rng.integers(0, 256, (n, m, s), dtype=np.uint8)
        want = np.bitwise_xor.reduce(parts, axis=0)
        assert np.array_equal(rk.gf_fold_plain(torch.from_numpy(parts)).numpy(), want)
        rk.reset_launch_counts()
        assert np.array_equal(rk.gf_fold(torch.from_numpy(parts)).numpy(), want)
        assert rk.launch_counts()["gf_fold"] == 0   # the CPU runs the plain version
    with pytest.raises(ValueError, match=r"\(n, m, S\)"):
        rk.gf_fold(torch.zeros((3, 4), dtype=torch.uint8))
    with pytest.raises(TypeError, match="uint8"):
        rk.gf_fold(torch.zeros((2, 3, 4), dtype=torch.int32))


@pytest.mark.parametrize("n", range(1, 9))
def test_gf_fold_plain_every_n(n):
    """The plain version against numpy's XOR reduction at n = 1 .. 8
    partials, aligned and ragged S, also on a view at an odd offset."""
    rng = np.random.default_rng(n)
    for m, s in ((3, 4096), (3, 4096 + 13), (1, 7), (2, 1)):
        buf = rng.integers(0, 256, n * m * s + 1, dtype=np.uint8)
        for off in (0, 1):
            parts = buf[off:off + n * m * s].reshape(n, m, s)
            want = np.bitwise_xor.reduce(parts, axis=0)
            got = rk.gf_fold_plain(torch.from_numpy(buf)[off:off + n * m * s].view(n, m, s))
            assert np.array_equal(got.numpy(), want)


def _fold_kernel_model(mem: np.ndarray, off: int, n: int, N: int, blocks: int) -> np.ndarray:
    """``farm_fold.cu`` step by step on the bytes ``mem`` (address 0 of it
    16-byte aligned), the partials at byte ``off``: every thread's chunks,
    the aligned 16-byte words it loads (each must hold a byte of its
    partial: no load leaves the partials' pages) funnel-shifted into
    place, and block 0's tail bytes.  Returns the output and checks each
    byte is written once."""
    T = rk.FOLD_THREADS
    out = np.zeros(N, np.uint8)
    written = np.zeros(N, np.int64)
    nvec = N >> 4

    def word(a16: int, r: int) -> list[int]:
        lo, hi = a16 * 16, a16 * 16 + 16
        start, end = off + r * N, off + (r + 1) * N
        assert lo < end and hi > start          # holds a byte of partial r
        return [int(x) for x in mem[lo:hi].view("<u4")]

    def realign(lo: list[int], hi: list[int], phase: int) -> list[int]:
        w = lo + hi
        q, s = phase >> 2, (phase & 3) * 8
        return [((w[q + j] | w[q + j + 1] << 32) >> s) & 0xFFFFFFFF for j in range(4)]

    for b in range(blocks):
        for t in range(T):
            for c in range(b * T + t, nvec, blocks * T):
                acc = [0, 0, 0, 0]
                for r in range(n):
                    a = off + r * N
                    phase = a & 15
                    lo = word((a - phase) // 16 + c, r)
                    v = realign(lo, word((a - phase) // 16 + c + 1, r), phase) if phase else lo
                    acc = [x ^ y for x, y in zip(acc, v)]
                out[16 * c:16 * c + 16] = np.array(acc, "<u4").view(np.uint8)
                written[16 * c:16 * c + 16] += 1
    for t in range(N & 15):                     # block 0's tail
        i = nvec * 16 + t
        out[i] = np.bitwise_xor.reduce(mem[off + i:off + n * N:N])
        written[i] += 1
    assert (written == 1).all()
    return out


@pytest.mark.parametrize("n", [1, 2, 3, 8])
def test_fold_kernel_model(n):
    """The kernel's split of a fold (a 16-byte chunk a thread, realigned
    partials, block 0's tail) equals numpy's XOR at aligned and ragged S,
    the partials at offsets 0, 1, 7 and 16, on the planned grid and on a
    grid too small for the chunks (so threads stride)."""
    rng = np.random.default_rng(n)
    for N in (4096, 4096 + 13, 16 * 700 + 5, 160, 9):
        for off in (0, 1, 7, 16):
            mem = rng.integers(0, 256, off + n * N + 32, dtype=np.uint8)
            want = np.bitwise_xor.reduce(mem[off:off + n * N].reshape(n, N), axis=0)
            for blocks in (1, rk.fold_blocks(N, 132)):
                got = _fold_kernel_model(mem, off, n, N, blocks)
                assert np.array_equal(got, want), (n, N, off, blocks)


def test_fold_blocks():
    """The fold's grid: a thread per 16-byte chunk, at most eight blocks an
    SM, at least one (a ragged S's tail alone)."""
    assert rk.fold_blocks(3 * 524288, 132) == 384
    assert rk.fold_blocks(3 * 524288 + 39, 132) == 385
    assert rk.fold_blocks(13, 132) == 1
    assert rk.fold_blocks(1 << 30, 132) == 132 * rk.FOLD_BLOCKS_PER_SM


def test_gf_bitmatmul_into_out():
    rng = np.random.default_rng(6)
    C = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    bits = torch.from_numpy(gf_matrix_to_bitmatrix(C))
    data = rng.integers(0, 256, (2, 5, 300), dtype=np.uint8)
    out = torch.zeros((2, 3, 300), dtype=torch.uint8)
    assert rk.gf_bitmatmul(bits, torch.from_numpy(data), out=out) is out
    assert np.array_equal(out[1].numpy(), gf_matmul(C, data[1]))
    with pytest.raises(ValueError, match="out must be"):
        rk.gf_bitmatmul(bits, torch.from_numpy(data), out=torch.zeros((2, 3, 299),
                                                                      dtype=torch.uint8))


# ---------------------------------------------------------------------------
# The service against the reference's, group for group
# ---------------------------------------------------------------------------

def _groups(rng):
    """Request groups, each applied concurrently (one window): one matrix
    several widths, a lone request (tp on a mesh), two matrices at once."""
    A = rng.integers(0, 256, (2, 4), dtype=np.uint8)
    B = rng.integers(0, 256, (3, 4), dtype=np.uint8)
    return [
        [(A, rng.integers(0, 256, (4, 1024 + 512 * i), dtype=np.uint8)) for i in range(5)],
        [(A, rng.integers(0, 256, (4, 3000), dtype=np.uint8))],
        [(A, rng.integers(0, 256, (4, 2048), dtype=np.uint8)),
         (B, rng.integers(0, 256, (4, 700), dtype=np.uint8)),
         (B, rng.integers(0, 256, (4, 5000), dtype=np.uint8))],
    ]


def _drive(svc, groups):
    async def go():
        outs = []
        for group in groups:
            outs.append(await asyncio.gather(*(svc.apply(M, r) for M, r in group)))
        return outs

    return asyncio.run(go())


@pytest.mark.parametrize("mode", ["mesh", "single"])
def test_service_matches_reference(mode):
    rng = np.random.default_rng(12)
    groups = _groups(rng)
    if mode == "mesh":
        port = es.EncodeService(_cpu_mesh(), min_bytes=0, window_s=0.005)
        ref = ref_es.EncodeService(_ref_mesh(), min_bytes=0, window_s=0.005)
    else:
        port = es.EncodeService(device="cpu", min_bytes=0, window_s=0.005)
        ref = ref_es.EncodeService(device=jax.devices()[0], min_bytes=0, window_s=0.005)
    A = groups[0][0][0]
    assert port.prewarm(A, [1024, 3000], coalesce=4) == ref.prewarm(A, [1024, 3000], coalesce=4)
    got, want = _drive(port, groups), _drive(ref, groups)
    for g_port, g_ref, group in zip(got, want, groups):
        for o, w, (M, r) in zip(g_port, g_ref, group):
            assert np.array_equal(o, w) and np.array_equal(o, gf_matmul(M, r))
    assert dict(port.stats) == dict(ref.stats)
    assert port.metrics.dump() is not None and "fallbacks" not in port.stats


def test_failing_dispatch_reaches_every_waiter(monkeypatch):
    """A dispatch that fails sets its exception on every waiter of the
    group; nothing answers from the host."""
    svc = es.EncodeService(device="cpu", min_bytes=0, window_s=0.005)

    def refuse(bits, data, pallas):
        raise RuntimeError("gf_bitmatmul kernel launch failed: cudaError 700")

    monkeypatch.setattr(rk.BitmatrixCodec, "_apply", staticmethod(refuse))
    rng = np.random.default_rng(1)
    M = rng.integers(0, 256, (2, 4), dtype=np.uint8)

    async def go():
        return await asyncio.gather(
            *(svc.apply(M, rng.integers(0, 256, (4, 512), dtype=np.uint8)) for _ in range(4)),
            return_exceptions=True)

    outs = asyncio.run(go())
    assert len(outs) == 4 and all(isinstance(o, RuntimeError) for o in outs)
    assert svc.stats["single_dispatches"] == 0 and "fallbacks" not in svc.stats


def test_single_dispatch_results_outlive_the_staging_buffer(monkeypatch):
    """On a card the single-device dispatch stages its rows and its result
    in pinned buffers that the next dispatch reuses.  A waiter's result
    must be its own copy: a lone request of a pow2 width is the whole
    buffer, and were it returned as a view, the next dispatch would
    overwrite it before the waiter reads it.  Stood in for on the CPU by
    a product that returns one reused buffer."""
    svc = es.EncodeService(device="cpu", min_bytes=0)
    M = isa_cauchy_matrix(4, 2)
    shared_out = torch.zeros((2, 4096), dtype=torch.uint8)
    plain = rk.BitmatrixCodec._apply

    def into_one_buffer(bits, rows, out):
        return shared_out.copy_(plain(bits, rows, out))

    monkeypatch.setattr(rk.BitmatrixCodec, "_apply", staticmethod(into_one_buffer))
    rng = np.random.default_rng(8)
    first, second = (rng.integers(0, 256, (4, 4096), dtype=np.uint8) for _ in range(2))
    out1 = svc._run_group_single([(M, first, None)], svc._bits(M), 4)[0]
    out2 = svc._run_group_single([(M, second, None)], svc._bits(M), 4)[0]
    assert np.array_equal(out1, gf_matmul(M, first))
    assert np.array_equal(out2, gf_matmul(M, second))
    assert not np.shares_memory(out1, shared_out.numpy())


def test_shared_needs_a_card_or_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        es.shared()
    svc = es.shared(device="cpu")
    assert svc.active() and svc.mesh is None and svc.device.type == "cpu"
    # the held CPU service is not handed to a caller that asks for the card
    with pytest.raises(RuntimeError):
        es.shared()
    assert es.shared(device="cpu") is svc
    es.reset_shared()
    assert not es.EncodeService().active()


# ---------------------------------------------------------------------------
# ecutil's async twins against the reference's
# ---------------------------------------------------------------------------

PROFILE = {"k": "4", "m": "2", "technique": "cauchy", "device-min-bytes": "0"}


def _pool(device_profile=PROFILE):
    ec = registry.factory("cuda", dict(device_profile), device="cpu")
    ref = ref_registry.factory("jax", dict(device_profile))
    k = ec.get_data_chunk_count()
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(4096 * k))
    rsinfo = ref_ecutil.StripeInfo(k, k * ref.get_chunk_size(4096 * k))
    return ec, ref, sinfo, rsinfo


def _async_flow(mod, sinfo, ec, svc, objects, *, aggregator=None):
    async def go():
        shards = await asyncio.gather(*(mod.encode_async(sinfo, ec, o, service=svc)
                                        for o in objects))
        reads = await asyncio.gather(*(mod.decode_concat_async(
            sinfo, ec, {s: c for s, c in sh.items() if s not in (1, 4)}, service=svc)
            for sh in shards))
        kw = {"aggregator": aggregator} if aggregator is not None else {}
        rebuilt = await asyncio.gather(*(mod.decode_shards_async(
            sinfo, ec, {s: c for s, c in sh.items() if s != 2}, {2}, service=svc, **kw)
            for sh in shards))
        return shards, reads, rebuilt

    return asyncio.run(go())


@pytest.mark.parametrize("mode", ["mesh", "single", "under_min_bytes"])
def test_async_ecutil_matches_reference(mode):
    rng = np.random.default_rng(21)
    ec, ref, sinfo, rsinfo = _pool()
    objects = [rng.integers(0, 256, sinfo.stripe_width * (2 + i), dtype=np.uint8)
               for i in range(4)]
    min_bytes = 1 << 30 if mode == "under_min_bytes" else 0
    if mode == "mesh":
        port = es.EncodeService(_cpu_mesh(), min_bytes=min_bytes, window_s=0.005)
        rsvc = ref_es.EncodeService(_ref_mesh(), min_bytes=min_bytes, window_s=0.005)
    else:
        port = es.EncodeService(device="cpu", min_bytes=min_bytes, window_s=0.005)
        rsvc = ref_es.EncodeService(device=jax.devices()[0], min_bytes=min_bytes,
                                    window_s=0.005)
    got = _async_flow(ecutil, sinfo, ec, port, objects)
    want = _async_flow(ref_ecutil, rsinfo, ref, rsvc, objects)
    for (sh, rd, rb), (rsh, rrd, rrb), obj in zip(zip(*got), zip(*want), objects):
        assert set(sh) == set(rsh) == set(range(6))
        assert all(np.array_equal(sh[s], rsh[s]) for s in sh)
        assert np.array_equal(rd, rrd) and np.array_equal(rd, obj)
        assert set(rb) == {2} and np.array_equal(rb[2], rrb[2]) and np.array_equal(rb[2], sh[2])
    assert dict(port.stats) == dict(rsvc.stats)
    farm = port.stats["dp_dispatches"] + port.stats["tp_dispatches"] + port.stats[
        "single_dispatches"]
    assert (farm == 0) == (mode == "under_min_bytes")


def test_async_ecutil_gates_and_aggregator_first():
    """A packet code takes the sync path; with an aggregator the recovery
    decodes go to it, not the farm."""
    rng = np.random.default_rng(5)
    svc = es.EncodeService(device="cpu", min_bytes=0, window_s=0.005)
    ec = registry.factory("jerasure", {"k": "4", "m": "2", "technique": "liberation",
                                       "packetsize": "32"}, device="cpu")
    k = ec.get_data_chunk_count()
    sinfo = ecutil.StripeInfo(k, k * ec.get_chunk_size(4096 * k))
    obj = rng.integers(0, 256, sinfo.stripe_width * 2, dtype=np.uint8)
    shards = asyncio.run(ecutil.encode_async(sinfo, ec, obj, service=svc))
    assert all(np.array_equal(shards[s], c) for s, c in ecutil.encode(sinfo, ec, obj).items())
    assert sum(svc.stats.values()) == 0
    ec, _, sinfo, _ = _pool()
    agg = DecodeAggregator(device="cpu", window_s=0.005)
    objects = [rng.integers(0, 256, sinfo.stripe_width * 2, dtype=np.uint8) for _ in range(3)]
    shards, _, rebuilt = _async_flow(ecutil, sinfo, ec, svc, objects, aggregator=agg)
    assert all(np.array_equal(r[2], s[2]) for r, s in zip(rebuilt, shards))
    assert agg.stats["batched_requests"] == 3
    assert svc.stats["coalesced"] == 3 + 3   # the encodes and the concat reads only


def test_inactive_service_and_uneven_tp_raise():
    with pytest.raises(RuntimeError, match="inactive"):
        asyncio.run(es.EncodeService().apply(np.zeros((2, 4), np.uint8),
                                             np.zeros((4, 64), np.uint8)))
    with pytest.raises(ValueError, match="do not split"):
        ef.sharded_encode_tp(_cpu_mesh(), torch.zeros((16, 24), dtype=torch.uint8),
                             torch.zeros((3, 64), dtype=torch.uint8))

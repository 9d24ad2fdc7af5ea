"""The port's CLAY plugin and its single-launch repair against ceph_tpu.

For CLAY(4,2,5) (the Ceph docs' example), (8,4,11) and (8,3,10) (q=3,
t=4, one shortened node), on the CPU: encode, ``minimum_to_decode``'s
sub-chunk runs, the host repair from the minimum reads, the layered
multi-erasure decode, and ``ecutil.decode_shards(packed_repair=True)``
over 3 stripes, each equal to the reference's (tolerance 0).  Then the
kernel's arithmetic: a numpy model of its packed-word GF(2^8) multiply
(PRMT lookups in the host-built product tables) against ``gf_mul`` for
all 256 x 256 pairs, a numpy model of the whole kernel on the schedule's
table (also CLAY(4,5,8), q = 5) against the plain version, and
``clay_repair.cu``'s device code compiled with g++ as host C++ and held
against the plain version (aligned and ragged sub-chunks).  ``ClayRepairProgram`` against
the reference's jitted program is in test_torch_clay_program.py.
"""

import ctypes
import itertools
import pathlib
import subprocess

import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch.ec import ECError, registry
from ceph_tpu_torch.ec.plugins import clay_cuda
from ceph_tpu_torch.ops.gf256 import gf_mul
from ceph_tpu_torch.osd import ecutil
from tests.xla_private import _private_xla_compiles  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parent.parent
GEOMETRIES = [(4, 2, 5), (8, 4, 11), (8, 3, 10)]


def _profile(k, m, d, **extra) -> dict:
    return {"k": str(k), "m": str(m), "d": str(d), **extra}


def _pair(k, m, d, **extra):
    prof = _profile(k, m, d, **extra)
    return (ref_registry.factory("clay", dict(prof)),
            registry.factory("clay", dict(prof), device="cpu"))


def _node(ec, chunk: int) -> int:
    return chunk if chunk < ec.k else chunk + ec.nu


def _helpers(ec, enc: dict, lost: int, sub: int) -> dict:
    minimum = ec.minimum_to_decode({lost}, set(range(ec.k + ec.m)) - {lost})
    return {c: np.concatenate([enc[c][o * sub:(o + n) * sub] for o, n in runs])
            for c, runs in minimum.items()}


@pytest.fixture(scope="module", params=GEOMETRIES, ids=lambda g: "clay{}-{}-{}".format(*g))
def coded(request):
    k, m, d = request.param
    ref, port = _pair(k, m, d)
    cs = port.get_chunk_size(k * 1024)
    data = np.random.default_rng(k * 100 + m).integers(0, 256, k * cs, dtype=np.uint8)
    enc = port.encode(set(range(k + m)), data)
    return ref, port, cs, data, enc


def test_geometry_and_encode_equal(coded):
    ref, port, cs, data, enc = coded
    assert (port.q, port.t, port.nu, port.sub_chunk_no) == (ref.q, ref.t, ref.nu,
                                                            ref.sub_chunk_no)
    assert cs == ref.get_chunk_size(port.k * 1024)
    want = ref.encode(set(range(port.k + port.m)), data)
    assert all(np.array_equal(enc[i], want[i]) for i in want)


def test_minimum_to_decode_runs_equal(coded):
    ref, port, *_ = coded
    n = port.k + port.m
    for lost in range(n):
        avail = set(range(n)) - {lost}
        got = port.minimum_to_decode({lost}, avail)
        assert got == ref.minimum_to_decode({lost}, avail)
        assert len(got) == port.d
        assert all(sum(c for _, c in runs) == port.sub_chunk_no // port.q
                   for runs in got.values())
        assert port.get_repair_subchunks(_node(port, lost)) == \
            ref.get_repair_subchunks(_node(ref, lost))
    for lost in itertools.combinations(range(n), 2):
        avail = set(range(n)) - set(lost)
        assert port.minimum_to_decode(set(lost), avail) == \
            ref.minimum_to_decode(set(lost), avail)


def test_host_repair_equal(coded):
    """The host traversal (decode with partial helper payloads)
    rebuilds each lost chunk from 1/q of each of d helpers."""
    ref, port, cs, _, enc = coded
    sub = cs // port.sub_chunk_no
    for lost in range(port.k + port.m):
        helpers = _helpers(port, enc, lost, sub)
        got = port.decode({lost}, helpers, cs)[lost]
        assert np.array_equal(got, enc[lost]), lost
        assert np.array_equal(got, ref.decode({lost}, helpers, cs)[lost])


def test_layered_decode_equal(coded):
    ref, port, cs, _, enc = coded
    n = port.k + port.m
    for e in range(2, port.m + 1):
        for lost in list(itertools.combinations(range(n), e))[::5]:
            avail = {i: c for i, c in enc.items() if i not in lost}
            got = port.decode(set(range(n)), avail, cs)
            want = ref.decode(set(range(n)), avail, cs)
            for i in range(n):
                assert np.array_equal(got[i], enc[i]) and np.array_equal(got[i], want[i])


@pytest.mark.parametrize("k,m,d", GEOMETRIES)
def test_ecutil_packed_repair_three_stripes(k, m, d):
    """ecutil.decode_shards(packed_repair=True) over 3 stripes of
    minimum-run reads (the twin of tests/test_clay.py:228-258)."""
    ref, port = _pair(k, m, d)
    n = k + m
    cs = port.get_chunk_size(1)
    sinfo, ref_sinfo = ecutil.StripeInfo(k, k * cs), ref_ecutil.StripeInfo(k, k * cs)
    sc = cs // port.sub_chunk_no
    ns = 3
    data = np.random.default_rng(31).integers(0, 256, ns * sinfo.stripe_width, dtype=np.uint8)
    shards = ecutil.encode(sinfo, port, data)
    want = ref_ecutil.encode(ref_sinfo, ref, data)
    assert all(np.array_equal(shards[s], want[s]) for s in want)
    for lost in (0, k - 1, n - 1):
        minimum = port.minimum_to_decode({lost}, set(range(n)) - {lost})
        payloads = {
            node: np.concatenate([
                shards[node][s * cs + off * sc: s * cs + (off + cnt) * sc]
                for s in range(ns) for off, cnt in runs])
            for node, runs in minimum.items()}
        got = ecutil.decode_shards(sinfo, port, payloads, {lost}, packed_repair=True)
        ref_got = ref_ecutil.decode_shards(ref_sinfo, ref, payloads, {lost},
                                           packed_repair=True)
        assert np.array_equal(got[lost], shards[lost])
        assert np.array_equal(got[lost], ref_got[lost])
    assert np.array_equal(ecutil.decode_concat(
        sinfo, port, {s: c for s, c in shards.items() if s not in (0, n - 1)}), data)


def test_clay_inner_codes_on_the_codes_device():
    ec = registry.factory("clay", _profile(4, 2, 5), device="cpu")
    assert ec.device.type == ec.mds.device.type == ec.pft.device.type == "cpu"
    isa = registry.factory("clay", _profile(4, 2, 5, scalar_mds="isa"), device="cpu")
    assert type(isa.mds).__name__ == "ErasureCodeIsa"


# -- the schedule and the plain version --------------------------------------

def test_schedule_refuses_what_the_kernel_does_not_take():
    with pytest.raises(ValueError, match="aloof"):
        clay_cuda.RepairSchedule(registry.factory("clay", _profile(4, 2, 4), device="cpu"), 0)
    packet = registry.factory(
        "clay", _profile(4, 2, 5, technique="cauchy_good"), device="cpu")
    with pytest.raises(ValueError, match="byte-stream"):
        clay_cuda.RepairSchedule(packet, 0)
    with pytest.raises(ECError):
        registry.factory("clay", _profile(4, 2, 5, scalar_mds="jax"), device="cpu")


def _staged(k, m, d, lost_chunk, sc, seed=3):
    ec = registry.factory("clay", _profile(k, m, d), device="cpu")
    prog = clay_cuda.ClayRepairProgram(ec, _node(ec, lost_chunk), device="cpu")
    rng = np.random.default_rng(seed)
    H = torch.from_numpy(rng.integers(0, 256, (prog.schedule.n_helpers, prog.schedule.P, sc),
                                      dtype=np.uint8))
    shortened = [i for i, n in enumerate(prog.helper_nodes) if ec.k <= n < ec.k + ec.nu]
    assert prog.shortened == shortened
    assert clay_cuda.chunk_node(ec, lost_chunk) == _node(ec, lost_chunk)
    H[shortened] = 0  # shortened nodes are zero rows
    return ec, prog, H


def test_plain_version_is_columnwise():
    """A ragged sub-chunk gives the aligned result's first columns."""
    _, prog, H = _staged(8, 4, 11, 3, 64)
    full = clay_cuda.clay_repair(H, prog.schedule)
    part = clay_cuda.clay_repair(H[..., :37].contiguous(), prog.schedule)
    assert full.shape == (64, 64) and torch.equal(part, full[:, :37])
    assert clay_cuda.launch_counts() == {"clay_repair": 0}


def test_schedule_table_layout():
    _, prog, _ = _staged(8, 4, 11, 9, 4)
    s = prog.schedule
    assert (s.P, s.K, s.Q, s.n_helpers, s.sub_chunk_no) == (16, 8, 4, 11, 64)
    # the stages composed: 14 shared inputs (8 a-, 6 b-operands) and one
    # private input per output, each product a 5-word table
    assert s.S == 14 and s.inputs.shape == (16, 14 + 4) and s.coef.shape == (16, 15, 4)
    assert s.table.shape == (16, 5 * 4 * 15 + 14 + 2 * 4) and s.table.dtype == np.int32
    assert np.array_equal(s.table[:, -4:], s.out_z)
    assert np.array_equal(s.table[:, 300:318], s.inputs)
    # the lost node's own output is a copy of its U: no private input
    assert np.all((s.inputs[:, 14:] < 0) == (s.c_h == 0))
    assert sorted(s.out_z.reshape(-1).tolist()) == list(range(64))
    # one copy per survivor q-row in each plane, the rest pair solves
    assert int((s.b_c == 0).sum()) == 16 * (s.K // s.Q)
    assert s.d.shape == (s.Q, s.K) and s.e_h.shape == (s.Q,)


# -- the kernel's arithmetic ----------------------------------------------------

def byte_perm(a, b, sel) -> np.ndarray:
    """CUDA's ``__byte_perm`` (default mode) on numpy uint32 arrays: byte
    t of the result is byte ``sel`` nibble t of the 8 bytes (b:a); the
    kernel keeps bit 3 of every nibble clear."""
    a, b, sel = (np.asarray(v, np.uint32) for v in (a, b, sel))
    v = (b.astype(np.uint64) << np.uint64(32)) | a.astype(np.uint64)
    out = np.zeros(np.broadcast(a, b, sel).shape, np.uint32)
    for t in range(4):
        nib = (sel >> np.uint32(4 * t)) & np.uint32(15)
        assert not np.any(nib & np.uint32(8))
        byte = (v >> (np.uint64(8) * (nib & np.uint32(7)).astype(np.uint64))) & np.uint64(0xFF)
        out |= byte.astype(np.uint32) << np.uint32(8 * t)
    return out


def kernel_selectors(x) -> list:
    """clay_repair.cu's ``selectors``: the three fields of each byte at
    nibble t of a PRMT selector (bytes 1 and 2 swapped)."""
    x = np.asarray(x, np.uint32)
    fields = (x & np.uint32(0x07070707), (x >> np.uint32(3)) & np.uint32(0x07070707),
              (x >> np.uint32(6)) & np.uint32(0x03030303))
    return [v + (v >> np.uint32(12)) for v in fields]


def kernel_product(t: np.ndarray, x) -> np.ndarray:
    """clay_repair.cu's ``product``: the 5 table words t (one coefficient)
    times the words x, bytes 1 and 2 swapped."""
    s0, s1, s2 = kernel_selectors(x)
    t = np.asarray(t).view(np.uint32)
    return byte_perm(t[0], t[1], s0) ^ byte_perm(t[2], t[3], s1) ^ byte_perm(t[4], 0, s2)


def unswap(w) -> np.ndarray:
    """The stored word: bytes 1 and 2 of a sum swapped back."""
    return byte_perm(w, 0, 0x3120)


def kernel_model(H: np.ndarray, sched) -> np.ndarray:
    """numpy model of clay_repair.cu on the schedule's table: per plane,
    each output the XOR of the products of its shared inputs and its
    private input, read from the table exactly as the kernel reads it
    (zeros past sc).  H (n_helpers, P, sc) -> (sub_chunk_no, sc)."""
    nh, P, sc = H.shape
    S, Q = sched.S, sched.Q
    words = -(-sc // 4)
    cells = np.zeros((nh * P, 4 * words), np.uint8)
    cells[:, :sc] = H.reshape(nh * P, sc)
    cells = cells.view("<u4")
    out = np.zeros((sched.sub_chunk_no, 4 * words), np.uint8)
    n = 5 * Q * (S + 1)
    for p in range(P):
        row = sched.table[p]
        t01 = row[:4 * Q * (S + 1)].reshape(S + 1, Q, 4)
        t2 = row[4 * Q * (S + 1):n].reshape(S + 1, Q)
        ins, oz = row[n:n + S + Q], row[n + S + Q:]
        acc = np.zeros((Q, words), np.uint32)
        for e in range(Q):
            for i in range(S + 1):
                r = ins[i] if i < S else ins[S + e]
                if r >= 0:
                    acc[e] ^= kernel_product(np.append(t01[i, e], t2[i, e]), cells[r])
            out[oz[e]] = unswap(acc[e]).view(np.uint8)
    return out[:, :sc]


def test_packed_word_multiply_model_all_pairs():
    """The kernel's multiply: every constant's product tables applied to
    all 256 bytes (packed four to a word) give gf_mul, once the sum's
    bytes 1 and 2 are swapped back."""
    xs = np.arange(256, dtype=np.uint8)
    words = xs.view("<u4")
    tables = clay_cuda.product_tables(np.arange(256, dtype=np.uint8))
    for c in range(256):
        got = unswap(kernel_product(tables[c], words)).view(np.uint8)
        assert np.array_equal(got, gf_mul(np.uint8(c), xs)), c


@pytest.mark.parametrize("k,m,d", GEOMETRIES + [(4, 5, 8)])
def test_kernel_model_equals_plain(k, m, d):
    """The numpy model of the kernel on the host-built table equals the
    plain version for every lost node, at an aligned and a ragged
    sub-chunk (the reference's jitted program: test_torch_clay_program.py)."""
    for lost in range(k + m):
        for sc in (64, 64 + 13):
            _, prog, H = _staged(k, m, d, lost, sc, seed=lost + sc)
            want = clay_cuda.clay_repair_plain(H, prog.schedule).numpy()
            assert np.array_equal(kernel_model(H.numpy(), prog.schedule), want), (lost, sc)


_HOST_PRELUDE = r"""
#include <algorithm>
#include <cstdint>
#include <cstring>
using std::min;
#define __host__
#define __device__
#define __forceinline__ inline
#define __restrict__
struct uint4 { uint32_t x, y, z, w; };
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
"""
# every thread of every block, one after another, with the plane's slice
# copied to an aligned buffer as the block copies it to shared memory
_HOST_LOOP = r"""
template <int Q, int W, bool kAligned>
static void run(const uint8_t* H, uint8_t* out, const int32_t* table, int P, int S,
                long long sc) {
  const int n = slice_words(S, Q);
  alignas(16) static int32_t slice[12288];
  long long* off = reinterpret_cast<long long*>(slice + offsets_at(S, Q));
  for (int p = 0; p < P; ++p) {
    std::memcpy(slice, table + (long long)p * n, n * sizeof(int32_t));
    const int32_t* in = slice + 5 * Q * (S + 1);
    for (int i = 0; i < S + Q; ++i) off[i] = in[i] >= 0 ? (long long)in[i] * sc : -1ll;
    for (long long blk = 0; 4 * blk * kThreads * W < sc; ++blk)
      for (int t = 0; t < kThreads; ++t) {
        long long cols[W];
        for (int j = 0; j < W; ++j) cols[j] = 4 * (blk * kThreads * W + j * kThreads + t);
        if (cols[0] < sc) repair_words<Q, W, kAligned>(H + cols[0], out, slice, off, S, sc, cols);
      }
  }
}
template <int Q>
static void run_q(const uint8_t* H, uint8_t* out, const int32_t* table, int P, int S,
                  long long sc, int aligned) {
  if (aligned) run<Q, 2, true>(H, out, table, P, S, sc);
  else run<Q, 1, false>(H, out, table, P, S, sc);
}
}  // namespace

extern "C" void host_repair(const uint8_t* H, uint8_t* out, const int32_t* table, int P,
                            int S, int Q, long long sc, int aligned) {
  switch (Q) {
    case 2: run_q<2>(H, out, table, P, S, sc, aligned); break;
    case 3: run_q<3>(H, out, table, P, S, sc, aligned); break;
    case 4: run_q<4>(H, out, table, P, S, sc, aligned); break;
    default: run_q<5>(H, out, table, P, S, sc, aligned); break;
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``clay_repair.cu``'s device code compiled with g++ as host code,
    one column word after another: its arithmetic, not its speed."""
    src = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "clay_repair.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src[: src.index("// -- kernel and launch")]
    d = tmp_path_factory.mktemp("clay_host")
    cpp, so = d / "clay_host.cpp", d / "libclay_host.so"
    cpp.write_text(_HOST_PRELUDE + src + _HOST_LOOP)
    subprocess.run(["g++", "-O1", "-w", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_repair.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int]
    return lib


@pytest.mark.parametrize("k,m,d,lost,sc", [
    (4, 2, 5, 0, 64), (4, 2, 5, 5, 64), (8, 4, 11, 3, 64), (8, 4, 11, 9, 256),
    (8, 3, 10, 0, 64), (8, 3, 10, 10, 64), (8, 4, 11, 3, 64 + 13), (8, 3, 10, 7, 5),
    (4, 5, 8, 0, 64), (4, 5, 8, 8, 4096 + 13), (8, 4, 11, 3, 4096),
])
def test_kernel_source_as_host_code(host_kernel, k, m, d, lost, sc):
    """Each thread's words as the launch lays them out: two words a
    thread kThreads words apart where aligned, else one; the inputs'
    offsets after the slice, as in the block's shared memory."""
    _, prog, H = _staged(k, m, d, lost, sc, seed=lost + sc)
    s = prog.schedule
    want = clay_cuda.clay_repair_plain(H, s)
    table = torch.from_numpy(s.table)
    out = torch.zeros_like(want)
    host_kernel.host_repair(H.data_ptr(), out.data_ptr(), table.data_ptr(), s.P, s.S, s.Q, sc,
                            int(sc % 4 == 0))
    assert torch.equal(out, want)


def test_constants_match_kernel_source():
    text = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "clay_repair.cu").read_text()
    assert f"kThreads = {clay_cuda.THREADS};" in text
    assert f"kMaxQ = {clay_cuda.MAX_Q};" in text


def test_inner_code_failure_raises_out_of_encode_and_decode(monkeypatch):
    """A failed product of an inner code propagates: no host fallback."""
    ec = registry.factory("clay", _profile(4, 2, 5), device="cpu")
    for inner in (ec.mds, ec.pft):
        inner.device_min_bytes = 0

    def refused(M, rows):
        raise RuntimeError("kernel launch refused")

    data = np.random.default_rng(4).integers(0, 256, 4 * ec.get_chunk_size(1), dtype=np.uint8)
    enc = ec.encode(set(range(6)), data)
    monkeypatch.setattr(ec.pft, "_apply_device", refused)
    monkeypatch.setattr(ec.mds, "_apply_device", refused)
    with pytest.raises(RuntimeError, match="refused"):
        ec.encode(set(range(6)), data)
    with pytest.raises(RuntimeError, match="refused"):
        ec.decode(set(range(6)), {i: c for i, c in enc.items() if i not in (0, 5)},
                  len(enc[0]))


def test_repair_refuses_other_devices_and_shapes():
    _, prog, H = _staged(4, 2, 5, 0, 16)
    with pytest.raises(ValueError, match="unsupported device"):
        clay_cuda.clay_repair(torch.empty(H.shape, dtype=torch.uint8, device="meta"),
                              prog.schedule)
    with pytest.raises(ValueError, match=r"\(5, 4, sc\)"):
        clay_cuda.clay_repair(H[:, :3], prog.schedule)
    with pytest.raises(TypeError):
        clay_cuda.clay_repair(H.to(torch.int32), prog.schedule)

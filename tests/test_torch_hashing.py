"""ceph_tpu_torch.ops.hashing and native.crc32c_zeros against ceph_tpu (CPU).

The crc helpers (M_W, S_W, the un-advance, the zeros path) equal the JAX
package's; the plain PyTorch batched crc equals the JAX
``batched_crc32c_device`` run on the CPU and the native host crc32c;
a numpy model of the CUDA kernel's arithmetic (``crc32c_lanes.cu``:
left-padded lanes, a contiguous segment a thread through slice-by-8
steps of 16 nibble lookups, a tree of constant advances as nibble
tables) and the kernel
source's device functions built with g++ as host code equal native
crc32c, which pins its bit order, geometry and advance directions
before the card runs it.  Every comparison is
exact (tolerance 0: crc words have no rounding).
"""

import os
import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu import native as ref_native
from ceph_tpu.ops import hashing as ref_h
from ceph_tpu_torch import native
from ceph_tpu_torch.ops import hashing as h
from tests.xla_private import _private_xla_compiles  # noqa: F401

POW2 = [1 << i for i in range(17)]  # 1 .. 65536


@pytest.fixture
def rng():
    return np.random.default_rng(7)


@pytest.mark.parametrize("width", POW2)
def test_crc_matrix_and_advance_match_reference(width):
    m_w, s_w = h._crc_ops(width)
    ref_m, ref_s = ref_h._crc_ops(width)
    assert np.array_equal(m_w, ref_m)
    assert np.array_equal(s_w, ref_s)
    assert np.array_equal(h.crc32c_matrix(width), ref_h.crc32c_matrix(width))


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 100, 4095, 65536, 123457])
def test_unadvance_matches_reference(rng, n):
    for crc in [0, 1, 0xFFFFFFFF, *map(int, rng.integers(0, 1 << 32, 3))]:
        got = h.crc32c_unadvance(crc, n)
        assert got == ref_h.crc32c_unadvance(crc, n)
        assert native.crc32c_zeros(n, got) == crc


@pytest.mark.parametrize("length", [0, 1, 2, 5, 8, 16, 255, 4096, 65536,
                                    (1 << 20) + 3, 10 ** 7])
def test_crc32c_zeros_matches_reference(rng, length):
    for seed in [0, 1, 0xFFFFFFFF, -1, *map(int, rng.integers(0, 1 << 32, 3))]:
        got = native.crc32c_zeros(length, seed)
        assert got == ref_native.crc32c_zeros(length, seed)
        if length <= 65536:  # the same as the crc of a zero buffer
            assert got == native.crc32c(bytes(length), seed)


def test_crc32c_zeros_python_loop_matches(monkeypatch):
    """Where the library did not build, the Python loop gives the same."""
    want = {(n, s): native.crc32c_zeros(n, s)
            for n in (0, 1, 3, 300) for s in (0, 1, 0xDEADBEEF)}
    monkeypatch.setattr(native, "_load", lambda: None)
    for (n, s), v in want.items():
        assert native.crc32c_zeros(n, s) == v


@pytest.mark.parametrize("b,w", [(1, 4096), (4, 8192), (2, 16384)])
def test_batched_plain_matches_jax_and_native(rng, b, w):
    lanes = rng.integers(0, 256, (b, w), dtype=np.uint8)
    lanes[-1, w // 2:] = 0  # a zero-padded lane
    got = h.batched_crc32c_plain(torch.from_numpy(lanes))
    assert got.dtype == torch.uint32 and got.shape == (b,)
    ref = np.asarray(ref_h.batched_crc32c_device(
        ref_h.crc32c_matrix(w), jnp.asarray(lanes)))
    assert np.array_equal(got.numpy(), ref)
    assert [int(x) for x in got.numpy()] == [native.crc32c(x, 0) for x in lanes]
    # the entry point on a CPU tensor is the plain version
    assert np.array_equal(h.batched_crc32c_device(torch.from_numpy(lanes)).numpy(), ref)


@pytest.mark.parametrize("w", [1, 2, 8, 64, 1024])
def test_batched_plain_narrow_lanes(rng, w):
    lanes = rng.integers(0, 256, (3, w), dtype=np.uint8)
    got = h.batched_crc32c_plain(torch.from_numpy(lanes)).numpy()
    assert [int(x) for x in got] == [native.crc32c(x, 0) for x in lanes]


def test_batched_plain_steps_over_wide_lanes(rng, monkeypatch):
    """Lanes wider than one step of the plain version fold their partial
    parities exactly (the step shrunk so the test stays small)."""
    monkeypatch.setattr(h, "_PLAIN_BYTES", 1024)
    lanes = rng.integers(0, 256, (2, 8192), dtype=np.uint8)
    got = h.batched_crc32c_plain(torch.from_numpy(lanes)).numpy()
    assert [int(x) for x in got] == [native.crc32c(x, 0) for x in lanes]


# ---------------------------------------------------------------------------
# The CUDA kernel's arithmetic, modelled in numpy
# ---------------------------------------------------------------------------

def _multmodp(a, b):
    """a * b modulo the polynomial, reflected, on uint32 arrays (zlib's
    multmodp, branch-free): the advance word times a register."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32).copy()
    p = np.zeros(np.broadcast(a, b).shape, np.uint32)
    one, zero = np.uint32(1), np.uint32(0)
    for i in range(31, -1, -1):
        p ^= b & (zero - ((a >> np.uint32(i)) & one))
        b = (b >> one) ^ (np.uint32(h.POLY) & (zero - (b & one)))
    return p


def _advance(a: np.ndarray, c: np.ndarray) -> np.ndarray:
    """The kernel's ``advance``: eight nibble lookups into (8, 16) tables."""
    out = np.zeros_like(c)
    for k in range(8):
        out ^= a[k][(c >> np.uint32(4 * k)) & np.uint32(15)]
    return out


def _kernel_model(lanes: np.ndarray) -> np.ndarray:
    """numpy model of crc32c_lanes.cu: a lane left-padded with zeros to
    ``cluster * THREADS`` segments of L = ``16 vec passes`` bytes; each
    segment's crc from register 0 by 8-byte steps, each the XOR of 16
    nibble-table entries; then the combine tree: at level s each run of
    2^s segments advanced by table s past the run after it, the pair
    XORed (shuffles, shared memory and distributed shared memory only
    move the words)."""
    b, w = lanes.shape
    vec, cluster, passes = h.crc_geometry(w)
    seg = 16 * vec * passes
    ops = h.kernel_operators(w)
    step = ops[:h.STEP_WORDS].reshape(16, 16)
    adv = ops[h.STEP_WORDS:].reshape(-1, 8, 16)
    assert adv.shape[0] == h.LEVELS
    nseg = cluster * h.THREADS
    v = np.zeros((b, nseg * seg), np.uint8)
    v[:, v.shape[1] - w:] = lanes
    words = v.reshape(b, nseg, seg).view("<u4")  # (b, nseg, seg / 4)

    def step8(lo, hi):
        out = np.zeros_like(lo)
        for j in range(8):
            out ^= step[j][(lo >> np.uint32(4 * j)) & np.uint32(15)]
            out ^= step[8 + j][(hi >> np.uint32(4 * j)) & np.uint32(15)]
        return out

    c = np.zeros((b, nseg), np.uint32)
    for q in range(0, seg // 4, 2):
        c = step8(words[..., q] ^ c, words[..., q + 1])
    for s in range(nseg.bit_length() - 1):
        pair = c.reshape(b, -1, 2)
        c = _advance(adv[s], pair[..., 0]) ^ pair[..., 1]
    assert c.shape == (b, 1)
    return c[:, 0]


@pytest.mark.parametrize("w", [1, 4, 16, 48, 512, 4096, 4097, 8192, 16384, 32768, 65536,
                               131072, 1 << 20, 3 << 20, 100003])
def test_kernel_model_matches_native(rng, w):
    """Both load widths, every cluster size (1-8), one and several passes
    a thread, widths past one block's and one cluster's span, and widths
    the scrub path never gives (not a power of two: the C entry takes
    any)."""
    lanes = rng.integers(0, 256, (3, w), dtype=np.uint8)
    lanes[1, w // 3:] = 0  # zero-padded lane
    lanes[2] = 0
    want = [native.crc32c(x, 0) for x in lanes]
    assert [int(x) for x in _kernel_model(lanes)] == want
    assert want[2] == 0


@pytest.mark.parametrize("w,vec,cluster,passes", [
    (1, 2, 1, 1), (4096, 2, 1, 1), (4097, 4, 1, 1), (8192, 4, 1, 1), (8193, 4, 2, 1),
    (16384, 4, 2, 1), (65536, 4, 8, 1), (65537, 4, 8, 2), (1 << 20, 4, 8, 16)])
def test_geometry(w, vec, cluster, passes):
    assert h.crc_geometry(w) == (vec, cluster, passes)
    assert h.kernel_operators(w).shape == (h.STEP_WORDS + h.LEVELS * h.ADV_WORDS,)


def test_kernel_operators_layout():
    """The step's nibble tables: entry [j, v] is the crc of 8 bytes, from
    register 0, with nibble j set to v; each combine table advances a
    register through its bytes (L = 64 at (32, 65536)), entry [k, v]
    being the register v << 4k advanced, and eight lookups advance any
    register as the advance word's multiply does."""
    ops = h.kernel_operators(65536)
    assert ops.dtype == np.uint32
    assert h.crc_geometry(65536) == (4, 8, 1)
    advances = h.combine_advances(65536)
    assert advances == [64 << s for s in range(10)]
    assert ops.shape == (256 + len(advances) * 128,)
    step = ops[:256].reshape(16, 16)
    for j in range(16):
        for v in (0, 1, 9, 15):
            msg = bytearray(8)
            msg[j // 2] = v << (4 * (j % 2))
            assert int(step[j, v]) == native.crc32c(bytes(msg), 0)
    adv = ops[256:].reshape(len(advances), 8, 16)
    regs = np.array([0, 1, 0x12345678, 0xFFFFFFFF, 1 << 31], np.uint32)
    for s, n in enumerate(advances):
        for k, v in [(0, 1), (3, 9), (7, 15)]:
            assert int(adv[s, k, v]) == native.crc32c_zeros(n, v << (4 * k))
        assert not adv[s, :, 0].any()
        assert [int(x) for x in _advance(adv[s], regs)] == [
            native.crc32c_zeros(n, int(r)) for r in regs]
        assert np.array_equal(_multmodp(np.full(regs.shape, h.advance_op(n), np.uint32), regs),
                              _advance(adv[s], regs))
    # narrow lanes: 32 bytes a thread, so L = 32
    assert h.combine_advances(1024)[0] == 32


def test_constants_match_kernel_source():
    src = os.path.join(os.path.dirname(h.__file__), "csrc", "crc32c_lanes.cu")
    with open(src) as f:
        text = f.read()
    for name, value in (("kThreads", h.THREADS), ("kMaxCluster", h.MAX_CLUSTER),
                        ("kLevels", h.LEVELS)):
        assert int(re.search(rf"\b{name} = (\d+);", text).group(1)) == value, name
    assert re.search(r"kStepWords = 16 \* 16;", text)
    assert re.search(r"kAdvWords = 8 \* 16;", text)
    assert re.search(r"const int v = width <= 32ll \* kThreads \? 2 : 4;", text)
    assert f"polynomial 0x{h.POLY:08X}" in text
    # one device operation a call: the entry neither zeroes nor accumulates
    assert "cudaMemset" not in text and not re.search(r"\batomic\w*\(", text)


# ---------------------------------------------------------------------------
# crc32c_lanes.cu's device code as host C++
# ---------------------------------------------------------------------------

_HOST_PRELUDE = r"""
#include <cstdint>
#include <cstring>
#define __device__
#define __forceinline__ inline
struct uint4 { uint32_t x, y, z, w; };
inline uint4 make_uint4(uint32_t x, uint32_t y, uint32_t z, uint32_t w) { return {x, y, z, w}; }
inline uint4 __ldg(const uint4* p) { uint4 v; std::memcpy(&v, p, 16); return v; }
// join_lanes compiles against this; the replay below joins by indexing
inline uint32_t __shfl_down_sync(unsigned, uint32_t c, int) { return c; }
"""

_HOST_LOOP = r"""
extern "C" int host_geometry(long long width, int* vec, long long* passes) {
  int cluster;
  ceph_crc32c_geometry(width, vec, &cluster, passes);
  return cluster;
}

template <int VEC>
static uint32_t segment(const uint32_t* tab, const uint8_t* lp, long long off, long long width,
                        long long passes, int aligned) {
  uint32_t r = 0;
  for (long long p = 0; p < passes; ++p, off += 16 * VEC) {
    uint4 v[VEC];
    load_pass<VEC>(v, lp, off, width, aligned != 0);
    for (int u = 0; u < VEC; ++u) r = step16(tab, r, v[u]);
  }
  return r;
}

// The kernel's arithmetic, one lane: every thread's segment through
// load_pass and step16, then the combine tree through advance, level s
// joining runs of 2^s segments (the shuffles' and shared memories' moves
// done by indexing).
extern "C" uint32_t host_lane(const uint8_t* lp, long long width, const uint32_t* ops,
                              int aligned) {
  int vec, cluster;
  long long passes;
  ceph_crc32c_geometry(width, &vec, &cluster, &passes);
  const long long seg = 16ll * vec * passes;
  const long long nseg = (long long)cluster * kThreads;
  const long long pad = seg * nseg - width;
  const uint32_t* adv = ops + kStepWords;
  uint32_t* c = new uint32_t[nseg];
  for (long long i = 0; i < nseg; ++i)
    c[i] = vec == 2 ? segment<2>(ops, lp, i * seg - pad, width, passes, aligned)
                    : segment<4>(ops, lp, i * seg - pad, width, passes, aligned);
  for (int s = 0; (1ll << s) < nseg; ++s)
    for (long long i = 0; i < nseg; i += 2ll << s)
      c[i] = advance(adv + s * kAdvWords, c[i]) ^ c[i + (1ll << s)];
  const uint32_t lane_crc = c[0];
  delete[] c;
  return lane_crc;
}
"""


@pytest.fixture(scope="module")
def host_crc(tmp_path_factory):
    """``crc32c_lanes.cu``'s device functions and its geometry compiled
    with g++ as host code (everything but the kernel and its launch)."""
    import ctypes
    import subprocess

    path = os.path.join(os.path.dirname(h.__file__), "csrc", "crc32c_lanes.cu")
    with open(path) as f:
        src = f.read()
    for inc in ("#include <cooperative_groups.h>", "#include <cuda_runtime.h>",
                "namespace cg = cooperative_groups;"):
        src = src.replace(inc, "")
    kernel = src[src.index("// ops: [kStepWords"):src.index("}  // namespace")]
    geometry = src[src.index("void ceph_crc32c_geometry"):src.index("// out[b] = crc32c")]
    src = src[:src.index("// ops: [kStepWords")] + "}  // namespace\n" + geometry
    assert "__global__" in kernel and "__global__" not in src
    d = tmp_path_factory.mktemp("crc_host")
    cpp, so = d / "crc_host.cpp", d / "libcrc_host.so"
    cpp.write_text(_HOST_PRELUDE + src + _HOST_LOOP)
    subprocess.run(["g++", "-O1", "-std=c++17", "-shared", "-fPIC", "-o", str(so), str(cpp)],
                   check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_geometry.restype = ctypes.c_int
    lib.host_geometry.argtypes = [ctypes.c_longlong, ctypes.POINTER(ctypes.c_int),
                                  ctypes.POINTER(ctypes.c_longlong)]
    lib.host_lane.restype = ctypes.c_uint32
    lib.host_lane.argtypes = [ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p, ctypes.c_int]
    return lib


@pytest.mark.parametrize("w", [1, 16, 48, 4096, 4097, 16384, 65536, 131072, 1 << 20, 100003])
def test_kernel_source_as_host_code(host_crc, rng, w):
    """The source's step, loads, nibble advance, geometry and combine
    order, with the host's operand block, against the plain version
    (power-of-two widths up to the scrub path's) and native crc32c; the
    byte path and the 16-byte path give the same."""
    import ctypes

    lanes = rng.integers(0, 256, (2, w), dtype=np.uint8)
    lanes[1, : w // 2] = 0
    ops = h.kernel_operators(w)
    vec, passes = ctypes.c_int(), ctypes.c_longlong()
    assert host_crc.host_geometry(w, ctypes.byref(vec), ctypes.byref(passes)) == \
        h.crc_geometry(w)[1]
    assert (vec.value, passes.value) == (h.crc_geometry(w)[0], h.crc_geometry(w)[2])
    want = [native.crc32c(x, 0) for x in lanes]
    if w & (w - 1) == 0 and w <= 65536:  # the plain version is slow past the scrub widths
        plain = h.batched_crc32c_plain(torch.from_numpy(lanes))
        assert [int(x) for x in plain.numpy()] == want
    for aligned in ((0, 1) if w % 16 == 0 else (0,)):
        got = [host_crc.host_lane(row.ctypes.data, w, ops.ctypes.data, aligned) for row in lanes]
        assert got == want, aligned


# ---------------------------------------------------------------------------
# The entry point
# ---------------------------------------------------------------------------

def test_entry_point_rejects_bad_operands():
    with pytest.raises(TypeError):
        h.batched_crc32c_device(torch.zeros((2, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        h.batched_crc32c_device(torch.zeros((16,), dtype=torch.uint8))
    with pytest.raises(ValueError, match="power of two"):
        h.batched_crc32c_device(torch.zeros((2, 24), dtype=torch.uint8))
    with pytest.raises(ValueError, match="power of two"):
        h.batched_crc32c_device(torch.zeros((2, 0), dtype=torch.uint8))


def test_empty_batch():
    assert h.batched_crc32c_device(torch.zeros((0, 4096), dtype=torch.uint8)).shape == (0,)


def test_no_launch_counted_on_cpu(rng):
    h.reset_launch_counts()
    h.batched_crc32c_device(torch.from_numpy(rng.integers(0, 256, (2, 64), dtype=np.uint8)))
    assert h.launch_counts() == {"batched_crc32c_device": 0}


def test_launch_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        h._launch(torch.zeros((2, 4096), dtype=torch.uint8),
                  torch.zeros((2,), dtype=torch.int32))


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    from ceph_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(h, "_fn", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        h._kernel()

"""The measurement probes' kernels against the JAX package's (CPU).

The five Pallas probes of ``tools/perf_lab.py``, ``perf_lab2.py`` and
``perf_lab3.py`` run in interpret mode, as the JAX package's tests run
Pallas on the CPU: each probe module is loaded by file path (``tools/``
is not a package) and, on the loaded module object only, its ``pl`` is
replaced by a namespace whose ``pallas_call`` is
``functools.partial(pl.pallas_call, interpret=True)``; its module-level
``K`` and ``M`` are set to the case's code, since the probes read them.
The same numpy inputs go through the port's entry points on CPU tensors,
which run their plain versions.  Every comparison is byte-exact
(tolerance 0: GF(2) arithmetic and copies have no rounding).

``gf_bitmatmul.cu``'s stage cuts are also compiled with g++ as host C++
(macros and small functions for the CUDA names) and held against the
plain versions: their arithmetic before any chip time.  The kernels'
speed and their parity on the card come from chip_smoke.py.
"""

import ctypes
import functools
import importlib.util
import pathlib
import subprocess
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from ceph_tpu.models import isa_cauchy_matrix as ref_isa_cauchy
from ceph_tpu.ops import rs_kernels as ref_rk
from ceph_tpu.ops.gf256 import gf_matmul as ref_gf_matmul
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix
from ceph_tpu_torch.ops import lab_kernels as lk
from ceph_tpu_torch.ops import rs_kernels as rk
from tests.xla_private import _private_xla_compiles  # noqa: F401

ROOT = pathlib.Path(__file__).resolve().parents[1]
CODES = [(8, 3), (4, 2), (6, 3)]
S, TILE = 4096, 1024
STAGES = ("load", "extract", "matmul", "full")


def _probe(name: str):
    """tools/<name>.py as a fresh module whose pallas_call interprets."""
    spec = importlib.util.spec_from_file_location(f"_ref_{name}", ROOT / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.pl = types.SimpleNamespace(
        pallas_call=functools.partial(pl.pallas_call, interpret=True),
        BlockSpec=pl.BlockSpec)
    return mod


@pytest.fixture(scope="module")
def probes():
    return {name: _probe(name) for name in ("perf_lab", "perf_lab2", "perf_lab3")}


def _case(probes, k, m, seed):
    for mod in probes.values():
        mod.K, mod.M = k, m
    codec = ref_rk.BitmatrixCodec(ref_isa_cauchy(k, m))
    bits = torch.from_numpy(np.array(codec.encode_bits))
    data = np.random.default_rng(seed).integers(0, 256, (k, S), dtype=np.uint8)
    return codec, bits, data


@pytest.mark.parametrize("k,m", CODES)
def test_copy_fn_vs_row_copy(probes, k, m):
    _, _, data = _case(probes, k, m, 1)
    want = np.asarray(probes["perf_lab"].copy_fn(jnp.asarray(data), tile=TILE))
    assert want.shape == (m, S)
    assert np.array_equal(lk.row_copy(torch.from_numpy(data), m).numpy(), want)


def test_fat_copy_plain_vs_numpy():
    """``fat_copy`` is nested inside ``perf_lab.main`` and cannot be
    called alone; its function is the first 384 rows of a (1024, N)
    array, so row_copy's plain version is held against the numpy slice
    at (1024, 4096) -> 384."""
    src = np.random.default_rng(2).integers(0, 256, (1024, 4096), dtype=np.uint8)
    got = lk.row_copy(torch.from_numpy(src), 384)
    assert got.shape == (384, 4096) and np.array_equal(got.numpy(), src[:384])


@pytest.mark.parametrize("stage", STAGES)
@pytest.mark.parametrize("k,m", CODES)
def test_ablate_vs_stage_cut(probes, k, m, stage):
    codec, bits, data = _case(probes, k, m, 3 + k)
    want = np.asarray(probes["perf_lab2"].make_ablate(stage, TILE, codec)(jnp.asarray(data)))
    got = rk.gf_stage_cut(bits, torch.from_numpy(data), stage)
    assert got.shape == (m, S) and np.array_equal(got.numpy(), want)


@pytest.mark.parametrize("k,m", CODES)
def test_repeat_variant_is_the_folded_product(probes, k, m):
    """The reference fact: the repeat variant is not the encode (its
    ``pltpu.repeat`` tiles the rows); it is the product with the
    host-folded matrix, which the port computes."""
    codec, bits, data = _case(probes, k, m, 5 + k)
    want = np.asarray(probes["perf_lab2"].make_repeat_variant(TILE, codec)(jnp.asarray(data)))
    assert not np.array_equal(want, ref_gf_matmul(codec.C, data))
    assert not np.array_equal(want, np.asarray(codec.encode(jnp.asarray(data))))
    folded = lk.fold_repeat_matrix(np.asarray(codec.encode_bits), k)
    bm = np.asarray(codec.encode_bits)
    manual = np.zeros_like(bm)
    for c in range(8 * k):
        manual[:, 8 * (c % k) + c % 8] ^= bm[:, c]
    assert np.array_equal(folded, manual)
    assert np.array_equal(rk.gf_bitmatmul_plain(torch.from_numpy(folded),
                                                torch.from_numpy(data)).numpy(), want)
    assert np.array_equal(lk.repeat_variant(bits, torch.from_numpy(data)).numpy(), want)


@pytest.mark.parametrize("carry", ["zero", "random"])
@pytest.mark.parametrize("seed", [0, 3, 255])
@pytest.mark.parametrize("k,m", CODES)
def test_acc_encode_vs_probe(probes, k, m, seed, carry):
    codec, bits, data = _case(probes, k, m, 7 + seed)
    c0 = (np.zeros((m, S), np.uint8) if carry == "zero"
          else np.random.default_rng(seed).integers(0, 256, (m, S), dtype=np.uint8))
    run = probes["perf_lab3"].make_acc_encode(codec, TILE)
    want = np.asarray(run(jnp.asarray(data), jnp.asarray(c0), jnp.array([seed], jnp.int32)))
    c = torch.from_numpy(c0.copy())
    got = lk.acc_encode(bits, torch.from_numpy(data), c, torch.tensor([seed], dtype=torch.int32))
    assert got is c  # updated in place, as the probe aliases its carry
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, c0 ^ ref_gf_matmul(codec.C, data ^ np.uint8(seed)))


def test_stage_cut_rejects_bad_operands():
    bits = rk.BitmatrixCodec(isa_cauchy_matrix(4, 2), device="cpu").encode_bits
    d = torch.zeros((4, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="stage"):
        rk.gf_stage_cut(bits, d, "fold")
    with pytest.raises(ValueError):
        rk.gf_stage_cut(bits, torch.zeros((2, 4, 64), dtype=torch.uint8), "load")
    wide = rk.BitmatrixCodec(isa_cauchy_matrix(2, 4), device="cpu").encode_bits
    with pytest.raises(ValueError, match="m <= k"):
        rk.gf_stage_cut(wide, torch.zeros((2, 64), dtype=torch.uint8), "load")
    assert rk.gf_stage_cut(wide, torch.zeros((2, 64), dtype=torch.uint8), "matmul").shape == (4, 64)
    with pytest.raises(ValueError, match="contiguous"):
        lk.row_copy(torch.zeros((4, 64), dtype=torch.uint8).t(), 1)
    with pytest.raises(ValueError, match="rows"):
        lk.row_copy(d, 5)
    with pytest.raises(ValueError, match="carry"):
        lk.acc_encode(bits, d, torch.zeros((3, 64), dtype=torch.uint8), 0)
    with pytest.raises(ValueError, match="multiple"):
        lk.repeat_variant(bits, d, tile_s=48)


def test_wrappers_raise_instead_of_falling_back(monkeypatch, tmp_path):
    """No fallback: the launchers refuse tensors off the card, a device
    that is neither CPU nor CUDA raises, and a kernel that cannot be
    built raises."""
    from ceph_tpu_torch.ops import _build

    bits = rk.BitmatrixCodec(isa_cauchy_matrix(8, 3), device="cpu").encode_bits
    d = torch.zeros((8, 512), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        lk._launch_copy(d, torch.zeros((3, 512), dtype=torch.uint8), 3 * 512)
    with pytest.raises(ValueError, match="CUDA"):
        rk._launch(bits, d, torch.zeros((3, 512), dtype=torch.uint8), stage="load")
    meta = torch.zeros((8, 512), dtype=torch.uint8, device="meta")
    with pytest.raises(ValueError, match="unsupported device"):
        lk.row_copy(meta, 3)

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(lk, "_copy_fn", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        lk._copy_kernel()


def test_no_launch_counted_on_cpu():
    rk.reset_launch_counts()
    lk.reset_launch_counts()
    bits = rk.BitmatrixCodec(isa_cauchy_matrix(8, 3), device="cpu").encode_bits
    d = torch.zeros((8, 512), dtype=torch.uint8)
    for st in STAGES:
        rk.gf_stage_cut(bits, d, st)
    lk.row_copy(d, 3)
    lk.repeat_variant(bits, d)
    lk.acc_encode(bits, d, torch.zeros((3, 512), dtype=torch.uint8), 1)
    assert lk.launch_counts() == {"row_copy": 0, "repeat_variant": 0, "acc_encode": 0}
    assert rk.launch_counts()["gf_stage_cut"] == 0
    assert rk.gf_stage_cut.by_stage == dict.fromkeys(STAGES, 0)


def test_copy_grid():
    """A block's chunk is at least one pass of 256 threads x 8 vectors x
    16 bytes (32 KiB), at most 64 blocks an SM: the probes' 192 MiB runs
    take 6144 blocks of one pass each; past 8448 passes chunks grow."""
    assert lk.copy_blocks(16, 132) == 1
    assert lk.copy_blocks(16 * 256 * 8 * 5, 132) == 5
    assert lk.copy_blocks(16 * 256 * 8 * 5 + 1, 132) == 6
    assert lk.copy_blocks(3 << 26, 132) == 6144
    assert lk.copy_blocks(1 << 30, 132) == 132 * lk.COPY_BLOCKS_PER_SM == 132 * 64


# ---------------------------------------------------------------------------
# gf_bitmatmul.cu's device code compiled as host C++
# ---------------------------------------------------------------------------

_HOST_PRELUDE = r"""
#include <algorithm>
#include <cstddef>
#include <cstdint>
using std::min;
#define __device__
#define __forceinline__ inline
#define __restrict__
struct uint4 { uint32_t x, y, z, w; };
struct uint2 { uint32_t x, y; };
static inline uint4 make_uint4(uint32_t a, uint32_t b, uint32_t c, uint32_t d) { return {a, b, c, d}; }
static inline uint2 make_uint2(uint32_t a, uint32_t b) { return {a, b}; }
template <class T> static inline T __ldg(const T* p) { return *p; }
static inline uint32_t __byte_perm(uint32_t x, uint32_t y, uint32_t s) {
  const uint64_t v = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int i = 0; i < 4; ++i) r |= uint32_t((v >> (8 * ((s >> (4 * i)) & 7))) & 0xFF) << (8 * i);
  return r;
}
"""
# one item after another, each as one thread would run it, with the
# masks as the block's shared copy
_HOST_LOOP = r"""
template <int MODE, int W, bool PACKED>
static void run_host(const Params& p) {
  for (unsigned t = 0; t < p.items; ++t) {
    uint32_t x[8][W];
    item<MODE, W, PACKED>(p, p.masks, locate<W>(p, t), x, false);
  }
}
template <int MODE>
static void run_w(const Params& p, int words) {
  if (words == 4) {
    if (p.packed) run_host<MODE, 4, true>(p); else run_host<MODE, 4, false>(p);
  } else {
    if (p.packed) run_host<MODE, 2, true>(p); else run_host<MODE, 2, false>(p);
  }
}
}  // namespace

extern "C" void host_bitmatmul(const uint8_t* data, uint8_t* out, const uint32_t* masks,
                               int packed, int k, int m, long long s, int mode, int words) {
  Params p;
  p.data = data; p.out = out; p.parity = nullptr; p.masks = masks; p.s = s;
  const long long per_row = (s + 4 * words - 1) / (4 * words);
  p.items_per_row = unsigned(per_row);
  p.items = unsigned(per_row);
  p.k = k; p.m = m; p.nch = (k + 7) / 8;
  p.seed_rep = 0u;
  p.vec = s % (4 * words) == 0;
  p.packed = packed;
  switch (mode) {
    case kCutLoad: run_w<kCutLoad>(p, words); break;
    case kCutExtract: run_w<kCutExtract>(p, words); break;
    case kCutProduct: run_w<kCutProduct>(p, words); break;
    default: run_w<kStore>(p, words); break;
  }
}
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """``gf_bitmatmul.cu``'s device code up to its kernel, compiled with
    g++ as host code: its arithmetic, not its speed."""
    src = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "gf_bitmatmul.cu").read_text()
    src = src.replace("#include <cuda_runtime.h>", "")
    src = src[: src.index("template <int MODE, int W, bool PACKED>\n__device__ __forceinline__ void run(")]
    d = tmp_path_factory.mktemp("gf_host")
    cpp, so = d / "gf_host.cpp", d / "libgf_host.so"
    cpp.write_text(_HOST_PRELUDE + src + _HOST_LOOP)
    subprocess.run(["g++", "-O1", "-w", "-std=c++17", "-shared", "-fPIC", "-o", str(so),
                    str(cpp)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(so))
    lib.host_bitmatmul.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 3 + [
        ctypes.c_longlong, ctypes.c_int, ctypes.c_int]
    return lib


@pytest.mark.parametrize("words", [2, 4])
@pytest.mark.parametrize("s", [4096, 4096 + 13, 7])
@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (6, 3), (16, 4), (128, 128)])
def test_stage_cuts_as_host_code(host_kernel, k, m, s, words):
    """Every stage cut and the store, at both widths, an aligned and two
    ragged S, a two-chunk code (k = 16) and a packed one (k + m = 256)."""
    bits = rk.BitmatrixCodec(isa_cauchy_matrix(k, m), device="cpu").encode_bits
    packed = not rk.replicated_fits(k, m)
    masks = torch.from_numpy(rk.kernel_masks(bits.numpy(), packed=packed).view(np.int32).copy())
    data = torch.from_numpy(np.random.default_rng(k + s).integers(0, 256, (k, s), dtype=np.uint8))
    for stage in STAGES:
        if stage in ("load", "extract") and m > k:
            continue
        out = torch.zeros((m, s), dtype=torch.uint8)
        host_kernel.host_bitmatmul(data.data_ptr(), out.data_ptr(), masks.data_ptr(),
                                   int(packed), k, m, s, rk.STAGE_MODES[stage], words)
        assert torch.equal(out, rk.gf_stage_cut_plain(bits, data, stage)), stage


def test_stage_modes_match_kernel_source():
    text = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "gf_bitmatmul.cu").read_text()
    for name, mode in (("kCutLoad", "load"), ("kCutExtract", "extract"),
                       ("kCutProduct", "matmul"), ("kStore", "full")):
        assert f"{name} = {rk.STAGE_MODES[mode]}," in text
    copy = (ROOT / "ceph_tpu_torch" / "ops" / "csrc" / "lab_copy.cu").read_text()
    assert f"kThreads = {lk.COPY_THREADS};" in copy
    assert f"kUnroll = {lk.COPY_UNROLL};" in copy

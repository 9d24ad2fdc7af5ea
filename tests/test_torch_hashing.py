"""ceph_tpu_torch.ops.hashing and native.crc32c_zeros against ceph_tpu (CPU).

The crc helpers (M_W, S_W, the un-advance, the zeros path) equal the JAX
package's; the plain PyTorch batched crc equals the JAX
``batched_crc32c_device`` run on the CPU and the native host crc32c;
and a numpy model of the CUDA kernel's arithmetic (``crc32c_lanes.cu``:
16-byte segments, two slice-by-8 steps, per-thread and per-block
advance words, XOR fold) equals native crc32c, which pins its bit order
and advance directions before the card runs it.  Every comparison is
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
    """The kernel's branch-free multmodp on uint32 arrays."""
    a = np.asarray(a, np.uint32)
    b = np.asarray(b, np.uint32).copy()
    p = np.zeros(np.broadcast(a, b).shape, np.uint32)
    one, zero = np.uint32(1), np.uint32(0)
    for i in range(31, -1, -1):
        p ^= b & (zero - ((a >> np.uint32(i)) & one))
        b = (b >> one) ^ (np.uint32(h.POLY) & (zero - (b & one)))
    return p


def _kernel_model(lanes: np.ndarray) -> np.ndarray:
    """numpy model of crc32c_lanes.cu: each lane left-padded to whole
    blocks of 4096 B; thread t of block j takes bytes [16t, 16t + 16) of
    the block, two slice-by-8 steps from register 0, times the thread's
    advance word; the block's XOR times the block's advance word; the
    blocks' XOR is the lane's crc."""
    b, w = lanes.shape
    ops = h.kernel_operators(w)
    t = ops[:2048].reshape(8, 256)
    to_block_end = ops[2048:2048 + h.THREADS]
    to_lane_end = ops[2048 + h.THREADS:]
    nblk = -(-w // h.BLOCK_BYTES)
    v = np.zeros((b, nblk * h.BLOCK_BYTES), np.uint8)
    v[:, v.shape[1] - w:] = lanes
    words = v.reshape(b, nblk, h.THREADS, h.SEG).view("<u4")  # (b, nblk, T, 4)

    def slice8(lo, hi):
        return (t[7][lo & 0xFF] ^ t[6][(lo >> 8) & 0xFF] ^ t[5][(lo >> 16) & 0xFF]
                ^ t[4][lo >> 24] ^ t[3][hi & 0xFF] ^ t[2][(hi >> 8) & 0xFF]
                ^ t[1][(hi >> 16) & 0xFF] ^ t[0][hi >> 24])

    c = slice8(words[..., 0], words[..., 1])
    c = slice8(words[..., 2] ^ c, words[..., 3])
    c = _multmodp(to_block_end, c)
    block = _multmodp(to_lane_end, np.bitwise_xor.reduce(c, axis=-1))
    return np.bitwise_xor.reduce(block, axis=-1)


@pytest.mark.parametrize("w", [1, 4, 16, 512, 4096, 8192, 65536])
def test_kernel_model_matches_native(rng, w):
    lanes = rng.integers(0, 256, (3, w), dtype=np.uint8)
    lanes[1, w // 3:] = 0  # zero-padded lane
    lanes[2] = 0
    want = [native.crc32c(x, 0) for x in lanes]
    assert [int(x) for x in _kernel_model(lanes)] == want
    assert want[2] == 0


def test_kernel_operators_layout():
    """Tables as native/crc32c.cc builds them; advance words are x^(8n)
    mod P, i.e. what the register 1<<31 (x^0) becomes after n zeros, and
    an advance word times a register advances it."""
    ops = h.kernel_operators(65536)
    assert ops.dtype == np.uint32
    assert ops.shape == (2048 + h.THREADS + 65536 // h.BLOCK_BYTES,)
    t = ops[:2048].reshape(8, 256)
    for s in range(8):
        for byte in (0, 1, 0x80, 0xFF):
            assert int(t[s, byte]) == native.crc32c(bytes([byte]) + bytes(s), 0)
    assert int(ops[2048 + h.THREADS - 1]) == 1 << 31     # last thread: no advance
    assert int(ops[-1]) == 1 << 31                       # last block: no advance
    assert int(ops[2048]) == h.advance_op(h.BLOCK_BYTES - h.SEG)
    assert int(ops[2048 + h.THREADS]) == h.advance_op(65536 - h.BLOCK_BYTES)
    for n, reg in [(16, 0x12345678), (4080, 0xFFFFFFFF), (61440, 1)]:
        assert int(_multmodp(h.advance_op(n), reg)) == native.crc32c_zeros(n, reg)
    # a lane narrower than a block has one block and no block advance
    assert h.kernel_operators(1024).shape == (2048 + h.THREADS + 1,)


def test_constants_match_kernel_source():
    src = os.path.join(os.path.dirname(h.__file__), "csrc", "crc32c_lanes.cu")
    with open(src) as f:
        text = f.read()
    assert int(re.search(r"kThreads = (\d+);", text).group(1)) == h.THREADS
    assert int(re.search(r"kSeg = (\d+);", text).group(1)) == h.SEG
    assert re.search(r"kTableWords = 8 \* 256;", text)
    assert f"0x{h.POLY:08X}u" in text


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

"""Kernels of the measurement probes (the JAX package's tools/perf_lab*.py).

The reference's lab probes are Pallas TPU kernels that the measurement
tools launch; here each is a Hopper counterpart with a plain PyTorch
version beside it (used on CPU tensors only) and a launch count:

- :func:`row_copy` — ``copy_fn`` (tools/perf_lab.py:58, ``pallas_call``
  :61) and ``main.fat_copy`` (:97, :101): the first ``rows`` rows of an
  (R, N) uint8 array.  Its own kernel, ``csrc/lab_copy.cu``.
- :func:`repeat_variant` — ``make_repeat_variant(tile, codec).run``
  (tools/perf_lab2.py:111, :113).  That probe's ``pltpu.repeat`` tiles
  the data rows (row r of the repeated block is ``d[r % K]``), so it
  computes a plain GF(2) bit-matrix product with a host-folded matrix
  (:func:`fold_repeat_matrix`), not the encode.  The port computes that
  same function: ``gf_bitmatmul.cu``'s store mode with the folded
  matrix as its operand.
- :func:`acc_encode` — ``make_acc_encode(codec, tile).run``
  (tools/perf_lab3.py:50, :52): ``carry ^= encode(data ^ seed)`` in
  place, the function of ``rs_kernels.gf_bitmatmul_pallas_acc``, through
  ``gf_bitmatmul.cu``'s acc mode.

The fourth probe, ``make_ablate`` (tools/perf_lab2.py:74, :76), is
``rs_kernels.gf_stage_cut``.
"""

from __future__ import annotations

import ctypes
import weakref

import numpy as np
import torch

from ceph_tpu_torch.ops import rs_kernels as rk

#: threads per block and 16-byte loads in flight a thread of the copy
#: kernel (``kThreads``, ``kUnroll`` in the source), and the grid cap in
#: blocks per SM
COPY_THREADS = 256
COPY_UNROLL = 8
COPY_BLOCKS_PER_SM = 64

_copy_fn = None


def _copy_kernel():
    """ctypes handle of ``ceph_lab_row_copy``, built on first use."""
    global _copy_fn
    if _copy_fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("lab_copy").ceph_lab_row_copy
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        _copy_fn = fn
    return _copy_fn


def copy_blocks(nbytes: int, sm_count: int) -> int:
    """Grid of a copy of ``nbytes``: a contiguous chunk a block of at
    least one pass (``COPY_UNROLL`` 16-byte vectors a thread), at most
    ``COPY_BLOCKS_PER_SM`` blocks per SM (past which chunks grow)."""
    return max(1, min(-(-nbytes // (16 * COPY_THREADS * COPY_UNROLL)),
                      sm_count * COPY_BLOCKS_PER_SM))


def _launch_copy(src: torch.Tensor, out: torch.Tensor, nbytes: int) -> None:
    """One copy launch of ``nbytes`` from ``src`` into ``out`` on the
    current stream; raises if it is refused."""
    for name, t in (("src", src), ("out", out)):
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
    index = src.get_device()
    if out.get_device() != index:
        raise ValueError(f"src on {src.device} but out on {out.device}")
    blocks = copy_blocks(nbytes, rk._sm_count(index))
    with torch.cuda.device(index):
        err = _copy_kernel()(src.data_ptr(), out.data_ptr(), nbytes, blocks,
                             torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"row_copy kernel launch failed: cudaError {err} "
                           f"(bytes={nbytes}, blocks={blocks})")


def row_copy_plain(src: torch.Tensor, rows: int) -> torch.Tensor:
    """Plain version of :func:`row_copy`."""
    return src[:rows].clone()


def row_copy(src: torch.Tensor, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of a contiguous (R, N) uint8 tensor, as a
    new (rows, N) tensor.  On the card: one launch of ``lab_copy.cu``."""
    if not isinstance(src, torch.Tensor) or src.dtype != torch.uint8:
        raise TypeError("src must be a uint8 torch.Tensor")
    if src.dim() != 2 or not src.is_contiguous():
        raise ValueError(f"src must be a contiguous (R, N) tensor, got {tuple(src.shape)}")
    if not 0 <= rows <= src.shape[0]:
        raise ValueError(f"rows must be in [0, {src.shape[0]}], got {rows}")
    if rk._on_cpu(src):
        return row_copy_plain(src, rows)
    out = torch.empty((rows, src.shape[1]), dtype=torch.uint8, device=src.device)
    _launch_copy(src, out, rows * src.shape[1])
    rk.count_launch(row_copy)
    return out


def fold_repeat_matrix(encode_bits, k: int) -> np.ndarray:
    """The matrix that tools/perf_lab2.py's repeat variant applies: its
    ``pltpu.repeat(d, 8, axis=0)`` tiles the k data rows, so column c of
    the byte-major (8m, 8k) ``encode_bits`` meets bit ``c % 8`` of data
    row ``c % k``.  Starting from zeros, column c is XORed into column
    ``8 * (c % k) + c % 8``."""
    bm = np.asarray(encode_bits.cpu() if isinstance(encode_bits, torch.Tensor)
                    else encode_bits, dtype=np.uint8) & 1
    m8, k8 = bm.shape
    if k8 != 8 * k:
        raise ValueError(f"encode_bits has {k8} columns, want 8k = {8 * k}")
    out = np.zeros_like(bm)
    for c in range(k8):
        out[:, 8 * (c % k) + c % 8] ^= bm[:, c]
    return out


#: id(encode bit-matrix) -> (weak reference to it, its _version, the
#: folded matrix on its device)
_fold_cache: dict[int, tuple] = {}


def _folded(bitmat: torch.Tensor) -> torch.Tensor:
    """:func:`fold_repeat_matrix` of ``bitmat`` on its device, made once
    per bit-matrix tensor (and again if it is changed in place)."""
    key = id(bitmat)
    hit = _fold_cache.get(key)
    if hit is not None and hit[0]() is bitmat and hit[1] == bitmat._version:
        return hit[2]
    folded = torch.from_numpy(fold_repeat_matrix(bitmat, bitmat.shape[1] // 8)).to(bitmat.device)

    def drop(ref, key=key):
        if _fold_cache.get(key, (None,))[0] is ref:
            del _fold_cache[key]

    _fold_cache[key] = (weakref.ref(bitmat, drop), bitmat._version, folded)
    return folded


def repeat_variant_plain(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`repeat_variant`."""
    return rk.gf_bitmatmul_plain(_folded(bitmat), data)


def repeat_variant(bitmat: torch.Tensor, data: torch.Tensor, *,
                   tile_s: int | None = None) -> torch.Tensor:
    """What tools/perf_lab2.py's repeat variant computes for the encode
    bit-matrix ``bitmat`` and (k, S) data: the bit-matrix product with
    ``fold_repeat_matrix(bitmat, k)``, (m, S) uint8.  ``tile_s`` is the
    probe's TPU block width; only its divisibility of S is kept.  On the
    card: one launch of ``gf_bitmatmul.cu``'s store mode with the folded
    matrix."""
    k, m = rk._check(bitmat, data)
    if data.dim() != 2:
        raise ValueError(f"data must be (k, S), got {tuple(data.shape)}")
    if tile_s is not None and data.shape[1] % tile_s:
        raise ValueError(f"S={data.shape[1]} is not a multiple of tile_s={tile_s}")
    if rk._on_cpu(data):
        return repeat_variant_plain(bitmat, data)
    out = torch.empty((m, data.shape[1]), dtype=torch.uint8, device=data.device)
    rk._launch(_folded(bitmat), data, out)
    rk.count_launch(repeat_variant)
    return out


def acc_encode_plain(bitmat: torch.Tensor, data: torch.Tensor,
                     carry: torch.Tensor, seed: int) -> torch.Tensor:
    """Plain version of :func:`acc_encode`."""
    return carry.bitwise_xor_(rk.gf_bitmatmul_plain(bitmat, data ^ (int(seed) & 0xFF)))


def acc_encode(bitmat: torch.Tensor, data: torch.Tensor, carry: torch.Tensor,
               seed) -> torch.Tensor:
    """``carry ^= encode(data ^ (seed & 0xFF))`` in place, returning
    ``carry``: tools/perf_lab3.py's looped-encode body, whose carry is
    aliased to its output (``input_output_aliases={3: 0}``).  ``seed`` is
    an int or a one-element int tensor (the probe's ``int32[1]``).  On the
    card: one launch of ``gf_bitmatmul.cu``'s acc mode."""
    k, m = rk._check(bitmat, data)
    if data.dim() != 2:
        raise ValueError(f"data must be (k, S), got {tuple(data.shape)}")
    if not isinstance(carry, torch.Tensor) or carry.dtype != torch.uint8:
        raise TypeError("carry must be a uint8 torch.Tensor")
    if tuple(carry.shape) != (m, data.shape[1]) or carry.device != data.device:
        raise ValueError(f"carry must be ({m}, {data.shape[1]}) on {data.device}, got "
                         f"{tuple(carry.shape)} on {carry.device}")
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    seed = int(seed) & 0xFF
    if rk._on_cpu(data):
        return acc_encode_plain(bitmat, data, carry, seed)
    rk._launch(bitmat, data, carry, acc=True, seed=seed)
    rk.count_launch(acc_encode)
    return carry


KERNEL_ENTRY_POINTS = (row_copy, repeat_variant, acc_encode)


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


reset_launch_counts()

"""Erasure-code kernels: GF(2^8) codes as GF(2) bit-matrix products.

Counterpart of ``ceph_tpu/ops/rs_kernels.py``.  Multiplication by a
constant in GF(2^8) is GF(2)-linear on the operand's bits, so an (m, k)
byte generator expands into an (8m, 8k) 0/1 matrix
(:func:`ceph_tpu_torch.ops.gf256.gf_matrix_to_bitmatrix`) and erasure
encode becomes

    parity_bits = (B @ data_bits) mod 2

Decode is the same product with a per-erasure-signature matrix (inverted
host-side and cached).

Deep scrub's re-encode-compare (:func:`gf_encode_compare`) is the same
product with a compare in place of the store, in a kernel of its own: it
returns a (B, m) mismatch mask against the stored parity, which it never
writes out.
The measurement probe's stage cuts (:func:`gf_stage_cut`) run the same
kernel's loop up to the load, the bit extraction or the product.
The encode farm's chunk-sharded encode combines its ranks' packed
partials with :func:`gf_fold`, an XOR in a kernel of its own
(``csrc/farm_fold.cu``).

Every entry point has two implementations of one function:

- on a CUDA tensor, the hand-written kernel of ``csrc/gf_bitmatmul.cu``
  (built with ``nvcc`` at first use, see :mod:`._build`); a launch that
  fails raises;
- on a CPU tensor, the plain PyTorch version :func:`gf_bitmatmul_plain`
  (unpack -> matmul -> ``& 1`` -> pack), or
  :func:`gf_encode_compare_plain`.

The entry points keep the JAX package's names and signatures, and each
counts its kernel launches in a plain integer attribute ``launches``
(:func:`launch_counts`), so a run shows which kernels it reached.
"""

from __future__ import annotations

import ctypes
import functools
import threading
import weakref

import numpy as np
import torch

from ceph_tpu_torch.ops.gf256 import gf_matrix_to_bitmatrix

#: columns per step of the plain version: bounds its float bit tensor
#: at 8k x 2^22 x 4 bytes however wide S is
_PLAIN_COLS = 1 << 22


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: the card unless the caller
    asks for another; raises when that is CUDA and there is none."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def unpack_bits(data: torch.Tensor) -> torch.Tensor:
    """(..., k, S) uint8 -> (..., 8k, S) uint8 of 0/1; byte i bit b (LSB
    first) lands at row 8i+b, matching gf_matrix_to_bitmatrix layout."""
    *lead, k, s = data.shape
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    bits = (data[..., :, None, :] >> shifts[:, None]) & 1
    return bits.reshape(*lead, k * 8, s)


def pack_bits(bits: torch.Tensor) -> torch.Tensor:
    """(..., 8m, S) ints in {0,1} -> (..., m, S) uint8 (LSB-first)."""
    *lead, m8, s = bits.shape
    b = bits.reshape(*lead, m8 // 8, 8, s).to(torch.int32)
    weights = (1 << torch.arange(8, dtype=torch.int32, device=bits.device))
    # bit positions are disjoint, so the sum is the bitwise OR
    return (b * weights[:, None]).sum(dim=-2).to(torch.uint8)


def gf_bitmatmul_plain(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """(8m, 8k) 0/1 matrix applied to (..., k, S) uint8 -> (..., m, S).

    The product runs in float32: every term is 0 or 1 and a sum has at
    most 8k <= 2040 of them, so it is exact (also under TF32, which keeps
    0 and 1 exact and accumulates in float32)."""
    *lead, k, s = data.shape
    m = bitmat.shape[0] // 8
    bm = bitmat.to(torch.float32)
    out = torch.empty((*lead, m, s), dtype=torch.uint8, device=data.device)
    for c0 in range(0, s, _PLAIN_COLS):
        bits = unpack_bits(data[..., c0:c0 + _PLAIN_COLS]).to(torch.float32)
        acc = torch.matmul(bm, bits).to(torch.int32) & 1
        out[..., c0:c0 + _PLAIN_COLS] = pack_bits(acc)
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel: masks, launch plan, launch
# ---------------------------------------------------------------------------

#: threads per block of the kernel (``kThreads`` in the source)
THREADS = 256
#: largest replicated mask block, bytes (``kReplicatedBytes`` in the
#: source); wider codes take the packed form
REPLICATED_BYTES = 48 * 1024
#: grid cap in blocks per SM (2-3 waves of resident blocks); past it
#: each thread strides over items
MAX_BLOCKS_PER_SM = 8

#: the compare's block: at most ``kCompareMaxThreads`` threads, and the
#: plan's fewest
COMPARE_MAX_THREADS = 512
COMPARE_MIN_THREADS = 128
#: the compare's words a unit (4 * words columns of one stored row;
#: ``kCompareWords``)
COMPARE_WORDS = 2
#: flags one pass over a batch entry reduces (``kGroupRows``)
COMPARE_GROUP_ROWS = 32

_fn = None
_compare_fn = None


def _library_entry(name: str, argtypes: list):
    """ctypes handle of ``name`` in the gf_bitmatmul library (built on
    first use)."""
    from ceph_tpu_torch.ops import _build

    fn = getattr(_build.library("gf_bitmatmul"), name)
    fn.restype = ctypes.c_int
    fn.argtypes = argtypes
    return fn


def _kernel():
    """ctypes handle of ``ceph_gf_bitmatmul``, built on first use."""
    global _fn
    if _fn is None:
        _fn = _library_entry("ceph_gf_bitmatmul", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # data, out, masks
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # packed, k, m
            ctypes.c_longlong, ctypes.c_int,                     # s, batch
            ctypes.c_int, ctypes.c_int,                          # mode, seed
            ctypes.c_int, ctypes.c_int,                          # words, blocks
            ctypes.c_void_p,                                     # stream
        ])
    return _fn


def _compare_kernel():
    """ctypes handle of ``ceph_gf_encode_compare``, built on first use."""
    global _compare_fn
    if _compare_fn is None:
        _compare_fn = _library_entry("ceph_gf_encode_compare", [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # data, parity, flags
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong, # masks, slots, n_slots
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # packed, k, m
            ctypes.c_longlong, ctypes.c_int,                     # s, batch
            ctypes.c_int, ctypes.c_int,                          # parts, threads
            ctypes.c_void_p,                                     # stream
        ])
    return _compare_fn


def replicated_masks(bitmat: np.ndarray) -> np.ndarray:
    """(8m, 8k) 0/1 bit-matrix -> (8m, k) uint32: word (r, i) is the byte
    whose bit b is ``bitmat[r, 8i + b]``, copied into all four bytes."""
    b = np.asarray(bitmat, dtype=np.uint8)
    m8, k8 = b.shape
    bytes_ = ((b.reshape(m8, k8 // 8, 8) & 1).astype(np.uint32)
              << np.arange(8, dtype=np.uint32)).sum(axis=-1, dtype=np.uint32)
    return bytes_ * np.uint32(0x01010101)


def kernel_masks(bitmat: np.ndarray, *, packed: bool) -> np.ndarray:
    """The masks in the kernel's order, flat uint32: [u][chunk][c][i] for
    output row 8u + c and input row 8 * chunk + i, i padded with zero
    masks to 8 a chunk.  ``packed``: four input rows to a word, byte t of
    word q being input row 4q + t ([u][chunk][c][q])."""
    words = replicated_masks(bitmat)
    m8, k = words.shape
    nch = -(-k // 8)
    byte = np.zeros((m8, 8 * nch), dtype=np.uint8)
    byte[:, :k] = words & 0xFF
    blocked = byte.reshape(m8 // 8, 8, nch, 8).transpose(0, 2, 1, 3)
    if packed:
        return np.ascontiguousarray(blocked).reshape(-1).view("<u4").copy()
    return blocked.reshape(-1).astype(np.uint32) * np.uint32(0x01010101)


def replicated_fits(k: int, m: int) -> bool:
    """Whether a (k, m) code's masks go to the kernel replicated (else
    packed four input rows to a word, for codes up to k + m = 256)."""
    return m * -(-k // 8) * 64 * 4 <= REPLICATED_BYTES


#: id(bit-matrix) -> (weak reference to it, its _version, packed,
#: device tensor of its masks, that tensor's address)
_mask_cache: dict[int, tuple] = {}


def _masks(bitmat: torch.Tensor) -> tuple[int, int]:
    """(packed, device address) of the kernel's masks for ``bitmat``,
    built once per bit-matrix tensor, kept while it lives, and rebuilt if
    it is changed in place."""
    key = id(bitmat)
    hit = _mask_cache.get(key)
    if hit is not None and hit[0]() is bitmat and hit[1] == bitmat._version:
        return hit[2], hit[4]
    m, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    packed = int(not replicated_fits(k, m))
    words = kernel_masks(bitmat.cpu().numpy(), packed=bool(packed))
    held = torch.from_numpy(words.view(np.int32)).to(bitmat.device)

    def drop(ref, key=key):
        if _mask_cache.get(key, (None,))[0] is ref:
            del _mask_cache[key]

    _mask_cache[key] = (weakref.ref(bitmat, drop), bitmat._version, packed,
                        held, held.data_ptr())
    return packed, held.data_ptr()


@functools.lru_cache(maxsize=1024)
def _launch_plan(s: int, batch: int, sm_count: int,
                 words: int | None = None) -> tuple[int, int]:
    """(words per thread, blocks) for a launch over ``batch`` rows of
    ``s`` columns.  A thread takes 4W columns of one batch row (item
    t -> row t // ceil(s / 4W)): W = 4 (16 columns) where there are
    items enough for the capped grid, else W = 2 (8 columns), unless
    ``words`` fixes it.  The grid is one thread per item, capped at
    ``MAX_BLOCKS_PER_SM`` blocks per SM, past which each thread strides
    over items."""
    cap = sm_count * MAX_BLOCKS_PER_SM
    if words is None:
        words = 4 if batch * -(-s // 16) >= cap * THREADS else 2
    items = batch * -(-s // (4 * words))
    return words, max(min(-(-items // THREADS), cap), 1)


_sm_counts: dict[int, int] = {}


def _sm_count(index: int) -> int:
    n = _sm_counts.get(index)
    if n is None:
        n = _sm_counts[index] = torch.cuda.get_device_properties(index).multi_processor_count
    return n


#: the kernel's modes (``Mode`` in the source)
MODE_STORE, MODE_ACC = 0, 1
#: the stage cuts' modes, by stage; "full" is the store
STAGE_MODES = {"load": 3, "extract": 4, "matmul": 5, "full": MODE_STORE}


def _operands(ts) -> int:
    """The CUDA device index of the (name, tensor) operands; raises
    unless all are CUDA tensors on one device, all but ``bitmat``
    contiguous."""
    for name, t in ts:
        if not t.is_cuda:
            raise ValueError(f"{name} is on {t.device}, the kernel needs CUDA")
    if not all(t.is_contiguous() for name, t in ts if name != "bitmat"):
        raise ValueError(", ".join(n for n, _ in ts if n != "bitmat") + " must be contiguous")
    index = ts[0][1].get_device()
    if any(t.get_device() != index for _, t in ts):
        raise ValueError("operands on different devices: " + ", ".join(
            f"{name} on {t.device}" for name, t in ts))
    return index


def _call(fn, args, index: int) -> int:
    """``fn(*args, stream)`` on device ``index``'s current stream."""
    if index == torch.cuda.current_device():
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))
    with torch.cuda.device(index):
        return fn(*args, torch._C._cuda_getCurrentRawStream(index))


def _launch(bitmat, data, out, *, acc=False, seed=0, words=None,
            stage=None) -> None:
    """One kernel launch on the current stream; raises if it is refused.
    ``words`` overrides the launch plan's columns per thread (4 * words).
    ``stage`` (a key of ``STAGE_MODES``) launches that stage cut instead
    of the store.  Checks only what the kernel needs (the entry points
    check the rest): all on one CUDA device, data and out contiguous."""
    index = _operands((("bitmat", bitmat), ("data", data), ("out", out)))
    *_, k, s = data.shape
    m = bitmat.shape[0] // 8
    batch = data.numel() // (k * s) if s else 0
    packed, masks = _masks(bitmat)
    words, blocks = _launch_plan(s, batch, _sm_count(index), words)
    mode = (MODE_ACC if acc else STAGE_MODES[stage] if stage is not None
            else MODE_STORE)
    err = _call(_kernel(), (data.data_ptr(), out.data_ptr(), masks, packed, k, m, s,
                            batch, mode, seed & 0xFF, words, blocks), index)
    if err != 0:
        raise RuntimeError(
            f"gf_bitmatmul kernel launch failed: cudaError {err} "
            f"(k={k}, m={m}, S={s}, batch={batch}, mode={mode}, words={words})")


def compare_plan(s: int, batch: int, m: int, sms: int) -> tuple[int, int]:
    """(parts, threads) of a compare launch over ``batch`` entries of
    ``s`` columns and ``m`` stored rows on a card of ``sms`` SMs: block i
    takes part i % parts of entry i // parts.  A unit is one (item of 4 *
    ``COMPARE_WORDS`` columns, stored row) pair of a row group, items in
    chunks of 32; thread t of a part takes units part * threads + t, +
    parts * threads, ...  A block an SM where that gives every thread at
    most one unit; else as many blocks an entry as the card holds for
    every entry at once (two an SM: 64 registers a thread, no shared
    memory but a word a warp), each thread the same count of units.  One
    part an entry where the entries outnumber the blocks."""
    lo, hi = COMPARE_MIN_THREADS, COMPARE_MAX_THREADS
    items = -(-s // (4 * COMPARE_WORDS))
    units = -(-items // 32) * 32 * min(m, COMPARE_GROUP_ROWS)
    if units == 0:
        return 1, lo

    def block(n: int) -> int:
        return min(hi, max(lo, -(-n // 32) * 32))

    parts = min(sms // max(batch, 1), -(-units // lo))
    if parts >= 1 and units <= parts * hi:
        return parts, block(-(-units // parts))
    parts = max(1, min(2 * sms // max(batch, 1), -(-units // lo)))
    per = -(-units // (parts * hi))
    return parts, block(-(-units // (parts * per)))


#: (device index, raw stream) -> the compare's zeroed slots
_SLOTS: dict[tuple[int, int], torch.Tensor] = {}


def _compare_slots(index: int, stream: int) -> torch.Tensor:
    """The compare's slots on one device and stream: 8 bytes for each
    (entry, row group, part), at most two blocks an SM times the row
    groups of the widest code; zeroed once, left zero by every launch."""
    slots = _SLOTS.get((index, stream))
    if slots is None:
        n = 2 * _sm_count(index) * -(-256 // COMPARE_GROUP_ROWS)
        slots = _SLOTS[(index, stream)] = torch.zeros(n, dtype=torch.int64,
                                                      device=f"cuda:{index}")
    return slots


def _launch_compare(bitmat, data, parity, flags) -> None:
    """One compare launch on the current stream; raises if it is refused.
    ``flags``: the (..., m) bool tensor the kernel writes."""
    index = _operands((("bitmat", bitmat), ("data", data), ("parity", parity),
                       ("flags", flags)))
    *_, k, s = data.shape
    m = bitmat.shape[0] // 8
    batch = flags.numel() // m
    packed, masks = _masks(bitmat)
    parts, threads = compare_plan(s, batch, m, _sm_count(index))
    slots = _compare_slots(index, torch._C._cuda_getCurrentRawStream(index))
    err = _call(_compare_kernel(), (data.data_ptr(), parity.data_ptr(), flags.data_ptr(), masks,
                                    slots.data_ptr(), slots.numel(), packed, k, m, s, batch,
                                    parts, threads), index)
    if err != 0:
        raise RuntimeError(
            f"gf_encode_compare kernel launch failed: cudaError {err} (k={k}, m={m}, "
            f"S={s}, batch={batch}, parts={parts}, threads={threads})")


def _check(bitmat: torch.Tensor, data: torch.Tensor) -> tuple[int, int]:
    """Validate operands; returns (k, m)."""
    for name, t in (("bitmat", bitmat), ("data", data)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not {type(t).__name__}")
        if t.dtype != torch.uint8:
            raise TypeError(f"{name} must be uint8, not {t.dtype}")
    if bitmat.is_cuda != data.is_cuda or bitmat.get_device() != data.get_device():
        raise ValueError(
            f"bitmat on {bitmat.device} but data on {data.device}")
    bshape, dshape = bitmat.shape, data.shape
    if len(bshape) != 2 or bshape[0] % 8 or bshape[1] % 8:
        raise ValueError(f"bitmat must be (8m, 8k), got {tuple(bshape)}")
    if len(dshape) < 2:
        raise ValueError(f"data must be (..., k, S), got {tuple(dshape)}")
    m, k = bshape[0] // 8, bshape[1] // 8
    if dshape[-2] != k:
        raise ValueError(f"data has {dshape[-2]} rows, bitmat wants {k}")
    if not (1 <= k and 1 <= m and k + m <= 256):
        raise ValueError(f"k={k}, m={m}: need k + m <= 256")
    return k, m


_count_lock = threading.Lock()


def count_launch(fn) -> None:
    """Add one to entry point ``fn``'s launch count (launches come from
    worker threads too, so under a lock)."""
    with _count_lock:
        fn.launches += 1


def _on_cpu(t: torch.Tensor) -> bool:
    if t.is_cuda:
        return False
    if t.is_cpu:
        return True
    raise ValueError(f"unsupported device {t.device}")


def gf_bitmatmul(bitmat: torch.Tensor, data: torch.Tensor,
                 out: torch.Tensor | None = None) -> torch.Tensor:
    """Apply an (8m, 8k) GF(2) bit-matrix to (..., k, S) uint8 chunk data,
    returning (..., m, S) uint8, into ``out`` where given (a contiguous
    tensor of that shape on data's device).  On the card: one launch, the
    leading dimensions folded into its flat item index (replaces the
    jitted XLA ``gf_bitmatmul`` of ceph_tpu/ops/rs_kernels.py:59-70)."""
    k, m = _check(bitmat, data)
    want = (*data.shape[:-2], m, data.shape[-1])
    if out is not None and (not isinstance(out, torch.Tensor) or out.dtype != torch.uint8
                            or tuple(out.shape) != want or out.device != data.device):
        raise ValueError(f"out must be a uint8 tensor {want} on {data.device}")
    if _on_cpu(data):
        res = gf_bitmatmul_plain(bitmat, data)
        return res if out is None else out.copy_(res)
    if out is None:
        out = torch.empty(want, dtype=torch.uint8, device=data.device)
    _launch(bitmat, data, out)
    count_launch(gf_bitmatmul)
    return out


def _check_2d(data: torch.Tensor, multiple: int) -> None:
    if data.dim() != 2:
        raise ValueError(f"data must be (k, S), got {tuple(data.shape)}")
    assert data.shape[1] % multiple == 0, (data.shape[1], multiple)


def gf_bitmatmul_pallas(bitmat: torch.Tensor, data: torch.Tensor, *,
                        tile_s: int) -> torch.Tensor:
    """2-D (k, S) form with S a multiple of ``tile_s``; bit-exact with
    :func:`gf_bitmatmul`.  Replaces ``gf_bitmatmul_pallas``
    (ceph_tpu/ops/rs_kernels.py:257-286); the tile is a TPU block width
    and only its divisibility is kept."""
    k, m = _check(bitmat, data)
    _check_2d(data, tile_s)
    if _on_cpu(data):
        return gf_bitmatmul_plain(bitmat, data)
    out = torch.empty((m, data.shape[1]), dtype=torch.uint8, device=data.device)
    _launch(bitmat, data, out)
    count_launch(gf_bitmatmul_pallas)
    return out


def gf_bitmatmul_pallas_grouped(bitmat: torch.Tensor, data: torch.Tensor, *,
                                tile_s: int, groups: int) -> torch.Tensor:
    """Grouped column layout: group j of window w covers columns
    [(w*g + j)*T, (w*g + j + 1)*T), S a multiple of ``groups * tile_s``.
    Replaces ``gf_bitmatmul_pallas_grouped``
    (ceph_tpu/ops/rs_kernels.py:204-240), which packed the groups as
    blockdiag(C, ..., C) to fill the TPU's MXU.  The grouping changes no
    output byte, so on the card it is the ungrouped launch; the layout's
    divisibility is still asserted."""
    k, m = _check(bitmat, data)
    _check_2d(data, groups * tile_s)
    if groups < 1 or groups & (groups - 1):
        raise ValueError(f"groups must be a power of two, got {groups}")
    if _on_cpu(data):
        return gf_bitmatmul_plain(bitmat, data)
    out = torch.empty((m, data.shape[1]), dtype=torch.uint8, device=data.device)
    _launch(bitmat, data, out)
    count_launch(gf_bitmatmul_pallas_grouped)
    return out


def gf_bitmatmul_pallas_acc(bitmat: torch.Tensor, data: torch.Tensor,
                            carry: torch.Tensor, seed, *,
                            tile_s: int) -> torch.Tensor:
    """``carry ^= encode(data ^ (seed & 0xFF))``, in place; returns
    ``carry``.  Replaces ``gf_bitmatmul_pallas_acc``
    (ceph_tpu/ops/rs_kernels.py:289-342), whose carry is aliased to its
    output (``input_output_aliases``): updating the tensor in place is
    how the port keeps that aliasing.  ``seed`` is an int or a
    one-element int tensor (the JAX ``int32[1]``); like the TPU kernel's
    cast, only its low byte is used.  The loop body of the throughput
    harness."""
    k, m = _check(bitmat, data)
    _check_2d(data, tile_s)
    if not isinstance(carry, torch.Tensor) or carry.dtype != torch.uint8:
        raise TypeError("carry must be a uint8 torch.Tensor")
    if tuple(carry.shape) != (m, data.shape[1]) or carry.device != data.device:
        raise ValueError(
            f"carry must be ({m}, {data.shape[1]}) on {data.device}, got "
            f"{tuple(carry.shape)} on {carry.device}")
    if isinstance(seed, torch.Tensor):
        seed = int(seed.reshape(-1)[0])
    seed = int(seed) & 0xFF
    if _on_cpu(data):
        return carry.bitwise_xor_(gf_bitmatmul_plain(bitmat, data ^ seed))
    _launch(bitmat, data, carry, acc=True, seed=seed)
    count_launch(gf_bitmatmul_pallas_acc)
    return carry


def gf_encode_compare_plain(bitmat: torch.Tensor, data: torch.Tensor,
                            parity: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf_encode_compare`: the expected parity,
    then ``!=`` and ``any`` over the columns."""
    return (gf_bitmatmul_plain(bitmat, data) != parity).any(dim=-1)


def gf_encode_compare(bitmat: torch.Tensor, data: torch.Tensor,
                      parity: torch.Tensor) -> torch.Tensor:
    """Deep scrub's batched re-encode-and-compare: apply the (8m, 8k)
    encode bit-matrix to (..., k, S) data-shard lanes and compare with
    the stored (..., m, S) parity lanes, returning a (..., m) bool
    mismatch mask.  Zero-padded columns are exact (the encode of zeros
    is zeros).  On the card: one launch of ``gf_encode_compare_kernel``,
    which writes the mask itself and whose expected parity never reaches
    memory: one device operation a call (replaces the jitted XLA
    ``gf_encode_compare`` of ceph_tpu/ops/rs_kernels.py:73-83)."""
    k, m = _check(bitmat, data)
    if not isinstance(parity, torch.Tensor) or parity.dtype != torch.uint8:
        raise TypeError("parity must be a uint8 torch.Tensor")
    want = (*data.shape[:-2], m, data.shape[-1])
    if tuple(parity.shape) != want or parity.device != data.device:
        raise ValueError(f"parity must be {want} on {data.device}, got "
                         f"{tuple(parity.shape)} on {parity.device}")
    if _on_cpu(data):
        return gf_encode_compare_plain(bitmat, data, parity)
    flags = torch.empty(want[:-1], dtype=torch.bool, device=data.device)
    if flags.numel():
        _launch_compare(bitmat, data, parity, flags)
        count_launch(gf_encode_compare)
    return flags


def gf_stage_cut_plain(bitmat: torch.Tensor, data: torch.Tensor,
                       stage: str) -> torch.Tensor:
    """Plain version of :func:`gf_stage_cut`."""
    m = bitmat.shape[0] // 8
    if stage == "load":
        return data[:m].clone()
    if stage == "extract":
        return data[:m] & 1
    out = gf_bitmatmul_plain(bitmat, data)
    return out & 1 if stage == "matmul" else out


def gf_stage_cut(bitmat: torch.Tensor, data: torch.Tensor,
                 stage: str) -> torch.Tensor:
    """The encode cut after ``stage``, as (m, S) uint8: ``load`` gives
    ``data[0:m]``, ``extract`` ``data[0:m] & 1``, ``matmul``
    ``f(data) & 1`` and ``full`` ``f(data)``, for the (8m, 8k) bit-matrix
    f and (k, S) data (``load`` and ``extract`` need m <= k).  Replaces
    the ablation probe ``make_ablate(stage).run`` of the JAX package's
    tools/perf_lab2.py:74 (``pallas_call`` :76).  On the card: one launch
    of ``gf_bitmatmul.cu`` in the stage's cut mode, which runs the
    kernel's own loop up to the stage over every input row (``full`` is
    the store).  Launches are counted per stage in
    ``gf_stage_cut.by_stage``."""
    k, m = _check(bitmat, data)
    if data.dim() != 2:
        raise ValueError(f"data must be (k, S), got {tuple(data.shape)}")
    if stage not in STAGE_MODES:
        raise ValueError(f"stage must be one of {sorted(STAGE_MODES)}, got {stage!r}")
    if stage in ("load", "extract") and m > k:
        raise ValueError(f"stage {stage!r} needs m <= k, got k={k}, m={m}")
    if _on_cpu(data):
        return gf_stage_cut_plain(bitmat, data, stage)
    out = torch.empty((m, data.shape[1]), dtype=torch.uint8, device=data.device)
    _launch(bitmat, data, out, stage=stage)
    count_launch(gf_stage_cut)
    with _count_lock:
        gf_stage_cut.by_stage[stage] += 1
    return out


# ---------------------------------------------------------------------------
# The encode farm's parity fold (csrc/farm_fold.cu)
# ---------------------------------------------------------------------------

#: threads per block of the fold kernel (``kThreads`` in the source) and
#: its grid cap in blocks per SM (past it each thread strides)
FOLD_THREADS = 256
FOLD_BLOCKS_PER_SM = 8

_fold_fn = None


def _fold_kernel():
    """ctypes handle of ``ceph_farm_fold``, built on first use."""
    global _fold_fn
    if _fold_fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("farm_fold").ceph_farm_fold
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,  # partials, out, bytes
                       ctypes.c_int, ctypes.c_int, ctypes.c_void_p]          # n, blocks, stream
        _fold_fn = fn
    return _fold_fn


def fold_blocks(nbytes: int, sm_count: int) -> int:
    """Grid of a fold over ``nbytes`` output bytes: a thread per 16-byte
    chunk, at most ``FOLD_BLOCKS_PER_SM`` blocks per SM, at least one
    block (the tail bytes of a ragged S are block 0's)."""
    return max(1, min(-(-(nbytes // 16) // FOLD_THREADS), sm_count * FOLD_BLOCKS_PER_SM))


def gf_fold_plain(partials: torch.Tensor) -> torch.Tensor:
    """Plain version of :func:`gf_fold`: an XOR reduction over dim 0."""
    out = partials[0].clone()
    for r in range(1, partials.shape[0]):
        out.bitwise_xor_(partials[r])
    return out


def gf_fold(partials: torch.Tensor) -> torch.Tensor:
    """XOR of n packed GF(2) partials, (n, m, S) uint8 -> (m, S): the
    combine of the chunk-sharded encode.  Replaces the ``psum``, ``& 1``
    and ``pack_bits`` of ``sharded_encode_tp._encode``
    (ceph_tpu/parallel/encode_farm.py:113-122): each rank's partial is
    already reduced mod 2 and packed, and (sum a_i) mod 2 = XOR (a_i mod
    2).  On the card: one launch of ``farm_fold.cu`` for any S and any
    address of the partials (a contiguous view at any offset), a 16-byte
    chunk a thread (:func:`fold_blocks`)."""
    if not isinstance(partials, torch.Tensor) or partials.dtype != torch.uint8:
        raise TypeError("partials must be a uint8 torch.Tensor")
    if partials.dim() != 3 or partials.shape[0] < 1:
        raise ValueError(f"partials must be (n, m, S) with n >= 1, got {tuple(partials.shape)}")
    if _on_cpu(partials):
        return gf_fold_plain(partials)
    if not partials.is_contiguous():
        raise ValueError("partials must be contiguous")
    n, m, s = partials.shape
    out = torch.empty((m, s), dtype=torch.uint8, device=partials.device)
    index = partials.get_device()
    blocks = fold_blocks(m * s, _sm_count(index))
    err = _call(_fold_kernel(), (partials.data_ptr(), out.data_ptr(), m * s, n, blocks), index)
    if err != 0:
        raise RuntimeError(f"farm_fold kernel launch failed: cudaError {err} "
                           f"(n={n}, m={m}, S={s}, blocks={blocks})")
    count_launch(gf_fold)
    return out


KERNEL_ENTRY_POINTS = (
    gf_bitmatmul,
    gf_bitmatmul_pallas,
    gf_bitmatmul_pallas_grouped,
    gf_bitmatmul_pallas_acc,
    gf_encode_compare,
    gf_stage_cut,
    gf_fold,
)


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0
    gf_stage_cut.by_stage = dict.fromkeys(STAGE_MODES, 0)


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset
    (``gf_stage_cut``: all stages; per stage in ``gf_stage_cut.by_stage``)."""
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


reset_launch_counts()


# ---------------------------------------------------------------------------
# Tile / group selection (kept from the JAX package so the same shapes
# reach the same entry points)
# ---------------------------------------------------------------------------

def _pick_groups(k: int, m: int, s: int, tile_s: int) -> int:
    """Largest power-of-two g with full blocks: 8kg <= 128, 8mg <= 128,
    g | s/tile_s (ceph_tpu/ops/rs_kernels.py:193-201)."""
    g = max(1, min(128 // (8 * k), 128 // (8 * m)))
    g = 1 << (g.bit_length() - 1)
    while g > 1 and ((s // tile_s) % g != 0):
        g //= 2
    return g


def _pick_tile(s: int, max_tile: int = 262144) -> int | None:
    """Largest power-of-two tile <= max_tile dividing s, None if s has
    no even tiling >= 512 (ceph_tpu/ops/rs_kernels.py:243-254)."""
    t = max_tile
    while t >= 512:
        if s % t == 0:
            return t
        t //= 2
    return None


# ---------------------------------------------------------------------------
# Encoder/decoder objects (host-side matrix prep, cached)
# ---------------------------------------------------------------------------

class BitmatrixCodec:
    """Precomputed bit-matrices for one (k, m, generator) code, on one
    device.  Decode matrices are derived and cached per erasure
    signature (the ISA plugin's decode-table cache, reference
    ErasureCodeIsaTableCache.cc)."""

    def __init__(self, coding_matrix: np.ndarray, *, device=None):
        self.device = resolve_device(device)
        self.C = np.asarray(coding_matrix, dtype=np.uint8)
        self.m, self.k = self.C.shape
        self.encode_bits = torch.as_tensor(
            gf_matrix_to_bitmatrix(self.C), device=self.device)
        self._decode_cache: dict[tuple[int, ...], tuple[list[int], torch.Tensor]] = {}

    def decode_bits(self, erasures: tuple[int, ...]) -> tuple[list[int], torch.Tensor]:
        """(survivor chunk ids, bit-matrix mapping survivors->erased)."""
        key = tuple(sorted(erasures))
        hit = self._decode_cache.get(key)
        if hit is None:
            from ceph_tpu_torch.models.matrices import decode_matrix_for

            D = decode_matrix_for(self.C, list(key))
            survivors = [
                i for i in range(self.k + self.m) if i not in set(key)
            ][: self.k]
            hit = (survivors, torch.as_tensor(
                gf_matrix_to_bitmatrix(D), device=self.device))
            self._decode_cache[key] = hit
        return hit

    def encode(self, data: torch.Tensor, *, pallas: bool | None = None) -> torch.Tensor:
        """(..., k, S) uint8 -> (..., m, S) parity.  ``pallas=None``
        picks the 2-D kernels for 2-D data on the card."""
        return self._apply(self.encode_bits, data, pallas)

    def decode_batch(self, batch: torch.Tensor,
                     erasures: tuple[int, ...]) -> torch.Tensor:
        """(B, k, S) survivor lanes (survivors in codec order for this
        signature) -> (B, e, S) reconstructed chunks, one launch."""
        _survivors, dbits = self.decode_bits(erasures)
        return gf_bitmatmul(dbits, batch)

    def decode(self, chunks: torch.Tensor, erasures: tuple[int, ...], *,
               pallas: bool | None = None) -> torch.Tensor:
        """Reconstruct erased chunks from the full (..., k+m, S) tensor in
        which erased rows are ignored.  Returns (..., len(erasures), S)
        with rows in the order *requested*, not sorted order."""
        survivors, dbits = self.decode_bits(erasures)
        sub = chunks[..., survivors, :].contiguous()
        rec = self._apply(dbits, sub, pallas)
        key = tuple(sorted(set(erasures)))
        if key != tuple(erasures):
            order = [key.index(e) for e in erasures]
            rec = rec[..., order, :]
        return rec

    @staticmethod
    def _apply(bits_matrix: torch.Tensor, data: torch.Tensor,
               pallas: bool | None) -> torch.Tensor:
        if pallas is None:
            pallas = data.dim() == 2 and data.device.type == "cuda"
        if pallas and data.dim() == 2:
            tile = _pick_tile(data.shape[-1])
            if tile is not None:
                m8, k8 = bits_matrix.shape
                g = _pick_groups(k8 // 8, m8 // 8, data.shape[-1], tile)
                if g > 1 and tile // g >= 512:
                    return gf_bitmatmul_pallas_grouped(
                        bits_matrix, data, tile_s=tile // g, groups=g)
                return gf_bitmatmul_pallas(bits_matrix, data, tile_s=tile)
        return gf_bitmatmul(bits_matrix, data)


def codec_from_reference(C: np.ndarray, *, device) -> BitmatrixCodec:
    """The port's codec for the (m, k) uint8 coding matrix that the JAX
    package's ``BitmatrixCodec.C`` holds: its ``encode_bits`` and
    ``decode_bits`` equal the JAX codec's."""
    return BitmatrixCodec(np.asarray(C, dtype=np.uint8), device=device)

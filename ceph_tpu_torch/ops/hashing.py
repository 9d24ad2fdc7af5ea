"""CRUSH's rjenkins1 hashes, and crc32c with its batched kernel for deep
scrub.

Counterpart of ``ceph_tpu/ops/hashing.py``.

The CRUSH hashes (:21-260) are Robert Jenkins' 96-bit mix with seed
1315423911 and the fixed padding words x=231232, y=1232
(src/crush/hash.c:12-90): ``crush_hash32`` .. ``crush_hash32_5`` on
numpy uint32 (with a plain-int fast path for the scalar mapper), and
``crush_hash32_2_torch`` / ``crush_hash32_3_torch`` on int32 tensors for
the plain version of the batched CRUSH mapper.  Placement is a pure
function of them, so they match the reference bit for bit.
``ceph_str_hash_rjenkins`` is Jenkins' lookup2 over an object's name, on
plain ints: the hash that places an object into its PG.

crc32c is GF(2)-linear in (state, message), so over a width-W message

    crc(d, seed) = S_W @ bits(seed)  XOR  M_W @ bits(d)

with S_W the 32x32 "advance through W zero bytes" operator and M_W a
(32, 8W) matrix, byte i bit j at column 8i+j (:func:`crc32c_matrix`,
built host-side by doubling and cached per width).  Deep scrub pads
each shard lane with zeros into its power-of-two bucket;
crc(d || 0^p, s) is the injective advance of crc(d, s) through p zeros,
so the true crc comes back exactly with :func:`crc32c_unadvance`.

:func:`batched_crc32c_device` maps (B, W) uint8 lanes to their (B,)
seed-0 crc words.  On a CUDA tensor it launches the hand-written kernel
of ``csrc/crc32c_lanes.cu`` (built with ``nvcc`` at first use); on a
CPU tensor it runs the plain PyTorch version
:func:`batched_crc32c_plain`, the literal product ``M_W @ bits(lane)``.
The JAX entry point took ``M_W`` as an argument; every caller passed
``crc32c_matrix(W)``, and the kernel computes crc32c itself, so the port
takes the lanes alone.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch import native
from ceph_tpu_torch.common.transfer_guard import check_operands
from ceph_tpu_torch.ops.rs_kernels import _on_cpu, count_launch

# ---------------------------------------------------------------------------
# CRUSH rjenkins1 hashes (numpy uint32, plain ints, int32 tensors)
# ---------------------------------------------------------------------------

HASH_SEED = np.uint32(1315423911)
_X = 231232
_Y = 1232
_M32 = 0xFFFFFFFF
_SEED_INT = 1315423911


def _mix_int(a: int, b: int, c: int) -> tuple[int, int, int]:
    """One Jenkins mix round on plain Python ints, kept masked to 32 bits
    so >> is a logical shift (the scalar mapper's fast path: a numpy
    scalar pays about a microsecond of dispatch per operation)."""
    a = (a - b - c) & _M32; a ^= c >> 13
    b = (b - c - a) & _M32; b ^= (a << 8) & _M32
    c = (c - a - b) & _M32; c ^= b >> 13
    a = (a - b - c) & _M32; a ^= c >> 12
    b = (b - c - a) & _M32; b ^= (a << 16) & _M32
    c = (c - a - b) & _M32; c ^= b >> 5
    a = (a - b - c) & _M32; a ^= c >> 3
    b = (b - c - a) & _M32; b ^= (a << 10) & _M32
    c = (c - a - b) & _M32; c ^= b >> 15
    return a, b, c


def _mix_np(a, b, c):
    """One Jenkins mix round on uint32 numpy arrays."""
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(13))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(8))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(13))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(12))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(16))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(5))
    a = a - b; a = a - c; a = a ^ (c >> np.uint32(3))
    b = b - c; b = b - a; b = b ^ (a << np.uint32(10))
    c = c - a; c = c - b; c = c ^ (b >> np.uint32(15))
    return a, b, c


def _wrapping(fn):
    """uint32 wraparound is the point: silence numpy's overflow warnings
    inside the hash only.  The all-plain-int path skips the errstate
    context, which costs more than the whole int hash."""
    @functools.wraps(fn)
    def inner(*a):
        for v in a:
            if type(v) is not int:
                with np.errstate(over="ignore"):
                    return fn(*a)
        return fn(*a)
    return inner


def _u32(x):
    return np.asarray(x).astype(np.uint32)


@_wrapping
def crush_hash32(a):
    if type(a) is int:
        a &= _M32
        h = (_SEED_INT ^ a) & _M32
        b, x, y = a, _X, _Y
        b, x, h = _mix_int(b, x, h)
        y, a, h = _mix_int(y, a, h)
        return h
    a = _u32(a)
    h = HASH_SEED ^ a
    b = a
    x = np.uint32(_X)
    y = np.uint32(_Y)
    b, x, h = _mix_np(b, x, h)
    y, a, h = _mix_np(y, a, h)
    return h


@_wrapping
def crush_hash32_2(a, b):
    if type(a) is int and type(b) is int:
        a &= _M32; b &= _M32
        h = (_SEED_INT ^ a ^ b) & _M32
        x, y = _X, _Y
        a, b, h = _mix_int(a, b, h)
        x, a, h = _mix_int(x, a, h)
        b, y, h = _mix_int(b, y, h)
        return h
    a, b = _u32(a), _u32(b)
    h = HASH_SEED ^ a ^ b
    x = np.uint32(_X)
    y = np.uint32(_Y)
    a, b, h = _mix_np(a, b, h)
    x, a, h = _mix_np(x, a, h)
    b, y, h = _mix_np(b, y, h)
    return h


@_wrapping
def crush_hash32_3(a, b, c):
    if type(a) is int and type(b) is int and type(c) is int:
        a &= _M32; b &= _M32; c &= _M32
        h = (_SEED_INT ^ a ^ b ^ c) & _M32
        x, y = _X, _Y
        a, b, h = _mix_int(a, b, h)
        c, x, h = _mix_int(c, x, h)
        y, a, h = _mix_int(y, a, h)
        b, x, h = _mix_int(b, x, h)
        y, c, h = _mix_int(y, c, h)
        return h
    a, b, c = _u32(a), _u32(b), _u32(c)
    h = HASH_SEED ^ a ^ b ^ c
    x = np.uint32(_X)
    y = np.uint32(_Y)
    a, b, h = _mix_np(a, b, h)
    c, x, h = _mix_np(c, x, h)
    y, a, h = _mix_np(y, a, h)
    b, x, h = _mix_np(b, x, h)
    y, c, h = _mix_np(y, c, h)
    return h


@_wrapping
def crush_hash32_4(a, b, c, d):
    if (type(a) is int and type(b) is int and type(c) is int
            and type(d) is int):
        a &= _M32; b &= _M32; c &= _M32; d &= _M32
        h = (_SEED_INT ^ a ^ b ^ c ^ d) & _M32
        x, y = _X, _Y
        a, b, h = _mix_int(a, b, h)
        c, d, h = _mix_int(c, d, h)
        a, x, h = _mix_int(a, x, h)
        y, b, h = _mix_int(y, b, h)
        c, x, h = _mix_int(c, x, h)
        y, d, h = _mix_int(y, d, h)
        return h
    a, b, c, d = _u32(a), _u32(b), _u32(c), _u32(d)
    h = HASH_SEED ^ a ^ b ^ c ^ d
    x = np.uint32(_X)
    y = np.uint32(_Y)
    a, b, h = _mix_np(a, b, h)
    c, d, h = _mix_np(c, d, h)
    a, x, h = _mix_np(a, x, h)
    y, b, h = _mix_np(y, b, h)
    c, x, h = _mix_np(c, x, h)
    y, d, h = _mix_np(y, d, h)
    return h


@_wrapping
def crush_hash32_5(a, b, c, d, e):
    if (type(a) is int and type(b) is int and type(c) is int
            and type(d) is int and type(e) is int):
        a &= _M32; b &= _M32; c &= _M32; d &= _M32; e &= _M32
        h = (_SEED_INT ^ a ^ b ^ c ^ d ^ e) & _M32
        x, y = _X, _Y
        a, b, h = _mix_int(a, b, h)
        c, d, h = _mix_int(c, d, h)
        e, x, h = _mix_int(e, x, h)
        y, a, h = _mix_int(y, a, h)
        b, x, h = _mix_int(b, x, h)
        y, c, h = _mix_int(y, c, h)
        d, x, h = _mix_int(d, x, h)
        y, e, h = _mix_int(y, e, h)
        return h
    a, b, c, d, e = _u32(a), _u32(b), _u32(c), _u32(d), _u32(e)
    h = HASH_SEED ^ a ^ b ^ c ^ d ^ e
    x = np.uint32(_X)
    y = np.uint32(_Y)
    a, b, h = _mix_np(a, b, h)
    c, d, h = _mix_np(c, d, h)
    e, x, h = _mix_np(e, x, h)
    y, a, h = _mix_np(y, a, h)
    b, x, h = _mix_np(b, x, h)
    y, c, h = _mix_np(y, c, h)
    d, x, h = _mix_np(d, x, h)
    y, e, h = _mix_np(y, e, h)
    return h


# int32 tensors wrap like uint32 for +, -, ^ and <<; >> must be a
# logical shift, so the sign bits it drags in are masked off

def _rs(v: torch.Tensor, n: int) -> torch.Tensor:
    return (v >> n) & ((1 << (32 - n)) - 1)


def _mix_torch(a, b, c):
    a = a - b; a = a - c; a = a ^ _rs(c, 13)
    b = b - c; b = b - a; b = b ^ (a << 8)
    c = c - a; c = c - b; c = c ^ _rs(b, 13)
    a = a - b; a = a - c; a = a ^ _rs(c, 12)
    b = b - c; b = b - a; b = b ^ (a << 16)
    c = c - a; c = c - b; c = c ^ _rs(b, 5)
    a = a - b; a = a - c; a = a ^ _rs(c, 3)
    b = b - c; b = b - a; b = b ^ (a << 10)
    c = c - a; c = c - b; c = c ^ _rs(b, 15)
    return a, b, c


#: the hash seed as an int32 (the same 32 bits)
_SEED_I32 = int(np.uint32(HASH_SEED).astype(np.int32))


def _as_i32(v, like: torch.Tensor | None = None) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        if v.dtype != torch.int32:
            raise TypeError(f"CRUSH hash operands are int32 tensors, not {v.dtype}")
        return v
    return torch.tensor(int(np.uint32(v & _M32).astype(np.int32)), dtype=torch.int32,
                        device=None if like is None else like.device)


def crush_hash32_3_torch(a, b, c) -> torch.Tensor:
    """crush_hash32_3 on int32 tensors (the uint32 bits as int32),
    broadcasting; the counterpart of ``crush_hash32_3_jax``."""
    like = next(v for v in (a, b, c) if isinstance(v, torch.Tensor))
    a, b, c = (_as_i32(v, like) for v in (a, b, c))
    h = _SEED_I32 ^ a ^ b ^ c
    x = torch.full_like(h, _X)
    y = torch.full_like(h, _Y)
    a, b, h = _mix_torch(a, b, h)
    c, x, h = _mix_torch(c, x, h)
    y, a, h = _mix_torch(y, a, h)
    b, x, h = _mix_torch(b, x, h)
    y, c, h = _mix_torch(y, c, h)
    return h


def crush_hash32_2_torch(a, b) -> torch.Tensor:
    """crush_hash32_2 on int32 tensors; the counterpart of
    ``crush_hash32_2_jax``."""
    like = next(v for v in (a, b) if isinstance(v, torch.Tensor))
    a, b = (_as_i32(v, like) for v in (a, b))
    h = _SEED_I32 ^ a ^ b
    x = torch.full_like(h, _X)
    y = torch.full_like(h, _Y)
    a, b, h = _mix_torch(a, b, h)
    x, a, h = _mix_torch(x, a, h)
    b, y, h = _mix_torch(b, y, h)
    return h


def ceph_str_hash_rjenkins(data: bytes | str) -> int:
    """Object-name hash (reference src/common/ceph_hash.cc
    ceph_str_hash_rjenkins): Jenkins lookup2 over 12-byte blocks with
    the length folded into c — the hash that places objects into PGs
    (object_locator_to_pg, src/osd/osd_types.cc).  Pure-int (scalar
    hot path: runs once per client op)."""
    if isinstance(data, str):
        data = data.encode("utf-8")
    k = data
    length = len(k)
    a = 0x9E3779B9
    b = 0x9E3779B9
    c = 0
    off = 0
    ln = length
    while ln >= 12:
        a = (a + int.from_bytes(k[off : off + 4], "little")) & _M32
        b = (b + int.from_bytes(k[off + 4 : off + 8], "little")) & _M32
        c = (c + int.from_bytes(k[off + 8 : off + 12], "little")) & _M32
        a, b, c = _mix_int(a, b, c)
        off += 12
        ln -= 12
    c = (c + length) & _M32
    tail = k[off:]
    t = tail + b"\0" * (11 - len(tail))
    if ln >= 9:
        # the first byte of c is reserved for the length
        c = (c + (
            (t[8] << 8) | (t[9] << 16 if ln >= 10 else 0) | (t[10] << 24 if ln >= 11 else 0)
        )) & _M32
    if ln >= 5:
        b = (b + (
            t[4] | (t[5] << 8 if ln >= 6 else 0) | (t[6] << 16 if ln >= 7 else 0)
            | (t[7] << 24 if ln >= 8 else 0)
        )) & _M32
    if ln >= 1:
        a = (a + (
            t[0] | (t[1] << 8 if ln >= 2 else 0) | (t[2] << 16 if ln >= 3 else 0)
            | (t[3] << 24 if ln >= 4 else 0)
        )) & _M32
    a, b, c = _mix_int(a, b, c)
    return c


# ---------------------------------------------------------------------------
# Host-side GF(2) operators (numpy)
# ---------------------------------------------------------------------------


def _crc_bits(v: int, n: int = 32) -> np.ndarray:
    return np.array([(v >> i) & 1 for i in range(n)], dtype=np.uint8)


def _gf2_mm(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return ((a.astype(np.uint32) @ b.astype(np.uint32)) & 1).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _crc_base() -> tuple[np.ndarray, np.ndarray]:
    """(M_1 (32,8), S_1 (32,32)): single-byte crc data/state operators."""
    m1 = np.zeros((32, 8), dtype=np.uint8)
    for b in range(8):
        m1[:, b] = _crc_bits(native.crc32c(bytes([1 << b]), 0))
    s1 = np.zeros((32, 32), dtype=np.uint8)
    for i in range(32):
        s1[:, i] = _crc_bits(native.crc32c_zeros(1, 1 << i))
    return m1, s1


@functools.lru_cache(maxsize=32)
def _crc_ops(width: int) -> tuple[np.ndarray, np.ndarray]:
    """(M_W (32, 8W), S_W (32, 32)) for a power-of-two ``width``."""
    assert width >= 1 and (width & (width - 1)) == 0, width
    if width == 1:
        return _crc_base()
    m_half, s_half = _crc_ops(width // 2)
    return (
        np.concatenate([_gf2_mm(s_half, m_half), m_half], axis=1),
        _gf2_mm(s_half, s_half),
    )


def crc32c_matrix(width: int) -> np.ndarray:
    """The (32, 8*width) GF(2) matrix M_W: crc contribution of a
    width-byte message at seed 0, bit j of byte i at column 8i+j."""
    return _crc_ops(width)[0]


@functools.lru_cache(maxsize=64)
def _crc_unadvance_op(n: int) -> np.ndarray:
    """32x32 inverse of the advance-by-n-zero-bytes operator S_n."""
    if n == 0:
        return np.eye(32, dtype=np.uint8)
    # S_1^{-1} by GF(2) Gaussian elimination (S is invertible: the crc
    # register update is a bijection), then binary decomposition
    if n == 1:
        s1 = _crc_base()[1]
        aug = np.concatenate([s1.copy(), np.eye(32, dtype=np.uint8)], axis=1)
        for col in range(32):
            piv = next(r for r in range(col, 32) if aug[r, col])
            aug[[col, piv]] = aug[[piv, col]]
            for r in range(32):
                if r != col and aug[r, col]:
                    aug[r] ^= aug[col]
        return np.ascontiguousarray(aug[:, 32:])
    if n & (n - 1) == 0:
        h = _crc_unadvance_op(n // 2)
        return _gf2_mm(h, h)
    lsb = n & -n
    return _gf2_mm(_crc_unadvance_op(n - lsb), _crc_unadvance_op(lsb))


def crc32c_unadvance(crc: int, n: int) -> int:
    """Invert ``crc32c_zeros(n, x) == crc``: the crc BEFORE advancing
    through ``n`` zero bytes (exact; the advance is injective)."""
    if n == 0:
        return crc
    out = _gf2_mm(_crc_unadvance_op(n), _crc_bits(crc).reshape(32, 1))
    return int(sum(int(b) << i for i, b in enumerate(out.reshape(32))))


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

#: lane bytes per step of the plain version: a step's sums stay below
#: 8 * 2^16 = 2^19 terms, exact in float32 (2^24), and its bit tensor
#: at B x 2^19 x 4 bytes
_PLAIN_BYTES = 1 << 16

#: (device, width) -> float32 M_W on that device
_plain_mats: dict[tuple, torch.Tensor] = {}


def _plain_matrix(width: int, device: torch.device) -> torch.Tensor:
    key = (str(device), width)
    mat = _plain_mats.get(key)
    if mat is None:
        if len(_plain_mats) >= 16:
            _plain_mats.clear()
        mat = _plain_mats[key] = torch.as_tensor(
            crc32c_matrix(width), device=device).to(torch.float32)
    return mat


def _check_lanes(data: torch.Tensor) -> tuple[int, int]:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, not {type(data).__name__}")
    check_operands(data)
    if data.dtype != torch.uint8:
        raise TypeError(f"data must be uint8, not {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (B, W), got {tuple(data.shape)}")
    b, w = data.shape
    if w < 1 or w & (w - 1):
        raise ValueError(f"lane width must be a power of two, got {w}")
    return b, w


def batched_crc32c_plain(data: torch.Tensor) -> torch.Tensor:
    """(B, W) uint8 lanes -> (B,) uint32 seed-0 crc32c words, as the
    literal GF(2) product ``crc32c_matrix(W) @ bits(lane)``, packed
    LSB-first.  Exact: each float32 partial sum counts at most 2^19
    terms; partial parities of the column steps XOR together."""
    b, w = _check_lanes(data)
    mat = _plain_matrix(w, data.device)
    shifts = torch.arange(8, dtype=torch.uint8, device=data.device)
    parity = torch.zeros((b, 32), dtype=torch.int64, device=data.device)
    for c0 in range(0, w, _PLAIN_BYTES):
        part = data[:, c0:c0 + _PLAIN_BYTES]
        # byte i bit j (LSB first) -> column 8i+j, matching crc32c_matrix
        bits = ((part[:, :, None] >> shifts) & 1).reshape(b, 8 * part.shape[1]).to(torch.float32)
        sums = bits @ mat[:, 8 * c0:8 * (c0 + part.shape[1])].T
        parity ^= sums.to(torch.int64) & 1
    weights = 1 << torch.arange(32, dtype=torch.int64, device=data.device)
    words = (parity * weights).sum(dim=1)
    # the same 32 bits as an int32, then viewed as uint32
    words = torch.where(words >= 1 << 31, words - (1 << 32), words)
    return words.to(torch.int32).view(torch.uint32)


# ---------------------------------------------------------------------------
# The CUDA kernel: tables, advance operators, launch
# ---------------------------------------------------------------------------

#: threads per block, the largest cluster, words of the 8-byte step's
#: nibble tables and of one advance's, and the combine tree's levels
#: (``kThreads``, ``kMaxCluster``, ``kStepWords``, ``kAdvWords``,
#: ``kLevels`` in the source)
THREADS = 128
MAX_CLUSTER = 8
STEP_WORDS = 16 * 16
ADV_WORDS = 8 * 16
LEVELS = (THREADS * MAX_CLUSTER).bit_length() - 1
POLY = 0x82F63B78


def slice8_tables() -> np.ndarray:
    """(8, 256) uint32 slice-by-8 tables, as ``native/crc32c.cc`` builds
    them: table s maps a byte to the register after it and s zeros,
    from register 0."""
    t = np.zeros((8, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (POLY ^ (c >> 1)) if c & 1 else c >> 1
        t[0, i] = c
    for s in range(1, 8):
        prev = t[s - 1]
        t[s] = t[0][prev & 0xFF] ^ (prev >> 8)
    return t


def step_tables() -> np.ndarray:
    """(16, 16) uint32 nibble tables of the kernel's 8-byte step: entry
    [j, v] is the register after 8 bytes, from register 0, whose nibble j
    (little-endian: byte j // 2, its high half for odd j) is v and every
    other nibble 0.  That byte meets 7 - j // 2 zeros after it, so the
    entry is slice-by-8 table 7 - j // 2 at ``v << 4 (j % 2)``."""
    t8 = slice8_tables()
    v = np.arange(16)
    return np.stack([t8[7 - j // 2][v << (4 * (j % 2))] for j in range(16)])


def advance_op(n: int) -> int:
    """x^(8n) modulo the crc32c polynomial, reflected: the register is
    advanced through n zero bytes by multiplying it by this word (the
    operator S_n, whose column 31 it is)."""
    return native.crc32c_zeros(n, 1 << 31)


def advance_tables(n: int) -> np.ndarray:
    """(8, 16) uint32 nibble tables of the advance through n zero bytes:
    entry [k, v] is the register ``v << 4k`` advanced.  The advance is
    linear in the register, so it is the XOR of the eight entries its
    nibbles pick (``advance`` in the source)."""
    basis = np.array([native.crc32c_zeros(n, 1 << b) for b in range(32)], dtype=np.uint32)
    v = np.arange(16, dtype=np.uint32)
    out = np.zeros((8, 16), dtype=np.uint32)
    for k in range(8):
        for bit in range(4):
            out[k] ^= np.where((v >> np.uint32(bit)) & np.uint32(1), basis[4 * k + bit],
                               np.uint32(0))
    return out


def crc_geometry(width: int) -> tuple[int, int, int]:
    """(16-byte loads a thread a pass, blocks a lane, passes a thread) of a
    launch over lanes of ``width`` bytes, as ``ceph_crc32c_geometry``
    computes them: two loads when a lane fits one block at 32 bytes a
    thread, else four; the cluster is the lane's blocks at that rate
    rounded up to a power of two, at most ``MAX_CLUSTER``."""
    vec = 2 if width <= 32 * THREADS else 4
    block_pass = 16 * vec * THREADS
    blocks = -(-width // block_pass)
    cluster = 1
    while cluster < MAX_CLUSTER and cluster < blocks:
        cluster *= 2
    return vec, cluster, -(-width // (cluster * block_pass))


def combine_advances(width: int) -> list[int]:
    """Bytes of each level's advance in the kernel's combine tree: level s
    advances a run of 2^s segments past the next run, 2^s L bytes, L = 16
    vec passes the bytes a thread owns (levels 0-4 over a warp's lanes,
    5-6 over a block's warps, 7-9 over a cluster's blocks)."""
    vec, _, passes = crc_geometry(width)
    return [(16 * vec * passes) << s for s in range(LEVELS)]


@functools.lru_cache(maxsize=64)
def kernel_operators(width: int) -> np.ndarray:
    """The kernel's operand block for lanes of ``width`` bytes, flat
    uint32: the 8-byte step's nibble tables (``STEP_WORDS``), then the
    nibble tables of each of :func:`combine_advances` (``ADV_WORDS``
    each)."""
    return np.concatenate([step_tables().reshape(-1)] + [
        advance_tables(n).reshape(-1) for n in combine_advances(width)])


#: (device, width) -> the operand block on that device
_operators: dict[tuple[torch.device, int], torch.Tensor] = {}
_fn = None


def _kernel():
    """ctypes handle of ``ceph_crc32c_lanes``, built on first use."""
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("crc32c_lanes").ceph_crc32c_lanes
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # data, out, ops
            ctypes.c_longlong, ctypes.c_int,                     # width, batch
            ctypes.c_void_p,                                     # stream
        ]
        _fn = fn
    return _fn


def _device_operators(width: int, device: torch.device) -> torch.Tensor:
    key = (device, width)
    ops = _operators.get(key)
    if ops is None:
        ops = _operators[key] = torch.from_numpy(
            kernel_operators(width).view(np.int32)).to(device)
    return ops


def prepare(width: int, device) -> None:
    """Put the kernel's operand block for lanes of ``width`` bytes on
    ``device`` now (one upload, once per width and card), so that a
    launch inside a guarded window moves no data but its operands.
    Nothing to do on the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type != "cpu":
        _device_operators(width, dev)


def _launch(data: torch.Tensor, out: torch.Tensor) -> None:
    """One launch on the current stream; raises if it is refused."""
    if not (data.is_cuda and out.is_cuda):
        raise ValueError(f"data on {data.device}, out on {out.device}: "
                         "the kernel needs CUDA")
    if not (data.is_contiguous() and out.is_contiguous()):
        raise ValueError("data and out must be contiguous")
    index = data.get_device()
    if out.get_device() != index:
        raise ValueError(f"out on {out.device}, data on {data.device}")
    b, w = data.shape
    ops = _device_operators(w, data.device)
    args = (data.data_ptr(), out.data_ptr(), ops.data_ptr(), w, b)
    if index == torch.cuda.current_device():
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(index))
    else:
        with torch.cuda.device(index):
            err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"crc32c_lanes kernel launch failed: cudaError "
                           f"{err} (B={b}, W={w})")


def batched_crc32c_device(data: torch.Tensor) -> torch.Tensor:
    """(B, W) uint8 payload lanes, W a power of two -> (B,) uint32 seed-0
    crc32c words, ``M_W @ bits(lane)``; callers fold seeds and padding
    host-side with ``native.crc32c_zeros`` / :func:`crc32c_unadvance`.
    On the card: one launch (replaces the jitted XLA kernel of
    ceph_tpu/ops/hashing.py:361-392)."""
    b, w = _check_lanes(data)
    if _on_cpu(data):
        return batched_crc32c_plain(data)
    out = torch.empty((b,), dtype=torch.int32, device=data.device)
    if b:
        _launch(data, out)
        count_launch(batched_crc32c_device)
    return out.view(torch.uint32)


KERNEL_ENTRY_POINTS = (batched_crc32c_device,)


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


reset_launch_counts()

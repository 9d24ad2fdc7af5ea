"""GF(2^w) minimal-density RAID-6 bit-matrix codes.

The jerasure technique family behind ``liberation``, ``blaum_roth`` and
``liber8tion`` (reference src/erasure-code/jerasure/ErasureCodeJerasure
.h:192-253; the underlying jerasure/gf-complete sources are empty git
submodules in the reference checkout, so the constructions here follow
the published papers):

- **liberation** (Plank, "The RAID-6 Liberation Codes", FAST'08):
  w prime, k <= w, m = 2.  Q's sub-matrix for data disk i is the
  rotation R^i plus one extra bit for i > 0 — minimal density
  (k*w + k - 1 ones in the Q block).
- **blaum_roth** (Blaum & Roth, "On Lowest Density MDS Codes"):
  w + 1 prime, k <= w, m = 2.  Q's sub-matrix for disk i is the
  multiplication-by-x^i matrix over the ring
  GF(2)[x] / (1 + x + ... + x^w).
- **liber8tion** (Plank, FAST'09): w = 8, k <= 8, m = 2.  The paper's
  matrices are a computer-search table that is not reproducible from
  the reference tree; this module substitutes the provably-MDS
  powers-of-alpha construction at the same design point (see
  liber8tion_bitmatrix's docstring), with chunk bytes frozen by KATs
  (tests/golden/ec_kats.json).

Every constructed matrix is verified MDS (all two-chunk erasure
patterns decodable) at build time — a wrong construction cannot ship
silently.  Byte-level identity with the jerasure C library is a
structural claim only: the corpus submodules the reference would pin it
with are empty (SURVEY.md §4.5), so our own KATs are the drift guard.

All matrices use the jerasure bit-matrix convention: output bit row r
of the Q block is the XOR of input data bits c with B[r][c] == 1, i.e.
``parity_bits = B @ data_bits (mod 2)`` — exactly the layout
ceph_tpu_torch.ops.rs_kernels executes (``gf_bitmatmul.cu``).

The port's copy of ``ceph_tpu/models/bitmatrices.py``, byte for byte
the same matrices.
"""

from __future__ import annotations

import functools

import numpy as np


def _is_prime(n: int) -> bool:
    if n < 2:
        return False
    return all(n % i for i in range(2, int(n ** 0.5) + 1))


def _gf2_invertible(m: np.ndarray) -> bool:
    """Gaussian elimination over GF(2)."""
    a = m.astype(np.uint8).copy() & 1
    n = a.shape[0]
    if a.shape[0] != a.shape[1]:
        return False
    row = 0
    for col in range(n):
        piv = None
        for r in range(row, n):
            if a[r, col]:
                piv = r
                break
        if piv is None:
            return False
        a[[row, piv]] = a[[piv, row]]
        for r in range(n):
            if r != row and a[r, col]:
                a[r] ^= a[row]
        row += 1
    return True


def is_mds_raid6_bitmatrix(q: np.ndarray, k: int, w: int) -> bool:
    """True iff the (2w, kw) Q/R block matrix forms an MDS code with
    the k identity data blocks: every 2-chunk erasure is decodable."""
    assert q.shape == (2 * w, k * w)
    blocks = []
    for i in range(k):  # data chunk rows: identity blocks
        b = np.zeros((w, k * w), np.uint8)
        b[:, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        blocks.append(b)
    blocks.append(q[:w])       # P chunk
    blocks.append(q[w:])       # Q chunk
    n = k + 2
    for i in range(n):
        for j in range(i + 1, n):
            rows = [blocks[t] for t in range(n) if t not in (i, j)][:k]
            if len(rows) < k:
                return False
            if not _gf2_invertible(np.concatenate(rows, axis=0)):
                return False
    return True


def _rotation(w: int, shift: int) -> np.ndarray:
    """R^shift: output row j reads input bit (j + shift) mod w."""
    m = np.zeros((w, w), np.uint8)
    for j in range(w):
        m[j, (j + shift) % w] = 1
    return m


@functools.lru_cache(maxsize=None)
def liberation_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) bitmatrix of the liberation code (w prime, k <= w)."""
    if not (_is_prime(w) and w > 2):
        raise ValueError(f"liberation: w={w} must be prime > 2")
    if not (1 <= k <= w):
        raise ValueError(f"liberation: k={k} must be <= w={w}")
    bits = np.zeros((2 * w, k * w), np.uint8)
    for i in range(k):
        # P block: identity
        bits[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        # Q block: rotation by i ...
        bits[w:, i * w:(i + 1) * w] = _rotation(w, i)
        # ... plus the liberation extra bit for i > 0
        if i > 0:
            j = (i * ((w - 1) // 2)) % w
            bits[w + j, i * w + (j + i - 1) % w] = 1
    q = bits
    assert is_mds_raid6_bitmatrix(q, k, w), (
        f"liberation({k},{w}) construction is not MDS")
    return bits


@functools.lru_cache(maxsize=None)
def blaum_roth_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) bitmatrix of the Blaum-Roth code (w+1 prime, k <= w)."""
    if w == 7:
        pass  # firefly back-compat: reference tolerates w=7 (w+1=8)
    elif not (_is_prime(w + 1) and w > 2):
        raise ValueError(f"blaum_roth: w+1={w + 1} must be prime, w > 2")
    if not (1 <= k <= w):
        raise ValueError(f"blaum_roth: k={k} must be <= w={w}")
    # multiplication-by-x over GF(2)[x]/(1 + x + ... + x^w):
    # x * x^j = x^{j+1} for j < w-1; x * x^{w-1} = 1 + x + ... + x^{w-1}
    mx = np.zeros((w, w), np.uint8)
    for j in range(w - 1):
        mx[j + 1, j] = 1
    mx[:, w - 1] = 1
    bits = np.zeros((2 * w, k * w), np.uint8)
    block = np.eye(w, dtype=np.uint8)
    for i in range(k):
        bits[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        bits[w:, i * w:(i + 1) * w] = block
        block = (mx @ block) % 2
    if w != 7:  # w=7 (w+1 = 8 not prime) is NOT MDS; back-compat only
        assert is_mds_raid6_bitmatrix(bits, k, w), (
            f"blaum_roth({k},{w}) construction is not MDS")
    return bits


@functools.lru_cache(maxsize=None)
def liber8tion_bitmatrix(k: int) -> np.ndarray:
    """(16, 8k) bitmatrix of an MDS code at the liber8tion design point
    (w = 8, m = 2, k <= 8; reference ErasureCodeJerasure.h:240-253).

    The paper's exact minimal-density matrices are a computer-search
    table we cannot reproduce from the reference tree (the jerasure
    submodule is empty), and a fresh search over the
    rotation-plus-one-bit space dead-ends: R^a ^ R^b is singular over
    GF(2) for every a, b at w = 8 (the all-ones vector is always in its
    null space), so the true table distributes its extra bits
    differently.  Minimal density only matters for CPU XOR schedules —
    the bit-matmul kernel's cost is density-independent — so this uses the
    provably-MDS powers-of-alpha construction at the same design point:
    X_i = the GF(2)-linear matrix of multiplication by alpha^i in
    GF(2^8); X_i ^ X_j is the matrix of alpha^i + alpha^j != 0, hence
    always invertible.  Parameter contract, packetsize semantics and
    chunk layout match the reference technique; the chunk bytes are
    ours, frozen by KATs.
    """
    w = 8
    if not (1 <= k <= w):
        raise ValueError(f"liber8tion: k={k} must be <= 8")
    from ceph_tpu_torch.ops.gf256 import gf_const_to_bitmatrix, gf_mul

    bits = np.zeros((2 * w, k * w), np.uint8)
    alpha_i = 1
    for i in range(k):
        bits[:w, i * w:(i + 1) * w] = np.eye(w, dtype=np.uint8)
        bits[w:, i * w:(i + 1) * w] = gf_const_to_bitmatrix(alpha_i)
        alpha_i = gf_mul(alpha_i, 2)
    assert is_mds_raid6_bitmatrix(bits, k, w)
    return bits

"""Generator-matrix constructions for systematic MDS codes over GF(2^8).

All return the (m, k) *coding* part C of the systematic (k+m, k)
distribution matrix [I; C]: parity_i = XOR_j C[i,j] * data_j.

:func:`isa_rs_vandermonde_matrix` / :func:`isa_cauchy_matrix` follow
Intel ISA-L's ``gf_gen_rs_matrix`` / ``gf_gen_cauchy1_matrix`` exactly
(used by the reference ISA plugin, src/erasure-code/isa/
ErasureCodeIsa.cc:384-387) — the two techniques of the ``cuda`` plugin.
The jerasure, SHEC and LRC constructions arrive with their plugins.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops.gf256 import gf_inv, gf_mat_inv, gf_matmul, gf_mul


def _check_km(k: int, m: int) -> None:
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for GF(2^8) codes")
    if k < 1 or m < 1:
        raise ValueError("k and m must be >= 1")


def isa_rs_vandermonde_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L ``gf_gen_rs_matrix`` coding part: row s is the geometric
    sequence (2^s)^j, j=0..k-1.  MDS only for the (k,m) ranges ISA-L
    supports; the reference plugin restricts Vandermonde to m<=2 beyond
    which it forces Cauchy (ErasureCodeIsa.cc:206)."""
    _check_km(k, m)
    C = np.zeros((m, k), dtype=np.uint8)
    gen = np.uint8(1)  # row s uses ratio 2^s: rows are 1^j, 2^j, 4^j, ...
    for s in range(m):
        p = np.uint8(1)
        for j in range(k):
            C[s, j] = p
            p = gf_mul(p, gen)
        gen = gf_mul(gen, np.uint8(2))
    return C


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """ISA-L ``gf_gen_cauchy1_matrix`` coding part: C[i,j] = 1/((k+i) ^ j)."""
    _check_km(k, m)
    i = np.arange(k, k + m, dtype=np.int32)[:, None]
    j = np.arange(k, dtype=np.int32)[None, :]
    return gf_inv((i ^ j).astype(np.uint8))


def decode_matrix_for(C: np.ndarray, erasures: list[int]) -> np.ndarray:
    """Rows that reconstruct the erased chunks from k surviving chunks.

    ``C`` is the (m,k) coding part; chunk indices 0..k-1 are data,
    k..k+m-1 parity.  Returns (len(erasures), k): multiply by the first k
    *surviving* chunks (in index order) to reconstruct each erased chunk
    (data or parity).  This is the algebra behind jerasure's
    ``jerasure_matrix_decode`` and ISA-L's decode-table construction
    (ErasureCodeIsa.cc:227-310); plugin layers cache it per erasure
    signature.
    """
    m, k = C.shape
    full = np.concatenate([np.eye(k, dtype=np.uint8), C], axis=0)
    erased = set(erasures)
    survivors = [i for i in range(k + m) if i not in erased][:k]
    if len(survivors) < k:
        raise ValueError("not enough surviving chunks to decode")
    B = full[survivors]          # (k, k): survivors = B @ data
    Binv = gf_mat_inv(B)         # data = Binv @ survivors
    return gf_matmul(full[list(erasures)], Binv)

"""The port's GF(2^8) host math and matrix constructions against ceph_tpu.

``ceph_tpu_torch`` keeps its own copies of ``ops/gf256.py`` and
``models/matrices.py``; these pin them byte-exact (tolerance 0: GF
arithmetic has no rounding) to the JAX package's for several (k, m) and
erasure sets.
"""

import numpy as np
import pytest

from ceph_tpu.models import matrices as ref_mx
from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu_torch.models import matrices as mx
from ceph_tpu_torch.ops import gf256 as gf
from tests.xla_private import _private_xla_compiles  # noqa: F401

KM = [(2, 1), (4, 2), (8, 3), (6, 4), (16, 4), (10, 6)]


def test_tables_equal():
    assert np.array_equal(gf.gf_exp_table(), ref_gf.gf_exp_table())
    assert np.array_equal(gf.gf_log_table(), ref_gf.gf_log_table())


def test_mul_div_inv_exhaustive():
    a = np.repeat(np.arange(256, dtype=np.uint8), 256)
    b = np.tile(np.arange(256, dtype=np.uint8), 256)
    assert np.array_equal(gf.gf_mul(a, b), ref_gf.gf_mul(a, b))
    nz = b != 0
    assert np.array_equal(gf.gf_div(a[nz], b[nz]), ref_gf.gf_div(a[nz], b[nz]))
    x = np.arange(1, 256, dtype=np.uint8)
    assert np.array_equal(gf.gf_inv(x), ref_gf.gf_inv(x))


@pytest.mark.parametrize("n,k,s", [(3, 8, 64), (1, 4, 17), (6, 6, 33)])
def test_gf_matmul(n, k, s):
    rng = np.random.default_rng(n * 100 + k)
    A = rng.integers(0, 256, (n, k), dtype=np.uint8)
    B = rng.integers(0, 256, (k, s), dtype=np.uint8)
    assert np.array_equal(gf.gf_matmul(A, B), ref_gf.gf_matmul(A, B))


@pytest.mark.parametrize("n", [1, 3, 8, 12])
def test_gf_mat_inv(n):
    rng = np.random.default_rng(n)
    while True:
        M = rng.integers(0, 256, (n, n), dtype=np.uint8)
        try:
            want = ref_gf.gf_mat_inv(M)
            break
        except np.linalg.LinAlgError:
            continue
    got = gf.gf_mat_inv(M)
    assert np.array_equal(got, want)
    assert np.array_equal(gf.gf_matmul(M, got), np.eye(n, dtype=np.uint8))


def test_gf_mat_inv_singular_raises():
    M = np.array([[1, 2], [2, 4]], dtype=np.uint8)  # row 2 = 2 * row 1
    with pytest.raises(np.linalg.LinAlgError):
        gf.gf_mat_inv(M)


def test_bitmatrix_and_bit_packing():
    rng = np.random.default_rng(7)
    M = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    assert np.array_equal(gf.gf_matrix_to_bitmatrix(M),
                          ref_gf.gf_matrix_to_bitmatrix(M))
    for c in range(256):
        assert np.array_equal(gf.gf_const_to_bitmatrix(c),
                              ref_gf.gf_const_to_bitmatrix(c))
    a = rng.integers(0, 256, (4, 40), dtype=np.uint8)
    bits = gf.bytes_to_bits(a)
    assert np.array_equal(bits, ref_gf.bytes_to_bits(a))
    assert np.array_equal(gf.bits_to_bytes(bits), a)


@pytest.mark.parametrize("k,m", KM)
def test_isa_matrices(k, m):
    assert np.array_equal(mx.isa_cauchy_matrix(k, m), ref_mx.isa_cauchy_matrix(k, m))
    assert np.array_equal(mx.isa_rs_vandermonde_matrix(k, m),
                          ref_mx.isa_rs_vandermonde_matrix(k, m))


@pytest.mark.parametrize("k,m,erasures", [
    (8, 3, [0]), (8, 3, [2, 9]), (8, 3, [0, 5, 10]), (8, 3, [8, 9, 10]),
    (8, 3, [9, 0]), (4, 2, [1, 4]), (16, 4, [3, 7, 15, 18]),
])
def test_decode_matrix_for(k, m, erasures):
    C = mx.isa_cauchy_matrix(k, m)
    got = mx.decode_matrix_for(C, erasures)
    assert np.array_equal(got, ref_mx.decode_matrix_for(C, erasures))
    # and it reconstructs: D @ survivors == erased rows of [I; C] @ data
    rng = np.random.default_rng(k + m)
    data = rng.integers(0, 256, (k, 32), dtype=np.uint8)
    full = np.concatenate([data, gf.gf_matmul(C, data)])
    survivors = [i for i in range(k + m) if i not in set(erasures)][:k]
    assert np.array_equal(gf.gf_matmul(got, full[survivors]), full[erasures])


def test_decode_matrix_for_too_many_erasures():
    with pytest.raises(ValueError):
        mx.decode_matrix_for(mx.isa_cauchy_matrix(4, 2), [0, 1, 2])


def test_check_km():
    with pytest.raises(ValueError):
        mx.isa_cauchy_matrix(200, 57)
    with pytest.raises(ValueError):
        mx.isa_rs_vandermonde_matrix(0, 2)

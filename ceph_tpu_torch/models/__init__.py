"""Code-family models: generator-matrix constructions over GF(2^8).

Each construction follows a specific upstream library's published
algorithm so that coefficients (and therefore encoded bytes) match that
lineage (reference: src/erasure-code/jerasure/ErasureCodeJerasure.cc,
src/erasure-code/isa/ErasureCodeIsa.cc).
"""

from ceph_tpu_torch.models.matrices import (  # noqa: F401
    cauchy_good_matrix,
    cauchy_original_matrix,
    decode_matrix_for,
    isa_cauchy_matrix,
    isa_rs_vandermonde_matrix,
    jerasure_rs_vandermonde_matrix,
)

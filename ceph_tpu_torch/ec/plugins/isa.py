"""ISA-L-compatible plugin.

Counterpart of the JAX package's ``isa`` plugin (ceph_tpu/ec/plugins/
isa.py), itself the twin of the reference ISA plugin
(src/erasure-code/isa/ErasureCodeIsa.{h,cc}): technique
``reed_sol_van`` (Vandermonde, with the verified-MDS k/m clamps of
ErasureCodeIsa.cc:330-361) or ``cauchy`` (gf_gen_cauchy1_matrix);
32-byte chunk alignment (EC_ISA_ADDRESS_ALIGNMENT,
ErasureCodeIsa.cc:66-79); byte-stream GF(2^8) encode
(ec_encode_data semantics) and per-erasure-signature cached decode
matrices (ErasureCodeIsaTableCache) — the cache lives in
matrix_base.MatrixErasureCode.  Payloads of at least
``device_min_bytes`` run on the plugin's device (the card unless the
factory is given another).
"""

from __future__ import annotations

import errno

from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix, isa_rs_vandermonde_matrix

__erasure_code_version__ = "0.1.0"

#: EC_ISA_ADDRESS_ALIGNMENT (ErasureCodeIsa.h)
EC_ISA_ADDRESS_ALIGNMENT = 32


class ErasureCodeIsa(MatrixErasureCode):
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def __init__(self, matrixtype: str = "reed_sol_van", *, device=None) -> None:
        super().__init__(device=device)
        self.matrixtype = matrixtype

    def parse(self, profile: dict) -> None:
        """ErasureCodeIsa.cc:323-363 incl. the Vandermonde MDS clamps."""
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        if self.matrixtype == "reed_sol_van":
            if self.k > 32:
                raise ECError(
                    errno.EINVAL, f"Vandermonde: k={self.k} should be <= 32"
                )
            if self.m > 4:
                raise ECError(
                    errno.EINVAL,
                    f"Vandermonde: m={self.m} should be < 5 to guarantee MDS",
                )
            if self.m == 4 and self.k > 21:
                raise ECError(
                    errno.EINVAL,
                    f"Vandermonde: k={self.k} should be < 22 for MDS with m=4",
                )
            self.prepare(isa_rs_vandermonde_matrix(self.k, self.m))
        else:
            self.prepare(isa_cauchy_matrix(self.k, self.m))

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeIsa.cc:66-79: ceil(size/k) rounded up to 32."""
        alignment = self.get_alignment()
        chunk_size = -(-object_size // self.k)
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size


def _make(profile: dict, device) -> ErasureCodeIsa:
    technique = profile.setdefault("technique", "reed_sol_van")
    if technique not in ("reed_sol_van", "cauchy"):
        raise ECError(
            errno.ENOENT,
            f"technique={technique} is not a valid coding technique. "
            "Choose one of reed_sol_van, cauchy",
        )
    return ErasureCodeIsa(matrixtype=technique, device=device)


def __erasure_code_init__(name: str, registry) -> None:
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin

    class IsaPlugin(ErasureCodePlugin):
        def factory(self, profile: dict, *, device=None):
            ec = _make(profile, device)
            ec.init(profile)
            return ec

    registry.add(name, IsaPlugin())

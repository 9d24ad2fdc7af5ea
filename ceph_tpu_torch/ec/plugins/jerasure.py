"""jerasure-compatible plugin.

Counterpart of the JAX package's ``jerasure`` plugin (ceph_tpu/ec/
plugins/jerasure.py), with the same techniques, profile keys and chunk
bytes.  Behavioral twin of the reference jerasure plugin
(src/erasure-code/jerasure/ErasureCodeJerasure.{h,cc},
ErasureCodePluginJerasure.cc): techniques ``reed_sol_van``,
``reed_sol_r6_op``, ``cauchy_orig``, ``cauchy_good`` with the same
profile keys (k/m/w/packetsize/jerasure-per-chunk-alignment), default
parameters, chunk-size/alignment math (ErasureCodeJerasure.cc:80-103,
174-186, 278-292) and chunk byte layout:

- reed_sol techniques: GF(2^8) byte-stream matmul
  (jerasure_matrix_encode);
- cauchy techniques: packet-row XOR schedules
  (jerasure_schedule_encode with w x w bit-matrix blocks and
  ``packetsize`` rows) — see matrix_base for why that is the same
  device kernel (``gf_bitmatmul.cu``) with a different row reshaping.

The GF(2^w) minimal-density bit-matrix techniques (liberation,
blaum_roth, liber8tion) build their (2w, kw) 0/1 matrices in
ceph_tpu_torch.models.bitmatrices and ride the same packet-row bit-matmul
machinery as the cauchy family (matrix_base rows_per_chunk=w).

Payloads of at least ``device_min_bytes`` run on the plugin's device
(the card unless the factory is given another).
"""

from __future__ import annotations

import errno

import numpy as np

from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode
from ceph_tpu_torch.models.matrices import (
    cauchy_good_matrix,
    cauchy_original_matrix,
    jerasure_rs_r6_matrix,
    jerasure_rs_vandermonde_matrix,
)
from ceph_tpu_torch.ops.gf256 import gf_matrix_to_bitmatrix

__erasure_code_version__ = "0.1.0"

#: reference LARGEST_VECTOR_WORDSIZE (ErasureCodeJerasure.cc)
LARGEST_VECTOR_WORDSIZE = 16

DEFAULT_PACKETSIZE = "2048"


class ErasureCodeJerasure(MatrixErasureCode):
    """Common profile parsing (ErasureCodeJerasure.cc:62-78)."""

    DEFAULT_K = "2"
    DEFAULT_M = "1"
    DEFAULT_W = "8"
    technique = "?"

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.w = self.to_int("w", profile, self.DEFAULT_W)
        if self.chunk_mapping and len(self.chunk_mapping) != self.k + self.m:
            self.chunk_mapping = []
            raise ECError(
                errno.EINVAL,
                f"mapping {profile.get('mapping')!r} maps "
                f"{len(profile.get('mapping', ''))} chunks instead of "
                f"the expected {self.k + self.m}",
            )
        self.sanity_check_k_m(self.k, self.m)
        self._parse_technique(profile)
        self._prepare()

    def _parse_technique(self, profile: dict) -> None:
        pass

    def _prepare(self) -> None:
        raise NotImplementedError

    def get_alignment(self) -> int:
        raise NotImplementedError

    def get_chunk_size(self, object_size: int) -> int:
        """ErasureCodeJerasure.cc:80-103."""
        alignment = self.get_alignment()
        if self.per_chunk_alignment:
            chunk_size = -(-object_size // self.k)
            # the reference aborts here (ceph_assert(alignment <=
            # chunk_size), ErasureCodeJerasure.cc:89) — never clamps
            assert alignment <= chunk_size, (alignment, chunk_size)
            modulo = chunk_size % alignment
            if modulo:
                chunk_size += alignment - modulo
            return chunk_size
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k


class ReedSolomonVandermonde(ErasureCodeJerasure):
    """technique=reed_sol_van (ErasureCodeJerasure.cc:158-201)."""

    DEFAULT_K = "7"
    DEFAULT_M = "3"
    technique = "reed_sol_van"

    def _parse_technique(self, profile: dict) -> None:
        if self.w not in (8, 16, 32):
            raise ECError(
                errno.EINVAL, f"reed_sol_van: w={self.w} must be one of {{8, 16, 32}}"
            )
        if self.w != 8:
            raise ECError(
                errno.EINVAL,
                f"reed_sol_van: w={self.w} needs GF(2^{self.w}) tables not yet "
                "built here; use w=8 (the reference default)",
            )
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def _prepare(self) -> None:
        self.prepare(jerasure_rs_vandermonde_matrix(self.k, self.m))

    def get_alignment(self) -> int:
        """ErasureCodeJerasure.cc:174-186."""
        if self.per_chunk_alignment:
            return self.w * LARGEST_VECTOR_WORDSIZE
        alignment = self.k * self.w * 4  # sizeof(int)
        if (self.w * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * LARGEST_VECTOR_WORDSIZE
        return alignment


class ReedSolomonRAID6(ReedSolomonVandermonde):
    """technique=reed_sol_r6_op (ErasureCodeJerasure.cc:203-257)."""

    DEFAULT_K = "7"
    DEFAULT_M = "2"
    technique = "reed_sol_r6_op"

    def _parse_technique(self, profile: dict) -> None:
        if self.m != 2:
            raise ECError(errno.EINVAL, f"reed_sol_r6_op: m={self.m} must be 2 for RAID6")
        super()._parse_technique(profile)

    def _prepare(self) -> None:
        self.prepare(jerasure_rs_r6_matrix(self.k))


class CauchyBase(ErasureCodeJerasure):
    """Packet-layout bitmatrix cauchy (ErasureCodeJerasure.cc:259-305)."""

    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def _parse_technique(self, profile: dict) -> None:
        if self.w != 8:
            raise ECError(
                errno.EINVAL,
                f"{self.technique}: w={self.w} unsupported here; the reference "
                "default (and the only value the byte-level corpus pins) is 8",
            )
        self.packetsize = self.to_int("packetsize", profile, DEFAULT_PACKETSIZE)
        if self.packetsize % 4:
            raise ECError(errno.EINVAL, "packetsize must be a multiple of 4")
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    def _cauchy_matrix(self) -> np.ndarray:
        raise NotImplementedError

    def _prepare(self) -> None:
        # jerasure_matrix_to_bitmatrix: (m*w, k*w) 0/1 expansion; the
        # schedule's packet XORs == GF(2^8) matmul by the 0/1 matrix.
        bits = gf_matrix_to_bitmatrix(self._cauchy_matrix())
        self.prepare(bits, rows_per_chunk=self.w)

    def get_alignment(self) -> int:
        """ErasureCodeJerasure.cc:278-292."""
        if self.per_chunk_alignment:
            alignment = self.w * self.packetsize
            modulo = alignment % LARGEST_VECTOR_WORDSIZE
            if modulo:
                alignment += LARGEST_VECTOR_WORDSIZE - modulo
            return alignment
        alignment = self.k * self.w * self.packetsize * 4
        if (self.w * self.packetsize * 4) % LARGEST_VECTOR_WORDSIZE:
            alignment = self.k * self.w * self.packetsize * LARGEST_VECTOR_WORDSIZE
        return alignment


class CauchyOrig(CauchyBase):
    technique = "cauchy_orig"

    def _cauchy_matrix(self) -> np.ndarray:
        return cauchy_original_matrix(self.k, self.m)


class CauchyGood(CauchyBase):
    technique = "cauchy_good"

    def _cauchy_matrix(self) -> np.ndarray:
        return cauchy_good_matrix(self.k, self.m)


class Liberation(CauchyBase):
    """technique=liberation (ErasureCodeJerasure.h:192-227): GF(2^w)
    minimal-density bitmatrix RAID-6; w prime, k <= w, m == 2."""

    DEFAULT_K = "2"
    DEFAULT_M = "2"
    DEFAULT_W = "7"
    technique = "liberation"

    def _parse_technique(self, profile: dict) -> None:
        # liberation family: any valid w (checked in _bitmatrix), not
        # just 8 — skip CauchyBase's w==8 pin but keep its packetsize
        # handling
        if self.m != 2:
            raise ECError(
                errno.EINVAL, f"{self.technique}: m={self.m} must be 2")
        if self.k > self.w:
            raise ECError(
                errno.EINVAL,
                f"{self.technique}: k={self.k} must be <= w={self.w}")
        self.packetsize = self.to_int("packetsize", profile, DEFAULT_PACKETSIZE)
        if self.packetsize % 4:
            raise ECError(errno.EINVAL, "packetsize must be a multiple of 4")
        self.per_chunk_alignment = self.to_bool(
            "jerasure-per-chunk-alignment", profile, "false"
        )

    _builder_name = "liberation_bitmatrix"

    def _bitmatrix(self):
        from ceph_tpu_torch.models import bitmatrices

        build = getattr(bitmatrices, self._builder_name)
        args = (self.k,) if self._builder_name == "liber8tion_bitmatrix" \
            else (self.k, self.w)
        try:
            return build(*args)
        except ValueError as e:
            raise ECError(errno.EINVAL, str(e)) from e

    def _prepare(self) -> None:
        self.prepare(self._bitmatrix(), rows_per_chunk=self.w)


class BlaumRoth(Liberation):
    """technique=blaum_roth (ErasureCodeJerasure.h:229-238): w+1 prime."""

    technique = "blaum_roth"
    _builder_name = "blaum_roth_bitmatrix"

    def _parse_technique(self, profile: dict) -> None:
        super()._parse_technique(profile)
        if self.w == 7:
            # firefly back-compat w (w+1 = 8 not prime): the matrix is
            # NOT MDS, so any-k consumers (fast_read) must not assume it
            self.mds_any_k = False


class Liber8tion(Liberation):
    """technique=liber8tion (ErasureCodeJerasure.h:240-253): w == 8."""

    DEFAULT_W = "8"
    technique = "liber8tion"

    _builder_name = "liber8tion_bitmatrix"

    def _parse_technique(self, profile: dict) -> None:
        if self.w != 8:
            raise ECError(
                errno.EINVAL, f"liber8tion: w={self.w} must be 8")
        super()._parse_technique(profile)


TECHNIQUES = {
    "reed_sol_van": ReedSolomonVandermonde,
    "reed_sol_r6_op": ReedSolomonRAID6,
    "cauchy_orig": CauchyOrig,
    "cauchy_good": CauchyGood,
    "liberation": Liberation,
    "blaum_roth": BlaumRoth,
    "liber8tion": Liber8tion,
}


def _make(profile: dict, device):
    technique = profile.get("technique", "reed_sol_van")
    cls = TECHNIQUES.get(technique)
    if cls is None:
        raise ECError(
            errno.ENOENT,
            f"technique={technique} is not a valid coding technique. Choose one of "
            "reed_sol_van, reed_sol_r6_op, cauchy_orig, cauchy_good, "
            "liberation, blaum_roth, liber8tion",
        )
    profile.setdefault("technique", technique)
    return cls(device=device)


def __erasure_code_init__(name: str, registry) -> None:
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin

    class JerasurePlugin(ErasureCodePlugin):
        def factory(self, profile: dict, *, device=None):
            ec = _make(profile, device)
            ec.init(profile)
            return ec

    registry.add(name, JerasurePlugin())

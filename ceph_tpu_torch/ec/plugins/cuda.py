"""The GPU plugin — registered as ``cuda``.

Counterpart of the JAX package's ``jax`` plugin (ceph_tpu/ec/plugins/
jax.py), with the same profile keys and chunk geometry, so a profile
that named ``plugin=jax`` names ``plugin=cuda`` here and yields the same
chunk bytes and layouts:

- ISA-L Cauchy generator by default (MDS for every k+m <= 256), or
  ISA-L's Vandermonde with ``technique=reed_sol_van``;
- chunk sizes aligned to 512 B (``get_chunk_size``);
- payloads of at least ``device-min-bytes`` go through the CUDA kernels
  of ``ceph_tpu_torch.ops.rs_kernels`` on the plugin's device, smaller
  ones through the host numpy path.

``factory(profile, device=...)`` takes a torch device; the default is
the card, and constructing the plugin without CUDA raises.
"""

from __future__ import annotations

import errno

from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode
from ceph_tpu_torch.models.matrices import isa_cauchy_matrix, isa_rs_vandermonde_matrix

__erasure_code_version__ = "0.1.0"

#: chunk alignment, kept from the JAX plugin so chunk sizes and layouts
#: are identical across the two packages
LANE_ALIGN = 512


class ErasureCodeCuda(MatrixErasureCode):
    DEFAULT_K = "8"
    DEFAULT_M = "3"

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.sanity_check_k_m(self.k, self.m)
        if self.k + self.m > 256:
            raise ECError(errno.EINVAL, f"k+m={self.k + self.m} must be <= 256")
        technique = profile.setdefault("technique", "cauchy")
        if technique == "cauchy":
            self.prepare(isa_cauchy_matrix(self.k, self.m))
        elif technique == "reed_sol_van":
            self.prepare(isa_rs_vandermonde_matrix(self.k, self.m))
        else:
            raise ECError(
                errno.ENOENT,
                f"technique={technique} is not a valid coding technique. "
                "Choose one of cauchy, reed_sol_van",
            )
        self.device_min_bytes = self.to_int(
            "device-min-bytes", profile, str(self.device_min_bytes)
        )

    def get_alignment(self) -> int:
        return LANE_ALIGN

    def get_chunk_size(self, object_size: int) -> int:
        chunk_size = -(-object_size // self.k)
        modulo = chunk_size % LANE_ALIGN
        if modulo:
            chunk_size += LANE_ALIGN - modulo
        return chunk_size


def __erasure_code_init__(name: str, registry) -> None:
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin

    class CudaPlugin(ErasureCodePlugin):
        def factory(self, profile: dict, *, device=None):
            ec = ErasureCodeCuda(device=device)
            ec.init(profile)
            return ec

    registry.add(name, CudaPlugin())

"""Erasure-code plugin framework (the port's twin of src/erasure-code/).

Public surface mirrors the reference contract
(`ErasureCodeInterface.h:170-462`, `ErasureCodePlugin.cc:86-196`) with a
Pythonic error model (exceptions carrying errno) and a batched
stripe-tensor hot path that runs on the GPU.
"""

from ceph_tpu_torch.ec.interface import (  # noqa: F401
    ECError,
    ErasureCode,
    ErasureCodeInterface,
    SIMD_ALIGN,
)
from ceph_tpu_torch.ec.registry import (  # noqa: F401
    ErasureCodePlugin,
    ErasureCodePluginRegistry,
    instance as registry,
)

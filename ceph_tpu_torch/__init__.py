"""ceph_tpu_torch — the erasure-code data plane on PyTorch and CUDA.

The PyTorch/CUDA port of ``ceph_tpu``'s RS(k, m) write / recover /
degraded-read / deep-scrub path, for one NVIDIA Hopper card (sm_90a).
Module paths and names follow the JAX package so each module's
counterpart is easy to find:

- ``ops``      — GF(2^8) host math (numpy), the GF(2) bit-matrix
                 kernels and the batched crc32c: hand-written CUDA
                 (``ops/csrc/``) on the card, a plain PyTorch version of
                 the same function on the CPU.
- ``models``   — generator-matrix constructions over GF(2^8).
- ``ec``       — erasure-code interface, plugin registry and the
                 ``cuda`` plugin.
- ``osd``      — ECUtil: stripe math, batched encode/decode, HashInfo.
- ``parallel`` — the batched recovery-decode aggregator and deep-scrub
                 verifier.
- ``common``   — perf counters and launch spans.
- ``native``   — host crc32c built with g++.

Entry points run on the card (``torch.device("cuda")``) unless the
caller passes ``device="cpu"``; with no CUDA device they raise.
"""

__version__ = "0.1.0"

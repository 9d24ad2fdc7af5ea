"""ceph_tpu_torch — the erasure-code data plane and CRUSH placement on
PyTorch and CUDA.

The PyTorch/CUDA port of ``ceph_tpu``'s RS(k, m) write / recover /
degraded-read / deep-scrub path, its whole-cluster PG remap and the
host layers under the daemons (config, metrics, tracing, the kv and the
object stores), for one NVIDIA Hopper card (sm_90a).
Module paths and names follow the JAX package so each module's
counterpart is easy to find:

- ``ops``      — GF(2^8) host math (numpy), the GF(2) bit-matrix
                 kernels, the batched crc32c and the batched CRUSH rule:
                 hand-written CUDA (``ops/csrc/``) on the card, a plain
                 PyTorch version of the same function on the CPU; the
                 CRUSH hashes.
- ``crush``    — the CRUSH map model, builder, scalar interpreter and
                 batched mapper, and ``crushtool --test``.
- ``models``   — generator-matrix constructions over GF(2^8).
- ``ec``       — erasure-code interface, plugin registry and the
                 ``cuda`` plugin.
- ``osd``      — ECUtil: stripe math, batched encode/decode, HashInfo;
                 pools, the OSDMap pipeline, the whole-cluster remap and
                 the upmap balancer.
- ``parallel`` — the batched recovery-decode aggregator and deep-scrub
                 verifier.
- ``common``   — the host foundation: typed config, perf counters and
                 their prometheus exposition, span tracing, the fault
                 injector, op tracking, reservers, admin sockets.
- ``kv``       — the ordered key-value store (MemDB, FileDB).
- ``store``    — the object stores: MemStore, KStore, FileStore and
                 BlockStore (checksums at rest) with BlueFS; on-disk
                 bytes are the JAX package's.
- ``msg``      — denc, the versioned wire encoding.
- ``compressor`` — the compressor registry.
- ``native``   — host crc32c, the region XOR and the scalar straw2
                 choose, built with g++.

Entry points run on the card (``torch.device("cuda")``) unless the
caller passes ``device="cpu"``; with no CUDA device they raise.
"""

__version__ = "0.1.0"

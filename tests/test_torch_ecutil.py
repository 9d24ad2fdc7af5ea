"""ceph_tpu_torch.osd.ecutil and native crc32c against ceph_tpu.

Same numpy inputs through the JAX package's ``ecutil`` with the ``jax``
plugin and the port's with the ``cuda`` plugin on the CPU; every shard,
read-back byte, crc and serialised HashInfo must be equal (tolerance 0).
"""

import numpy as np
import pytest

from ceph_tpu import native as ref_native
from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.osd import ecutil as ref_ecutil
from ceph_tpu_torch import native
from ceph_tpu_torch.ec import ECError, registry
from ceph_tpu_torch.osd import ecutil
from tests.xla_private import _private_xla_compiles  # noqa: F401

# (seed, payload, expected) from reference test_crc32c.cc:21-43, as
# tests/test_ecutil.py pins them
REFERENCE_CRC_VECTORS = [
    (0, b"foo bar baz", 4119623852),
    (1234, b"foo bar baz", 881700046),
    (0, b"whiz bang boom", 2360230088),
    (5678, b"whiz bang boom", 3743019208),
    (0, b"\x01" * 5, 2715569182),
    (0, b"\x01" * 35, 440531800),
    (0, b"\x01" * 4096000, 31583199),
    (1234, b"\x01" * 4096000, 1400919119),
]

PROFILES = [
    {"k": "4", "m": "2", "technique": "reed_sol_van", "device-min-bytes": "0"},
    {"k": "8", "m": "3", "technique": "cauchy", "device-min-bytes": "0"},
    {"k": "8", "m": "3", "technique": "cauchy"},
]


@pytest.mark.parametrize("seed,payload,want", REFERENCE_CRC_VECTORS)
def test_crc32c_reference_vectors(seed, payload, want):
    assert native.available()
    assert native.crc32c(payload, seed) == want
    assert ref_native.crc32c(payload, seed) == want


def test_crc32c_python_table_matches():
    rng = np.random.default_rng(1)
    for n in (0, 1, 7, 8, 9, 63, 1024):
        buf = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for seed in (0, 1234, 0xFFFFFFFF):
            want = ref_native.crc32c(buf, seed)
            assert native.crc32c(buf, seed) == want
            assert native._py_crc32c(buf, seed) == want


def test_crc32c_chaining_splits():
    buf = np.random.default_rng(2).integers(0, 256, 1000, dtype=np.uint8).tobytes()
    whole = native.crc32c(buf)
    for cut in (0, 1, 8, 500, 999, 1000):
        assert native.crc32c(buf[cut:], native.crc32c(buf[:cut])) == whole


def test_stripe_info_and_bucket_lanes_match():
    a, b = ecutil.StripeInfo(4, 4096), ref_ecutil.StripeInfo(4, 4096)
    for off in (0, 1, 4095, 8192, 10000):
        for fn in ("logical_to_prev_chunk_offset", "logical_to_next_chunk_offset",
                   "logical_to_prev_stripe_offset", "logical_to_next_stripe_offset"):
            assert getattr(a, fn)(off) == getattr(b, fn)(off)
    assert a.offset_len_to_stripe_bounds(5000, 2000) == b.offset_len_to_stripe_bounds(5000, 2000)
    for n in (0, 1, 4096, 5000, 65536, 65537, 300000):
        assert ecutil.bucket_lanes(n, min_bucket=4096, tile_cap=65536) == \
            ref_ecutil.bucket_lanes(n, min_bucket=4096, tile_cap=65536)


def _pair(profile):
    return (ref_registry.factory("jax", dict(profile)),
            registry.factory("cuda", dict(profile), device="cpu"))


def _sinfo(mod, ec):
    k = ec.get_data_chunk_count()
    return mod.StripeInfo(k, k * ec.get_chunk_size(4096 * k))


@pytest.mark.parametrize("profile", PROFILES)
def test_encode_decode_concat_decode_shards(profile):
    ref, port = _pair(profile)
    rsi, psi = _sinfo(ref_ecutil, ref), _sinfo(ecutil, port)
    assert psi.stripe_width == rsi.stripe_width
    n, k = port.get_chunk_count(), port.get_data_chunk_count()
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 3 * psi.stripe_width, dtype=np.uint8)
    want = ref_ecutil.encode(rsi, ref, data)
    got = ecutil.encode(psi, port, data)
    assert set(got) == set(want) == set(range(n))
    for s in range(n):
        assert np.array_equal(got[s], want[s]), s
    assert np.array_equal(ecutil.decode_concat(psi, port, got), data)
    for lost in [{2}, {2, n - 2}, set(range(n - k))]:
        avail = {s: c for s, c in got.items() if s not in lost}
        read = ecutil.decode_concat(psi, port, avail)
        assert np.array_equal(read, ref_ecutil.decode_concat(rsi, ref, avail))
        assert np.array_equal(read, data)
        rebuilt = ecutil.decode_shards(psi, port, avail, lost)
        ref_rebuilt = ref_ecutil.decode_shards(rsi, ref, avail, lost)
        assert set(rebuilt) == set(ref_rebuilt) == lost
        for s in lost:
            assert np.array_equal(rebuilt[s], ref_rebuilt[s])
            assert np.array_equal(rebuilt[s], want[s])


def test_encode_rejects_unaligned_and_empty():
    _, port = _pair(PROFILES[0])
    si = _sinfo(ecutil, port)
    with pytest.raises(ECError):
        ecutil.encode(si, port, np.zeros(si.stripe_width + 1, np.uint8))
    assert ecutil.encode(si, port, b"") == {}
    assert ecutil.decode_concat(si, port, {0: np.zeros(0, np.uint8)}).size == 0


def test_hashinfo_chain_and_serialise_equal():
    ref, port = _pair(PROFILES[1])
    rsi, psi = _sinfo(ref_ecutil, ref), _sinfo(ecutil, port)
    rng = np.random.default_rng(7)
    a = rng.integers(0, 256, psi.stripe_width, dtype=np.uint8)
    b = rng.integers(0, 256, 2 * psi.stripe_width, dtype=np.uint8)
    hi, rhi = ecutil.HashInfo(11), ref_ecutil.HashInfo(11)
    hi.append(0, ecutil.encode(psi, port, a))
    rhi.append(0, ref_ecutil.encode(rsi, ref, a))
    hi.append(psi.chunk_size, ecutil.encode(psi, port, b))
    rhi.append(rsi.chunk_size, ref_ecutil.encode(rsi, ref, b))
    assert hi.cumulative_shard_hashes == rhi.cumulative_shard_hashes
    assert hi.to_bytes() == rhi.to_bytes()
    full = ecutil.encode(psi, port, np.concatenate([a, b]))
    for s in range(11):
        assert hi.get_chunk_hash(s) == native.crc32c(full[s])
    rt = ecutil.HashInfo.from_bytes(rhi.to_bytes())
    assert rt.cumulative_shard_hashes == hi.cumulative_shard_hashes
    assert rt.get_total_chunk_size() == 3 * psi.chunk_size
    with pytest.raises(AssertionError):
        hi.append(4, full)
    hi.clear()
    assert hi.cumulative_shard_hashes == [0xFFFFFFFF] * 11
    hi.set_projected_total_logical_size(psi, 5000)
    rhi.set_projected_total_logical_size(rsi, 5000)
    assert hi.get_projected_total_chunk_size() == rhi.get_projected_total_chunk_size()

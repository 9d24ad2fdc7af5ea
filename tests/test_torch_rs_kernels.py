"""ceph_tpu_torch.ops.rs_kernels against ceph_tpu.ops.rs_kernels (CPU).

The port's kernel entry points, on CPU tensors, run their plain PyTorch
version; here each is held against the JAX package's Pallas kernel run
in interpret mode (as tests/test_rs_kernels.py runs it) or its XLA path,
on the same numpy inputs.  Every comparison is byte-exact (tolerance 0:
GF arithmetic has no rounding).  The CUDA kernels themselves are held
against the same plain versions on the card by chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from ceph_tpu.models import matrices as ref_mx
from ceph_tpu.ops import gf256 as ref_gf
from ceph_tpu.ops import rs_kernels as ref_rk
from ceph_tpu_torch.models import matrices as mx
from ceph_tpu_torch.ops import rs_kernels as rk

CODES = [(8, 3), (4, 2), (16, 4)]


def _t(a: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a))


def _codecs(k, m):
    C = ref_mx.isa_cauchy_matrix(k, m)
    return ref_rk.BitmatrixCodec(C), rk.codec_from_reference(C, device="cpu")


@pytest.fixture
def rng():
    return np.random.default_rng(42)


def test_unpack_pack_match_reference(rng):
    data = rng.integers(0, 256, (2, 3, 256), dtype=np.uint8)
    bits = rk.unpack_bits(_t(data))
    assert np.array_equal(bits.numpy(), np.asarray(ref_rk.unpack_bits(jnp.asarray(data))))
    assert np.array_equal(rk.pack_bits(bits).numpy(), data)


def test_codec_from_reference_state_equal():
    ref, port = _codecs(8, 3)
    assert np.array_equal(port.encode_bits.numpy(), np.asarray(ref.encode_bits))
    for erasures in [(0,), (2, 9), (10, 0, 5), (8, 9, 10)]:
        rs, rb = ref.decode_bits(erasures)
        ps, pb = port.decode_bits(erasures)
        assert ps == rs
        assert np.array_equal(pb.numpy(), np.asarray(rb))


@pytest.mark.parametrize("k,m", CODES)
def test_pallas_plain_vs_interpret(rng, k, m):
    ref, port = _codecs(k, m)
    D = rng.integers(0, 256, (k, 1024), dtype=np.uint8)
    want = np.asarray(ref_rk.gf_bitmatmul_pallas(
        ref.encode_bits, jnp.asarray(D), tile_s=512, interpret=True))
    got = rk.gf_bitmatmul_pallas(port.encode_bits, _t(D), tile_s=512)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, ref_gf.gf_matmul(ref.C, D))


@pytest.mark.parametrize("k,m", CODES)
@pytest.mark.parametrize("g", [1, 2, 4])
def test_grouped_plain_vs_interpret(rng, k, m, g):
    """Encode and a 2-erasure decode through the grouped entry point."""
    ref, port = _codecs(k, m)
    D = rng.integers(0, 256, (k, 4096), dtype=np.uint8)
    want = np.asarray(ref_rk.gf_bitmatmul_pallas_grouped(
        ref.encode_bits, jnp.asarray(D), tile_s=512, groups=g, interpret=True))
    got = rk.gf_bitmatmul_pallas_grouped(port.encode_bits, _t(D), tile_s=512, groups=g)
    assert np.array_equal(got.numpy(), want)
    chunks = np.concatenate([D, want])
    survivors, dbits = ref.decode_bits((0, k))
    want_rec = np.asarray(ref_rk.gf_bitmatmul_pallas_grouped(
        dbits, jnp.asarray(chunks[survivors]), tile_s=512, groups=g, interpret=True))
    psurv, pbits = port.decode_bits((0, k))
    got_rec = rk.gf_bitmatmul_pallas_grouped(
        pbits, _t(chunks[psurv]), tile_s=512, groups=g)
    assert np.array_equal(got_rec.numpy(), want_rec)
    assert np.array_equal(want_rec, chunks[[0, k]])


def test_grouped_asserts_divisibility(rng):
    _, port = _codecs(8, 3)
    D = _t(rng.integers(0, 256, (8, 1536), dtype=np.uint8))
    with pytest.raises(AssertionError):
        rk.gf_bitmatmul_pallas_grouped(port.encode_bits, D, tile_s=512, groups=2)


@pytest.mark.parametrize("seed", [0, 5, 255, 261])
def test_acc_plain_vs_interpret(rng, seed):
    """The uint8 cut of the int32 seed: 261 acts as 5."""
    ref, port = _codecs(8, 3)
    D = rng.integers(0, 256, (8, 1024), dtype=np.uint8)
    carry = rng.integers(0, 256, (3, 1024), dtype=np.uint8)
    want = np.asarray(ref_rk.gf_bitmatmul_pallas_acc(
        ref.encode_bits, jnp.asarray(D), jnp.asarray(carry),
        jnp.array([seed], jnp.int32), tile_s=512, interpret=True))
    c = _t(carry.copy())
    got = rk.gf_bitmatmul_pallas_acc(port.encode_bits, _t(D), c,
                                     torch.tensor([seed], dtype=torch.int32),
                                     tile_s=512)
    assert got is c  # in place: the port's form of the JAX carry aliasing
    assert np.array_equal(got.numpy(), want)


def test_acc_two_step_fold(rng):
    """Two acc steps fold to r0 ^ r1, as the JAX fori_loop harness does."""
    ref, port = _codecs(8, 3)
    D = rng.integers(0, 256, (8, 512), dtype=np.uint8)

    def body(i, c):
        return ref_rk.gf_bitmatmul_pallas_acc(
            ref.encode_bits, jnp.asarray(D), c, jnp.array([i], jnp.int32),
            tile_s=512, interpret=True)

    want = np.asarray(lax.fori_loop(0, 2, body, jnp.zeros((3, 512), jnp.uint8)))
    c = torch.zeros((3, 512), dtype=torch.uint8)
    for i in range(2):
        rk.gf_bitmatmul_pallas_acc(port.encode_bits, _t(D), c, i, tile_s=512)
    assert np.array_equal(c.numpy(), want)
    r0 = ref_gf.gf_matmul(ref.C, D)
    r1 = ref_gf.gf_matmul(ref.C, D ^ np.uint8(1))
    assert np.array_equal(want, r0 ^ r1)


@pytest.mark.parametrize("k,m", CODES)
def test_gf_bitmatmul_batched_vs_xla(rng, k, m):
    ref, port = _codecs(k, m)
    D = rng.integers(0, 256, (3, k, 300), dtype=np.uint8)
    want = np.asarray(ref_rk.gf_bitmatmul(ref.encode_bits, jnp.asarray(D)))
    got = rk.gf_bitmatmul(port.encode_bits, _t(D))
    assert got.shape == (3, m, 300)
    assert np.array_equal(got.numpy(), want)


def test_codec_encode_decode_batch(rng):
    ref, port = _codecs(8, 3)
    D = rng.integers(0, 256, (5, 8, 256), dtype=np.uint8)
    want = np.asarray(ref.encode(jnp.asarray(D)))
    got = port.encode(_t(D))
    assert np.array_equal(got.numpy(), want)
    full = np.concatenate([D, want], axis=1)
    survivors, _ = port.decode_bits((1, 9))
    want_b = np.asarray(ref.decode_batch(jnp.asarray(full[:, survivors]), (1, 9)))
    got_b = port.decode_batch(_t(full[:, survivors]), (9, 1))
    assert np.array_equal(got_b.numpy(), want_b)
    assert np.array_equal(want_b, full[:, [1, 9]])


@pytest.mark.parametrize("erasures", [(0,), (9, 0), (10, 2, 5), (8, 9, 10)])
@pytest.mark.parametrize("pallas", [None, True])
def test_codec_decode_requested_order(rng, erasures, pallas):
    """Rows come back in the order requested, not sorted."""
    ref, port = _codecs(8, 3)
    D = rng.integers(0, 256, (8, 1024), dtype=np.uint8)
    full = np.concatenate([D, ref_gf.gf_matmul(ref.C, D)])
    want = np.asarray(ref.decode(jnp.asarray(full), erasures))
    got = port.decode(_t(full), erasures, pallas=pallas)
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, full[list(erasures)])


def test_decode_cache_reused():
    _, port = _codecs(4, 2)
    assert port.decode_bits((1, 4))[1] is port.decode_bits((4, 1))[1]


@pytest.mark.parametrize("s", [512, 1536, 4096, 2**20, 3 * 2**14, 2**20 + 7, 100])
def test_pick_tile_matches_reference(s):
    assert rk._pick_tile(s) == ref_rk._pick_tile(s)


@pytest.mark.parametrize("k,m,s,t", [
    (8, 3, 2**20, 2**14), (4, 2, 2**20, 2**14), (16, 4, 2**20, 2**14),
    (8, 3, 3 * 2**14, 2**14), (8, 1, 2**19, 2**18), (2, 1, 2**20, 2**12),
])
def test_pick_groups_matches_reference(k, m, s, t):
    assert rk._pick_groups(k, m, s, t) == ref_rk._pick_groups(k, m, s, t)


def test_wrappers_reject_bad_operands():
    bits = torch.zeros((24, 64), dtype=torch.uint8)
    with pytest.raises(TypeError):
        rk.gf_bitmatmul(bits, torch.zeros((8, 16), dtype=torch.int32))
    with pytest.raises(ValueError):
        rk.gf_bitmatmul(bits, torch.zeros((7, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rk.gf_bitmatmul(torch.zeros((20, 64), dtype=torch.uint8),
                        torch.zeros((8, 16), dtype=torch.uint8))
    with pytest.raises(ValueError):
        rk.gf_bitmatmul_pallas(bits, torch.zeros((2, 8, 512), dtype=torch.uint8),
                               tile_s=512)
    with pytest.raises(ValueError):
        rk.gf_bitmatmul_pallas_acc(bits, torch.zeros((8, 512), dtype=torch.uint8),
                                   torch.zeros((2, 512), dtype=torch.uint8), 0,
                                   tile_s=512)


def test_kernel_build_failure_raises(monkeypatch, tmp_path):
    """A kernel that cannot be built raises; nothing falls back."""
    from ceph_tpu_torch.ops import _build

    def no_nvcc():
        raise RuntimeError("nvcc not found")

    monkeypatch.setattr(_build, "nvcc", no_nvcc)
    monkeypatch.setattr(_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(rk, "_fn", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        rk._kernel()
    assert _build.sources() == ["gf_bitmatmul"]


def test_launch_refuses_cpu_tensors():
    z = torch.zeros((8, 512), dtype=torch.uint8)
    with pytest.raises(ValueError, match="CUDA"):
        rk._launch(torch.zeros((24, 64), dtype=torch.uint8), z,
                   torch.zeros((3, 512), dtype=torch.uint8))


def test_no_launch_counted_on_cpu(rng):
    """Launch counters count kernel launches only; CPU tensors take the
    plain version."""
    rk.reset_launch_counts()
    _, port = _codecs(8, 3)
    port.encode(_t(rng.integers(0, 256, (8, 1024), dtype=np.uint8)), pallas=True)
    assert rk.launch_counts() == {fn.__name__: 0 for fn in rk.KERNEL_ENTRY_POINTS}

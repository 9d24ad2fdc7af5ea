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
from tests.xla_private import _private_xla_compiles  # noqa: F401

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
    assert _build.sources() == ["clay_repair", "crc32c_lanes", "crush_rule", "farm_fold",
                                "gf_bitmatmul", "lab_copy", "mgr_analytics"]


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


# ---------------------------------------------------------------------------
# The CUDA kernel's host-side pieces: masks, word arithmetic, launch plan
# ---------------------------------------------------------------------------

MASK_CODES = [(8, 3), (4, 2), (6, 1), (10, 4), (16, 4), (128, 128)]


def _bitmat(k, m):
    return np.asarray(ref_rk.BitmatrixCodec(ref_mx.isa_cauchy_matrix(k, m)).encode_bits)


@pytest.mark.parametrize("k,m", MASK_CODES)
def test_replicated_masks_match_bitmatrix(k, m):
    """Word (r, i) is bits(bitmat[r, 8i:8i+8]) * 0x01010101; the kernel's
    blocked layouts hold the same bytes, replicated or packed four to a
    word, with zero masks padding k to a multiple of 8."""
    bm = _bitmat(k, m)
    words = rk.replicated_masks(bm)
    assert words.shape == (8 * m, k) and words.dtype == np.uint32
    byte = (bm.reshape(8 * m, k, 8).astype(np.uint32) << np.arange(8, dtype=np.uint32)).sum(-1)
    assert np.array_equal(words, byte * 0x01010101)
    for r, i in [(0, 0), (8 * m - 1, k - 1), (5 % (8 * m), k // 2)]:
        want = sum(int(bm[r, 8 * i + b]) << b for b in range(8))
        assert int(words[r, i]) == want * 0x01010101
    nch = -(-k // 8)
    padded = np.zeros((8 * m, 8 * nch), dtype=np.uint32)
    padded[:, :k] = byte
    want_blocked = padded.reshape(m, 8, nch, 8).transpose(0, 2, 1, 3)
    rep = rk.kernel_masks(bm, packed=False).reshape(m, nch, 8, 8)
    assert np.array_equal(rep, want_blocked * np.uint32(0x01010101))
    packed = rk.kernel_masks(bm, packed=True).reshape(m, nch, 8, 2)
    spread = (packed[..., None] >> (8 * np.arange(4, dtype=np.uint32))) & 0xFF
    assert np.array_equal(spread.reshape(m, nch, 8, 8), want_blocked)
    assert rk.replicated_fits(k, m) == (rep.nbytes <= rk.REPLICATED_BYTES)
    if (k, m) == (128, 128):
        # RS(128,128) takes the packed form: 128 KB of shared memory
        assert not rk.replicated_fits(k, m) and packed.nbytes == 128 * 1024


def test_constants_match_kernel_source():
    import os
    import re

    src = os.path.join(os.path.dirname(rk.__file__), "csrc", "gf_bitmatmul.cu")
    with open(src) as f:
        text = f.read()
    assert re.search(r"kReplicatedBytes = 48 \* 1024;", text)
    assert rk.REPLICATED_BYTES == 48 * 1024
    assert int(re.search(r"kThreads = (\d+);", text).group(1)) == rk.THREADS
    assert int(re.search(r"kCompareMaxThreads = (\d+);", text).group(1)) == rk.COMPARE_MAX_THREADS
    assert int(re.search(r"kGroupRows = (\d+);", text).group(1)) == rk.COMPARE_GROUP_ROWS
    assert int(re.search(r"kCompareWords = (\d+);", text).group(1)) == rk.COMPARE_WORDS
    # the compare writes its mask itself: no memset call, no atomic op
    assert "cudaMemset" not in text and not re.search(r"\batomic[A-Z]", text)
    assert rk.replicated_fits(8, 3) and rk.replicated_fits(16, 4)


def _fold8(a):
    """The kernel's tree fold (fold_pair, fold_stage2, fold_stage3) on uint32 arrays
    a[0..7], the parity words of bit rows 0..7."""
    def pick(keep, x, y):
        keep = np.uint32(keep)
        return (x & keep) | (y & ~keep)

    n1, n2, n4 = np.uint32(1), np.uint32(2), np.uint32(4)
    b = [pick(0x0F0F0F0F, a[c] ^ (a[c] >> n4), a[c + 4] ^ (a[c + 4] << n4)) for c in range(4)]
    d = [pick(0x33333333, b[c] ^ (b[c] >> n2), b[c + 2] ^ (b[c + 2] << n2)) for c in range(2)]
    return pick(0x55555555, d[0] ^ (d[0] >> n1), d[1] ^ (d[1] << n1))


def _kernel_model(bitmat: np.ndarray, data: np.ndarray) -> np.ndarray:
    """numpy model of gf_bitmatmul.cu's word arithmetic: 4 columns to a
    uint32 word, the blocked replicated masks, AND-XOR per output bit row
    over 8-row chunks, then the three-stage tree fold."""
    m, k = bitmat.shape[0] // 8, bitmat.shape[1] // 8
    nch = -(-k // 8)
    masks = rk.kernel_masks(bitmat, packed=False).reshape(m, nch, 8, 8)
    s = data.shape[1]
    rows = np.zeros((8 * nch, -(-s // 4) * 4), dtype=np.uint8)
    rows[:k, :s] = data
    x = rows.view("<u4")
    out = np.zeros((m, x.shape[1]), dtype="<u4")
    for u in range(m):
        a = [np.zeros(x.shape[1], dtype=np.uint32) for _ in range(8)]
        for ch in range(nch):
            for i in range(8):
                for c in range(8):
                    a[c] ^= x[8 * ch + i] & masks[u, ch, c, i]
        out[u] = _fold8(a)
    return out.view(np.uint8)[:, :s]


def _model_cases():
    cases = [("encode", k, m, ()) for k, m in [(8, 3), (4, 2), (16, 4), (10, 4)]]
    return cases + [("decode", 8, 3, e) for e in [(2,), (2, 9), (0, 5, 10), (8, 9, 10)]]


@pytest.mark.parametrize("kind,k,m,erasures", _model_cases())
def test_kernel_word_model_vs_interpret(rng, kind, k, m, erasures):
    """The kernel's replicated-mask AND-XOR and tree fold, modelled in
    numpy, against the JAX Pallas kernel in interpret mode (byte-exact):
    pins the fold's bit order before the card runs it."""
    ref, _ = _codecs(k, m)
    D = rng.integers(0, 256, (k, 1024), dtype=np.uint8)
    if kind == "encode":
        bits, src = np.asarray(ref.encode_bits), D
    else:
        full = np.concatenate([D, ref_gf.gf_matmul(ref.C, D)])
        survivors, dbits = ref.decode_bits(erasures)
        bits, src = np.asarray(dbits), full[survivors]
    want = np.asarray(ref_rk.gf_bitmatmul_pallas(
        jnp.asarray(bits), jnp.asarray(src), tile_s=512, interpret=True))
    assert np.array_equal(_kernel_model(bits, src), want)
    if kind == "decode":
        assert np.array_equal(want, full[list(erasures)])


def test_kernel_word_model_ragged_tail(rng):
    """Columns past S read as zero and are never written."""
    bits = _bitmat(8, 3)
    D = rng.integers(0, 256, (8, 301), dtype=np.uint8)
    want = np.asarray(ref_rk.gf_bitmatmul(jnp.asarray(bits), jnp.asarray(D)))
    assert np.array_equal(_kernel_model(bits, D), want)


def _covered(s, batch, words, blocks):
    """How often the kernel's loop (gf_bitmatmul.cu ``run``) touches each
    column of each batch row: thread g takes items g, g + stride, ...;
    item t is columns [4W (t mod ipr), +4W) of row t // ipr."""
    ipr = -(-s // (4 * words))
    items = batch * ipr
    stride = blocks * rk.THREADS
    g = np.arange(stride)
    t = np.concatenate([g + j * stride for j in range(-(-items // stride))])
    t = t[t < items]
    b, it = t // ipr, t % ipr
    cols = it[:, None] * 4 * words + np.arange(4 * words)
    flat = (b[:, None] * ipr * 4 * words + cols).reshape(-1)
    hits = np.bincount(flat, minlength=batch * ipr * 4 * words)
    # past s the kernel reads zeros and writes nothing
    return hits.reshape(batch, ipr * 4 * words)[:, :s]


@pytest.mark.parametrize("s", [16, 4096 + 13, 65536 + 3, 262144 + 13])
@pytest.mark.parametrize("batch", [1, 8])
def test_launch_plan_covers_every_column_once(s, batch):
    words, blocks = rk._launch_plan(s, batch, 132)
    assert words in (2, 4) and 1 <= blocks <= 132 * rk.MAX_BLOCKS_PER_SM
    assert np.all(_covered(s, batch, words, blocks) == 1)
    for w in (2, 4):  # a forced width covers as well
        assert np.all(_covered(s, batch, *rk._launch_plan(s, batch, 132, w)) == 1)


@pytest.mark.parametrize("s,batch", [(524288, 1), (262144, 1), (65536, 8)])
def test_launch_plan_fills_the_card_at_main_path_shapes(s, batch):
    """The grouped encode (8, 524288), the plain-layout encode (8, 262144)
    and the batched decode (8, 8, 65536): at least 4 blocks of 256 threads
    per SM (528), or one thread for every item where there are fewer."""
    words, blocks = rk._launch_plan(s, batch, 132)
    items = batch * -(-s // (4 * words))
    assert blocks >= 528 or blocks * rk.THREADS >= items
    assert words == 2


def test_launch_plan_strides_at_large_s():
    """The acc loop's (8, 256 MiB): 16 columns a thread, the grid capped
    at 8 blocks per SM, each thread striding over many items."""
    words, blocks = rk._launch_plan(256 << 20, 1, 132)
    assert (words, blocks) == (4, 132 * 8)
    assert np.all(_covered(1 << 16, 1, 4, 3) == 1)  # stride loop, small


def test_mask_cache_is_by_identity_and_version():
    bits = torch.tensor(_bitmat(8, 3))
    packed, ptr = rk._masks(bits)
    assert packed == 0 and rk._masks(bits) == (0, ptr)

    def held(t):
        return rk._mask_cache[id(t)][3].numpy().view("<u4")

    assert np.array_equal(held(bits), rk.kernel_masks(bits.numpy(), packed=False))
    twin = bits.clone()  # equal contents, another tensor: its own entry
    assert rk._masks(twin)[1] != ptr
    bits[0, 0] ^= 1  # changed in place: rebuilt
    assert rk._masks(bits)[1] != ptr
    assert rk._mask_cache[id(bits)][1] == bits._version
    assert np.array_equal(held(bits), rk.kernel_masks(bits.numpy(), packed=False))
    n = len(rk._mask_cache)
    del twin  # a freed bit-matrix drops its entry
    assert len(rk._mask_cache) == n - 1
    wide = torch.tensor(_bitmat(128, 128))
    assert rk._masks(wide)[0] == 1
    assert np.array_equal(held(wide), rk.kernel_masks(wide.numpy(), packed=True))


# ---------------------------------------------------------------------------
# Deep scrub's re-encode-compare
# ---------------------------------------------------------------------------

def _compare_inputs(rng, k, m, batch, s, case):
    """(bit-matrix, data, parity) with ``case``: clean parity, one data
    byte flipped, one parity byte flipped, or zero-padded lanes (the
    scrub batcher's bucket padding)."""
    ref, _ = _codecs(k, m)
    data = rng.integers(0, 256, (batch, k, s), dtype=np.uint8)
    if case == "padded":
        data[:, :, s // 3:] = 0
    parity = np.stack([ref_gf.gf_matmul(ref.C, d) for d in data])
    b = batch - 1
    if case == "data_flip":
        data[b, k - 1, s // 2] ^= 0x40
    elif case == "parity_flip":
        parity[b, m - 1, s - 1] ^= 0x01
    return np.asarray(ref.encode_bits), data, parity


@pytest.mark.parametrize("k,m", [(8, 3), (4, 2), (3, 2)])
@pytest.mark.parametrize("batch", [1, 8])
@pytest.mark.parametrize("case", ["clean", "data_flip", "parity_flip", "padded"])
def test_encode_compare_plain_vs_jax(rng, k, m, batch, case):
    bits, data, parity = _compare_inputs(rng, k, m, batch, 1024, case)
    want = np.asarray(ref_rk.gf_encode_compare(
        jnp.asarray(bits), jnp.asarray(data), jnp.asarray(parity)))
    got = rk.gf_encode_compare_plain(_t(bits), _t(data), _t(parity))
    assert got.dtype == torch.bool and got.shape == (batch, m)
    assert np.array_equal(got.numpy(), want)
    # the entry point on CPU tensors is the plain version
    assert np.array_equal(rk.gf_encode_compare(_t(bits), _t(data), _t(parity)).numpy(), want)
    flagged = want.sum()
    if case in ("clean", "padded"):
        assert flagged == 0
    elif case == "parity_flip":
        assert flagged == 1 and want[batch - 1, m - 1]
    else:  # a Cauchy code: every parity row depends on every data byte
        assert flagged == m and want[batch - 1].all()


def test_encode_compare_all_mismatch(rng):
    bits, data, parity = _compare_inputs(rng, 8, 3, 8, 512, "clean")
    got = rk.gf_encode_compare(_t(bits), _t(data), _t(parity ^ 0xFF))
    assert got.all()


def test_encode_compare_rejects_bad_parity():
    bits = torch.tensor(_bitmat(8, 3))
    data = torch.zeros((2, 8, 64), dtype=torch.uint8)
    with pytest.raises(ValueError, match="parity"):
        rk.gf_encode_compare(bits, data, torch.zeros((2, 2, 64), dtype=torch.uint8))
    with pytest.raises(TypeError, match="parity"):
        rk.gf_encode_compare(bits, data, torch.zeros((2, 3, 64), dtype=torch.int32))
    assert "gf_encode_compare" in rk.launch_counts()


def _compare_model(bitmat, data, parity, parts, threads, words=rk.COMPARE_WORDS):
    """numpy model of gf_encode_compare_kernel over its launch plan.
    Block i takes part q = i % parts of entry b = i // parts.  A unit is
    one (item, stored row) pair of a row group (32 rows, a bit each):
    chunk c of 32 units is row c % rows of items (c // rows) * 32 + lane
    (4 * words columns an item, zeros past S; items past the row are
    skipped), and thread t of part q takes units q * threads + t, +
    parts * threads, ...  The block ORs its units' bits; with parts > 1
    parts 1.. post (1 << 32) | bits to their slots, and part 0 takes each
    slot once it is posted, clears it, ORs and writes the group's flags.
    The output starts as garbage (``torch.empty``), the slots as zeros.
    Returns (flags, stores per flag, units each thread took per entry,
    slots after the launch)."""
    batch, k, s = data.shape
    m = parity.shape[1]
    diff = np.stack([_kernel_model(bitmat, d) for d in data]) != parity  # (B, m, S)
    ipr = -(-s // (4 * words))
    pad = np.zeros((batch, m, ipr * 4 * words), dtype=bool)
    pad[:, :, :s] = diff
    item_bad = pad.reshape(batch, m, ipr, 4 * words).any(-1)  # (B, m, ipr)
    chunks = -(-ipr // 32)
    groups = -(-m // rk.COMPARE_GROUP_ROWS)
    slots = np.zeros(batch * groups * parts, dtype=np.uint64)
    out = np.full(batch * m, 0xA5, dtype=np.uint8)
    stores = np.zeros(batch * m, dtype=int)
    taken = np.zeros(parts * threads, dtype=int)
    for b in range(batch):
        for grp in range(groups):
            u0 = grp * rk.COMPARE_GROUP_ROWS
            rows = min(rk.COMPARE_GROUP_ROWS, m - u0)
            w = np.arange(chunks * rows * 32)
            c, lane = w // 32, w % 32
            item, row = (c // rows) * 32 + lane, u0 + c % rows
            ok = item < ipr
            thread = w % (parts * threads)
            if b == 0:
                taken += np.bincount(thread[ok], minlength=parts * threads)
            unit_bad = np.zeros(w.size, dtype=bool)
            unit_bad[ok] = item_bad[b, row[ok], item[ok]]
            bits = [int(np.bitwise_or.reduce(
                np.where(unit_bad & (thread // threads == q), 1 << (row - u0), 0), initial=0))
                for q in range(parts)]                         # block_or
            base = (b * groups + grp) * parts
            for q in range(1, parts):                          # posts
                assert slots[base + q] == 0
                slots[base + q] = np.uint64((1 << 32) | bits[q])
            every = bits[0]
            for q in range(1, parts):                          # part 0 takes
                v = int(slots[base + q])
                assert v >> 32 == 1
                slots[base + q] = 0
                every |= v & 0xFFFFFFFF
            for r in range(rows):
                out[b * m + u0 + r] = (every >> r) & 1
                stores[b * m + u0 + r] += 1
    return out.reshape(batch, m).astype(bool), stores.reshape(batch, m), taken, slots


@pytest.mark.parametrize("s,batch", [(4096 + 13, 8), (301, 3), (64, 8)])
@pytest.mark.parametrize("sms", [132, 6])
def test_compare_epilogue_model(rng, s, batch, sms):
    """Ragged S: every part reads zeros past S; a flip in one entry flags
    only it; on a card of 132 SMs and of 6 (fewer parts, or one a batch
    entry), each flag is stored once and the slots are left zero."""
    bits, data, parity = _compare_inputs(rng, 8, 3, batch, s, "clean")
    parity[0, 1, s - 1] ^= 0x80                  # entry 0, row 1, last column
    data[batch - 1, 0, 0] ^= 0x01                # the last entry, every row
    want = rk.gf_encode_compare_plain(_t(bits), _t(data), _t(parity)).numpy()
    got, stores, _, slots = _compare_model(bits, data, parity,
                                           *rk.compare_plan(s, batch, 3, sms))
    assert np.array_equal(got, want) and np.all(stores == 1) and not slots.any()
    assert want[0].tolist() == [False, True, False] or batch == 1
    assert want[batch - 1].all()


#: forced (parts, threads) beside the plan's: one block an entry striding,
#: three parts of 96 threads, 40 parts of 32 threads
_PLAN_FORMS = [None, (1, 128), (3, 96), (40, 32)]


@pytest.mark.parametrize("s", [4096, 65536, 4096 + 13])
@pytest.mark.parametrize("m", [1, 3])
def test_compare_flags_written_once(s, m):
    """Batches 1-8, clean, one parity byte flipped and every parity byte
    wrong, at the plan's form and three forced ones: the model's mask
    equals the plain version and the reference's, each (b, u) flag is
    stored exactly once, with no zeroing, every (item, row) unit is taken
    by exactly one thread, and every slot is posted, taken and left
    zero."""
    rng = np.random.default_rng(s + m)
    bits, data, parity = _compare_inputs(rng, 8, m, 8, s, "clean")
    flipped = parity.copy()
    flipped[5, m - 1, s // 3] ^= 0x10
    for what, par in (("clean", parity), ("one flip", flipped), ("all wrong", parity ^ 0xFF)):
        want8 = np.asarray(ref_rk.gf_encode_compare(
            jnp.asarray(bits), jnp.asarray(data), jnp.asarray(par)))
        for batch in range(1, 9):
            d, p = data[:batch], par[:batch]
            want = want8[:batch]
            assert np.array_equal(
                rk.gf_encode_compare_plain(_t(bits), _t(d), _t(p)).numpy(), want)
            for form in _PLAN_FORMS:
                plan = form or rk.compare_plan(s, batch, m, 132)
                got, stores, taken, slots = _compare_model(bits, d, p, *plan)
                assert np.array_equal(got, want), (what, batch, plan)
                assert np.all(stores == 1) and not slots.any()
                assert taken.sum() == -(-s // (4 * rk.COMPARE_WORDS)) * m
        assert want8.sum() == {"clean": 0, "one flip": 1, "all wrong": 8 * m}[what]


def test_compare_model_wide_code(rng):
    """A code of 40 parity rows takes two row groups (rows 32-39 past
    the four loaded early): each flag is stored once, the slots of both
    groups are left zero, and the mask equals the reference's."""
    bits, data, parity = _compare_inputs(rng, 8, 40, 2, 301, "clean")
    parity[1, 37, 100] ^= 0x40
    parity[0, 2, 7] ^= 0x01
    want = np.asarray(ref_rk.gf_encode_compare(
        jnp.asarray(bits), jnp.asarray(data), jnp.asarray(parity)))
    got, stores, _, slots = _compare_model(bits, data, parity, 3, 32)
    assert np.array_equal(got, want) and np.all(stores == 1) and not slots.any()
    assert np.flatnonzero(want).tolist() == [2, 40 + 37]


def test_compare_plan():
    """On 132 SMs: the scrub path's (8, 8, 65536) with m = 3 is 24576
    units an entry, more than a block an SM gives one a thread: 33 parts
    an entry (264 blocks, two an SM) of 384 threads, two units a thread;
    one entry takes a block an SM of 192 threads, one unit a thread; a
    4096-column lane 12 parts; no columns one part; more entries than
    blocks one part an entry, its threads striding.  Wherever parts wait
    on each other, every block is resident at once (two an SM)."""
    assert rk.compare_plan(65536, 8, 3, 132) == (33, 384)
    assert rk.compare_plan(65536, 1, 3, 132) == (132, 192)
    assert rk.compare_plan(4096, 8, 3, 132) == (12, 128)
    assert rk.compare_plan(4096 + 13, 1, 1, 132) == (5, 128)
    assert rk.compare_plan(0, 3, 3, 132) == (1, 128)
    assert rk.compare_plan(65536, 1000, 3, 132) == (1, 512)
    for s in (0, 64, 4096 + 13, 65536, 1 << 20):
        for batch in (1, 3, 8, 66, 133, 300):
            for m in (1, 3, 40):
                parts, threads = rk.compare_plan(s, batch, m, 132)
                assert parts == 1 or parts * batch <= 2 * 132
                assert threads % 32 == 0 and 128 <= threads <= rk.COMPARE_MAX_THREADS

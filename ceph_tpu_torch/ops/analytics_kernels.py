"""The mgr's cluster analytics as one kernel: percentiles, EWMA trends,
means and outlier daemons over the whole time-series store.

Counterpart of the jitted XLA program of ``ceph_tpu/mgr/analytics.py``
(``AnalyticsEngine._build_jit.run``, :205-213).  The store is three
arrays: ``values`` (D, M, W) int64, ``valid`` (D, M, W) bool and
``cursor`` (D,) int64, ``cursor[d]`` the oldest column of daemon d's
ring.  The result is six arrays, as ``analyze_numpy`` gives them:

- ``percentiles`` (M, 3) int64: nearest-rank p50 / p95 / p99 over every
  valid sample of a metric, 0 where it has none;
- ``n_samples`` (M,) int64;
- ``ewma_scaled`` (D, M) int64: fixed point (2^8), alpha 1/4, oldest
  sample first, seeded by the first valid one;
- ``mean_scaled`` and ``count`` (D, M) int64: ``(sum << 8) // count``;
- ``outlier`` (D, M) bool: mean > 2x the lower median of the reporting
  daemons' means.

Every step is int64 arithmetic with numpy's semantics (wrapping shifts,
sums and products, floor division and modulo), so the kernel, the plain
version and the numpy reference agree bit for bit on any input.

Two implementations of one function:

- on CUDA tensors, :func:`analyze_packed` launches ``csrc/mgr_analytics.cu``
  once (a cluster of blocks a metric, see the source) into one int64
  buffer that holds all six outputs, so they come back in one copy;
- on CPU tensors, the plain PyTorch version :func:`analyze_plain`.

:func:`analyze` gives the six outputs as views of that buffer.  Launches
are counted in :func:`launch_counts`.
"""

from __future__ import annotations

import ctypes

import torch

from ceph_tpu_torch.ops import rs_kernels as rk

#: fixed-point scale of the EWMA and the means (2^8 sub-unit steps)
SCALE_SHIFT = 8
#: EWMA alpha = 1 / 2^ALPHA_SHIFT
ALPHA_SHIFT = 2
#: the percentiles reported (nearest rank)
PCTS = (50, 95, 99)
#: a daemon's mean above OUTLIER_FACTOR x the median of means is an outlier
OUTLIER_FACTOR = 2

_I64_MAX = torch.iinfo(torch.int64).max

#: the kernel's largest cluster (``kMaxCluster``), and the daemons a
#: block holds where the cluster allows
MAX_CLUSTER = 8
DAEMONS_PER_BLOCK = 128
#: the selects' pass plan (``kFirstBits``, ``kLaterBits``, ``kGather`` in
#: the source): a select's first histogram pass decides the 11 bits below
#: the highest bit where the cluster's keys differ, each later pass the
#: next 10, its bins read as super-bins of 32; a select with at most
#: ``GATHER_MAX`` candidates left ends by a rank count among them
FIRST_DIGIT_BITS = 11
LATER_DIGIT_BITS = 10
GATHER_MAX = 64
#: the two histogram buffers at the front of the dynamic shared memory,
#: 4096 bins of 4 bytes each: two selects' first passes, or four later
HIST_BYTES = 2 * 4096 * 4
#: shared memory a block may use on an H100 for its staging area: less
#: the histograms and the kernel's static arrays (super-bins, the early
#: ends' lists, the selects' state; under 8 KiB).  At 128 daemons of 32
#: samples a block takes under half an SM's 228 KiB, so two blocks share
#: an SM and every cluster of a (1024, 16, 32) store is resident at once
SMEM_LIMIT = 232448 - HIST_BYTES - 8192

#: output names, in the packed buffer's order
OUTPUTS = ("percentiles", "n_samples", "ewma_scaled", "mean_scaled", "count", "outlier")


def smem_bytes(nd: int, W: int) -> int:
    """Bytes of the staging area of a block holding ``nd`` daemons' rows
    of ``W`` samples: the staged values and valid bytes at an odd row
    stride, the sample keys, the mean keys, the means, the counts and the
    rings' starts and first wrapped steps (``ceph_mgr_analytics_smem`` in
    the source)."""
    S = W | 1
    return nd * (S * 8 + W * 8 + 8 + 8 + 4 + 8 + S)


def geometry(D: int, W: int) -> tuple[int, int, bool]:
    """(cluster, daemons a block, staged) of a launch over D daemons of W
    samples: the fewest blocks a metric, up to ``MAX_CLUSTER``, that hold
    at most ``DAEMONS_PER_BLOCK`` daemons each; ``staged`` where a
    block's share does not fit its shared memory, so the kernel stages
    the rows in a global scratch buffer (:func:`stage_bytes`)."""
    cluster = min(MAX_CLUSTER, max(1, -(-D // DAEMONS_PER_BLOCK)))
    nd = -(-D // cluster)
    return cluster, nd, smem_bytes(nd, W) > SMEM_LIMIT


def check_shape(D: int, M: int, W: int) -> None:
    """Raise where a (D, M, W) store exceeds the kernel's launch: a
    metric a grid row (at most 65535) and a metric's samples counted in
    32 bits."""
    if M > 65535 or D * W >= 1 << 31:
        raise ValueError(f"a store of {D} x {M} x {W} exceeds the kernel's launch "
                         "(M <= 65535 metrics, D * W < 2^31 samples a metric)")


def stage_bytes(D: int, M: int, W: int) -> int:
    """Bytes of the global scratch buffer of a staged launch: a slice a
    block, ``smem_bytes`` rounded up to 16; 0 where the rows fit shared
    memory."""
    cluster, nd, staged = geometry(D, W)
    return cluster * M * (-(-smem_bytes(nd, W) // 16) * 16) if staged else 0


def packed_words(D: int, M: int) -> int:
    """int64 words of the packed result: percentiles, n, ewma, mean,
    count, then D*M outlier bytes."""
    return 4 * M + 3 * D * M + -(-D * M // 8)


def unpack(buf: torch.Tensor, D: int, M: int) -> dict[str, torch.Tensor]:
    """The six outputs as views of a packed buffer (on any device)."""
    DM = D * M
    o = 4 * M + 3 * DM
    return {
        "percentiles": buf[:3 * M].view(M, 3),
        "n_samples": buf[3 * M:4 * M],
        "ewma_scaled": buf[4 * M:4 * M + DM].view(D, M),
        "mean_scaled": buf[4 * M + DM:4 * M + 2 * DM].view(D, M),
        "count": buf[4 * M + 2 * DM:o].view(D, M),
        "outlier": buf[o:].view(torch.uint8)[:DM].view(D, M).view(torch.bool),
    }


def pack(out: dict[str, torch.Tensor]) -> torch.Tensor:
    """The packed buffer of six outputs (the kernel's layout)."""
    M = out["n_samples"].shape[0]
    D = out["count"].shape[0]
    buf = torch.zeros(packed_words(D, M), dtype=torch.int64, device=out["count"].device)
    views = unpack(buf, D, M)
    for name in OUTPUTS:
        views[name].copy_(out[name])
    return buf


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

def _ordered(values, valid, cursor):
    """Each daemon's ring in time order, oldest first."""
    D, M, W = values.shape
    idx = torch.remainder(cursor[:, None] + torch.arange(W, device=values.device), W)
    gid = idx[:, None, :].expand(D, M, W)
    return torch.gather(values, 2, gid), torch.gather(valid, 2, gid)


def _percentiles(vals, mask):
    D, M, W = vals.shape
    flat = vals.transpose(0, 1).reshape(M, D * W)
    fmask = mask.transpose(0, 1).reshape(M, D * W)
    srt = torch.sort(torch.where(fmask, flat, _I64_MAX), dim=1).values
    n = fmask.sum(dim=1, dtype=torch.int64)
    cols = []
    for p in PCTS:
        pos = torch.clamp(torch.div(p * n + 99, 100, rounding_mode="floor") - 1, 0, D * W - 1)
        v = torch.gather(srt, 1, pos[:, None])[:, 0]
        cols.append(torch.where(n > 0, v, 0))
    return torch.stack(cols, dim=1), n


def _means(vals, mask):
    sums = torch.where(mask, vals, 0).sum(dim=2)
    cnt = mask.sum(dim=2, dtype=torch.int64)
    mean = torch.div(sums << SCALE_SHIFT, torch.clamp(cnt, min=1), rounding_mode="floor")
    return torch.where(cnt > 0, mean, 0), cnt


def _outliers(mean_scaled, cnt):
    col = mean_scaled.transpose(0, 1)
    have = cnt.transpose(0, 1) > 0
    srt = torch.sort(torch.where(have, col, _I64_MAX), dim=1).values
    nv = have.sum(dim=1, dtype=torch.int64)
    idx = torch.clamp(torch.div(nv - 1, 2, rounding_mode="floor"), 0, col.shape[1] - 1)
    med = torch.where(nv > 0, torch.gather(srt, 1, idx[:, None])[:, 0], 0)
    out = have & (col > OUTLIER_FACTOR * med[:, None]) & (med[:, None] > 0)
    return out.transpose(0, 1)


def _ewma(vals, mask):
    D, M, W = vals.shape
    e = torch.zeros((D, M), dtype=torch.int64, device=vals.device)
    seen = torch.zeros((D, M), dtype=torch.bool, device=vals.device)
    for t in range(W):
        x, v = vals[:, :, t], mask[:, :, t]
        xs = x << SCALE_SHIFT
        upd = e + ((xs - e) >> ALPHA_SHIFT)
        e = torch.where(v, torch.where(seen, upd, xs), e)
        seen = seen | v
    return e


def analyze_plain(values: torch.Tensor, valid: torch.Tensor,
                  cursor: torch.Tensor) -> dict[str, torch.Tensor]:
    """Plain version of :func:`analyze`: a gather into time order, two
    sorts and a loop over the window, as ``analyze_numpy``."""
    vals, mask = _ordered(values, valid, cursor)
    pct, n = _percentiles(vals, mask)
    mean, cnt = _means(vals, mask)
    return {"percentiles": pct, "n_samples": n, "ewma_scaled": _ewma(vals, mask),
            "mean_scaled": mean, "count": cnt, "outlier": _outliers(mean, cnt)}


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    """ctypes handle of ``ceph_mgr_analytics``, built on first use."""
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("mgr_analytics").ceph_mgr_analytics
        fn.restype = ctypes.c_int
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,  # values, valid, cursor
                       ctypes.c_void_p,                                    # out
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,           # D, M, W
                       ctypes.c_int, ctypes.c_int,                         # cluster, nd
                       ctypes.c_void_p, ctypes.c_void_p]                   # stage, stream
        _fn = fn
    return _fn


def _check(values, valid, cursor) -> tuple[int, int, int]:
    """Validate the store; returns (D, M, W)."""
    for name, t, dtype in (("values", values, torch.int64), ("valid", valid, torch.bool),
                           ("cursor", cursor, torch.int64)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, not {type(t).__name__}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, not {t.dtype}")
        if t.device != values.device:
            raise ValueError(f"{name} on {t.device} but values on {values.device}")
    if values.dim() != 3 or min(values.shape) < 1:
        raise ValueError(f"values must be (D, M, W) with each >= 1, got {tuple(values.shape)}")
    D, M, W = values.shape
    if tuple(valid.shape) != (D, M, W) or tuple(cursor.shape) != (D,):
        raise ValueError(f"valid must be {(D, M, W)} and cursor ({D},), got "
                         f"{tuple(valid.shape)} and {tuple(cursor.shape)}")
    return D, M, W


def analyze_packed(values: torch.Tensor, valid: torch.Tensor,
                   cursor: torch.Tensor) -> torch.Tensor:
    """The six outputs packed into one int64 tensor on the store's device
    (:func:`unpack` splits it).  On the card: one launch of
    ``mgr_analytics.cu``; a launch that fails raises."""
    D, M, W = _check(values, valid, cursor)
    if rk._on_cpu(values):
        return pack(analyze_plain(values, valid, cursor))
    if not (values.is_contiguous() and valid.is_contiguous() and cursor.is_contiguous()):
        raise ValueError("values, valid and cursor must be contiguous")
    check_shape(D, M, W)
    cluster, nd, staged = geometry(D, W)
    out = torch.empty(packed_words(D, M), dtype=torch.int64, device=values.device)
    stage = (torch.empty(stage_bytes(D, M, W), dtype=torch.uint8, device=values.device)
             if staged else None)
    index = values.get_device()
    err = rk._call(_kernel(), (values.data_ptr(), valid.data_ptr(), cursor.data_ptr(),
                               out.data_ptr(), D, M, W, cluster, nd,
                               None if stage is None else stage.data_ptr()), index)
    if err != 0:
        raise RuntimeError(f"mgr_analytics kernel launch failed: cudaError {err} "
                           f"(D={D}, M={M}, W={W}, cluster={cluster}, nd={nd}, "
                           f"staged={staged})")
    rk.count_launch(analyze_packed)
    return out


def analyze(values: torch.Tensor, valid: torch.Tensor,
            cursor: torch.Tensor) -> dict[str, torch.Tensor]:
    """One analytics pass over the store: the six outputs of
    ``analyze_numpy`` as tensors on the store's device (views of one
    buffer on the card)."""
    if rk._on_cpu(values):
        _check(values, valid, cursor)
        return analyze_plain(values, valid, cursor)
    D, M, _ = values.shape
    return unpack(analyze_packed(values, valid, cursor), D, M)


def reset_launch_counts() -> None:
    analyze_packed.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches since the last reset, by kernel."""
    return {"mgr_analytics": analyze_packed.launches}


reset_launch_counts()

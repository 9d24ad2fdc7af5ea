"""ScrubVerifier: batched deep-scrub verification with fixed shapes.

Counterpart of ``ceph_tpu/parallel/scrub_batcher.py``.  Deep scrub is
how an OSD proves its stored shards sound: the crc32c of every shard is
checked against ``HashInfo`` and the parity equations are re-checked.
Scrub chunks are a stream of small independent checks, the launch-bound
regime the recovery-decode aggregator (``parallel/decode_batcher.py``)
batches, so this module does the same for scrub:

- concurrent in-flight checks (across objects, and across PGs that share
  a verifier) are collected during a short window;
- every shard payload splits into the closed power-of-two bucket ladder
  (``ecutil.bucket_lanes``: pad to a power of two below the 64 KiB tile
  cap, tile-cap-wide column lanes above it), and two kinds of launch of
  fixed shape cover a whole group:

  1. **batched crc32c**: a (B, W) stack of payload lanes is one launch
     of the crc kernel (``ops.hashing.batched_crc32c_device``), which
     returns every lane's seed-0 crc word; the host folds them into
     each shard's exact crc32c with ``native.crc32c_zeros`` and
     ``hashing.crc32c_unadvance``, bit-identical to the per-object
     host loop;
  2. **re-encode compare**: (B, k, W) data-shard lanes re-encode
     through the profile's bit-matrix and are compared with the stored
     (B, m, W) parity lanes on the device
     (``ops.rs_kernels.gf_encode_compare``), which returns only a
     (B, m) mismatch mask: the expected parity never reaches memory.
     That catches silent parity divergence that per-shard crcs cannot.

- launch shapes come from a small fixed set (#width buckets x #batch
  buckets [x #profiles for the compare]); :meth:`prewarm` launches each
  once at daemon warmup (kernel builds, operator and mask caches), and
  the ``cold_launches`` counter proves the scrub path meets none after.

Padding is exact in both kernels: the encode of zero columns is zero
columns, and the crc of a zero-padded lane is the injective advance of
the true crc.

Where the port differs from the reference, on purpose: ``device=None``
means the card; a failed launch is raised to every waiter of its group
and out of :meth:`ScrubVerifier.verify_object`, never answered from the
host (``parity_bad=None`` is kept only for the objects the compare does
not cover by design, :meth:`ScrubVerifier._parity_eligible`); each
launch makes one declared upload of its lane batch and one download of
the (B,) words or the (B, m) mask inside a transfer-guard window, where
any other copy is counted and raises (``common/transfer_guard.py``).
"""

from __future__ import annotations

import asyncio
import collections
import threading

import numpy as np
import torch

from ceph_tpu_torch import native
from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.common.metrics import BucketCounters
from ceph_tpu_torch.common.tracing import device_tracer
from ceph_tpu_torch.ops.gf256 import gf_matrix_to_bitmatrix
from ceph_tpu_torch.ops.hashing import batched_crc32c_device, crc32c_unadvance
from ceph_tpu_torch.ops.hashing import prepare as prepare_crc
from ceph_tpu_torch.ops.rs_kernels import gf_encode_compare, prepare, resolve_device
from ceph_tpu_torch.osd.ecutil import bucket_lanes
from ceph_tpu_torch.parallel.decode_batcher import (
    DEFAULT_MAX_BATCH,
    DEFAULT_MIN_BUCKET,
    DEFAULT_TILE_CAP,
)

#: ceiling on the lane dimension of one batched crc launch (crc lanes
#: are single shard payloads, so many more fit per launch than the
#: (k, W) re-encode items)
DEFAULT_CRC_LANES = 32

_SEED = 0xFFFFFFFF
_BITS_CACHE_SIZE = 64


class ObjectCheck:
    """One object's batched verification result.

    ``crcs`` maps shard id -> crc32c of the shard payload (seed -1,
    reference ceph_crc32c semantics, bit-identical to the host
    ``native.crc32c`` loop).  ``parity_bad`` is the set of shard ids
    whose stored parity disagrees with a re-encode of the data shards,
    or None when the compare does not cover the object (not a plain
    matrix code, or not every shard present at one length)."""

    __slots__ = ("crcs", "parity_bad")

    def __init__(self, crcs: dict[int, int],
                 parity_bad: frozenset[int] | None):
        self.crcs = crcs
        self.parity_bad = parity_bad


class ScrubVerifier:
    """Coalesces concurrent deep-scrub checks into fixed-shape batched
    crc32c and re-encode-compare launches on ``device`` (the card
    unless the caller asks for the CPU, where the kernels' plain PyTorch
    versions run)."""

    def __init__(self, *, device=None, window_s: float = 0.002,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 crc_lanes: int = DEFAULT_CRC_LANES,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 tile_cap: int = DEFAULT_TILE_CAP):
        self.device = resolve_device(device)
        self.window_s = window_s
        self.max_batch = max_batch
        self.crc_lanes = crc_lanes
        self.min_bucket = min_bucket
        self.tile_cap = tile_cap
        #: bucket width -> [(lane view, width, fut)] awaiting a crc
        self._crc_pending: dict[int, list[tuple]] = {}
        #: (matrix signature, bucket) -> [(C, data, parity, fut)]
        self._enc_pending: dict[tuple, list[tuple]] = {}
        self._flush_handle = None
        #: dispatch tasks in flight (the loop holds tasks weakly)
        self._tasks: set[asyncio.Task] = set()
        self._bits_cache: collections.OrderedDict = collections.OrderedDict()
        #: launch shapes already launched (by prewarm or a previous
        #: launch); a launch outside this set is cold
        self._warm: set[tuple] = set()
        self._warm_lock = threading.Lock()
        self.stats = collections.Counter(
            objects=0, launches=0, crc_launches=0, enc_launches=0,
            cold_launches=0, batched_lanes=0)
        self.metrics = BucketCounters("scrub_verify_batch")

    # -- gating --------------------------------------------------------

    def active(self) -> bool:
        return True

    @staticmethod
    def _parity_eligible(ec_impl, payloads) -> bool:
        """The re-encode compare covers plain matrix codes with every
        shard present at one length; anything else answers
        ``parity_bad=None``."""
        from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode

        if not isinstance(ec_impl, MatrixErasureCode):
            return False
        if ec_impl.rows_per_chunk != 1 or ec_impl.get_sub_chunk_count() != 1:
            return False
        n = ec_impl.get_chunk_count()
        shards = {ec_impl.chunk_index(c) for c in range(n)}
        if set(payloads) != shards:
            return False
        sizes = {len(p) for p in payloads.values()}
        return len(sizes) == 1 and sizes.pop() > 0

    # -- request side --------------------------------------------------

    async def verify_object(
        self, ec_impl, payloads: dict[int, np.ndarray]
    ) -> ObjectCheck:
        """Verify one object's shard payloads, coalescing the device
        work with every other concurrent caller.  A failed launch
        raises here."""
        loop = asyncio.get_running_loop()
        arrs = {
            s: (np.frombuffer(bytes(p), dtype=np.uint8)
                if isinstance(p, (bytes, bytearray, memoryview))
                else np.ascontiguousarray(
                    np.asarray(p, dtype=np.uint8).reshape(-1)))
            for s, p in payloads.items()
        }
        crc_futs: dict[int, list[tuple[int, int, asyncio.Future]]] = {}
        for s, arr in arrs.items():
            futs = []
            for off, width, bucket in bucket_lanes(
                    arr.nbytes, min_bucket=self.min_bucket,
                    tile_cap=self.tile_cap):
                fut = loop.create_future()
                self._crc_pending.setdefault(bucket, []).append(
                    (arr[off:off + width], width, fut))
                futs.append((width, bucket, fut))
            crc_futs[s] = futs

        enc_futs: list[asyncio.Future] | None = None
        k = m = 0
        if ec_impl is not None and self._parity_eligible(ec_impl, arrs):
            k = ec_impl.get_data_chunk_count()
            m = ec_impl.get_chunk_count() - k
            C = np.asarray(ec_impl.coding_matrix, dtype=np.uint8)
            sig = C.shape[0].to_bytes(2, "little") + C.tobytes()
            size = len(next(iter(arrs.values())))
            enc_futs = []
            for off, width, bucket in bucket_lanes(
                    size, min_bucket=self.min_bucket,
                    tile_cap=self.tile_cap):
                fut = loop.create_future()
                data = np.stack([
                    arrs[ec_impl.chunk_index(c)][off:off + width]
                    for c in range(k)
                ])
                parity = np.stack([
                    arrs[ec_impl.chunk_index(k + j)][off:off + width]
                    for j in range(m)
                ])
                self._enc_pending.setdefault((sig, bucket), []).append(
                    (C, data, parity, fut))
                enc_futs.append(fut)

        self.stats["objects"] += 1
        if self._flush_handle is None and (
                self._crc_pending or self._enc_pending):
            self._flush_handle = loop.call_later(self.window_s, self._flush)

        try:
            crcs: dict[int, int] = {}
            for s, futs in crc_futs.items():
                c = _SEED
                pad = 0
                for width, bucket, fut in futs:
                    c = native.crc32c_zeros(bucket, c) ^ await fut
                    pad = bucket - width
                crcs[s] = crc32c_unadvance(c, pad)
            parity_bad: frozenset[int] | None = None
            if enc_futs is not None:
                bad: set[int] = set()
                for fut in enc_futs:
                    mask = await fut
                    bad.update(
                        ec_impl.chunk_index(k + j)
                        for j in range(m) if mask[j]
                    )
                parity_bad = frozenset(bad)
            return ObjectCheck(crcs, parity_bad)
        except BaseException:
            # the launch's error is raised once, here; the object's other
            # futures carry it too and are marked as read
            for fut in [f for futs in crc_futs.values() for *_, f in futs] + (
                    enc_futs or []):
                if fut.done() and not fut.cancelled():
                    fut.exception()
            raise

    # -- dispatch side -------------------------------------------------

    def _flush(self) -> None:
        """call_later callback: hand pending groups to worker threads;
        the launches and their copies must not run on the event loop."""
        self._flush_handle = None
        crc_pending, self._crc_pending = self._crc_pending, {}
        enc_pending, self._enc_pending = self._enc_pending, {}
        loop = asyncio.get_running_loop()
        runs = [(group, lambda g, w=bucket: self._run_crc_group(w, g))
                for bucket, group in crc_pending.items()]
        runs += [(group, lambda g, w=bucket: self._run_enc_group(w, g))
                 for (_sig, bucket), group in enc_pending.items()]
        for group, run in runs:
            task = loop.create_task(self._dispatch(group, run))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

    async def _dispatch(self, group, run) -> None:
        try:
            outs = await asyncio.to_thread(run, group)
        except Exception as e:
            for item in group:
                if not item[-1].done():
                    item[-1].set_exception(e)
            return
        for item, out in zip(group, outs):
            fut = item[-1]
            if not fut.done():
                fut.set_result(out)

    def _enc_bits(self, C: np.ndarray) -> torch.Tensor:
        key = C.shape[0].to_bytes(2, "little") + C.tobytes()
        hit = self._bits_cache.get(key)
        if hit is None:
            hit = prepare(torch.as_tensor(gf_matrix_to_bitmatrix(C),
                                          device=self.device))
            self._bits_cache[key] = hit
            if len(self._bits_cache) > _BITS_CACHE_SIZE:
                self._bits_cache.popitem(last=False)
        else:
            self._bits_cache.move_to_end(key)
        return hit

    def _note_launch(self, shape_key, kind, w, b, b_real,
                     real_bytes, padded_bytes):
        """Count one launch; returns its ``cuda_launch`` span (bucket
        shape, occupancy, cold verdict; upload-launch-download time)."""
        # crc and compare groups launch from worker threads at once
        with self._warm_lock:
            cold = shape_key not in self._warm
            self._warm.add(shape_key)
            self.stats["cold_launches"] += cold
            self.stats["launches"] += 1
            self.stats[f"{kind}_launches"] += 1
            self.stats["batched_lanes"] += b_real
        if cold:
            self.metrics.inc("cold_launches", w=w, b=b, k=kind)
        self.metrics.inc("launches", w=w, b=b, k=kind)
        self.metrics.inc("occupied_lanes", w=w, b=b, k=kind, by=b_real)
        self.metrics.inc("padded_lanes", w=w, b=b, k=kind, by=b)
        self.metrics.inc("occupied_bytes", w=w, b=b, k=kind, by=real_bytes)
        self.metrics.inc("padded_bytes", w=w, b=b, k=kind, by=padded_bytes)
        return device_tracer().span(
            "cuda_launch", stage="device", kind=f"scrub_{kind}",
            w=w, b=b, b_real=b_real, occupancy=round(b_real / b, 3),
            cold=cold,
        )

    def _run_crc_group(self, w: int, group: list[tuple]) -> list[int]:
        """Worker-thread body: batched crc32c launches over one bucket;
        returns each lane's seed-0 crc word of the padded lane."""
        outs: list[int] = [0] * len(group)
        # the kernel's operand block for this width goes up before the
        # window, as the bit-matrix masks do (prepare)
        prepare_crc(w, self.device)
        for at in range(0, len(group), self.crc_lanes):
            chunk = group[at:at + self.crc_lanes]
            b_real = len(chunk)
            # two batch shapes only (1 and max), so prewarm covers them
            b = 1 if b_real == 1 else self.crc_lanes
            batch = np.zeros((b, w), np.uint8)
            for j, (arr, width, _f) in enumerate(chunk):
                batch[j, :width] = arr
            # one upload of the lane batch, one download of the (B,)
            # words (the crcs fold on the host)
            with self._note_launch(
                ("crc", b, w), "crc", w, b, b_real,
                sum(width for _, width, _ in chunk), b * w,
            ), tg.no_implicit_transfers("scrub_crc", self.device):
                out = tg.readback(batched_crc32c_device(
                    tg.upload(batch, self.device)
                ).view(torch.int32)).view(np.uint32)
            for j in range(b_real):
                outs[at + j] = int(out[j])
        return outs

    def _run_enc_group(self, w: int, group: list[tuple]) -> list[np.ndarray]:
        """Worker-thread body: batched re-encode-compare launches for
        one (profile, bucket); returns each item's (m,) mismatch mask."""
        C = group[0][0]
        bits = self._enc_bits(C)
        m, k = C.shape
        outs: list[np.ndarray] = [None] * len(group)
        for at in range(0, len(group), self.max_batch):
            chunk = group[at:at + self.max_batch]
            b_real = len(chunk)
            b = 1 if b_real == 1 else self.max_batch
            data = np.zeros((b, k, w), np.uint8)
            parity = np.zeros((b, m, w), np.uint8)
            for j, (_C, d, p, _f) in enumerate(chunk):
                data[j, :, :d.shape[1]] = d
                parity[j, :, :p.shape[1]] = p
            # two uploads and the (B, m) mask back: the parity the
            # data re-encodes to never leaves the device
            with self._note_launch(
                (tuple(bits.shape), b, k, w), "enc", w, b, b_real,
                sum((k + m) * d.shape[1] for _C, d, _p, _f in chunk),
                b * (k + m) * w,
            ), tg.no_implicit_transfers("scrub_enc", self.device):
                out = tg.readback(gf_encode_compare(
                    bits, tg.upload(data, self.device),
                    tg.upload(parity, self.device)))
            for j in range(b_real):
                outs[at + j] = out[j]
        return outs

    # -- warmup --------------------------------------------------------

    def prewarm(self, ec_impl=None, widths=None, *, batches=None) -> int:
        """Launch every shape this verifier can launch once: the crc
        kernel over the full bucket ladder at batch 1 and ``crc_lanes``,
        plus the re-encode compare for ``ec_impl``'s code when given (at
        batch 1 and ``max_batch``, or ``batches``).  That covers the
        kernel builds, the crc advance operators per width and the
        bit-matrix masks.  Blocking: call from daemon warmup, never the
        scrub path.  Returns the number of shapes launched."""
        buckets = set()
        w = self.min_bucket
        while w <= self.tile_cap:
            buckets.add(w)
            w <<= 1
        for x in widths or ():
            x = max(min(x, self.tile_cap), self.min_bucket, 1)
            buckets.add(1 << (x - 1).bit_length())
        todo: list[tuple] = [("crc", b, w) for w in sorted(buckets)
                             for b in (1, self.crc_lanes)]
        ec_bits = None
        if ec_impl is not None and getattr(
                ec_impl, "rows_per_chunk", 1) == 1 and hasattr(
                ec_impl, "coding_matrix"):
            C = np.asarray(ec_impl.coding_matrix, dtype=np.uint8)
            ec_m, ec_k = C.shape
            ec_bits = self._enc_bits(C)
            todo += [(tuple(ec_bits.shape), b, ec_k, w) for w in sorted(buckets)
                     for b in (batches or (1, self.max_batch))]
        n = 0
        for key in todo:
            with self._warm_lock:
                if key in self._warm:
                    continue
            if key[0] == "crc":
                _, b, w = key
                batched_crc32c_device(
                    torch.zeros((b, w), dtype=torch.uint8, device=self.device))
            else:
                _, b, k_, w = key
                gf_encode_compare(
                    ec_bits,
                    torch.zeros((b, k_, w), dtype=torch.uint8, device=self.device),
                    torch.zeros((b, ec_m, w), dtype=torch.uint8, device=self.device))
            with self._warm_lock:
                self._warm.add(key)
            n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prewarmed_shapes"] += n
        self.metrics.inc("prewarmed_shapes", by=n)
        return n


_shared: ScrubVerifier | None = None


def shared(device=None) -> ScrubVerifier:
    """Process-wide verifier on ``device`` (the card unless the caller asks
    for the CPU), built on first use; co-hosted daemons share its
    launch shapes and coalesce their work.  A request for another
    device than the held verifier's raises; ``reset_shared()`` drops the
    held one."""
    global _shared
    want = resolve_device(device)
    if _shared is None:
        _shared = ScrubVerifier(device=want)
    elif _shared.device != want:
        raise RuntimeError(
            f"the shared verifier runs on {_shared.device}, not on the "
            f"requested {want}; reset_shared() first")
    return _shared


def reset_shared() -> None:
    """Test hook: drop the process-wide verifier."""
    global _shared
    _shared = None

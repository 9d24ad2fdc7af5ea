"""DecodeAggregator: batched recovery-decode dispatch with fixed shapes.

Counterpart of ``ceph_tpu/parallel/decode_batcher.py``.  Recovery
reconstructs objects one at a time (``ecutil.decode_shards_async`` per
object), so the decode stage of a degraded PG is a stream of small
per-object GF matmuls — the launch-bound regime "Repair Pipelining for
Erasure-Coded Storage" (arxiv 1908.01527) shows is won by batching
repair traffic.  This module is that layer for the GPU path:

- concurrent in-flight decodes that share an **erasure signature**
  (same decode matrix — k, m and the missing-shard pattern all feed the
  matrix, so matrix identity IS the signature) are collected during a
  short coalescing window;
- each request's stripe payload is padded into a **fixed power-of-two
  width bucket** (payloads wider than the tile cap split into
  fixed-width column lanes — the GF matmul is column-independent), the
  group is stacked into a (B, k, W) batch, and ONE batched launch of the
  CUDA kernel (``ops.rs_kernels.gf_bitmatmul``) per (signature, bucket,
  ``max_batch`` lanes) reconstructs every lane in the group;
- launch shapes are therefore drawn from a small fixed set
  (#erasure-counts x #width-buckets x #batch-buckets), all of which
  :meth:`prewarm` launches once at daemon warmup — after it the
  recovery I/O path meets no first-use cost (kernel build, allocator
  growth), and the ``cold_launches`` counter proves it.

Padding is exact: the decode matrix applied to zero columns yields
zero columns, so slicing the first S columns of each lane returns the
bit-identical per-object ``decode_shards`` result.  A failed launch is
raised to every waiter of its group; nothing is answered from the host.
"""

from __future__ import annotations

import asyncio
import collections
import threading

import numpy as np
import torch

from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.common.metrics import BucketCounters
from ceph_tpu_torch.common.tracing import device_tracer
from ceph_tpu_torch.ops.gf256 import gf_matrix_to_bitmatrix
from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul, prepare, resolve_device

#: padded widths below this stay in one bucket — tiny decodes all share
#: one shape instead of minting pow2 shapes per small size
DEFAULT_MIN_BUCKET = 4096

#: widest bucket; payloads wider than this split into TILE_CAP-wide
#: lanes (the GF matmul is column-independent), so the launch-shape set
#: is CLOSED: every possible payload lands in one of the
#: log2(TILE_CAP/MIN_BUCKET)+1 buckets and prewarm covers them all
DEFAULT_TILE_CAP = 1 << 16

#: ceiling on the batch dimension of one launch; larger groups split
#: into several full launches (shapes stay fixed either way)
DEFAULT_MAX_BATCH = 8

_BITS_CACHE_SIZE = 64


def pow2_bucket(n: int, floor: int = DEFAULT_MIN_BUCKET) -> int:
    """Smallest power-of-two >= max(n, floor)."""
    n = max(n, floor, 1)
    return 1 << (n - 1).bit_length()


class DecodeAggregator:
    """Coalesces concurrent ``D @ rows`` decode matmuls into fixed-shape
    batched launches on ``device`` (the card unless the caller asks for
    the CPU, where the kernel's plain PyTorch version runs)."""

    def __init__(self, *, device=None, window_s: float = 0.002,
                 max_batch: int = DEFAULT_MAX_BATCH,
                 min_bucket: int = DEFAULT_MIN_BUCKET,
                 tile_cap: int = DEFAULT_TILE_CAP):
        self.device = resolve_device(device)
        self.window_s = window_s
        self.max_batch = max_batch
        self.min_bucket = min_bucket
        self.tile_cap = tile_cap
        self._pending: dict[bytes, list[tuple]] = {}
        self._flush_handle = None
        self._bits_cache: collections.OrderedDict = collections.OrderedDict()
        #: (matrix shape, B, k, W) shapes already launched (by prewarm or
        #: a previous launch); a launch outside this set is cold — zero
        #: of those must happen after daemon warmup
        self._warm: set[tuple] = set()
        self._warm_lock = threading.Lock()
        #: ``fallbacks`` stays 0: a failed launch raises, it is never
        #: answered from the host
        self.stats = collections.Counter(
            requests=0, launches=0, cold_launches=0, batched_requests=0,
            fallbacks=0)
        self.metrics = BucketCounters("recovery_decode_batch")

    # -- gating --------------------------------------------------------

    def active(self) -> bool:
        return True

    # -- request side --------------------------------------------------

    async def apply(self, D: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """``D @ rows`` over GF(2^8), batched with concurrent callers
        that share the decode matrix.

        D is an (out, k) byte matrix (the plugin's cached decode matrix
        for one erasure signature); rows is (k, S) uint8.  Returns
        (out, S) uint8, bit-identical to ``gf_matmul(D, rows)``.
        """
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        key = D.shape[0].to_bytes(2, "little") + D.tobytes()
        self._pending.setdefault(key, []).append((D, rows, fut))
        self.stats["requests"] += 1
        if self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window_s, self._flush)
        return await fut

    # -- dispatch side -------------------------------------------------

    def _bits(self, D: np.ndarray) -> torch.Tensor:
        key = D.shape[0].to_bytes(2, "little") + D.tobytes()
        hit = self._bits_cache.get(key)
        if hit is None:
            # made, and its kernel masks built, once a signature and
            # outside the launch's guard window
            hit = prepare(torch.as_tensor(gf_matrix_to_bitmatrix(D),
                                          device=self.device))
            self._bits_cache[key] = hit
            if len(self._bits_cache) > _BITS_CACHE_SIZE:
                self._bits_cache.popitem(last=False)
        else:
            self._bits_cache.move_to_end(key)
        return hit

    def _flush(self) -> None:
        """call_later callback: hand every pending signature group to a
        worker thread — the launch and its copies must not run on the
        event loop."""
        self._flush_handle = None
        pending, self._pending = self._pending, {}
        loop = asyncio.get_running_loop()
        for group in pending.values():
            loop.create_task(self._dispatch_group(group))

    async def _dispatch_group(self, group: list[tuple]) -> None:
        try:
            outs = await asyncio.to_thread(self._run_group, group)
        except Exception as e:
            for _, _, fut in group:
                if not fut.done():
                    fut.set_exception(e)
            return
        for (_, _, fut), out in zip(group, outs):
            if not fut.done():
                fut.set_result(out)

    def _bucket_plan(
        self, group: list[tuple]
    ) -> dict[int, list[tuple[int, int, int]]]:
        """Bucket width -> [(group index, column offset, width), ...].

        Payloads wider than ``tile_cap`` split into tile_cap-wide
        column lanes (the GF matmul is column-independent, so slicing
        columns is exact); narrower payloads pad up to their pow2
        bucket.  Every lane therefore lands in the CLOSED ladder
        [min_bucket .. tile_cap] that prewarm launches in full."""
        plan: dict[int, list[tuple[int, int, int]]] = {}
        for i, (_, rows, _) in enumerate(group):
            s = rows.shape[1]
            if s <= self.tile_cap:
                w = pow2_bucket(s, self.min_bucket)
                plan.setdefault(w, []).append((i, 0, s))
            else:
                for off in range(0, s, self.tile_cap):
                    plan.setdefault(self.tile_cap, []).append(
                        (i, off, min(self.tile_cap, s - off)))
        return plan

    def _run_group(self, group: list[tuple]) -> list[np.ndarray]:
        """Worker-thread body: one batched launch per (signature,
        bucket, max_batch lanes); returns per-request outputs in
        request order."""
        D = group[0][0]
        bits = self._bits(D)
        k = group[0][1].shape[0]
        out_rows = bits.shape[0] // 8
        outs = [
            np.empty((out_rows, rows.shape[1]), np.uint8)
            for _, rows, _ in group
        ]
        for w, lanes in self._bucket_plan(group).items():
            for at in range(0, len(lanes), self.max_batch):
                chunk = lanes[at:at + self.max_batch]
                b_real = len(chunk)
                # two batch shapes only (1 and max): the warmup set
                # stays small
                b = 1 if b_real == 1 else self.max_batch
                batch = np.zeros((b, k, w), np.uint8)
                for j, (gi, off, width) in enumerate(chunk):
                    batch[j, :, :width] = group[gi][1][:, off:off + width]
                shape_key = (tuple(bits.shape), b, k, w)
                with self._warm_lock:
                    cold = shape_key not in self._warm
                    self._warm.add(shape_key)
                if cold:
                    self.stats["cold_launches"] += 1
                    self.metrics.inc("cold_launches", w=w, b=b)
                # launch span: bucket shape, lane occupancy and the
                # upload -> launch -> download time, per launch, so
                # padding waste is visible
                with device_tracer().span(
                    "cuda_launch", stage="device", kind="decode_batch",
                    w=w, b=b, b_real=b_real,
                    occupancy=round(b_real / b, 3), cold=cold,
                ), tg.no_implicit_transfers("decode_batch", self.device):
                    # one declared upload of the padded batch, one
                    # declared download of the launch result (rebuilt
                    # shards persist to the store); any other copy in
                    # the window is counted and raises
                    out = tg.readback(gf_bitmatmul(
                        bits, tg.upload(batch, self.device)))
                self.stats["launches"] += 1
                self.stats["batched_requests"] += b_real
                self.metrics.inc("launches", w=w, b=b)
                self.metrics.inc("occupied_lanes", w=w, b=b, by=b_real)
                self.metrics.inc("padded_lanes", w=w, b=b, by=b)
                real = sum(width for _, _, width in chunk)
                self.metrics.inc("occupied_bytes", w=w, b=b, by=real * k)
                self.metrics.inc("padded_bytes", w=w, b=b, by=b * k * w)
                for j, (gi, off, width) in enumerate(chunk):
                    outs[gi][:, off:off + width] = out[j, :, :width]
        return outs

    # -- warmup --------------------------------------------------------

    def prewarm(self, ec_impl, widths=None, *, erasure_counts=(1, 2),
                batches=None) -> int:
        """Launch every (signature-shape, batch, bucket) combination this
        aggregator can launch for ``ec_impl``'s code once, so the
        recovery path meets no first-use cost afterwards.  Blocking —
        call from daemon warmup (or via to_thread), never the I/O path.

        The bucket ladder [min_bucket .. tile_cap] is CLOSED (wider
        payloads split into tile_cap lanes), so warming the whole
        ladder covers every payload size this aggregator can ever see;
        ``widths`` is accepted as a hint for extra buckets but is not
        required.  ``erasure_counts`` covers the missing-shard
        multiplicities to warm (the decode matrix shape depends only on
        the count).  Returns the number of shapes launched.
        """
        k = ec_impl.get_data_chunk_count()
        r = getattr(ec_impl, "rows_per_chunk", 1)
        if batches is None:
            batches = [1, self.max_batch]
        buckets = set()
        w = pow2_bucket(self.min_bucket, 1)
        while w <= self.tile_cap:
            buckets.add(w)
            w <<= 1
        for x in widths or ():
            buckets.add(pow2_bucket(min(x, self.tile_cap), self.min_bucket))
        n = 0
        for e in erasure_counts:
            if e > ec_impl.get_chunk_count() - k:
                # impossible signature: more erasures than parity
                continue
            bits_shape = (8 * e * r, 8 * k * r)
            bits = torch.zeros(bits_shape, dtype=torch.uint8, device=self.device)
            for w in sorted(buckets):
                for b in batches:
                    shape_key = (bits_shape, b, k * r, w)
                    with self._warm_lock:
                        if shape_key in self._warm:
                            continue
                    gf_bitmatmul(bits, torch.zeros(
                        (b, k * r, w), dtype=torch.uint8, device=self.device))
                    with self._warm_lock:
                        self._warm.add(shape_key)
                    n += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.stats["prewarmed_shapes"] += n
        self.metrics.inc("prewarmed_shapes", by=n)
        return n


_shared: DecodeAggregator | None = None


def shared(device=None) -> DecodeAggregator:
    """Process-wide aggregator on ``device`` (the card unless the caller asks
    for the CPU), built on first use; co-hosted daemons share its
    launch shapes and coalesce their work.  A request for another
    device than the held aggregator's raises; ``reset_shared()`` drops the
    held one."""
    global _shared
    want = resolve_device(device)
    if _shared is None:
        _shared = DecodeAggregator(device=want)
    elif _shared.device != want:
        raise RuntimeError(
            f"the shared aggregator runs on {_shared.device}, not on the "
            f"requested {want}; reset_shared() first")
    return _shared


def reset_shared() -> None:
    """Test hook: drop the process-wide aggregator."""
    global _shared
    _shared = None

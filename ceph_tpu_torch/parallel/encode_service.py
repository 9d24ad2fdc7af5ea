"""EncodeService: the in-daemon microbatching bridge onto the encode farm.

Counterpart of ``ceph_tpu/parallel/encode_service.py``.  OSD write and
recovery ops running as concurrent asyncio tasks enqueue their GF(2^8)
matrix applications here; requests that land within one coalescing
window and share a matrix are dispatched together:

- on a mesh (:class:`ceph_tpu_torch.parallel.encode_farm.Mesh`), padded
  into one (B, k, S) batch through :func:`batch_encode_dp`, or, for a
  lone request when the mesh has a ``shard`` axis that divides k,
  through the chunk-sharded :func:`sharded_encode_tp` (its partials
  folded by ``farm_fold.cu``);
- on one device, concatenated along S (the GF product is
  column-independent) and padded to a power-of-two width: one kernel
  launch for the whole window.

This is the seam the reference implements as the ECSubWrite fan-out and
the per-op ``ECUtil::encode`` loop (src/osd/ECCommon.cc:749,
ECTransaction.cc:37): independent per-PG ops become one batched device
computation.  Launch shapes come from a small fixed set (pow2 widths and
batches), which :meth:`EncodeService.prewarm` launches once, so the I/O
path meets no first-use cost (``cold_launches``).

A dispatch that fails sets its exception on every waiter's future: no op
is answered from the host.  ``EncodeService(mesh=None, device=None)`` is
inactive and callers take their own path (:meth:`EncodeService.active`).
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
from ceph_tpu_torch.ops.rs_kernels import BitmatrixCodec, prepare, resolve_device
from ceph_tpu_torch.parallel.decode_batcher import pow2_bucket
from ceph_tpu_torch.parallel.encode_farm import Mesh, batch_encode_dp, sharded_encode_tp

#: payloads smaller than this stay on the caller's local path — dispatch
#: overhead dwarfs the math
DEFAULT_MIN_BYTES = 32768

_BITS_CACHE_SIZE = 64


class EncodeService:
    """Coalesces concurrent GF matrix applications onto a device mesh or
    one device.

    ``mesh`` must have a ``pg`` axis (stripe-batch data parallelism) and
    may have a ``shard`` axis (chunk sharding for the tp path).  With
    ``mesh=None`` and a ``device`` the service coalesces onto that one
    device; with neither it is inactive."""

    def __init__(self, mesh: Mesh | None = None, *, device=None,
                 min_bytes: int = DEFAULT_MIN_BYTES, window_s: float = 0.001):
        self.mesh = mesh
        self.device = None if device is None else resolve_device(device)
        self.min_bytes = min_bytes
        self.window_s = window_s
        self._pending: dict[bytes, list[tuple]] = {}
        self._flush_handle = None
        #: dispatch tasks in flight (the loop holds tasks weakly)
        self._tasks: set[asyncio.Task] = set()
        self._bits_cache: collections.OrderedDict = collections.OrderedDict()
        self.stats = collections.Counter()
        #: dispatch shapes already launched (by prewarm or an earlier
        #: dispatch); a dispatch outside this set is a cold launch
        self._warm: set[tuple] = set()
        self.metrics = BucketCounters("encode_farm")
        #: pinned host buffers of single-device dispatches on a card, by
        #: (direction, rows, S); a dispatch holds the lock while it uses them
        self._pinned: dict[tuple, torch.Tensor] = {}
        self._stage_lock = threading.Lock()

    # -- gating --------------------------------------------------------

    def active(self) -> bool:
        return self.mesh is not None or self.device is not None

    def _home(self) -> torch.device:
        """Where results gather: the mesh's first device, or the device."""
        return self.mesh.devices.flat[0] if self.mesh is not None else self.device

    # -- request side --------------------------------------------------

    async def apply(self, M: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """``M @ rows`` over GF(2^8), batched with concurrent callers.

        M is an (out, k) byte matrix (coding or cached decode matrix);
        rows is (k, S) uint8.  Returns (out, S) uint8."""
        if not self.active():
            raise RuntimeError("the encode service is inactive (no mesh and no device)")
        loop = asyncio.get_running_loop()
        fut = loop.create_future()
        key = M.shape[0].to_bytes(2, "little") + M.tobytes()
        self._pending.setdefault(key, []).append((M, rows, fut))
        if self._flush_handle is None:
            self._flush_handle = loop.call_later(self.window_s, self._flush)
        return await fut

    # -- dispatch side -------------------------------------------------

    def _bits(self, M: np.ndarray) -> torch.Tensor:
        """M's bit-matrix on the home device, cached (the farm keeps its
        copies on the other devices and its column blocks while this
        tensor lives)."""
        key = M.shape[0].to_bytes(2, "little") + M.tobytes()
        hit = self._bits_cache.get(key)
        if hit is None:
            hit = prepare(torch.as_tensor(gf_matrix_to_bitmatrix(M),
                                          device=self._home()))
            self._bits_cache[key] = hit
            if len(self._bits_cache) > _BITS_CACHE_SIZE:
                self._bits_cache.popitem(last=False)
        else:
            self._bits_cache.move_to_end(key)
        return hit

    def _flush(self) -> None:
        """call_later callback: hand every pending group to a worker
        thread; the dispatch and its copies must not run on the event
        loop (they would stall every other op of the process)."""
        self._flush_handle = None
        pending, self._pending = self._pending, {}
        loop = asyncio.get_running_loop()
        for group in pending.values():
            task = loop.create_task(self._dispatch_group(group))
            self._tasks.add(task)
            task.add_done_callback(self._tasks.discard)

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

    def _run_group(self, group: list[tuple]) -> list[np.ndarray]:
        """Worker-thread body: one dispatch for the whole group; returns
        per-request outputs in order."""
        M = group[0][0]
        bits = self._bits(M)
        k = M.shape[1]

        if self.mesh is None:
            return self._run_group_single(group, bits, k)

        if len(group) == 1 and "shard" in self.mesh.shape:
            _, rows, _fut = group[0]
            nsh = self.mesh.shape["shard"]
            if nsh > 1 and k % nsh == 0:
                # the dp path's fixed buckets: S padded to its pow2 bucket
                S = pow2_bucket(rows.shape[1], 1)
                padded = np.zeros((rows.shape[0], S), np.uint8)
                padded[:, : rows.shape[1]] = rows
                with self._note_shape(("tp", tuple(bits.shape), k, S), w=S):
                    out = sharded_encode_tp(self.mesh, bits, torch.from_numpy(padded)).cpu()
                self.stats["tp_dispatches"] += 1
                self.metrics.inc("launches", w=S)
                return [np.ascontiguousarray(out.numpy()[:, : rows.shape[1]])]

        # data-parallel batch: each request's S padded to one pow2 width
        # bucket and the batch to a pow2 multiple of the device count
        ndev = self.mesh.size
        widths = [rows.shape[1] for _, rows, _ in group]
        S = pow2_bucket(max(widths), 1)
        B = ndev * pow2_bucket(-(-len(group) // ndev), 1)
        batch = np.zeros((B, k, S), np.uint8)
        for i, (_, rows, _) in enumerate(group):
            batch[i, :, : rows.shape[1]] = rows
        axes = tuple(a for a in ("pg", "shard") if a in self.mesh.shape)
        with self._note_shape(("dp", tuple(bits.shape), B, k, S), w=S, b=B,
                              b_real=len(group)):
            out = batch_encode_dp(self.mesh, bits, torch.from_numpy(batch), axis=axes).cpu()
        self.stats["dp_dispatches"] += 1
        self.stats["coalesced"] += len(group)
        self.metrics.inc("launches", w=S, b=B)
        self.metrics.inc("occupied_lanes", w=S, b=B, by=len(group))
        self.metrics.inc("padded_lanes", w=S, b=B, by=B)
        self.metrics.inc("occupied_bytes", w=S, b=B, by=sum(widths) * k)
        self.metrics.inc("padded_bytes", w=S, b=B, by=B * k * S)
        host = out.numpy()
        return [np.ascontiguousarray(host[i, :, : rows.shape[1]])
                for i, (_, rows, _) in enumerate(group)]

    def _note_shape(self, shape_key: tuple, *, w: int, b: int = 1, b_real: int = 1):
        """Count a dispatch shape not launched before (a cold launch the
        warmup should have covered) and return the launch span."""
        cold = shape_key not in self._warm
        if cold:
            self._warm.add(shape_key)
            self.stats["cold_launches"] += 1
            self.metrics.inc("cold_launches", w=w, b=b)
        return device_tracer().span(
            "cuda_launch", stage="device", kind=f"encode_{shape_key[0]}", w=w, b=b,
            b_real=b_real, occupancy=round(b_real / max(b, 1), 3), cold=cold)

    def _staging(self, direction: str, rows: int, S: int) -> torch.Tensor:
        """The pinned (rows, S) host buffer of ``direction`` ("in" or
        "out") for single-device dispatches on a card, made on first use
        (by :meth:`prewarm`) and reused."""
        buf = self._pinned.get((direction, rows, S))
        if buf is None:
            buf = torch.empty((rows, S), dtype=torch.uint8, pin_memory=True)
            self._pinned[(direction, rows, S)] = buf
        return buf

    def _run_group_single(self, group: list[tuple], bits: torch.Tensor,
                          k: int) -> list[np.ndarray]:
        """Single-device dispatch: every request's rows concatenated along
        S, padded to a pow2 width, one kernel launch for the window.  On a
        card the rows go straight into a pinned buffer, so the upload and
        the download are one DMA each (the pad columns hold stale bytes;
        their parity is never read)."""
        widths = [rows.shape[1] for _, rows, _ in group]
        total = sum(widths)
        S = pow2_bucket(total, 1)
        on_card = self.device.type == "cuda"
        with self._stage_lock:
            tin = (self._staging("in", k, S) if on_card
                   else torch.zeros((k, S), dtype=torch.uint8))
            big = tin.numpy()
            off = 0
            for (_, rows, _), w in zip(group, widths):
                big[:, off:off + w] = rows
                off += w
            with self._note_shape(("single", tuple(bits.shape), k, S), w=S,
                                  b_real=len(group)), \
                    tg.no_implicit_transfers("encode_single", self.device):
                # the pinned buffers' two copies are the launch's
                # declared upload and read-back
                with tg.declared():
                    tin = tin.to(self.device, non_blocking=True)
                out = BitmatrixCodec._apply(bits, tin, None)
                with tg.declared():
                    if on_card:
                        tout = self._staging("out", out.shape[0], S)
                        tout.copy_(out, non_blocking=True)
                        torch.cuda.current_stream(self.device).synchronize()
                        out = tout
                    host = out.numpy()
            # copies, always: a slice that is already contiguous (a lone
            # request of a pow2 width) would otherwise be a view of the
            # staging buffer, which the next dispatch overwrites before
            # the waiter reads it
            outs = []
            off = 0
            for w in widths:
                outs.append(host[:, off:off + w].copy())
                off += w
        self.stats["single_dispatches"] += 1
        self.stats["coalesced"] += len(group)
        self.metrics.inc("launches", w=S)
        self.metrics.inc("occupied_bytes", w=S, by=total * k)
        self.metrics.inc("padded_bytes", w=S, by=k * S)
        return outs

    # -- warmup --------------------------------------------------------

    def prewarm(self, M: np.ndarray, widths, *, coalesce: int = 16) -> int:
        """Launch once every fixed-bucket dispatch shape this service can
        hit for matrix ``M`` and per-request payload widths ``widths``
        (coalescing concatenates or batches up to ``coalesce`` concurrent
        requests).  Blocking — run at daemon warmup, never in the I/O
        path.  Returns the number of shapes launched."""
        if not self.active():
            return 0
        M = np.asarray(M, np.uint8)
        bits = self._bits(M)
        k = M.shape[1]
        home = self._home()
        n = 0
        if self.mesh is not None:
            ndev = self.mesh.size
            axes = tuple(a for a in ("pg", "shard") if a in self.mesh.shape)
            bbs = sorted({ndev * pow2_bucket(-(-g // ndev), 1) for g in range(1, coalesce + 1)})
            for S in sorted(pow2_bucket(w, 1) for w in widths):
                for B in bbs:
                    key = ("dp", tuple(bits.shape), B, k, S)
                    if key in self._warm:
                        continue
                    batch_encode_dp(self.mesh, bits, torch.zeros((B, k, S), dtype=torch.uint8,
                                                                 device=home), axis=axes)
                    self._warm.add(key)
                    n += 1
            nsh = self.mesh.shape.get("shard", 1)
            if nsh > 1 and k % nsh == 0:
                for S in sorted(pow2_bucket(w, 1) for w in widths):
                    key = ("tp", tuple(bits.shape), k, S)
                    if key in self._warm:
                        continue
                    sharded_encode_tp(self.mesh, bits,
                                      torch.zeros((k, S), dtype=torch.uint8, device=home))
                    self._warm.add(key)
                    n += 1
        else:
            buckets: set[int] = set()
            for w in widths:
                f = 1
                while f <= coalesce:
                    buckets.add(pow2_bucket(w * f, 1))
                    f <<= 1
            for S in sorted(buckets):
                key = ("single", tuple(bits.shape), k, S)
                if key in self._warm:
                    continue
                out = BitmatrixCodec._apply(bits, torch.zeros((k, S), dtype=torch.uint8,
                                                              device=home), None)
                if home.type == "cuda":
                    self._staging("in", k, S)
                    self._staging("out", out.shape[0], S)
                self._warm.add(key)
                n += 1
        for dev in {d for d in (self.mesh.devices.flat if self.mesh is not None else [home])}:
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        self.stats["prewarmed_shapes"] += n
        self.metrics.inc("prewarmed_shapes", by=n)
        return n


_shared: EncodeService | None = None


def _layout(device) -> tuple:
    """What ``shared(device)`` serves: a ('pg', 'shard') mesh over every
    card when the request names no card and there are several (shard 2
    when their count is even), else the one resolved device."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and dev.index is None and torch.cuda.is_available() \
            and torch.cuda.device_count() > 1:
        n = torch.cuda.device_count()
        nsh = 2 if n % 2 == 0 else 1
        return ("mesh", n, nsh)
    return ("device", resolve_device(dev))


def _held_layout(svc: EncodeService) -> tuple:
    if svc.mesh is not None:
        rows, nsh = svc.mesh.devices.shape
        return ("mesh", rows * nsh, nsh)
    return ("device", svc.device)


def shared(device=None) -> EncodeService:
    """Process-wide service, built on first use: a ('pg', 'shard') mesh
    over every card when there are several, single-device mode on one
    card.  With no card it raises unless the caller asks for
    ``device="cpu"`` (single-device mode on the CPU, the kernels' plain
    versions).  A request for another device (or mesh) than the held
    service's raises; ``reset_shared()`` drops the held one."""
    global _shared
    want = _layout(device)
    if _shared is None:
        if want[0] == "mesh":
            _, n, nsh = want
            grid = np.array([torch.device("cuda", i) for i in range(n)],
                            dtype=object).reshape(n // nsh, nsh)
            _shared = EncodeService(Mesh(grid, ("pg", "shard")))
        else:
            _shared = EncodeService(device=want[1])
    elif _held_layout(_shared) != want:
        raise RuntimeError(
            f"the shared encode service runs on {_held_layout(_shared)}, "
            f"not on the requested {want}; reset_shared() first")
    return _shared


def reset_shared() -> None:
    """Test hook: drop the process-wide service."""
    global _shared
    _shared = None

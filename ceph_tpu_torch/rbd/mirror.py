"""rbd-mirror: journal-based one-way image replication (reference
src/tools/rbd_mirror/: ImageReplayer bootstrap + journal replay,
promote/demote via the primary flag).

A :class:`MirrorDaemon` watches journaled primary images in a source
pool and replays their events into a destination pool — typically a
different cluster's RADOS client, here any second ``RBD`` handle:

  1. **bootstrap**: a missing destination image is created
     (non-primary) and fully synced object-by-object;
  2. **replay**: events past this peer's recorded position
     (``peer.<name>`` in the source journal header) are applied to the
     destination via the normal Image ops, then the position advances —
     at-least-once delivery, safe because events are idempotent;
  3. **failover**: ``demote()`` the source, ``promote()`` the
     destination; direction is enforced by the primary flag (a
     non-primary image refuses writes, ceph_tpu_torch/rbd/__init__.py).

Counterpart of ``ceph_tpu/rbd/mirror.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from __future__ import annotations

import asyncio
import errno

from ceph_tpu_torch.rbd import RBD, Image, RBDError


class MirrorDaemon:
    def __init__(self, src: RBD, dst: RBD, peer_name: str = "mirror"):
        self.src = src
        self.dst = dst
        self.peer = peer_name
        self.stats = {"events_replayed": 0, "images_bootstrapped": 0}
        self._task: asyncio.Task | None = None
        # open handles cached across polls: re-opening every 200ms
        # would re-read header+objmap per image per tick — and, worse,
        # re-run journal replay on the OWNER's journal (open with
        # replay=False is the non-owning stance; see RBD.open)
        self._src_imgs: dict[str, Image] = {}
        self._dst_imgs: dict[str, Image] = {}
        self.stopping = False

    # -- one image, one pass ----------------------------------------------

    async def _src_open(self, name: str) -> Image:
        img = self._src_imgs.get(name)
        if img is None:
            img = await self.src.open(name, replay=False)
            self._src_imgs[name] = img
        else:
            # primary/demote flips arrive out-of-band: re-read the flag
            hdr = await self.src.meta.omap_get(f"rbd_header.{name}")
            img.primary = hdr.get("primary", b"1") == b"1"
        return img

    async def sync_image(self, name: str) -> int:
        """Bootstrap if needed, then replay pending events.  Returns
        how many events were applied."""
        src_img = await self._src_open(name)
        if src_img.journal is None:
            raise RBDError(
                errno.EOPNOTSUPP, f"image {name!r} has no journaling")
        if not src_img.primary:
            return 0  # demoted: nothing flows from this side
        await src_img.journal.register_peer(self.peer)
        dst_img = await self._ensure_dst(name, src_img)
        pos = await src_img.journal.peer_pos(self.peer)
        applied = 0
        for seq, head, payload in await src_img.journal.events_after(pos):
            await self._apply(dst_img, head, payload)
            await src_img.journal.peer_commit(self.peer, seq)
            applied += 1
        self.stats["events_replayed"] += applied
        return applied

    async def _ensure_dst(self, name: str, src_img: Image) -> Image:
        cached = self._dst_imgs.get(name)
        if cached is not None:
            return cached
        hdr_oid = f"rbd_header.{name}"
        fresh = False
        try:
            img = await self.dst.open(name, replay=False)
            hdr = await self.dst.meta.omap_get(hdr_oid)
            complete = hdr.get("mirror_bootstrapped") == b"1"
        except RBDError as e:
            if e.errno != errno.ENOENT:
                raise
            # bootstrap: the copy is non-primary from birth and no
            # journaling feature — its writes come only from replay
            await self.dst.create(
                name, src_img.size(), order=src_img.order,
                features=tuple(
                    f for f in src_img.features if f != "journaling"),
            )
            img = await self.dst.open(name)
            complete = False
            fresh = True
        if not complete:
            # (re)run the full object copy: a crash mid-bootstrap left
            # a half-synced image that MUST NOT pass as replicated —
            # the completion flag is written only after the last
            # object lands (and the demote happens before any data, so
            # no crash window leaves both sides primary)
            await img.demote()
            img.primary = True  # temporarily, for the initial copy
            try:
                if img.size() != src_img.size():
                    # the source grew/shrank since a crashed attempt
                    # created dst — without this every resumed copy
                    # past the stale size fails forever
                    await img.resize(src_img.size())
                step = img.obj_size
                for off in range(0, src_img.size(), step):
                    n = min(step, src_img.size() - off)
                    data = await src_img.read(off, n)
                    if data.strip(b"\0"):
                        await img.write(off, data)
                    elif not fresh:
                        # resumed bootstrap: a crashed earlier attempt
                        # may have copied a block the source has since
                        # zeroed (and the journal event may already be
                        # trimmed — this peer wasn't registered yet).
                        # Skipping would leave the stale block behind a
                        # bootstrapped=1 flag: a silently divergent
                        # replica.  Sparse-skip is only safe on a
                        # just-created destination.
                        await img.write(off, data)
            finally:
                img.primary = False
            await self.dst.meta.omap_set(
                hdr_oid, {"mirror_bootstrapped": b"1"})
            self.stats["images_bootstrapped"] += 1
        self._dst_imgs[name] = img
        return img

    async def _apply(self, dst_img: Image, head: dict, payload: bytes) -> None:
        """Replay one source event onto the (non-primary) destination
        through the SAME dispatcher open-time crash replay uses
        (Image._apply_journal_event) — one switch over event types,
        with the demoted-image and size guards suspended there."""
        await dst_img._apply_journal_event(head, payload)

    # -- continuous mode ---------------------------------------------------

    async def run(self, interval: float = 0.2) -> None:
        """Poll-and-replay every journaled image until stop()."""
        while not self.stopping:
            try:
                for name in await self.src.list():
                    try:
                        await self.sync_image(name)
                    except RBDError:
                        continue  # not journaled / mid-create
            except OSError:
                pass  # source cluster briefly unavailable: retry
            await asyncio.sleep(interval)

    def start(self, interval: float = 0.2) -> None:
        self.stopping = False
        self._task = asyncio.ensure_future(self.run(interval))

    async def stop(self) -> None:
        self.stopping = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            self._task = None

"""Cache tiering: HitSet recency + TierAgent flush/evict (reference
src/osd/PrimaryLogPG.cc TierAgent machinery, src/osd/HitSet.h),
split out of the daemon per the PGBackend seam layout."""

from __future__ import annotations

import asyncio
import errno
import logging
import time


from ceph_tpu_torch.osd.pglog import (
    PGMETA_OID,
)
from ceph_tpu_torch.osd.types import pg_t
from ceph_tpu_torch.store import coll_t, ghobject_t

from ceph_tpu_torch.msg.messages import (
    OP_DELETE,
    OP_READ,
    OP_SETXATTR,
    OP_WRITE_FULL,
    MOSDOp,
    MOSDOpReply,
)
from ceph_tpu_torch.osd.pgutil import (
    NO_SHARD,
    object_to_pg,
)

log = logging.getLogger("ceph_tpu_torch.osd")


class TieringMixin:
    """Cache-tier admission, promotion, flush and eviction — mixed
    into OSDDaemon; state lives in the daemon's __init__."""

    # -- cache tiering (PrimaryLogPG HitSet/TierAgent, src/osd/HitSet.h)

    def _hitset(self, pool_id: int) -> "OrderedDict":
        from collections import OrderedDict as _OD

        hs = getattr(self, "_hitsets", None)
        if hs is None:
            hs = self._hitsets = {}
        if pool_id not in hs:
            hs[pool_id] = _OD()
        return hs[pool_id]

    def _hitset_touch(self, pool_id: int, oid: str) -> None:
        """Approximate recency (the reference's HitSet stack reduced to
        one explicit-object window, src/osd/HitSet.h ExplicitHashHitSet):
        most-recent at the end, bounded."""
        hs = self._hitset(pool_id)
        hs[oid] = time.monotonic()
        hs.move_to_end(oid)
        while len(hs) > 4096:
            hs.popitem(last=False)

    async def _pool_op(self, pool_id: int, oid: str, ops: list) -> "MOSDOpReply":
        """The daemon as a CLIENT of another pool (the tiering
        flush/promote I/O, PrimaryLogPG::start_copy using the
        objecter).  Minimal resend-on-EAGAIN."""
        import errno as _errno

        for _try in range(8):
            om = self.osdmap
            pool = om.get_pg_pool(pool_id)
            if pool is None:
                return MOSDOpReply(result=-_errno.ENOENT, epoch=self.epoch)
            pg = object_to_pg(pool, oid)
            _, primary = self._acting(pool, pg)
            addr = om.osd_addrs.get(primary)
            if primary < 0 or addr is None:
                await asyncio.sleep(0.2)
                continue
            tid = next(self._tids)
            m = MOSDOp(pool=pool_id, oid=oid, ops=list(ops), tid=tid,
                       epoch=om.epoch)
            if m.is_write():
                m.reqid = f"osd.{self.id}:{tid}"
            fut: asyncio.Future = asyncio.get_running_loop().create_future()
            self._waiters[tid] = fut
            try:
                conn = await self.messenger.connect_to(
                    ("osd", primary), *addr)
                await conn.send_message(m)
                reply = await asyncio.wait_for(fut, 30.0)
            except (ConnectionError, OSError, asyncio.TimeoutError):
                await asyncio.sleep(0.2)
                continue
            finally:
                self._waiters.pop(tid, None)
            if reply.result == -_errno.EAGAIN:
                await asyncio.sleep(0.1 * (_try + 1))
                continue
            return reply
        return MOSDOpReply(result=-_errno.ETIMEDOUT, epoch=self.epoch)

    async def _tier_internal_op(
        self, pool, oid: str, ops: list, *, have_lock: bool = False,
    ) -> int:
        """Run a replicated write vector on OUR pool as an internal op
        (agent flush/evict, promote): full primary pipeline, replicas
        included, marked so the tier hook doesn't recurse.
        ``have_lock``: the caller already holds the object lock."""
        m = MOSDOp(pool=pool.id, oid=oid, ops=list(ops),
                   tid=next(self._tids), epoch=self.epoch)
        m._tier_internal = True
        m._have_obj_lock = have_lock
        m.reqid = f"osd.{self.id}:{m.tid}"
        reply = await self._execute_op(m)
        return reply.result

    async def _tier_prepare(self, pool, pg, msg) -> "MOSDOpReply | None":
        """The cache-pool op admission (PrimaryLogPG::maybe_handle_cache
        + do_cache_redirect/promote_object, writeback mode):

        - CACHE_FLUSH / CACHE_EVICT / COPY_FROM vectors are handled
          here entirely;
        - an op whose object misses the cache promotes it from the
          base pool first (whole-object, data only — documented lite
          scope vs the reference's omap/xattr copy);
        - deletes propagate to the base synchronously (the reference
          whiteouts + flushes; same visible result);
        - writes mark the object dirty (xattr), reads/writes record
          hits.  Returns a reply to short-circuit, or None to continue
          with the (possibly rewritten) vector."""
        import errno as _errno

        from ceph_tpu_torch.msg.messages import (
            OP_CACHE_EVICT,
            OP_CACHE_FLUSH,
            OP_COPY_FROM,
            OSDOp,
        )

        base_pid = int(pool.extra["tier_of"])
        c = self._shard_coll(pool, pg, NO_SHARD)
        o = ghobject_t(msg.oid)
        present = self.store.exists(c, o) and not self._is_whiteout(c, o)

        kinds = {op.op for op in msg.ops}
        if OP_CACHE_FLUSH in kinds:
            if not present:
                return MOSDOpReply(tid=msg.tid, result=-_errno.ENOENT,
                                   epoch=self.epoch)
            rc = await self._tier_flush(pool, base_pid, c, o, msg.oid,
                                        have_lock=True)
            return MOSDOpReply(tid=msg.tid, result=rc, epoch=self.epoch)
        if OP_CACHE_EVICT in kinds:
            if not present:
                return MOSDOpReply(tid=msg.tid, result=-_errno.ENOENT,
                                   epoch=self.epoch)
            if self._tier_dirty(c, o):
                return MOSDOpReply(tid=msg.tid, result=-_errno.EBUSY,
                                   epoch=self.epoch)
            rc = await self._tier_internal_op(
                pool, msg.oid, [OSDOp(OP_DELETE)], have_lock=True)
            self._hitset(pool.id).pop(msg.oid, None)
            self.perf.inc("tier_evict")
            return MOSDOpReply(tid=msg.tid, result=rc, epoch=self.epoch)
        if OP_COPY_FROM in kinds:
            op = next(op for op in msg.ops if op.op == OP_COPY_FROM)
            spool, _, soid = (op.name or "").partition(":")
            reply = await self._pool_op(
                int(spool), soid, [OSDOp(OP_READ)])
            if reply.result != 0:
                return MOSDOpReply(tid=msg.tid, result=reply.result,
                                   epoch=self.epoch)
            # the copy is DIRTY (writeback: it exists only here until
            # flushed — an unflushed-evictable copy would be lost)
            msg.ops = [
                OSDOp(OP_WRITE_FULL, data=reply.data),
                OSDOp(OP_SETXATTR, name="cache.dirty", data=b"1"),
            ]
            return None  # continue as a normal replicated write

        self._hitset_touch(pool.id, msg.oid)
        if present:
            self.perf.inc("tier_hit")
        else:
            self.perf.inc("tier_miss")
            # promote-on-miss (reads AND writes: writeback promotes
            # before mutating, PrimaryLogPG::promote_object)
            reply = await self._pool_op(base_pid, msg.oid, [OSDOp(OP_READ)])
            if reply.result == 0:
                rc = await self._tier_internal_op(pool, msg.oid, [
                    OSDOp(OP_WRITE_FULL, data=reply.data),
                ], have_lock=True)
                if rc != 0:
                    return MOSDOpReply(tid=msg.tid, result=rc,
                                       epoch=self.epoch)
                self.perf.inc("tier_promote")
            elif reply.result != -_errno.ENOENT:
                return MOSDOpReply(tid=msg.tid, result=reply.result,
                                   epoch=self.epoch)

        if msg.is_write():
            if any(op.op == OP_DELETE for op in msg.ops):
                # propagate the delete to the base FIRST (lite
                # stand-in for whiteout + flush): if the base refuses,
                # the op fails — a cache-only delete would resurrect
                # on the next promote
                reply = await self._pool_op(
                    base_pid, msg.oid, [OSDOp(OP_DELETE)])
                if reply.result not in (0, -_errno.ENOENT):
                    return MOSDOpReply(tid=msg.tid, result=reply.result,
                                       epoch=self.epoch)
            else:
                msg.ops = list(msg.ops) + [
                    OSDOp(OP_SETXATTR, name="cache.dirty", data=b"1")]
        return None

    def _tier_dirty(self, c: coll_t, o: ghobject_t) -> bool:
        try:
            return self.store.getattr(c, o, "u_cache.dirty") == b"1"
        except (KeyError, FileNotFoundError, OSError):
            return False

    async def _tier_flush(self, pool, base_pid: int, c, o, oid: str,
                          *, have_lock: bool = False) -> int:
        """Write a dirty cache object back to the base pool, then mark
        it clean (CEPH_OSD_OP_CACHE_FLUSH, PrimaryLogPG::start_flush)."""
        from ceph_tpu_torch.msg.messages import OP_RMXATTR, OSDOp

        try:
            data = self.store.read(c, o)
        except (FileNotFoundError, OSError):
            return -errno.ENOENT
        if self._tier_dirty(c, o):
            reply = await self._pool_op(
                base_pid, oid, [OSDOp(OP_WRITE_FULL, data=bytes(data))])
            if reply.result != 0:
                return reply.result
            rc = await self._tier_internal_op(
                pool, oid, [OSDOp(OP_RMXATTR, name="cache.dirty")],
                have_lock=have_lock)
            if rc != 0:
                return rc
        self.perf.inc("tier_flush")
        return 0

    async def _tier_agent(self) -> None:
        """The TierAgent loop (PrimaryLogPG::agent_work): under
        target_max_bytes pressure, flush dirty objects then evict cold
        clean ones, per cache pool, for the PGs this OSD leads."""
        interval = self.conf["osd_tier_agent_interval"]
        while not self.stopping:
            await asyncio.sleep(interval)
            om = self.osdmap
            if om is None:
                continue
            for pool in list(om.pools.values()):
                try:
                    target = int(pool.extra.get("target_max_bytes", "0"))
                except (TypeError, ValueError):
                    continue
                if (
                    not target
                    or not pool.extra.get("tier_of")
                    or pool.extra.get("cache_mode") != "writeback"
                ):
                    continue
                try:
                    await self._tier_agent_pool(pool, target)
                except Exception:
                    log.exception("osd.%d: tier agent failed", self.id)

    async def _tier_agent_pool(self, pool, target: int) -> None:
        from ceph_tpu_torch.msg.messages import OSDOp

        base_pid = int(pool.extra["tier_of"])
        mine: list[tuple[str, int, coll_t, ghobject_t]] = []
        total = 0
        for ps in range(pool.pg_num):
            pg = pg_t(pool.id, ps)
            _a, primary = self._acting(pool, pg)
            if primary != self.id:
                continue
            c = coll_t(pool.id, ps, NO_SHARD)
            if not self.store.collection_exists(c):
                continue
            for o in self.store.collection_list(c):
                if o.name == PGMETA_OID or o.snap >= 0:
                    continue
                if self._is_whiteout(c, o):
                    continue
                try:
                    size = self.store.stat(c, o)
                except (FileNotFoundError, OSError):
                    continue
                mine.append((o.name, size, c, o))
                total += size
        if total <= target:
            return
        # coldest first: hitset order is recency (absent = coldest)
        hs = self._hitset(pool.id)
        rank = {oid: i for i, oid in enumerate(hs)}
        mine.sort(key=lambda t: rank.get(t[0], -1))
        for oid, size, c, o in mine:
            if total <= target * 0.8:
                break
            # flush-then-evict is ATOMIC vs client ops on this object:
            # the object lock spans both, so a write can't land between
            # the flush and the delete and be silently dropped
            async with self._obj_lock(pool.id, oid):
                if self._tier_dirty(c, o):
                    if await self._tier_flush(pool, base_pid, c, o, oid,
                                              have_lock=True) != 0:
                        continue
                if await self._tier_internal_op(
                        pool, oid, [OSDOp(OP_DELETE)],
                        have_lock=True) == 0:
                    self.perf.inc("tier_evict")
                    hs.pop(oid, None)
                    total -= size

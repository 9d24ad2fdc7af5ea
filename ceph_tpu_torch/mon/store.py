"""MonitorDBStore analogue: durable monitor/paxos state.

The reference monitor persists everything through MonitorDBStore — a
RocksDB kv store that Paxos writes transactionally (reference
src/mon/MonitorDBStore.h; src/mon/Paxos.h:174 "all paxos state is
stored in the store's 'paxos' namespace").  Here the same contract
rides the ObjectStore seam (MemStore for volatile tests, FileStore for
a durable WAL-backed monitor): one meta object whose omap holds

- ``pn.accepted`` / ``pn.last``    — proposal numbers
- ``last_committed`` / ``first_committed``
- ``v.<%016d>``                    — the committed value log
- ``uncommitted``                  — (version, pn, blob) a peon accepted
- ``snap.version`` / ``snap.blob`` — state-machine snapshot for trim

so a monitor restart replays snapshot + committed tail and rejoins the
quorum with its promises intact (a majority restart loses nothing).
"""

from __future__ import annotations

import asyncio
import struct

from ceph_tpu_torch.store import ObjectStore, Transaction, coll_t, ghobject_t

MON_COLL = coll_t(-2, 0)
PAXOS_OID = ghobject_t("_monstore_")


class MonStore:
    def __init__(self, store: ObjectStore):
        self.store = store
        # create the collection eagerly: write txns are built on the
        # event loop but may commit on worker threads, so a lazy
        # exists-check inside txn construction races itself
        if not self.store.collection_exists(MON_COLL):
            t = Transaction()
            t.create_collection(MON_COLL)
            t.touch(MON_COLL, PAXOS_OID)
            self.store.queue_transaction(t)

    # -- helpers -------------------------------------------------------

    def _txn(self) -> Transaction:
        t = Transaction()
        t.touch(MON_COLL, PAXOS_OID)
        return t

    async def _commit(self, t: Transaction) -> None:
        # journaling stores fsync: never stall the mon event loop (a
        # blocked loop looks like every OSD going silent at once)
        if getattr(self.store, "blocking_commit", False):
            await asyncio.to_thread(self.store.queue_transaction, t)
        else:
            self.store.queue_transaction(t)

    async def _setkeys(self, kv: dict[str, bytes]) -> None:
        t = self._txn()
        t.omap_setkeys(MON_COLL, PAXOS_OID, kv)
        await self._commit(t)

    @staticmethod
    def _u64(v: int) -> bytes:
        return struct.pack("<Q", v)

    # -- writes (each called at its paxos protocol point) --------------

    async def put_pns(self, accepted_pn: int, last_pn: int) -> None:
        await self._setkeys({
            "pn.accepted": self._u64(accepted_pn),
            "pn.last": self._u64(last_pn),
        })

    async def put_election_epoch(self, epoch: int) -> None:
        await self._setkeys({"election_epoch": self._u64(epoch)})

    async def put_uncommitted(self, version: int, pn: int, value: bytes) -> None:
        await self._setkeys({
            "uncommitted": struct.pack("<QQ", version, pn) + value,
        })

    async def put_commit(self, version: int, value: bytes) -> None:
        """Value + last_committed + clear uncommitted, atomically."""
        t = self._txn()
        t.omap_setkeys(MON_COLL, PAXOS_OID, {
            f"v.{version:016d}": value,
            "last_committed": self._u64(version),
        })
        t.omap_rmkeys(MON_COLL, PAXOS_OID, ["uncommitted"])
        await self._commit(t)

    async def put_snapshot(self, version: int, blob: bytes) -> None:
        await self._setkeys({
            "snap.version": self._u64(version),
            "snap.blob": blob,
        })

    async def trim_values(self, below: int) -> None:
        """Drop v.* entries with version < below; record the new tail.
        Key names are deterministic, so the old tail marker alone gives
        the drop range — no whole-omap scan of value blobs."""
        import struct as _s

        old = 1
        if self.store.collection_exists(MON_COLL) and self.store.exists(
            MON_COLL, PAXOS_OID
        ):
            raw = self.store.omap_get_values(
                MON_COLL, PAXOS_OID, ["first_committed"]
            ).get("first_committed")
            if raw:
                old = max(1, _s.unpack("<Q", raw)[0])
        if below - old > 10 * len(self._load_omap()) + 1000:
            # marker far behind reality (e.g. fresh store adopting a
            # full-sync at a huge version): enumerate what actually
            # exists instead of materializing millions of key names
            drop = [
                k for k in self._load_omap()
                if k.startswith("v.") and int(k[2:]) < below
            ]
        else:
            drop = [f"v.{v:016d}" for v in range(old, below)]
        t = self._txn()
        if drop:
            t.omap_rmkeys(MON_COLL, PAXOS_OID, drop)
        t.omap_setkeys(MON_COLL, PAXOS_OID, {
            "first_committed": self._u64(below),
        })
        await self._commit(t)

    # -- load ----------------------------------------------------------

    def _load_omap(self) -> dict[str, bytes]:
        if not self.store.collection_exists(MON_COLL):
            return {}
        if not self.store.exists(MON_COLL, PAXOS_OID):
            return {}
        return self.store.omap_get(MON_COLL, PAXOS_OID)

    def load(self) -> dict:
        """Everything needed to rejoin: see module docstring."""
        omap = self._load_omap()

        def u64(key: str, default: int = 0) -> int:
            raw = omap.get(key)
            return struct.unpack("<Q", raw)[0] if raw else default

        values = {
            int(k[2:]): v for k, v in omap.items() if k.startswith("v.")
        }
        unc = None
        raw = omap.get("uncommitted")
        if raw:
            uv, upn = struct.unpack_from("<QQ", raw)
            unc = (uv, upn, bytes(raw[16:]))
        snap = None
        if "snap.blob" in omap:
            snap = (u64("snap.version"), omap["snap.blob"])
        return {
            "election_epoch": u64("election_epoch", 1),
            "accepted_pn": u64("pn.accepted"),
            "last_pn": u64("pn.last"),
            "last_committed": u64("last_committed"),
            "first_committed": u64("first_committed"),
            "values": values,
            "uncommitted": unc,
            "snapshot": snap,
        }

"""FileStore: a durable ObjectStore (WAL + checkpoint).

The persistence rung between MemStore and a BlueStore-grade engine
(reference src/os/: BlueStore journals small writes through a RocksDB
WAL and checkpoints into its block allocation; the old FileStore
journaled whole transactions).  Same shape here, sized for the
mini-cluster:

- state lives in RAM (a MemStore) for reads and validation;
- every transaction is denc-encoded, crc32c-framed, appended to
  ``wal.log`` and flushed+fsynced BEFORE it is applied — a transaction
  is durable exactly when queue_transaction returns (the reference's
  writeahead contract);
- ``mount()`` replays the checkpoint then the WAL, ignoring a torn
  tail record (crash mid-append);
- when the WAL exceeds ``checkpoint_bytes`` the full state is written
  to ``checkpoint.new``, atomically renamed, and the WAL truncated.
"""

from __future__ import annotations

import os
import struct
import threading

from ceph_tpu_torch.msg.denc import Decoder, Encoder, EncodingError
from ceph_tpu_torch.native import crc32c
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.objectstore import (
    ObjectStore,
    Transaction,
    TxOp,
    coll_t,
    ghobject_t,
)

_MAGIC = 0xC397


def _enc_coll(enc: Encoder, c: coll_t) -> None:
    enc.i64(c.pool)
    enc.u32(c.ps)
    enc.i32(c.shard)


def _dec_coll(dec: Decoder) -> coll_t:
    return coll_t(dec.i64(), dec.u32(), dec.i32())


def _enc_obj(enc: Encoder, o: ghobject_t) -> None:
    enc.str_(o.name)
    enc.i64(o.snap)
    enc.i64(o.gen)
    enc.i32(o.shard)


def _dec_obj(dec: Decoder) -> ghobject_t:
    return ghobject_t(dec.str_(), dec.i64(), dec.i64(), dec.i32())


def encode_txn(txn: Transaction) -> bytes:
    """ObjectStore::Transaction encode (reference Transaction.h
    ENCODE_START over the op list)."""
    enc = Encoder()
    with enc.versioned(1, 1):
        enc.u32(len(txn.ops))
        for op in txn.ops:
            kind = op[0]
            enc.str_(kind.value)
            if kind in (TxOp.MKCOLL, TxOp.RMCOLL):
                _enc_coll(enc, op[1])
            elif kind == TxOp.COLL_MOVE_RENAME:
                _enc_coll(enc, op[1])
                _enc_obj(enc, op[2])
                _enc_coll(enc, op[3])
                _enc_obj(enc, op[4])
            else:
                _enc_coll(enc, op[1])
                _enc_obj(enc, op[2])
                if kind == TxOp.WRITE:
                    enc.u64(op[3])
                    enc.bytes_(op[4])
                elif kind == TxOp.ZERO:
                    enc.u64(op[3])
                    enc.u64(op[4])
                elif kind == TxOp.TRUNCATE:
                    enc.u64(op[3])
                elif kind in (TxOp.SETATTRS, TxOp.OMAP_SETKEYS):
                    enc.u32(len(op[3]))
                    for k in sorted(op[3]):
                        enc.str_(k)
                        enc.bytes_(op[3][k])
                elif kind == TxOp.RMATTR:
                    enc.str_(op[3])
                elif kind == TxOp.OMAP_RMKEYS:
                    enc.u32(len(op[3]))
                    for k in op[3]:
                        enc.str_(k)
                elif kind == TxOp.CLONE:
                    _enc_obj(enc, op[3])
    return enc.bytes()


def decode_txn(raw: bytes) -> Transaction:
    dec = Decoder(raw)
    txn = Transaction()
    with dec.versioned():
        for _ in range(dec.u32()):
            kind = TxOp(dec.str_())
            if kind in (TxOp.MKCOLL, TxOp.RMCOLL):
                txn.ops.append((kind, _dec_coll(dec)))
                continue
            if kind == TxOp.COLL_MOVE_RENAME:
                txn.ops.append((
                    kind, _dec_coll(dec), _dec_obj(dec),
                    _dec_coll(dec), _dec_obj(dec),
                ))
                continue
            c = _dec_coll(dec)
            o = _dec_obj(dec)
            if kind == TxOp.WRITE:
                txn.ops.append((kind, c, o, dec.u64(), dec.bytes_()))
            elif kind == TxOp.ZERO:
                txn.ops.append((kind, c, o, dec.u64(), dec.u64()))
            elif kind == TxOp.TRUNCATE:
                txn.ops.append((kind, c, o, dec.u64()))
            elif kind in (TxOp.SETATTRS, TxOp.OMAP_SETKEYS):
                kv = {dec.str_(): dec.bytes_() for _ in range(dec.u32())}
                txn.ops.append((kind, c, o, kv))
            elif kind == TxOp.RMATTR:
                txn.ops.append((kind, c, o, dec.str_()))
            elif kind == TxOp.OMAP_RMKEYS:
                txn.ops.append((kind, c, o, [dec.str_() for _ in range(dec.u32())]))
            elif kind == TxOp.CLONE:
                txn.ops.append((kind, c, o, _dec_obj(dec)))
            else:
                txn.ops.append((kind, c, o))
    return txn


def _snapshot(mem: MemStore) -> bytes:
    """Full-state checkpoint: one big synthetic transaction."""
    txn = Transaction()
    for c in mem.list_collections():
        txn.create_collection(c)
        for o in mem.collection_list(c):
            data = mem.read(c, o)
            if data:
                txn.write(c, o, 0, data)
            else:
                txn.touch(c, o)
            attrs = mem.getattrs(c, o)
            if attrs:
                txn.setattrs(c, o, attrs)
            omap = mem.omap_get(c, o)
            if omap:
                txn.omap_setkeys(c, o, omap)
    return encode_txn(txn)


class FileStore(ObjectStore):
    def __init__(self, path: str, checkpoint_bytes: int = 64 * 1024 * 1024):
        self.path = path
        self.checkpoint_bytes = checkpoint_bytes
        self._mem = MemStore()
        self._wal = None
        self._wal_size = 0
        # commits may arrive from worker threads (asyncio.to_thread):
        # validate+journal+apply must be one atomic sequence
        self._commit_lock = threading.Lock()

    # -- mount/replay --------------------------------------------------

    def statfs(self) -> dict:
        """Host-filesystem truth (the FileStore reported its backing
        fs the same way)."""
        st = os.statvfs(self.path)
        total = st.f_frsize * st.f_blocks
        avail = st.f_frsize * st.f_bavail
        return {
            "total": total,
            "used": max(0, total - avail),
            "available": avail,
        }

    def mount(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        cp = os.path.join(self.path, "checkpoint")
        if os.path.exists(cp):
            with open(cp, "rb") as f:
                self._mem.queue_transaction(decode_txn(f.read()))
        walfn = os.path.join(self.path, "wal.log")
        if os.path.exists(walfn):
            with open(walfn, "rb") as f:
                raw = f.read()
            off = 0
            while off + 10 <= len(raw):
                magic, ln = struct.unpack_from("<HI", raw, off)
                if magic != _MAGIC or off + 10 + ln > len(raw):
                    break  # torn tail: crash mid-append
                (crc,) = struct.unpack_from("<I", raw, off + 6)
                body = raw[off + 10 : off + 10 + ln]
                if crc32c(body) != crc:
                    break
                try:
                    self._mem.queue_transaction(decode_txn(body))
                except (EncodingError, OSError, ValueError):
                    break
                off += 10 + ln
            self._wal_size = off
        self._wal = open(walfn, "ab")
        if self._wal.tell() != self._wal_size:
            # drop the torn tail so new records append cleanly
            self._wal.truncate(self._wal_size)

    def umount(self) -> None:
        if self._wal is not None:
            self._checkpoint()
            self._wal.close()
            self._wal = None

    # -- transactions --------------------------------------------------

    #: daemons sharing an event loop should offload queue_transaction
    #: (it fsyncs); OSDDaemon checks this and uses asyncio.to_thread
    blocking_commit = True

    def queue_transaction(self, txn: Transaction) -> None:
        """validate -> journal (flush+fsync) -> apply to RAM.

        Ordering is the durability contract: nothing mutates (and no
        on_applied/on_commit callback fires) until the record is on
        stable storage, and a failed journal write leaves RAM exactly
        as-is — a later checkpoint can never persist a transaction the
        caller saw fail."""
        assert self._wal is not None, "FileStore not mounted"
        with self._commit_lock:
            self._mem.validate(txn)
            body = encode_txn(txn)
            rec = struct.pack("<HI", _MAGIC, len(body)) + struct.pack(
                "<I", crc32c(body)
            ) + body
            self._wal.write(rec)
            self._wal.flush()
            os.fsync(self._wal.fileno())
            self._mem.queue_transaction(txn)
            self._wal_size += len(rec)
            if self._wal_size > self.checkpoint_bytes:
                self._checkpoint()

    def _checkpoint(self) -> None:
        cp = os.path.join(self.path, "checkpoint")
        tmp = cp + ".new"
        with open(tmp, "wb") as f:
            f.write(_snapshot(self._mem))
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, cp)
        # the rename must be durable BEFORE the WAL shrinks, or a crash
        # could surface the OLD checkpoint beside an empty WAL — losing
        # acked transactions; fsync the directory to order them
        dirfd = os.open(self.path, os.O_RDONLY)
        try:
            os.fsync(dirfd)
        finally:
            os.close(dirfd)
        self._wal.truncate(0)
        self._wal.seek(0)
        os.fsync(self._wal.fileno())
        self._wal_size = 0

    # -- reads: delegate to the RAM state ------------------------------

    def read(self, c, o, off=0, length=None):
        return self._mem.read(c, o, off, length)

    def stat(self, c, o):
        return self._mem.stat(c, o)

    def exists(self, c, o):
        return self._mem.exists(c, o)

    def getattr(self, c, o, name):
        return self._mem.getattr(c, o, name)

    def getattrs(self, c, o):
        return self._mem.getattrs(c, o)

    def omap_get(self, c, o):
        return self._mem.omap_get(c, o)

    def omap_get_values(self, c, o, keys):
        return self._mem.omap_get_values(c, o, keys)

    def list_collections(self):
        return self._mem.list_collections()

    def collection_exists(self, c):
        return self._mem.collection_exists(c)

    def collection_list(self, c):
        return self._mem.collection_list(c)

"""Cross-mount parity of the stores: a directory written by one package
mounts in the other and reads the same.

``FileDB``, ``KStore`` (on a FileDB), ``FileStore`` and ``BlockStore``
(first-fit and bitmap allocators, with and without zlib compression at
rest, on BlueFS and on a FileDB) are filled by ``ceph_tpu`` or by
``ceph_tpu_torch`` with one workload made from a seed with numpy
(inline and multi-unit writes, overwrites, a COW clone written after,
zero, truncate, xattrs, omap, a remove and a collection move), unmounted,
and mounted by the other package: listings, data, xattrs, omap and
``fsck()`` are equal; the reader then writes more and the writer's
package mounts it again.  The same workload written by each package
leaves byte-identical directories (tolerance 0).  A ``PGLog`` appended,
trimmed and split by one package into a ``BlockStore`` on a ``FileDB``
loads in the other's ``PGLog`` with the same entries, info and
contiguity floor, both ways.
"""

from __future__ import annotations

import json
import os
import types

import numpy as np
import pytest

import ceph_tpu.kv as ref_kv
import ceph_tpu.osd.pglog as ref_pglog
import ceph_tpu.store.blockstore as ref_blockstore
import ceph_tpu.store.filestore as ref_filestore
import ceph_tpu.store.kstore as ref_kstore
import ceph_tpu.store.objectstore as ref_objectstore
import ceph_tpu_torch.kv as kv
import ceph_tpu_torch.osd.pglog as pglog
import ceph_tpu_torch.store.blockstore as blockstore
import ceph_tpu_torch.store.filestore as filestore
import ceph_tpu_torch.store.kstore as kstore
import ceph_tpu_torch.store.objectstore as objectstore
from tests.xla_private import _private_xla_compiles  # noqa: F401

PKGS = {
    "ceph_tpu": types.SimpleNamespace(kv=ref_kv, os=ref_objectstore, kstore=ref_kstore,
                                      filestore=ref_filestore, blockstore=ref_blockstore,
                                      pglog=ref_pglog),
    "ceph_tpu_torch": types.SimpleNamespace(kv=kv, os=objectstore, kstore=kstore,
                                            filestore=filestore, blockstore=blockstore,
                                            pglog=pglog),
}
DIRECTIONS = [("ceph_tpu", "ceph_tpu_torch"), ("ceph_tpu_torch", "ceph_tpu")]


def _open(pkg, kind: str, path: str):
    """A mounted store of ``kind`` at ``path`` from package ``pkg``."""
    if kind == "filedb":
        store = pkg.kv.FileDB(path)
    elif kind == "kstore":
        store = pkg.kstore.KStore(pkg.kv.FileDB(path))
    elif kind == "filestore":
        store = pkg.filestore.FileStore(path)
    else:
        _, alloc, comp, db = kind.split(":")
        store = pkg.blockstore.BlockStore(
            path, allocator=alloc, compression=comp,
            db=pkg.kv.FileDB(os.path.join(path, "kv")) if db == "filedb" else None)
    store.mount()
    return store


OBJECT_STORES = ["kstore", "filestore", "blockstore:first-fit:none:bluefs",
                 "blockstore:bitmap:none:bluefs", "blockstore:first-fit:zlib:bluefs",
                 "blockstore:bitmap:zlib:bluefs", "blockstore:first-fit:none:filedb"]
KINDS = ["filedb", *OBJECT_STORES]


def _payload(rng: np.random.Generator, n: int) -> bytes:
    """Half random, half a repeated pattern: compressible past the
    compression gate."""
    rand = rng.integers(0, 256, n // 2, dtype=np.uint8).tobytes()
    return rand + (b"ceph" * (n // 8 + 1))[: n - len(rand)]


def _workload(pkg, store, rng: np.random.Generator, round_: int) -> None:
    """Transactions of every kind the OSD issues, from ``rng``."""
    T, C, O = pkg.os.Transaction, pkg.os.coll_t, pkg.os.ghobject_t
    c1, c2 = C(1, 2 * round_, 2), C(1, 2 * round_ + 1, 2)
    objs = [O(f"obj{round_}.{i}", shard=2) for i in range(5)]
    clone = O(f"obj{round_}.0", snap=int(rng.integers(1, 1000)), shard=2)
    store.queue_transaction(T().create_collection(c1).create_collection(c2))
    sizes = (1000, 3 * 65536 + 123, 70000, 4096, 200000)
    t = T()
    for o, n in zip(objs, sizes):
        t.write(c1, o, 0, _payload(rng, n))
        t.setattrs(c1, o, {"hinfo": _payload(rng, 40), "_v": bytes([round_, n % 256])})
    store.queue_transaction(t)
    store.queue_transaction(T().omap_setkeys(
        c1, objs[1], {f"k{i:03d}": _payload(rng, int(rng.integers(1, 90))) for i in range(12)}))
    store.queue_transaction(T().write(c1, objs[1], 5000, _payload(rng, 10000)))
    store.queue_transaction(T().clone(c1, objs[1], clone))
    store.queue_transaction(T().write(c1, clone, 65536 - 7, _payload(rng, 300)))
    store.queue_transaction(T().zero(c1, objs[2], 100, 5000).truncate(c1, objs[2], 65000))
    store.queue_transaction(T().omap_rmkeys(c1, objs[1], ["k003", "k007"])
                            .rmattr(c1, objs[0], "_v").omap_clear(c1, objs[3]))
    store.queue_transaction(T().remove(c1, objs[3]))
    store.queue_transaction(T().collection_move_rename(c1, objs[4], c2, objs[4]))


def _snapshot(store) -> dict:
    """Listings, data, xattrs and omap as plain tuples (either package)."""
    out = {}
    for c in store.list_collections():
        objs = {}
        for o in store.collection_list(c):
            objs[(o.name, o.snap, o.gen, o.shard)] = (
                store.read(c, o), store.getattrs(c, o), store.omap_get(c, o), store.stat(c, o))
        out[(c.pool, c.ps, c.shard)] = objs
    return out


def _db_batches(pkg, db, rng: np.random.Generator, round_: int) -> None:
    for i in range(6):
        b = pkg.kv.WriteBatch()
        for j in range(int(rng.integers(4, 20))):
            b.set("OC"[j % 2], f"r{round_}.{i}.{j:03d}", _payload(rng, int(rng.integers(1, 700))))
        if i % 3 == 2:
            b.rmkey("O", f"r{round_}.{i - 1}.000").rm_range("C", f"r{round_}.0.", f"r{round_}.0.~")
        db.submit(b)


def _db_snapshot(db) -> dict:
    out = {}
    for prefix in db.prefixes():
        it, rows = db.get_iterator(prefix).seek_to_first(), []
        while it.valid():
            rows.append((it.key(), it.value()))
            it.next()
        out[prefix] = rows
    return out


def _fill(pkg, kind: str, store, rng, round_: int) -> dict:
    if kind == "filedb":
        _db_batches(pkg, store, rng, round_)
        return _db_snapshot(store)
    _workload(pkg, store, rng, round_)
    return _snapshot(store)


def _read(kind: str, store) -> dict:
    return _db_snapshot(store) if kind == "filedb" else _snapshot(store)


def _fsck(store):
    return store.fsck() if hasattr(store, "fsck") else None


def _blobs(store) -> list[str]:
    """A BlockStore's blob ids in its extent maps (shared ones repeated)."""
    it, out = store.db.get_iterator("O").seek_to_first(), []
    while it.valid():
        out += [blob for _, blob, _ in json.loads(it.value()).get("extents", [])]
        it.next()
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
@pytest.mark.parametrize("kind", KINDS)
def test_cross_mount(tmp_path, kind, writer, reader):
    path = str(tmp_path / "store")
    rng = np.random.default_rng([KINDS.index(kind), DIRECTIONS.index((writer, reader))])
    first = _open(PKGS[writer], kind, path)
    want = _fill(PKGS[writer], kind, first, rng, 0)
    assert want and _fsck(first) in (None, [])
    if kind.startswith("blockstore"):
        blobs = _blobs(first)
        # the clone shares blobs at rest; zlib stores some compressed
        assert len(set(blobs)) < len(blobs)
        assert any(":zlib:" in b for b in blobs) == (":zlib:" in kind)
    first.umount()

    second = _open(PKGS[reader], kind, path)
    assert _read(kind, second) == want
    assert _fsck(second) in (None, [])
    # the reader writes on, and the writer's package mounts that
    want = _fill(PKGS[reader], kind, second, rng, 1)
    second.umount()
    third = _open(PKGS[writer], kind, path)
    assert _read(kind, third) == want
    assert _fsck(third) in (None, [])
    third.umount()


def _tree(root: str) -> dict[str, bytes]:
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("kind", KINDS)
def test_same_workload_same_bytes_on_disk(tmp_path, kind):
    trees = {}
    for name, pkg in PKGS.items():
        path = str(tmp_path / name)
        store = _open(pkg, kind, path)
        rng = np.random.default_rng(7)
        _fill(pkg, kind, store, rng, 0)
        # a checkpoint and a WAL tail after it
        store.umount()
        store = _open(pkg, kind, path)
        _fill(pkg, kind, store, rng, 1)
        store.umount()
        trees[name] = _tree(path)
    ours, ref = trees["ceph_tpu_torch"], trees["ceph_tpu"]
    assert sorted(ours) == sorted(ref) and ours
    differing = {f: int((np.frombuffer(ours[f], np.uint8) != np.frombuffer(ref[f], np.uint8)).sum())
                 if len(ours[f]) == len(ref[f]) else abs(len(ours[f]) - len(ref[f])) for f in ref}
    assert differing == dict.fromkeys(ref, 0)


PGLOG_STORE = "blockstore:first-fit:none:filedb"


def _pglog_round(pkg, store, rng: np.random.Generator, round_: int) -> None:
    """Appends with a skipped counter (the floor pins), a trim and a
    split of shard 0's log into a child PG, from ``rng``; logs are
    loaded from the store first, as the OSD loads them."""
    P, T, C = pkg.pglog, pkg.os.Transaction, pkg.os.coll_t
    for shard in (0, 1):
        c = C(3, 5, shard)
        if not store.collection_exists(c):
            store.queue_transaction(T().create_collection(c))
        lg = P.PGLog(c)
        lg.load(store)
        v = lg.info.last_update.version
        for i in range(int(rng.integers(10, 30))):
            v += int(rng.choice([1, 1, 1, 2]))
            t = T()
            lg.append(t, P.pg_log_entry_t(int(rng.choice([P.MODIFY, P.DELETE])),
                                          f"rbd_data.{int(rng.integers(0, 40)):04x}",
                                          P.eversion_t(7 + round_, v),
                                          P.eversion_t(7, max(v - 1, 0)),
                                          f"client.{round_}:{shard}.{i}"))
            store.queue_transaction(t)
        t = T()
        lg.trim(t, int(rng.integers(6, 12)))
        store.queue_transaction(t)
        if shard == 0:
            child_c = C(3, 5 + 32 * (round_ + 1), 0)
            store.queue_transaction(T().create_collection(child_c))
            t = T()
            lg.split_into(t, P.PGLog(child_c), lambda oid: int(oid[-1], 16) % 2 == 1)
            store.queue_transaction(t)


def _pglog_snapshot(pkg, store) -> dict:
    """Every collection's log as loaded: entries, info, floor (plain tuples)."""
    def ev(v):
        return None if v is None else (v.epoch, v.version)

    out = {}
    for c in store.list_collections():
        lg = pkg.pglog.PGLog(c)
        lg.load(store)
        out[(c.pool, c.ps, c.shard)] = (
            [(e.op, e.oid, ev(e.version), ev(e.prior_version), e.reqid)
             for _, e in sorted(lg.entries.items())],
            ev(lg.info.last_update), ev(lg.info.log_tail), ev(lg.contig_floor))
    return out


@pytest.mark.parametrize("writer,reader", DIRECTIONS)
def test_pglog_cross_mount(tmp_path, writer, reader):
    path = str(tmp_path / "store")
    rng = np.random.default_rng([len(KINDS), DIRECTIONS.index((writer, reader))])
    first = _open(PKGS[writer], PGLOG_STORE, path)
    _pglog_round(PKGS[writer], first, rng, 0)
    want = _pglog_snapshot(PKGS[writer], first)
    assert len(want) == 3 and all(entries for entries, *_ in want.values())
    assert any(floor is not None for *_, floor in want.values())
    first.umount()

    second = _open(PKGS[reader], PGLOG_STORE, path)
    assert _pglog_snapshot(PKGS[reader], second) == want
    assert second.fsck() == []
    # the reader's package appends on, and the writer's loads that
    _pglog_round(PKGS[reader], second, rng, 1)
    want = _pglog_snapshot(PKGS[reader], second)
    second.umount()
    third = _open(PKGS[writer], PGLOG_STORE, path)
    assert _pglog_snapshot(PKGS[writer], third) == want and len(want) == 4
    assert third.fsck() == []
    third.umount()

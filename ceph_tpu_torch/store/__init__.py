"""Local storage engines (reference src/os/): the ObjectStore
transaction seam and the in-RAM MemStore used by tests and the
mini-cluster OSD.

The port's twin of ceph_tpu/store/: KStore, FileStore, BlockStore and
BlueFS write the JAX package's bytes (FileStore's journal, BlockStore's
block file, blob names and per-blob crc32c, BlueFS's superblock, and
the FileDB under them), so a directory written by one package mounts
in the other and reads the same."""

from ceph_tpu_torch.store.filestore import FileStore
from ceph_tpu_torch.store.memstore import MemStore
from ceph_tpu_torch.store.objectstore import (
    META_COLL,
    ObjectStore,
    Transaction,
    TxOp,
    coll_t,
    ghobject_t,
)

__all__ = [
    "FileStore",
    "META_COLL",
    "MemStore",
    "ObjectStore",
    "Transaction",
    "TxOp",
    "coll_t",
    "ghobject_t",
]

"""CephFS-lite: single-MDS filesystem on RADOS.

The reference's file service (src/mds/ 92 kLoC + src/client/ 29 kLoC)
reduced to its load-bearing shape: dirfrag omaps + journaled metadata
mutations on the MDS (:mod:`mds`, :mod:`journal`), striped direct
data I/O on the client (:mod:`client`).

Counterpart of ``ceph_tpu/fs/__init__.py``: the same names, wire bytes and
stored bytes; host code, whose I/O reaches the card only through the
OSDs under it.
"""

from .client import File, FSClient  # noqa: F401
from .mds import FSError, MDSDaemon  # noqa: F401

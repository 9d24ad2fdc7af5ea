"""Shared PG-layer constants and helpers.

Counterpart of ``ceph_tpu/osd/pgutil.py``: the constants, extent reads,
``ECFetchError``, the ``_v`` object-version attribute and
``object_to_pg`` (object name -> PG through the rjenkins name hash)
that the PGBackend seams (EC backend, recovery, scrub, tiering) share,
the way the reference splits PGBackend.h / ECBackend.cc /
PrimaryLogPG.cc / scrubber/.  ``osd.daemon`` re-exports them.
"""

from __future__ import annotations

import asyncio
import errno

from ceph_tpu_torch.ops.hashing import ceph_str_hash_rjenkins
from ceph_tpu_torch.osd.pglog import ZERO, eversion_t
from ceph_tpu_torch.osd.types import PgPool, pg_t

NO_SHARD = -1
STRIPE_UNIT = 4096  # logical bytes per data chunk per stripe
SUBOP_TIMEOUT = 30.0

SIZE_ATTR = "_size"
HINFO_ATTR = "hinfo"
VERSION_ATTR = "_v"  # object_info version (oi attr analogue)
USER_XATTR_PREFIX = "u_"  # client xattrs, namespaced off internal attrs

#: snap id of the per-shard ROLLBACK SIDECAR object (the reference
#: ECTransaction's roll-backward info): every versioned EC shard
#: overwrite first clones the pre-write state here, so a partial
#: fan-out can RESTORE a member to the previous version instead of
#: wedging the pg.  Far above any real snap id, below NOSNAP, and
#: within int64 (durable stores encode ghobject snaps as i64).
RB_SNAP = 0x7FFFFFFFFFFFFF00

ECConnErrors = (ConnectionError, asyncio.TimeoutError)


def _read_extents(store, c, o, extents) -> bytes:
    """Serve a multi-run ranged read from ONE covering store read:
    checksummed engines (BlockStore) verify each blob once instead of
    once per run — CLAY sub-chunk repairs issue many runs per chunk."""
    lo = min(eo for eo, _ln in extents)
    hi = max(eo + ln for eo, ln in extents)
    span = bytes(store.read(c, o, lo, hi - lo))
    # per-run slices clamp at the object size exactly like the
    # individual reads they replace (no padding)
    return b"".join(span[eo - lo : eo - lo + ln] for eo, ln in extents)


class ECFetchError(Exception):
    """A version-consistent EC fetch could not complete."""

    def __init__(self, eno: int):
        super().__init__(errno.errorcode.get(eno, str(eno)))
        self.errno = eno


def _v_bytes(v: eversion_t) -> bytes:
    return v.key().encode()


def _v_parse(raw: bytes | None) -> eversion_t:
    if not raw:
        return ZERO
    e, v = raw.decode().split(".")
    return eversion_t(int(e), int(v))


def object_to_pg(pool: PgPool, oid: str) -> pg_t:
    """object_locator_to_pg (src/osd/osd_types.cc): name hash -> raw pg
    (the mapping pipeline folds it into pg_num)."""
    return pg_t(pool.id, int(ceph_str_hash_rjenkins(oid)))

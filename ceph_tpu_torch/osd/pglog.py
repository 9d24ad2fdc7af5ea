"""Per-PG operation log: versions, missing sets, delta recovery.

Behavioral twin of the reference's log-based consistency core
(src/osd/PGLog.{h,cc}, src/osd/osd_types.h pg_log_entry_t /
eversion_t / pg_missing_t; doc/dev/osd_internals/log_based_pg.rst):
every write the primary orders gets an eversion (epoch, seq); the
entry is persisted by every acting member in the same transaction as
the data; after a map change peers compare ``last_update`` and the
primary computes per-peer missing sets from the log delta — full
backfill only when a peer's state predates the log tail.

The log lives in the PG meta object's omap (reference: pg log keys in
the pgmeta object), one key per entry, plus an ``info`` key carrying
pg_info (last_update, log_tail).
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field

from ceph_tpu_torch.msg.denc import Decoder, Encoder
from ceph_tpu_torch.store import ObjectStore, Transaction, coll_t, ghobject_t

PGMETA_OID = "_pgmeta_"
INFO_KEY = "info"
LOG_KEY_PREFIX = "log."
FLOOR_KEY = "contig_floor"

MODIFY = 1
DELETE = 2


@dataclass(frozen=True, order=True)
class eversion_t:
    """(epoch, version) — reference src/osd/osd_types.h eversion_t;
    totally ordered, (0, 0) is 'nothing'."""

    epoch: int = 0
    version: int = 0

    def key(self) -> str:
        # zero-padded so omap string order == version order
        return f"{self.epoch:010d}.{self.version:012d}"

    def __str__(self) -> str:
        return f"{self.epoch}'{self.version}"


ZERO = eversion_t(0, 0)


@dataclass(frozen=True)
class pg_log_entry_t:
    """One ordered op (reference pg_log_entry_t: op, soid, version,
    prior_version, reqid — the reqid feeds duplicate-op detection so a
    client resend of a non-idempotent op is answered, not re-applied)."""

    op: int
    oid: str
    version: eversion_t
    prior_version: eversion_t = ZERO
    reqid: str = ""

    def encode(self) -> bytes:
        enc = Encoder()
        with enc.versioned(2, 1):
            enc.u8(self.op)
            enc.str_(self.oid)
            enc.u32(self.version.epoch)
            enc.u64(self.version.version)
            enc.u32(self.prior_version.epoch)
            enc.u64(self.prior_version.version)
            enc.str_(self.reqid)
        return enc.bytes()

    @classmethod
    def decode(cls, raw: bytes) -> "pg_log_entry_t":
        dec = Decoder(raw)
        with dec.versioned() as v:
            op = dec.u8()
            oid = dec.str_()
            ver = eversion_t(dec.u32(), dec.u64())
            pv = eversion_t(dec.u32(), dec.u64())
            reqid = dec.str_() if v >= 2 else ""
        return cls(op, oid, ver, pv, reqid)


@dataclass
class pg_info_t:
    """The slice of reference pg_info_t peering compares."""

    last_update: eversion_t = ZERO
    log_tail: eversion_t = ZERO

    def encode(self) -> bytes:
        enc = Encoder()
        with enc.versioned(1, 1):
            enc.u32(self.last_update.epoch)
            enc.u64(self.last_update.version)
            enc.u32(self.log_tail.epoch)
            enc.u64(self.log_tail.version)
        return enc.bytes()

    @classmethod
    def decode(cls, raw: bytes) -> "pg_info_t":
        dec = Decoder(raw)
        with dec.versioned():
            lu = eversion_t(dec.u32(), dec.u64())
            lt = eversion_t(dec.u32(), dec.u64())
        return cls(lu, lt)


@dataclass
class MissingSet:
    """oid -> (need, have): versions a peer must recover
    (reference pg_missing_t)."""

    items: dict[str, tuple[eversion_t, eversion_t]] = field(default_factory=dict)

    def add(self, oid: str, need: eversion_t, have: eversion_t = ZERO) -> None:
        prev = self.items.get(oid)
        if prev is None or need > prev[0]:
            have = prev[1] if prev is not None else have
            self.items[oid] = (need, have)

    def __bool__(self) -> bool:
        return bool(self.items)

    def __len__(self) -> int:
        return len(self.items)


class PGLog:
    """In-memory log + its persistence into the pgmeta omap."""

    #: duplicate-detection window kept past trim (the reference's
    #: osd_pg_log_dups_tracked analogue)
    REQID_WINDOW = 2000

    def __init__(self, cid: coll_t):
        self.cid = cid
        self.meta = ghobject_t(PGMETA_OID, shard=cid.shard)
        self.info = pg_info_t()
        self.entries: dict[eversion_t, pg_log_entry_t] = {}
        # reqid -> version of already-applied client ops; survives log
        # trim in RAM (rebuilt from surviving entries on load, so the
        # window shrinks to the log length across a restart — the same
        # bounded-dup contract the reference's dups list provides)
        self.reqids: "OrderedDict[str, eversion_t]" = OrderedDict()
        # highest version counter handed out by _next_version but not
        # yet appended (IN-MEMORY: an in-flight mint dies with the
        # daemon and its counter is simply skipped — a detectable gap).
        # Without the reservation, two concurrent ops to DIFFERENT
        # objects both read last_update before either append lands
        # (the fan-out round-trip sits in between) and mint the SAME
        # eversion — the loser's log entry is silently swallowed by
        # the winner's, leaving its object with no log evidence
        # (chaos x load composition-found version-mint collision).
        self.reserved_version: eversion_t = ZERO
        # contiguity floor (PERSISTED): the last_update this log held
        # when a NON-CONTIGUOUS entry was first appended (pg version
        # counters are dense, so a skipped counter means ops this
        # member never saw — a member revived mid-traffic starts
        # applying new sub-ops and its last_update leapfrogs the
        # missed window).  While set, last_update must NOT be trusted
        # as "has everything up to here": peering scopes this member
        # from the floor instead.  None = contiguous (normal).
        self.contig_floor: eversion_t | None = None

    # -- mutation ------------------------------------------------------

    def _track_reqid(self, entry: pg_log_entry_t) -> None:
        if entry.reqid:
            self.reqids[entry.reqid] = entry.version
            self.reqids.move_to_end(entry.reqid)
            while len(self.reqids) > self.REQID_WINDOW:
                self.reqids.popitem(last=False)

    def append(self, t: Transaction, entry: pg_log_entry_t) -> None:
        """Record one op; caller folds ``t`` into the data transaction
        so log and data commit atomically.

        A non-contiguous append (version counter skips — this member
        missed ops while the pg moved on) pins the contiguity floor at
        the pre-append last_update: the missed window's entries will
        never arrive (appends are forward-only), so last_update alone
        would silently vouch for state this member does not hold —
        the stale-shard scrub flake's root mechanism."""
        assert entry.version > self.info.last_update, (
            entry.version, self.info.last_update,
        )
        kv = {
            LOG_KEY_PREFIX + entry.version.key(): entry.encode(),
        }
        if (entry.version.version > self.info.last_update.version + 1
                and self.contig_floor is None):
            self.contig_floor = self.info.last_update
            kv[FLOOR_KEY] = self.contig_floor.key().encode()
        self.entries[entry.version] = entry
        self.info.last_update = entry.version
        self._track_reqid(entry)
        kv[INFO_KEY] = self.info.encode()
        t.touch(self.cid, self.meta)
        t.omap_setkeys(self.cid, self.meta, kv)

    def fill(self, t: Transaction, entry: pg_log_entry_t) -> None:
        """Insert a history entry a gapped log missed (post-recovery
        log sync): unlike append, versions at or below last_update
        are accepted — they fill CONTENT holes, so if this member is
        ever primary its missing_from() computations see the whole
        history instead of silently skipping the window it missed."""
        if entry.version in self.entries:
            return
        self.entries[entry.version] = entry
        self._track_reqid(entry)
        kv = {LOG_KEY_PREFIX + entry.version.key(): entry.encode()}
        if entry.version > self.info.last_update:
            self.info.last_update = entry.version
            kv[INFO_KEY] = self.info.encode()
        t.touch(self.cid, self.meta)
        t.omap_setkeys(self.cid, self.meta, kv)

    def effective_last_update(self) -> eversion_t:
        """What this log can VOUCH for: last_update, unless a
        contiguity gap pinned the floor lower."""
        if self.contig_floor is not None:
            return min(self.contig_floor, self.info.last_update)
        return self.info.last_update

    def clear_contig_floor(self, t: Transaction) -> None:
        """Primary-verified: every object through the gap was
        reconciled (a full recovery pass completed), so last_update
        may be trusted again."""
        if self.contig_floor is None:
            return
        self.contig_floor = None
        t.touch(self.cid, self.meta)
        t.omap_rmkeys(self.cid, self.meta, [FLOOR_KEY])

    def rollback_divergent(
        self, t: Transaction, oid: str, to: "eversion_t"
    ) -> None:
        """Drop this object's entries newer than ``to`` — the writes
        they recorded did not survive into the authoritative state
        (reference PGLog divergent-entry handling in merge_log /
        _merge_divergent_entries).  Their reqids must stop answering
        dup detection so a client retry re-applies the op.
        ``last_update`` is left alone: versions stay monotonic."""
        drop = [
            v for v, e in self.entries.items() if e.oid == oid and v > to
        ]
        for v in drop:
            e = self.entries.pop(v)
            if e.reqid:
                self.reqids.pop(e.reqid, None)
            t.touch(self.cid, self.meta)
            t.omap_rmkeys(self.cid, self.meta, [LOG_KEY_PREFIX + v.key()])

    def trim(self, t: Transaction, keep: int) -> None:
        """Drop oldest entries beyond ``keep`` (osd_min_pg_log_entries
        semantics); log_tail advances to the oldest kept version."""
        if len(self.entries) <= keep:
            return
        versions = sorted(self.entries)
        drop = versions[: len(versions) - keep]
        for v in drop:
            del self.entries[v]
        self.info.log_tail = drop[-1]
        t.touch(self.cid, self.meta)
        t.omap_rmkeys(
            self.cid, self.meta, [LOG_KEY_PREFIX + v.key() for v in drop]
        )
        t.omap_setkeys(self.cid, self.meta, {INFO_KEY: self.info.encode()})

    def set_tail(self, t: Transaction, tail: eversion_t) -> None:
        """Adopt a sender's log_tail after backfill: entries at or below
        it are dropped (the local log has a gap there)."""
        if tail <= self.info.log_tail:
            return
        drop = [v for v in self.entries if v <= tail]
        for v in drop:
            del self.entries[v]
        self.info.log_tail = tail
        if self.info.last_update < tail:
            self.info.last_update = tail
        t.touch(self.cid, self.meta)
        if drop:
            t.omap_rmkeys(
                self.cid, self.meta, [LOG_KEY_PREFIX + v.key() for v in drop]
            )
        t.omap_setkeys(self.cid, self.meta, {INFO_KEY: self.info.encode()})

    def adopt_tail(
        self,
        t: Transaction,
        tail: eversion_t,
        entries: "list[pg_log_entry_t] | tuple[pg_log_entry_t, ...]" = (),
        verified: bool = False,
    ) -> None:
        """Adopt an authoritative peer's (log_tail, entries-above-tail)
        after backfill — set_tail + fill as ONE step that keeps the
        log's evidence consistent:

        - dup detection: every adopted entry's reqid enters the window
          (via fill -> _track_reqid), so a client resend of an op this
          member ADOPTED rather than executed still dedups exactly-once;
        - contiguity: when adoption RAISES last_update past state this
          member never held (tail > pre-adoption last_update) and the
          transfer is not yet object-verified (``verified=False``), the
          contiguity floor pins at the pre-adoption effective
          last_update — otherwise an INTERRUPTED backfill leaves a log
          whose last_update silently vouches for the adopted window and
          the restart would wrongly take the cheap log-delta path.
          ``verified=True`` (the sender reconciled every object through
          the window) clears the floor instead."""
        pre_eff = self.effective_last_update()
        gapped = tail > self.info.last_update
        self.set_tail(t, tail)
        for e in entries:
            if e.version > tail:
                self.fill(t, e)
        if verified:
            self.clear_contig_floor(t)
        elif gapped and self.contig_floor is None:
            self.contig_floor = pre_eff
            t.touch(self.cid, self.meta)
            t.omap_setkeys(
                self.cid, self.meta, {FLOOR_KEY: pre_eff.key().encode()}
            )

    def split_into(self, t: Transaction, child: "PGLog", belongs) -> None:
        """PGLog::split_into twin (reference src/osd/PGLog.h split_into,
        called from PG::split_into on pg_num growth): entries whose
        object now folds into the child pg MOVE to the child's log;
        BOTH logs keep the parent's version bounds (last_update /
        log_tail continue the parent's eversion sequence), so
        post-split authority comparisons between members remain
        meaningful — without this, children born with empty logs make
        an empty member look authoritative and refiled objects get
        reaped as strays."""
        moved = [e for e in self.entries.values() if belongs(e.oid)]
        child.info.last_update = self.info.last_update
        child.info.log_tail = self.info.log_tail
        t.touch(child.cid, child.meta)
        kv = {INFO_KEY: child.info.encode()}
        for e in moved:
            child.entries[e.version] = e
            child._track_reqid(e)
            kv[LOG_KEY_PREFIX + e.version.key()] = e.encode()
        t.omap_setkeys(child.cid, child.meta, kv)
        if moved:
            for e in moved:
                del self.entries[e.version]
            t.touch(self.cid, self.meta)
            t.omap_rmkeys(self.cid, self.meta, [
                LOG_KEY_PREFIX + e.version.key() for e in moved
            ])
        t.omap_setkeys(self.cid, self.meta, {INFO_KEY: self.info.encode()})

    def merge_from(self, t: Transaction, child: "PGLog") -> None:
        """PG::merge_from twin (reference src/osd/PG.cc:563, called on
        pg_num shrink): the dissolving child pg's log folds into this
        (target) log.  Entries move wholesale; version bounds take the
        elementwise max so neither side's completeness claim widens —
        a peer whose state predates the merged tail must backfill,
        matching the reference's conservative stance on merge (it
        forces backfill when either side's history is short).  The
        child's on-disk meta dies with its collection in the same
        transaction (caller removes it).

        Version keys can COLLIDE across the two logs: child and target
        ran independent per-PG version counters, so the same
        (epoch, version) may name different ops in each.  Folding a
        colliding child entry in directly would silently overwrite the
        target's entry and its omap record — losing a log entry AND
        its reqid dedup vouch.  On collision, the child's entries are
        rewritten into a disjoint version range just past both logs'
        heads (order preserved, reqids intact); the rewritten versions
        only feed peering deltas and dup detection, and the post-merge
        reconcile pass (merge_pending) re-verifies objects by their
        stored attrs, so authority is unaffected — the reference's
        don't-trust-merged-logs stance at entry granularity."""
        t.touch(self.cid, self.meta)
        kv: dict[str, bytes] = {}
        child_entries = [child.entries[v] for v in sorted(child.entries)]
        if any(e.version in self.entries for e in child_entries):
            base = max(self.info.last_update, child.info.last_update)
            remapped = []
            for i, e in enumerate(child_entries):
                nv = eversion_t(base.epoch, base.version + 1 + i)
                remapped.append(pg_log_entry_t(
                    e.op, e.oid, nv, e.prior_version, e.reqid))
            child_entries = remapped
        for e in child_entries:
            self.entries[e.version] = e
            self._track_reqid(e)
            kv[LOG_KEY_PREFIX + e.version.key()] = e.encode()
        if child_entries and child_entries[-1].version > self.info.last_update:
            self.info.last_update = child_entries[-1].version
        if child.info.last_update > self.info.last_update:
            self.info.last_update = child.info.last_update
        if child.info.log_tail > self.info.log_tail:
            self.info.log_tail = child.info.log_tail
        kv[INFO_KEY] = self.info.encode()
        t.omap_setkeys(self.cid, self.meta, kv)

    # -- persistence ---------------------------------------------------

    def load(self, store: ObjectStore) -> None:
        if not store.collection_exists(self.cid) or not store.exists(
            self.cid, self.meta
        ):
            return
        omap = store.omap_get(self.cid, self.meta)
        if INFO_KEY in omap:
            self.info = pg_info_t.decode(omap[INFO_KEY])
        if FLOOR_KEY in omap:
            try:
                ep, _, ver = omap[FLOOR_KEY].decode().partition(".")
                self.contig_floor = eversion_t(int(ep), int(ver))
            except ValueError:
                self.contig_floor = ZERO  # unreadable: trust nothing
        self.entries = {}
        for key, raw in omap.items():
            if key.startswith(LOG_KEY_PREFIX):
                e = pg_log_entry_t.decode(raw)
                self.entries[e.version] = e
        for v in sorted(self.entries):
            self._track_reqid(self.entries[v])

    # -- peering math --------------------------------------------------

    def entries_after(self, v: eversion_t) -> list[pg_log_entry_t]:
        return [self.entries[k] for k in sorted(self.entries) if k > v]

    def covers(self, v: eversion_t) -> bool:
        """True when the log can produce an exact delta from state
        ``v`` (v >= log_tail)."""
        return v >= self.info.log_tail

    def missing_from(self, peer_last_update: eversion_t) -> MissingSet | None:
        """Missing set for a peer at ``peer_last_update``; None means
        the log was trimmed past it and backfill is required
        (PGLog::proc_replica_log semantics, simplified: no divergent
        branches because the primary serializes all writes)."""
        if peer_last_update == self.info.last_update:
            return MissingSet()
        if not self.covers(peer_last_update):
            return None
        missing = MissingSet()
        latest: dict[str, pg_log_entry_t] = {}
        first: dict[str, pg_log_entry_t] = {}
        for e in self.entries_after(peer_last_update):
            latest[e.oid] = e
            first.setdefault(e.oid, e)
        for oid, e in latest.items():
            if e.op == DELETE:
                # deletion replays as a delete during recovery
                missing.add(oid, e.version)
            else:
                # ``have`` = the version the peer actually holds: the
                # prior_version of the FIRST entry past its last_update
                # (later entries' prior_versions are intermediates the
                # peer never saw)
                missing.add(oid, e.version, first[oid].prior_version)
        return missing

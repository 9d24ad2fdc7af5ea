"""PGLog unit tests (reference analogue: src/test/osd/TestPGLog.cc,
simplified to the primary-serialized model).

The port's twin of tests/test_pglog.py: the same cases over
``ceph_tpu_torch``.
"""

import pytest

from ceph_tpu_torch.osd.pglog import (
    DELETE,
    MODIFY,
    ZERO,
    MissingSet,
    PGLog,
    eversion_t,
    pg_info_t,
    pg_log_entry_t,
)
from ceph_tpu_torch.store import MemStore, Transaction, coll_t


def ev(e, v):
    return eversion_t(e, v)


@pytest.fixture
def store():
    s = MemStore()
    s.queue_transaction(Transaction().create_collection(C))
    return s


C = coll_t(1, 0, 0)


def applied(log, store, entry):
    t = Transaction()
    log.append(t, entry)
    store.queue_transaction(t)


class TestLog:
    def test_append_advances_info(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(MODIFY, "b", ev(1, 2), ev(1, 1)))
        assert log.info.last_update == ev(1, 2)
        assert log.info.log_tail == ZERO

    def test_append_rejects_stale_version(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(2, 5)))
        with pytest.raises(AssertionError):
            log.append(Transaction(), pg_log_entry_t(MODIFY, "b", ev(2, 5)))

    def test_persistence_roundtrip(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(DELETE, "a", ev(2, 2), ev(1, 1)))
        log2 = PGLog(C)
        log2.load(store)
        assert log2.info.last_update == ev(2, 2)
        assert sorted(log2.entries) == [ev(1, 1), ev(2, 2)]
        assert log2.entries[ev(2, 2)].op == DELETE
        assert log2.entries[ev(2, 2)].prior_version == ev(1, 1)

    def test_trim_moves_tail(self, store):
        log = PGLog(C)
        for i in range(1, 11):
            applied(log, store, pg_log_entry_t(MODIFY, f"o{i}", ev(1, i)))
        t = Transaction()
        log.trim(t, keep=3)
        store.queue_transaction(t)
        assert sorted(log.entries) == [ev(1, 8), ev(1, 9), ev(1, 10)]
        assert log.info.log_tail == ev(1, 7)
        # persisted state agrees
        log2 = PGLog(C)
        log2.load(store)
        assert sorted(log2.entries) == sorted(log.entries)
        assert log2.info.log_tail == ev(1, 7)

    def test_version_key_order_is_string_order(self):
        vs = [ev(1, 2), ev(1, 10), ev(2, 1), ev(10, 0)]
        keys = [v.key() for v in vs]
        assert keys == sorted(keys)


class TestMissing:
    def _log_with(self, store, n=5):
        log = PGLog(C)
        for i in range(1, n + 1):
            applied(log, store, pg_log_entry_t(MODIFY, f"o{i}", ev(1, i)))
        return log

    def test_up_to_date_peer_has_empty_missing(self, store):
        log = self._log_with(store)
        missing = log.missing_from(ev(1, 5))
        assert missing is not None and not missing

    def test_behind_peer_gets_delta(self, store):
        log = self._log_with(store)
        missing = log.missing_from(ev(1, 2))
        assert missing is not None
        assert sorted(missing.items) == ["o3", "o4", "o5"]
        assert missing.items["o3"][0] == ev(1, 3)

    def test_rewrites_collapse_to_latest(self, store):
        log = self._log_with(store, 3)
        applied(log, store, pg_log_entry_t(MODIFY, "o2", ev(1, 4), ev(1, 2)))
        missing = log.missing_from(ev(1, 1))
        assert missing.items["o2"][0] == ev(1, 4)

    def test_delete_is_replayed(self, store):
        log = self._log_with(store, 3)
        applied(log, store, pg_log_entry_t(DELETE, "o1", ev(1, 4), ev(1, 1)))
        missing = log.missing_from(ev(1, 3))
        assert list(missing.items) == ["o1"]

    def test_trimmed_past_peer_forces_backfill(self, store):
        log = self._log_with(store, 10)
        t = Transaction()
        log.trim(t, keep=2)
        store.queue_transaction(t)
        assert log.missing_from(ev(1, 3)) is None     # backfill
        assert log.missing_from(ev(1, 9)) is not None  # delta still fine
        assert log.missing_from(ZERO) is None          # brand-new peer


class TestMergeFrom:
    """merge_from on pg_num shrink: version-key collisions between the
    dissolving child and the target must never silently overwrite
    target entries or their reqid dedup records."""

    C2 = coll_t(1, 1, 0)

    def _log(self, store, cid, oids_versions):
        if not store.collection_exists(cid):
            store.queue_transaction(Transaction().create_collection(cid))
        log = PGLog(cid)
        for oid, v, reqid in oids_versions:
            t = Transaction()
            log.append(t, pg_log_entry_t(MODIFY, oid, v, reqid=reqid))
            store.queue_transaction(t)
        return log

    def test_disjoint_versions_fold_in(self, store):
        tgt = self._log(store, C, [("a", ev(1, 1), "c1:1")])
        child = self._log(store, self.C2, [("b", ev(2, 5), "c2:1")])
        t = Transaction()
        tgt.merge_from(t, child)
        store.queue_transaction(t)
        assert tgt.entries[ev(2, 5)].oid == "b"
        assert tgt.info.last_update == ev(2, 5)

    def test_collision_rewrites_child_into_disjoint_range(self, store):
        tgt = self._log(store, C, [
            ("a", ev(1, 1), "c1:1"), ("a2", ev(1, 2), "c1:2")])
        child = self._log(store, self.C2, [
            ("b", ev(1, 2), "c2:1"), ("b2", ev(1, 3), "c2:2")])
        t = Transaction()
        tgt.merge_from(t, child)
        store.queue_transaction(t)
        # the target's colliding entry survives untouched
        assert tgt.entries[ev(1, 2)].oid == "a2"
        assert tgt.entries[ev(1, 2)].reqid == "c1:2"
        # the child's entries landed, in order, in a disjoint range
        child_oids = [
            e.oid for v, e in sorted(tgt.entries.items())
            if e.oid.startswith("b")
        ]
        assert child_oids == ["b", "b2"]
        assert len(tgt.entries) == 4
        # both sides' reqids still answer dup detection
        for rid in ("c1:1", "c1:2", "c2:1", "c2:2"):
            assert rid in tgt.reqids
        # last_update covers the rewritten range
        assert tgt.info.last_update == max(tgt.entries)
        # persisted state agrees (no omap record was lost)
        log2 = PGLog(C)
        log2.load(store)
        assert sorted(log2.entries) == sorted(tgt.entries)

    def test_collision_rewrite_preserves_delete_ops(self, store):
        tgt = self._log(store, C, [("x", ev(1, 1), "t:1")])
        store.queue_transaction(Transaction().create_collection(self.C2))
        child = PGLog(self.C2)
        t0 = Transaction()
        child.append(t0, pg_log_entry_t(MODIFY, "y", ev(1, 1), reqid="s:1"))
        child.append(t0, pg_log_entry_t(
            DELETE, "y", ev(1, 2), ev(1, 1), reqid="s:2"))
        store.queue_transaction(t0)
        t = Transaction()
        tgt.merge_from(t, child)
        store.queue_transaction(t)
        ys = [e for e in tgt.entries.values() if e.oid == "y"]
        assert sorted(e.op for e in ys) == [MODIFY, DELETE]
        # the rewritten DELETE is still the newest entry for "y"
        newest = max(
            (e for e in tgt.entries.values() if e.oid == "y"),
            key=lambda e: e.version)
        assert newest.op == DELETE


class TestTrimDup:
    """Aggressive trim (the soak scenario's osd_min/max_pg_log_entries
    pressure) must not reopen the exactly-once window: a client resend
    of an op whose log entry was TRIMMED still dedups."""

    def _log(self, store, n):
        log = PGLog(C)
        for i in range(1, n + 1):
            applied(log, store, pg_log_entry_t(
                MODIFY, f"o{i}", ev(1, i), reqid=f"c:{i}"))
        return log

    def test_reqid_survives_trim_in_ram(self, store):
        log = self._log(store, 10)
        t = Transaction()
        log.trim(t, keep=2)
        store.queue_transaction(t)
        # entries 1..8 are gone from the log...
        assert sorted(log.entries) == [ev(1, 9), ev(1, 10)]
        # ...but their reqids still answer dup detection: the resend
        # of c:3 must be recognized, not re-applied
        for i in range(1, 11):
            assert f"c:{i}" in log.reqids
        assert log.reqids["c:3"] == ev(1, 3)

    def test_reload_window_shrinks_to_log(self, store):
        """Across a restart the dup window is rebuilt from surviving
        entries — the same bounded contract the reference's dups list
        provides (trimmed reqids are forgotten only on restart)."""
        log = self._log(store, 10)
        t = Transaction()
        log.trim(t, keep=2)
        store.queue_transaction(t)
        fresh = PGLog(C)
        fresh.load(store)
        assert sorted(fresh.reqids) == ["c:10", "c:9"]
        assert fresh.reqids["c:9"] == ev(1, 9)

    def test_trim_then_divergent_rollback_reopens_reqid(self, store):
        """rollback_divergent drops the entry AND its reqid so the
        client retry re-applies; trim must not have broken that."""
        log = self._log(store, 6)
        t = Transaction()
        log.trim(t, keep=3)
        log.rollback_divergent(t, "o6", ev(1, 5))
        store.queue_transaction(t)
        assert "c:6" not in log.reqids
        assert "c:5" in log.reqids


class TestAdoptTail:
    """adopt_tail = set_tail + fill + floor bookkeeping in one step
    (interrupted-backfill log adoption)."""

    def _entry(self, oid, e, v, reqid=""):
        return pg_log_entry_t(MODIFY, oid, ev(e, v), reqid=reqid)

    def test_unverified_adoption_pins_floor(self, store):
        """An interrupted backfill adopts the sender's tail without
        object verification: last_update rises past state this member
        never held, so the floor must pin at the pre-adoption
        effective last_update — the restart then takes the backfill
        path, not the cheap log-delta path."""
        log = PGLog(C)
        applied(log, store, self._entry("a", 1, 1))
        applied(log, store, self._entry("a", 1, 2))
        t = Transaction()
        log.adopt_tail(t, ev(2, 7), [self._entry("b", 2, 8)],
                       verified=False)
        store.queue_transaction(t)
        assert log.info.last_update == ev(2, 8)
        assert log.contig_floor == ev(1, 2)
        assert log.effective_last_update() == ev(1, 2)
        # persisted: a restart sees the same evidence
        fresh = PGLog(C)
        fresh.load(store)
        assert fresh.contig_floor == ev(1, 2)

    def test_verified_adoption_clears_floor(self, store):
        log = PGLog(C)
        applied(log, store, self._entry("a", 1, 1))
        # earlier gap already pinned a floor
        applied(log, store, self._entry("b", 1, 5))
        assert log.contig_floor == ev(1, 1)
        t = Transaction()
        log.adopt_tail(t, ev(1, 6), [self._entry("c", 1, 7)],
                       verified=True)
        store.queue_transaction(t)
        assert log.contig_floor is None
        assert log.effective_last_update() == ev(1, 7)

    def test_adopted_reqids_answer_dup_detection(self, store):
        """An op this member ADOPTED rather than executed still dedups
        exactly-once on client resend."""
        log = PGLog(C)
        applied(log, store, self._entry("a", 1, 1))
        t = Transaction()
        log.adopt_tail(t, ev(1, 4), [
            self._entry("b", 1, 5, reqid="cl:5"),
            self._entry("c", 1, 6, reqid="cl:6"),
        ], verified=True)
        store.queue_transaction(t)
        assert log.reqids.get("cl:5") == ev(1, 5)
        assert log.reqids.get("cl:6") == ev(1, 6)

    def test_adoption_yields_missing_evidence(self, store):
        """After adoption the log can scope a behind peer: the adopted
        window is real history for missing_from, and a peer below the
        adopted tail is forced to backfill."""
        log = PGLog(C)
        applied(log, store, self._entry("a", 1, 1))
        t = Transaction()
        log.adopt_tail(t, ev(1, 4), [
            self._entry("b", 1, 5),
            self._entry("c", 1, 6),
        ], verified=True)
        store.queue_transaction(t)
        miss = log.missing_from(ev(1, 5))
        assert sorted(miss.items) == ["c"]
        # below the adopted tail: history is gone there -> backfill
        assert log.missing_from(ev(1, 2)) is None

    def test_entries_at_or_below_tail_are_dropped(self, store):
        log = PGLog(C)
        applied(log, store, self._entry("a", 1, 1))
        applied(log, store, self._entry("b", 1, 2))
        t = Transaction()
        log.adopt_tail(t, ev(1, 2), [self._entry("c", 1, 3)],
                       verified=True)
        store.queue_transaction(t)
        assert sorted(log.entries) == [ev(1, 3)]
        assert log.info.log_tail == ev(1, 2)
        # no gap was introduced past held state: no floor
        assert log.contig_floor is None


class TestContigFloor:
    """The log-contiguity floor: pg version counters are dense, so an
    append that skips counters means ops this member never saw — its
    last_update must stop vouching past the gap (the stale-shard
    flake's persisted evidence)."""

    def test_contiguous_appends_keep_no_floor(self, store):
        log = PGLog(C)
        for v in range(1, 4):
            applied(log, store, pg_log_entry_t(MODIFY, f"o{v}", ev(1, v)))
        assert log.contig_floor is None
        assert log.effective_last_update() == ev(1, 3)

    def test_gap_pins_floor_at_pre_append_last_update(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 2)))
        # counters 3..4 happened elsewhere while this member was down
        applied(log, store, pg_log_entry_t(MODIFY, "b", ev(2, 5)))
        assert log.contig_floor == ev(1, 2)
        assert log.effective_last_update() == ev(1, 2)
        assert log.info.last_update == ev(2, 5)
        # a second gap never LOWERS an existing floor
        applied(log, store, pg_log_entry_t(MODIFY, "c", ev(2, 9)))
        assert log.contig_floor == ev(1, 2)

    def test_floor_survives_reload(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(MODIFY, "b", ev(2, 4)))
        assert log.contig_floor == ev(1, 1)
        fresh = PGLog(C)
        fresh.load(store)
        assert fresh.contig_floor == ev(1, 1)
        assert fresh.info.last_update == ev(2, 4)

    def test_clear_floor_persists(self, store):
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(MODIFY, "b", ev(2, 4)))
        t = Transaction()
        log.clear_contig_floor(t)
        store.queue_transaction(t)
        assert log.contig_floor is None
        fresh = PGLog(C)
        fresh.load(store)
        assert fresh.contig_floor is None

    def test_fill_inserts_missed_history(self, store):
        """fill() accepts entries at or below last_update — the
        post-recovery log sync hands a gapped member the window it
        missed, so its own future missing_from() sees whole history."""
        log = PGLog(C)
        applied(log, store, pg_log_entry_t(MODIFY, "a", ev(1, 1)))
        applied(log, store, pg_log_entry_t(MODIFY, "b", ev(2, 4)))
        t = Transaction()
        log.fill(t, pg_log_entry_t(MODIFY, "hole", ev(1, 2), reqid="r2"))
        log.fill(t, pg_log_entry_t(MODIFY, "hole", ev(2, 3)))
        store.queue_transaction(t)
        assert ev(1, 2) in log.entries and ev(2, 3) in log.entries
        assert log.info.last_update == ev(2, 4)  # unchanged
        assert log.reqids.get("r2") == ev(1, 2)  # dup window learns it
        fresh = PGLog(C)
        fresh.load(store)
        assert ev(1, 2) in fresh.entries
        # a behind-peer delta now includes the once-missing window
        miss = log.missing_from(ev(1, 1))
        assert "hole" in miss.items

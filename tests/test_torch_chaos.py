"""Chaos engine unit + smoke tests.

Covers the subsystem's three testable-without-a-cluster layers —
schedule determinism, netem semantics, invariant checkers on
hand-built violating histories — plus a fast 3-scenario live smoke
(one seed each) and a ``slow``-marked multi-seed sweep (the committed
CHAOS artifact is the full sweep's record; see
tools/chaos_run.py and tests/test_bench_artifacts.py).

The port's twin of tests/test_chaos.py: the same cases over
``ceph_tpu_torch``, the daemons on the CPU and the EC pools on the
``cuda`` plugin."""

from __future__ import annotations

import asyncio

import pytest

from ceph_tpu_torch.chaos.schedule import (
    EVENT_KINDS,
    generate_schedule,
    trace_hash,
)
from ceph_tpu_torch.chaos.runner import SCENARIOS


# -- schedule determinism ---------------------------------------------------

class TestScheduleDeterminism:
    def test_same_seed_identical_trace(self):
        for name, sc in SCENARIOS.items():
            for seed in (0, 1, 66):
                a = generate_schedule(seed, sc)
                b = generate_schedule(seed, sc)
                assert [e.to_json() for e in a] == [
                    e.to_json() for e in b], (name, seed)
                assert trace_hash(a) == trace_hash(b)

    def test_different_seeds_differ(self):
        sc = SCENARIOS["osd_thrash"]
        hashes = {trace_hash(generate_schedule(s, sc)) for s in range(16)}
        assert len(hashes) == 16  # no two seeds collapse to one trace

    def test_known_kinds_and_sorted_times(self):
        for name, sc in SCENARIOS.items():
            ev = generate_schedule(3, sc)
            assert ev, name
            assert all(e.kind in EVENT_KINDS for e in ev)
            assert [e.t for e in ev] == sorted(e.t for e in ev)

    def test_trace_is_applicable(self):
        """Generator-internal state discipline: never revive a live
        osd, never kill a dead one, and the trace always ends whole
        (every kill has a revive, every out an in)."""
        sc = dict(SCENARIOS["osd_thrash"], n_events=40, duration=10.0)
        for seed in range(10):
            alive = set(range(sc["n_osds"]))
            inn = set(range(sc["n_osds"]))
            for e in generate_schedule(seed, sc):
                if e.kind == "osd_kill":
                    assert e.args["osd"] in alive, seed
                    alive.discard(e.args["osd"])
                elif e.kind == "osd_revive":
                    assert e.args["osd"] not in alive, seed
                    alive.add(e.args["osd"])
                elif e.kind == "osd_out":
                    assert e.args["osd"] in inn, seed
                    inn.discard(e.args["osd"])
                elif e.kind == "osd_in":
                    assert e.args["osd"] not in inn, seed
                    inn.add(e.args["osd"])
            assert alive == set(range(sc["n_osds"])), seed
            assert inn == set(range(sc["n_osds"])), seed

    def test_scenario_change_changes_trace(self):
        a = generate_schedule(0, SCENARIOS["osd_thrash"])
        b = generate_schedule(0, SCENARIOS["netem_storm"])
        assert trace_hash(a) != trace_hash(b)


# -- netem semantics --------------------------------------------------------

class _Ping:
    """Tiny echo protocol over two real messengers."""

    def __init__(self):
        from ceph_tpu_torch.msg.messages import MOSDPing, PING, PING_REPLY

        self.MOSDPing, self.PING, self.PING_REPLY = (
            MOSDPing, PING, PING_REPLY)
        self.got: list = []

    async def dispatch(self, msg):
        self.got.append(msg)
        if msg.op == self.PING:
            await msg.conn.send_message(self.MOSDPing(
                op=self.PING_REPLY, from_osd=99, stamp=msg.stamp))


class TestNetem:
    def _pair(self, netem, a=("osd", 1), b=("osd", 2)):
        """Two live messengers with the shim attached; returns
        (ma, mb, proto_b, conn a->b)."""
        from ceph_tpu_torch.msg.messenger import Messenger

        async def build():
            pa, pb = _Ping(), _Ping()
            ma = Messenger(a, pa.dispatch)
            mb = Messenger(b, pb.dispatch)
            await ma.bind()
            await mb.bind()
            netem.attach(ma)
            netem.attach(mb)
            conn = await ma.connect(*mb.addr)
            return ma, mb, pa, pb, conn

        return build

    def test_partition_symmetric_and_heals(self):
        from ceph_tpu_torch.chaos.netem import Netem

        netem = Netem()

        async def go():
            ma, mb, pa, pb, conn = await self._pair(netem)()
            ping = pb  # noqa: F841
            netem.partition(("osd", 1), ("osd", 2))
            with pytest.raises(ConnectionError):
                await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            # symmetric: the other direction dies too
            back = await mb.connect(*ma.addr)
            with pytest.raises(ConnectionError):
                await back.send_message(pb.MOSDPing(op=pb.PING, from_osd=2))
            netem.heal_partition(("osd", 2), ("osd", 1))  # order-free
            conn2 = await ma.connect(*mb.addr)
            await conn2.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            for _ in range(100):
                if pb.got:
                    break
                await asyncio.sleep(0.01)
            assert pb.got, "healed link must deliver"
            await ma.shutdown()
            await mb.shutdown()

        asyncio.new_event_loop().run_until_complete(go())

    def test_oneway_drop_is_oneway(self):
        from ceph_tpu_torch.chaos.netem import Netem

        netem = Netem()

        async def go():
            ma, mb, pa, pb, conn = await self._pair(netem)()
            netem.drop_oneway(("osd", 1), ("osd", 2))
            # a->b vanishes silently: no error, no delivery
            await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            await asyncio.sleep(0.05)
            assert not pb.got
            assert netem.stats["dropped_sends"] == 1
            # b->a still flows
            back = await mb.connect(*ma.addr)
            await back.send_message(pa.MOSDPing(op=pa.PING, from_osd=2))
            for _ in range(100):
                if pa.got:
                    break
                await asyncio.sleep(0.01)
            assert pa.got
            netem.heal_oneway(("osd", 1), ("osd", 2))
            await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            for _ in range(100):
                if pb.got:
                    break
                await asyncio.sleep(0.01)
            assert pb.got
            await ma.shutdown()
            await mb.shutdown()

        asyncio.new_event_loop().run_until_complete(go())

    def test_wildcard_matches_kind(self):
        from ceph_tpu_torch.chaos.netem import Netem

        netem = Netem()

        async def go():
            ma, mb, pa, pb, conn = await self._pair(netem)()
            netem.partition(("osd", None), ("osd", None))
            with pytest.raises(ConnectionError):
                await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            netem.clear()
            await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            await ma.shutdown()
            await mb.shutdown()

        asyncio.new_event_loop().run_until_complete(go())

    def test_delay_applies(self):
        from ceph_tpu_torch.chaos.netem import Netem

        netem = Netem()

        async def go():
            ma, mb, pa, pb, conn = await self._pair(netem)()
            netem.delay(("osd", 1), ("osd", 2), 0.15)
            loop = asyncio.get_running_loop()
            t0 = loop.time()
            await conn.send_message(pb.MOSDPing(op=pb.PING, from_osd=1))
            assert loop.time() - t0 >= 0.14
            assert netem.stats["delayed_sends"] == 1
            await ma.shutdown()
            await mb.shutdown()

        asyncio.new_event_loop().run_until_complete(go())

    def test_reorder_holds_every_nth(self):
        """With reorder(every=2, hold), concurrent sends 1..4 arrive
        with at least one out-of-order pair (the held message is
        overtaken), and delivery is complete."""
        from ceph_tpu_torch.chaos.netem import Netem

        netem = Netem()

        async def go():
            ma, mb, pa, pb, conn = await self._pair(netem)()
            netem.reorder(("osd", 1), ("osd", 2), every=2, hold=0.1)
            await asyncio.gather(*(
                conn.send_message(pb.MOSDPing(
                    op=pb.PING_REPLY, from_osd=i, stamp=i))
                for i in range(1, 5)
            ))
            for _ in range(200):
                if len(pb.got) == 4:
                    break
                await asyncio.sleep(0.01)
            stamps = [m.stamp for m in pb.got]
            assert sorted(stamps) == [1, 2, 3, 4]  # nothing lost
            assert stamps != sorted(stamps), stamps  # genuinely reordered
            assert netem.stats["reordered_sends"] >= 1
            await ma.shutdown()
            await mb.shutdown()

        asyncio.new_event_loop().run_until_complete(go())


# -- invariant checkers on hand-built histories ----------------------------

def _mk_history(writes, reads=(), snaps=()):
    from ceph_tpu_torch.chaos.workload import History

    h = History()
    h.writes = list(writes)
    h.reads = list(reads)
    h.snaps = list(snaps)
    return h


class TestInvariantCheckers:
    W = staticmethod(
        lambda v, s, a, pool="p", oid="o", err=None: {
            "pool": pool, "oid": oid, "version": v, "start": s,
            "ack": a, "error": err,
        })
    R = staticmethod(
        lambda v, s, e, valid=True, pool="p", oid="o", err=None: {
            "pool": pool, "oid": oid, "version": v, "start": s,
            "end": e, "valid": valid, "error": err,
        })

    def test_clean_history_passes(self):
        from ceph_tpu_torch.chaos import invariants as inv

        h = _mk_history(
            [self.W(1, 1, 2), self.W(2, 5, 6)],
            [self.R(1, 3, 4), self.R(2, 7, 8),
             self.R(1, 5, 7)],  # overlaps w2: v1 or v2 both legal
        )
        assert inv.check_history(h) == []

    def test_stale_read_detected(self):
        from ceph_tpu_torch.chaos import invariants as inv

        h = _mk_history(
            [self.W(1, 1, 2), self.W(2, 3, 4)],
            [self.R(1, 6, 7)],  # v2 acked at 4 < start 6: v1 is stale
        )
        out = inv.check_history(h)
        assert [v["invariant"] for v in out] == ["stale_read"]

    def test_lost_acked_write_detected(self):
        from ceph_tpu_torch.chaos import invariants as inv
        import errno as _errno

        h = _mk_history(
            [self.W(1, 1, 2)],
            [self.R(None, 3, 4, valid=False,
                    err=f"errno={_errno.ENOENT}")],
        )
        out = inv.check_history(h)
        assert [v["invariant"] for v in out] == ["acked_write_lost"]

    def test_corrupt_and_phantom_reads_detected(self):
        from ceph_tpu_torch.chaos import invariants as inv

        h = _mk_history(
            [self.W(1, 1, 2)],
            [self.R(None, 3, 4, valid=False),   # garbage payload
             self.R(7, 5, 6)],                  # version never written
        )
        kinds = sorted(v["invariant"] for v in inv.check_history(h))
        assert kinds == ["corrupt_read", "phantom_read"]

    def test_availability_errors_are_not_violations(self):
        from ceph_tpu_torch.chaos import invariants as inv

        h = _mk_history(
            [self.W(1, 1, 2)],
            [self.R(None, 3, 4, valid=False, err="errno=110")],
        )
        assert inv.check_history(h) == []

    def test_final_reads_judgement(self):
        from ceph_tpu_torch.chaos import invariants as inv

        h = _mk_history(
            [self.W(1, 1, 2), self.W(2, 3, 4),
             self.W(3, 5, None)],  # v3 indeterminate (never acked)
            snaps=[{"pool": "p", "oid": "o", "snapid": 9,
                    "expect_version": 1}],
        )
        ok_final = [
            {"pool": "p", "oid": "o", "kind": "final", "version": 2,
             "valid": True},
            {"pool": "p", "oid": "o", "kind": "snap", "snapid": 9,
             "expect_version": 1, "version": 1, "valid": True},
        ]
        assert inv.check_final_reads(h, ok_final) == []
        # indeterminate v3 surviving is legal too
        assert inv.check_final_reads(h, [dict(ok_final[0], version=3)]) == []
        # v1 < last acked v2: lost write
        out = inv.check_final_reads(h, [dict(ok_final[0], version=1)])
        assert [v["invariant"] for v in out] == ["acked_write_lost"]
        # snap drifted to a different version
        out = inv.check_final_reads(h, [dict(ok_final[1], version=2)])
        assert [v["invariant"] for v in out] == ["snap_moved"]

    def test_converged_and_scrub_and_cold_checkers(self):
        from ceph_tpu_torch.chaos import invariants as inv

        good = {"pgs": {"num_pgs": 4, "num_reported": 4,
                        "by_state": {"active+clean": 4}}}
        bad = {"pgs": {"num_pgs": 4, "num_reported": 4,
                       "by_state": {"active+clean": 3,
                                    "active+degraded": 1}}}
        assert inv.check_converged(good) == []
        assert inv.check_converged(bad)[0]["invariant"] == "not_converged"
        assert inv.check_scrub_reports(
            [{"pg": "1.0", "inconsistencies": []}]) == []
        out = inv.check_scrub_reports(
            [{"pg": "1.0", "inconsistencies": [{"object": "o"}]}])
        assert out[0]["invariant"] == "scrub_inconsistency"
        assert inv.check_cold_launches(
            {"decode": 3}, {"decode": 3}) == []
        out = inv.check_cold_launches({"decode": 3}, {"decode": 5})
        assert out[0]["invariant"] == "cold_launch"

    def test_quorum_checker(self):
        from ceph_tpu_torch.chaos import invariants as inv

        good = [
            {"rank": 0, "stable": True, "leader": 0, "epoch": 9},
            {"rank": 1, "stable": True, "leader": 0, "epoch": 9},
            {"rank": 2, "stable": True, "leader": 0, "epoch": 9},
        ]
        assert inv.check_quorum(good) == []
        # the seed-66 bug class: cross-adopted leaders
        split = [
            {"rank": 0, "stable": True, "leader": 1, "epoch": 9},
            {"rank": 1, "stable": True, "leader": 0, "epoch": 9},
        ]
        assert "split_brain" in [
            v["invariant"] for v in inv.check_quorum(split)]
        skew = [dict(good[0]), dict(good[1], epoch=8), dict(good[2])]
        assert "map_epoch_skew" in [
            v["invariant"] for v in inv.check_quorum(skew)]


# -- workload payload codec -------------------------------------------------

class TestPayloadCodec:
    def test_roundtrip_and_tamper_detection(self):
        from ceph_tpu_torch.chaos.workload import parse_payload, payload_for

        p = payload_for("rep", "obj1", 3, 8192)
        assert len(p) == 8192
        assert parse_payload(p) == ("rep", "obj1", 3)
        assert parse_payload(p[:-1] + b"\x00") is None  # bit flip
        blend = p[:4096] + payload_for("rep", "obj1", 4, 8192)[4096:]
        assert parse_payload(blend) is None  # torn/blended write
        assert parse_payload(b"") is None
        assert parse_payload(b"\x00" * 64) is None


# -- live smoke: every builtin scenario, one seed each ---------------------

class TestChaosSmoke:
    # compose_load boots the loadgen harness on top of the cluster —
    # the slow sweep + the CHAOS/LOAD artifact guards carry it; the
    # fast smoke keeps tier-1's wall clock bounded
    @pytest.mark.parametrize(
        "scenario",
        sorted(n for n in SCENARIOS if n != "compose_load"))
    def test_scenario_seed0_green(self, scenario):
        from ceph_tpu_torch.chaos.runner import run_scenario

        loop = asyncio.new_event_loop()
        try:
            r = loop.run_until_complete(asyncio.wait_for(
                run_scenario(scenario, 0, device="cpu"), 180))
        finally:
            loop.close()
        assert r["ok"], r["invariants"]
        # replay contract: the trace regenerates bit-identically
        from ceph_tpu_torch.chaos.schedule import generate_schedule, trace_hash

        assert r["trace_hash"] == trace_hash(
            generate_schedule(0, SCENARIOS[scenario]))

    def test_dump_chaos_counts_events(self):
        """The smoke runs above (or this one's own run) land in the
        process-wide chaos counters the admin socket dumps."""
        from ceph_tpu_torch.chaos import dump_chaos

        d = dump_chaos()
        assert "counters" in d and "recent_events" in d


# -- slow: multi-seed sweep (the CHAOS artifact's live twin) ---------------

@pytest.mark.slow
class TestChaosSweepSlow:
    @pytest.mark.parametrize("scenario", sorted(SCENARIOS))
    @pytest.mark.parametrize("seed", range(1, 4))
    def test_sweep(self, scenario, seed):
        from ceph_tpu_torch.chaos.runner import run_scenario

        loop = asyncio.new_event_loop()
        try:
            r = loop.run_until_complete(asyncio.wait_for(
                run_scenario(scenario, seed, device="cpu"), 240))
        finally:
            loop.close()
        assert r["ok"], r["invariants"]


# -- production-weirdness checkers (client-netem / fullness / load) --------

class TestClientNetemChecker:
    def _obs(self, **kw):
        base = {
            "client_events": 3,
            "netem": {"client_partitioned_sends": 4,
                      "client_dropped_sends": 1,
                      "client_delayed_sends": 2},
            "errored_writes": [],
        }
        base.update(kw)
        return base

    def test_clean_obs_passes(self):
        from ceph_tpu_torch.chaos import invariants as inv

        assert inv.check_client_netem(self._obs()) == []

    def test_no_scheduled_events_flagged(self):
        from ceph_tpu_torch.chaos import invariants as inv

        out = inv.check_client_netem(self._obs(client_events=0))
        assert [v["invariant"] for v in out] == [
            "no_client_event_scheduled"]

    def test_armed_but_unfired_partition_flagged(self):
        from ceph_tpu_torch.chaos import invariants as inv

        out = inv.check_client_netem(self._obs(
            netem={"client_partitioned_sends": 0}))
        assert any(v["invariant"] == "client_partition_never_fired"
                   for v in out)

    def test_legal_and_illegal_errnos(self):
        import errno as _errno

        from ceph_tpu_torch.chaos import invariants as inv

        legal = [
            {"pool": "rep", "oid": "o", "version": 2,
             "errno": _errno.ETIMEDOUT, "error": "timed out"},
            {"pool": "rep", "oid": "o", "version": 3,
             "errno": _errno.EAGAIN, "error": "busy"},
        ]
        assert inv.check_client_netem(
            self._obs(errored_writes=legal)) == []
        bad = [{"pool": "rep", "oid": "o", "version": 4,
                "errno": _errno.ENOENT, "error": "vanished"}]
        out = inv.check_client_netem(self._obs(errored_writes=bad))
        assert any(v["invariant"] == "illegal_client_error"
                   for v in out)


class TestFullnessChecker:
    def _obs(self, **kw):
        base = {
            "nearfull_raised": True, "backfillfull_raised": True,
            "full_raised": True, "enospc_bounced": True,
            "backfill_rejects": 2.0, "failsafe_peak": 0.84,
            "failsafe_ratio": 0.97, "ladder_cleared": True,
        }
        base.update(kw)
        return base

    def test_full_ladder_passes(self):
        from ceph_tpu_torch.chaos import invariants as inv

        assert inv.check_fullness(self._obs()) == []

    def test_each_rung_required(self):
        from ceph_tpu_torch.chaos import invariants as inv

        for key, inv_name in (
            ("nearfull_raised", "fullness_check_never_raised"),
            ("backfillfull_raised", "fullness_check_never_raised"),
            ("full_raised", "fullness_check_never_raised"),
            ("enospc_bounced", "enospc_never_bounced"),
            ("ladder_cleared", "fullness_never_cleared"),
        ):
            out = inv.check_fullness(self._obs(**{key: False}))
            assert any(v["invariant"] == inv_name for v in out), key
        out = inv.check_fullness(self._obs(backfill_rejects=0))
        assert any(v["invariant"] == "backfill_never_paused"
                   for v in out)

    def test_failsafe_breach_flagged(self):
        from ceph_tpu_torch.chaos import invariants as inv

        out = inv.check_fullness(self._obs(failsafe_peak=0.98))
        assert any(v["invariant"] == "failsafe_breached" for v in out)


class TestLoadChecker:
    def _rec(self, **kw):
        base = {
            "latency": {"errors": 0, "overall": {
                "p50_us": 900.0, "p95_us": 4000.0, "p99_us": 9000.0}},
            "undrained": 0,
            "verify": {"checked": 32, "mismatches": 0, "lost": 0},
            "client_vs_mgr": {"agree": True},
            "qos": {"gold": {"admitted": 50}, "bronze": {"admitted": 70}},
            "cold_launches": 0, "host_transfers": 0,
        }
        base.update(kw)
        return base

    def test_green_record_passes(self):
        from ceph_tpu_torch.chaos import invariants as inv

        assert inv.check_load(self._rec(), ["bronze", "gold"]) == []

    def test_each_gate_required(self):
        from ceph_tpu_torch.chaos import invariants as inv

        cases = [
            (dict(latency={"errors": 3, "overall": {
                "p50_us": 1.0, "p95_us": 1.0, "p99_us": 1.0}}),
             "load_op_errors"),
            (dict(undrained=2), "load_undrained"),
            (dict(verify={"checked": 8, "mismatches": 1, "lost": 0}),
             "load_acked_write_lost"),
            (dict(client_vs_mgr={"agree": False}),
             "load_mgr_crosscheck_failed"),
            (dict(qos={"gold": {"admitted": 9}}),
             "load_qos_rows_missing"),
            (dict(cold_launches=1), "load_cold_launches"),
            (dict(host_transfers=2), "load_host_transfers"),
        ]
        for patch, name in cases:
            out = inv.check_load(self._rec(**patch), ["bronze", "gold"])
            assert any(v["invariant"] == name for v in out), name


class TestClientNetemCounters:
    def test_client_link_verdicts_counted_separately(self):
        """The client-netem oracle needs PROOF a rule bit a CLIENT
        send: per-kind counters split client links out."""
        from ceph_tpu_torch.chaos.netem import Netem

        async def drive():
            netem = Netem()
            netem.partition(("client", None), ("osd", None))
            with pytest.raises(ConnectionError):
                await netem.on_send(("client", 8), ("osd", 2))
            with pytest.raises(ConnectionError):
                await netem.on_send(("osd", 2), ("client", 8))
            netem.clear()
            netem.drop_oneway(("osd", None), ("client", None))
            assert not await netem.on_send(("osd", 1), ("client", 8))
            # an osd<->osd link under the same shim counts only the
            # generic buckets
            netem.clear()
            netem.partition(("osd", 0), ("osd", 1))
            with pytest.raises(ConnectionError):
                await netem.on_send(("osd", 0), ("osd", 1))
            return netem.stats

        stats = asyncio.new_event_loop().run_until_complete(drive())
        assert stats["client_partitioned_sends"] == 2
        assert stats["client_dropped_sends"] == 1
        assert stats["partitioned_sends"] == 3
        assert stats["dropped_sends"] == 1


class TestWorkloadSnapRecords:
    def test_snap_removal_marks_record_and_skips_final_read(self):
        from ceph_tpu_torch.chaos.workload import History, Workload

        h = History()
        h.record_snap("ec", "o1", 7, 2)
        h.record_snap("ec", "o2", 8, 2)
        h.mark_snap_removed("ec", "o1", 7)
        assert [s["removed"] for s in h.snaps] == [True, False]

    def test_snap_remove_partition_is_deterministic(self):
        from ceph_tpu_torch.chaos.workload import Workload

        picks = {oid: Workload._snap_remove_for(oid)
                 for oid in (f"ec-obj{i}" for i in range(8))}
        assert picks == {oid: Workload._snap_remove_for(oid)
                        for oid in picks}
        assert any(picks.values()) and not all(picks.values())

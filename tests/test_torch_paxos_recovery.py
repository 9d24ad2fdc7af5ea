"""Unit tests for Paxos uncommitted-value recovery (collect phase).

Pins the duplicate-commit guard: a value the previous leader already
committed (learned via catch-up FETCH after collect) must not be
re-proposed under a fresh version.  Reference semantics: Paxos recovers
only the single newest uncommitted value, after catch-up
(src/mon/Paxos.cc handle_last / begin ordering).

The port's twin of tests/test_paxos_recovery.py over ``ceph_tpu_torch``.
"""

import asyncio

from ceph_tpu_torch.mon.paxos import ACCEPT, BEGIN, LAST, Paxos, MMonPaxos


def run(coro):
    return asyncio.new_event_loop().run_until_complete(coro)


class _Net:
    """Captures sends; peers auto-ACCEPT any BEGIN so propose() can
    complete without a live quorum."""

    def __init__(self):
        self.sent: list[tuple[int, object]] = []
        self.committed: list[tuple[int, bytes]] = []
        self.p: Paxos | None = None

    async def send(self, rank, msg):
        self.sent.append((rank, msg))
        if isinstance(msg, MMonPaxos) and msg.op == BEGIN:
            asyncio.get_running_loop().create_task(
                self.p.handle_paxos(
                    MMonPaxos(ACCEPT, msg.pn, msg.version, b"", 0), rank
                )
            )

    async def on_commit(self, v, value):
        self.committed.append((v, value))


def _leader(net, rank=0, n=3, quorum=None) -> Paxos:
    p = Paxos(rank, n, net.send, net.on_commit)
    p._become_leader(quorum or {0, 1, 2})
    p.accepted_pn = 100 + rank
    net.p = p
    return p


def test_recovers_only_newest_uncommitted_value():
    net = _Net()
    p = _leader(net)

    async def go():
        # two peons report different uncommitted values; only the
        # newest (version 2) may be re-proposed
        p._collect_replies = {
            1: MMonPaxos(LAST, p.accepted_pn, 1, b"old", 0),
            2: MMonPaxos(LAST, p.accepted_pn, 2, b"new", 0),
        }
        await p._finish_collect()
        assert p._recover_task is not None
        await p._recover_task

    run(go())
    # single-value recovery: exactly one commit, of the newest value
    assert net.committed == [(1, b"new")]


def test_already_committed_value_not_reproposed():
    net = _Net()
    p = _leader(net)

    async def go():
        # peon 1 is ahead (last_committed=2) and also reports an
        # uncommitted copy of a value the old leader in fact committed
        # as version 2.  The leader must fetch, see version 2 arrive,
        # and NOT re-propose it at version 3.
        p._collect_replies = {
            1: MMonPaxos(LAST, p.accepted_pn, 2, b"val2", 2),
            2: MMonPaxos(LAST, p.accepted_pn, 0, b"", 0),
        }
        await p._finish_collect()
        assert not p.caught_up.is_set()  # FETCH issued
        # catch-up commits arrive from peon 1
        await p._commit_local(1, b"val1")
        await p._commit_local(2, b"val2")
        assert p.caught_up.is_set()
        await p._recover_task

    run(go())
    # the recovered value was found committed during catch-up: the
    # recovery task must be a no-op (no duplicate at version 3)
    assert net.committed == [(1, b"val1"), (2, b"val2")]
    assert p.last_committed == 2


def test_recovery_skipped_after_leadership_loss():
    net = _Net()
    p = _leader(net)

    async def go():
        p._collect_replies = {
            1: MMonPaxos(LAST, p.accepted_pn, 1, b"v", 0),
        }
        await p._finish_collect()
        # leadership lost before the recovery task runs
        p.stable.clear()
        p.leader = None
        await p._recover_task

    run(go())
    assert net.committed == []

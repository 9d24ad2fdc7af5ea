"""Paxos + elections for the monitor quorum.

Behavioral twin of the reference's monitor consensus core
(src/mon/Paxos.h:174, src/mon/Elector.h / ElectionLogic): a rank-based
election picks the leader (lowest rank reachable by a majority; odd
election epochs while electing, even once stable — the reference's
epoch parity convention), and the leader drives a single Paxos
sequence of numbered values over the quorum:

    collect(pn)  -> peons reply last(pn, last_committed [, uncommitted])
    begin(pn, v, value) -> peons record the pending value + accept
    commit(v)    -> everyone applies value v

Durability model: this class keeps paxos state (accepted_pn, the
committed ``values`` log, last_committed) in RAM and the committed log
is the catch-up source for rebooted/partitioned members; the monitor
layer persists committed values through MonStore (mon/
store.py — snapshot + committed tail over an ObjectStore) before they
apply, mirroring the reference's MonitorDBStore split (Paxos.h:174
writes through MonitorDBStore::Transaction).  A restarted monitor
replays its MonStore and rejoins; state survives full-quorum restarts
when members run on durable stores.

Values are opaque blobs; the monitor replicates its *state-mutating
commands* (osd boot/failure/out, pool create, profile set) and applies
them deterministically on every member — state-machine replication,
where the reference replicates encoded kv transactions of its store
(same capability, simpler value encoding).  The leader re-shares
missing commits during collect, which is how a rebooted/partitioned
peon catches up (Paxos::share_state).
"""

from __future__ import annotations

import asyncio
import logging
from typing import Awaitable, Callable

from ceph_tpu_torch.msg.denc import Decoder, Encoder
from ceph_tpu_torch.msg.messenger import Message

log = logging.getLogger("ceph_tpu_torch.mon.paxos")

# election ops (MMonElection)
PROPOSE, ACK, VICTORY = 1, 2, 3
# paxos ops (MMonPaxos); FETCH = straggler catch-up request; SYNC = a
# state-machine snapshot for peers older than the trimmed log tail (the
# reference's store full-sync, src/mon/Monitor.cc sync_start)
COLLECT, LAST, BEGIN, ACCEPT, COMMIT, FETCH, SYNC, NACK = 1, 2, 3, 4, 5, 6, 7, 8


class MMonElection(Message):
    TYPE = 65

    def __init__(self, op: int = 0, epoch: int = 0, rank: int = 0):
        self.op, self.epoch, self.rank = op, epoch, rank

    def encode_payload(self, enc: Encoder):
        enc.u8(self.op)
        enc.u32(self.epoch)
        enc.i32(self.rank)

    @classmethod
    def decode_payload(cls, dec: Decoder):
        return cls(dec.u8(), dec.u32(), dec.i32())


class MMonPaxos(Message):
    TYPE = 66

    def __init__(
        self, op: int = 0, pn: int = 0, version: int = 0,
        value: bytes = b"", last_committed: int = 0,
        uncommitted_pn: int = 0,
    ):
        self.op, self.pn, self.version = op, pn, version
        self.value, self.last_committed = value, last_committed
        # LAST only: the pn under which the reported uncommitted value
        # was accepted (the Paxos adopt-highest-pn rule needs it)
        self.uncommitted_pn = uncommitted_pn

    def encode_payload(self, enc: Encoder):
        enc.u8(self.op)
        enc.u64(self.pn)
        enc.u64(self.version)
        enc.bytes_(self.value)
        enc.u64(self.last_committed)
        enc.u64(self.uncommitted_pn)

    @classmethod
    def decode_payload(cls, dec: Decoder):
        return cls(
            dec.u8(), dec.u64(), dec.u64(), dec.bytes_(), dec.u64(),
            dec.u64(),
        )


class Paxos:
    """One monitor's consensus state.

    ``send(rank, msg)`` delivers to a peer monitor; ``on_commit(v,
    value)`` applies a committed value to the monitor's state machine.
    The host monitor wires both.
    """

    def __init__(
        self,
        rank: int,
        n_ranks: int,
        send: Callable[[int, Message], Awaitable[None]],
        on_commit: Callable[[int, bytes], Awaitable[None]],
        store=None,
        get_snapshot: Callable[[], bytes] | None = None,
        install_snapshot: Callable[[int, bytes], Awaitable[None]] | None = None,
    ):
        self.rank = rank
        self.n_ranks = n_ranks
        self._send = send
        self._on_commit = on_commit
        # durable backing (MonStore) + state-machine snapshot hooks for
        # trim/full-sync; None = volatile (tests)
        self.store = store
        self._get_snapshot = get_snapshot
        self._install_snapshot = install_snapshot
        # election state
        self.election_epoch = 1  # odd = electing
        self.leader: int | None = None
        self.quorum: set[int] = set()
        self._election_acks: set[int] = set()
        self._electing = False  # our own candidacy is live
        # paxos state
        self.last_pn = 0
        self.accepted_pn = 0
        self.last_committed = 0
        self.first_committed = 1  # log tail (values below were trimmed)
        self.values: dict[int, bytes] = {}     # committed log
        self._uncommitted: tuple[int, bytes] | None = None
        self._uncommitted_pn = 0  # pn the uncommitted value was accepted under
        if self.store is not None:
            st = self.store.load()
            self.accepted_pn = st["accepted_pn"]
            self.last_pn = st["last_pn"]
            # rejoin near the quorum's election epoch instead of from 1
            # (the reference Elector persists its epoch the same way);
            # stale-epoch PROPOSEs from a rebooted member churn every
            # peer through a useless election round otherwise
            self.election_epoch = max(1, st.get("election_epoch", 1))
            self.last_committed = st["last_committed"]
            self.first_committed = max(1, st["first_committed"])
            self.values = st["values"]
            if st["uncommitted"] is not None:
                uv, upn, ublob = st["uncommitted"]
                if uv > self.last_committed:
                    self._uncommitted = (uv, ublob)
                    self._uncommitted_pn = upn
        self._accepts: set[int] = set()
        self._propose_version = 0  # version the in-flight BEGIN carries
        self._collect_replies: dict[int, MMonPaxos] = {}
        self._recover_task: asyncio.Task | None = None  # strong root
        self._propose_lock = asyncio.Lock()
        self._phase_done: asyncio.Event | None = None
        self.stable = asyncio.Event()
        # cleared while this (newly elected) leader is still fetching
        # commits it missed; proposals wait on it
        self.caught_up = asyncio.Event()
        self.caught_up.set()
        self._catchup_target = 0
        if n_ranks == 1:
            self._become_leader({rank})

    # -- election (ElectionLogic, rank-based) --------------------------

    @property
    def is_leader(self) -> bool:
        return self.leader == self.rank and self.stable.is_set()

    def majority(self) -> int:
        return self.n_ranks // 2 + 1

    async def start_election(self) -> None:
        self.stable.clear()
        self.leader = None
        self._electing = True
        if self.election_epoch % 2 == 0:
            self.election_epoch += 1
        else:
            self.election_epoch += 2
        self._election_acks = {self.rank}
        if self.store is not None:
            await self.store.put_election_epoch(self.election_epoch)
        log.info("mon.%d: starting election e%d", self.rank, self.election_epoch)
        for r in range(self.n_ranks):
            if r != self.rank:
                await self._maybe_send(r, MMonElection(
                    PROPOSE, self.election_epoch, self.rank
                ))
        await self._check_victory()

    async def _maybe_send(self, rank: int, msg: Message) -> None:
        try:
            await self._send(rank, msg)
        except (ConnectionError, OSError, asyncio.TimeoutError):
            pass  # unreachable peers simply don't vote

    async def _check_victory(self) -> None:
        if not self._electing:
            return
        if len(self._election_acks) >= self.majority() and not self.stable.is_set():
            self._electing = False
            quorum = set(self._election_acks)
            self.election_epoch += 1  # even: stable
            self._become_leader(quorum)
            log.info(
                "mon.%d: won election e%d quorum %s",
                self.rank, self.election_epoch, sorted(quorum),
            )
            # VICTORY to everyone: members outside the voting quorum
            # still follow the leader and catch up on commits
            for r in range(self.n_ranks):
                if r != self.rank:
                    await self._maybe_send(r, MMonElection(
                        VICTORY, self.election_epoch, self.rank
                    ))
            await self._leader_collect()

    def _become_leader(self, quorum: set[int]) -> None:
        self.leader = self.rank
        self.quorum = quorum
        self.stable.set()

    async def handle_election(self, msg: MMonElection, from_rank: int) -> None:
        if msg.op == PROPOSE:
            if self.rank < msg.rank:
                # I outrank the proposer: (re)launch my own candidacy
                # at an epoch everyone will honor.  The proposer will
                # defer when my PROPOSE reaches it.
                if (
                    self.stable.is_set()
                    or not self._electing
                    or msg.epoch > self.election_epoch
                ):
                    self.election_epoch = max(self.election_epoch, msg.epoch)
                    await self.start_election()
            else:
                # defer to the lower rank: cancel any candidacy of ours
                self.stable.clear()
                self.leader = None
                self._electing = False
                self.election_epoch = max(self.election_epoch, msg.epoch)
                if self.store is not None:
                    await self.store.put_election_epoch(self.election_epoch)
                await self._maybe_send(from_rank, MMonElection(
                    ACK, msg.epoch, self.rank
                ))
        elif msg.op == ACK:
            if self._electing and msg.epoch == self.election_epoch:
                self._election_acks.add(from_rank)
                await self._check_victory()
        elif msg.op == VICTORY:
            if from_rank > self.rank and (self._electing or self.is_leader):
                # a higher rank won a race our candidacy should win:
                # keep contesting (the reference's lowest-rank
                # guarantee; the new leader will defer on our PROPOSE).
                # The is_leader arm closes the simultaneous-victory
                # cross-adoption race (quorum-storm seed 66): two mons
                # win concurrent elections whose epochs renumber to the
                # SAME even value and the VICTORYs cross — the higher
                # rank correctly yields to ours, but we were no longer
                # _electing and would adopt THEIRS, leaving a stable
                # split brain where each side redirects commands to the
                # other forever.
                self.election_epoch = max(self.election_epoch, msg.epoch)
                await self.start_election()
                return
            if msg.epoch < self.election_epoch:
                return  # stale victory
            self.election_epoch = msg.epoch
            if self.store is not None:
                await self.store.put_election_epoch(self.election_epoch)
            self.leader = from_rank
            self._electing = False
            self.quorum = set()  # peons don't track the full quorum
            self.stable.set()
            log.info("mon.%d: leader is mon.%d (e%d)", self.rank, from_rank, msg.epoch)

    # -- paxos phases --------------------------------------------------

    async def _leader_collect(self) -> None:
        """Phase 1 after winning: learn the quorum's state, re-share
        missing commits, recover any uncommitted value."""
        if self.n_ranks == 1:
            return
        # collision-free by construction (Paxos::get_new_proposal_number):
        # round up to the next multiple of 100, then add our rank
        self.last_pn = (
            max(self.last_pn, self.accepted_pn) // 100 + 1
        ) * 100 + self.rank
        pn = self.last_pn
        self.accepted_pn = pn
        if self.store is not None:
            await self.store.put_pns(self.accepted_pn, self.last_pn)
        self._collect_replies = {}
        for r in self.quorum:
            if r != self.rank:
                await self._maybe_send(r, MMonPaxos(
                    COLLECT, pn, 0, b"", self.last_committed
                ))

    async def _finish_collect(self) -> None:
        # every collect re-derives catch-up state: a previous term's
        # unfinished fetch (source died mid-catch-up) must not wedge
        # this term's proposals
        self.caught_up.set()
        # if WE are behind (led a minority partition, or rebooted):
        # fetch the quorum's commits before proposing anything, or our
        # next version numbers would collide with committed history
        ahead = [
            (r, rep.last_committed)
            for r, rep in self._collect_replies.items()
            if rep.last_committed > self.last_committed
        ]
        if ahead:
            src, target = max(ahead, key=lambda t: t[1])
            log.info(
                "mon.%d: behind quorum (%d < %d); fetching from mon.%d",
                self.rank, self.last_committed, target, src,
            )
            self._catchup_target = target
            self.caught_up.clear()
            await self._maybe_send(src, MMonPaxos(
                FETCH, self.accepted_pn, 0, b"", self.last_committed
            ))
        # catch up anyone behind
        for r, rep in self._collect_replies.items():
            for v in range(rep.last_committed + 1, self.last_committed + 1):
                if v in self.values:
                    await self._maybe_send(r, MMonPaxos(
                        COMMIT, self.accepted_pn, v, self.values[v],
                        self.last_committed,
                    ))
        # Recover at most ONE uncommitted value from the previous
        # leader: the one accepted under the HIGHEST pn (version as
        # tie-break) across our own state and all replies — the Paxos
        # adopt rule; two values at the same version from different
        # terms must resolve toward the possibly-committed one.
        # Deferred to a task: re-proposal must wait for our own
        # catch-up FETCH (which arrives on a peer connection whose
        # reader must keep running), and the version guard must be
        # re-checked *after* catch-up — a value the old leader already
        # committed would otherwise be committed twice under a fresh
        # version.
        best: tuple[int, int, bytes] | None = None  # (pn, version, value)
        if self._uncommitted and self._uncommitted[0] > self.last_committed:
            best = (self._uncommitted_pn, *self._uncommitted)
        for rep in self._collect_replies.values():
            if rep.value and rep.version > self.last_committed:
                cand = (rep.uncommitted_pn, rep.version, rep.value)
                if best is None or cand[:2] > best[:2]:
                    best = cand
        if self._recover_task is not None and not self._recover_task.done():
            # a previous term's recovery must not race this one into a
            # double-commit of the same value
            self._recover_task.cancel()
        if best is not None:
            self._recover_task = asyncio.create_task(
                self._propose_recovered(best[1], best[2])
            )

    async def _propose_recovered(self, version: int, value: bytes) -> None:
        """Re-propose an uncommitted value recovered during collect,
        after catch-up, unless catch-up revealed it was committed."""
        try:
            await asyncio.wait_for(self.caught_up.wait(), 10)
        except asyncio.TimeoutError:
            return
        if version <= self.last_committed or not self.is_leader:
            return  # already committed (or leadership lost meanwhile)
        try:
            await self.propose(value)
        except ConnectionError:
            pass  # quorum lost; next election re-runs recovery

    async def propose(self, value: bytes) -> int:
        """Leader-only: replicate one value; returns its version once
        committed (majority accepted)."""
        async with self._propose_lock:
            if not self.is_leader:
                raise ConnectionError("not leader")
            if self.n_ranks > 1:
                try:
                    await asyncio.wait_for(self.caught_up.wait(), 10)
                except asyncio.TimeoutError:
                    raise ConnectionError("leader still catching up")
            version = self.last_committed + 1
            if self.n_ranks == 1:
                await self._commit_local(version, value)
                return version
            pn = self.accepted_pn
            self._accepts = {self.rank}
            self._propose_version = version
            self._phase_done = asyncio.Event()
            self._uncommitted = (version, value)
            self._uncommitted_pn = pn
            if self.store is not None:
                await self.store.put_uncommitted(version, pn, value)
            for r in self.quorum:
                if r != self.rank:
                    await self._maybe_send(r, MMonPaxos(
                        BEGIN, pn, version, value, self.last_committed
                    ))
            deadline = asyncio.get_running_loop().time() + 10
            while not self._phase_done.is_set():
                if not self.is_leader or self.accepted_pn != pn:
                    # a re-election raced this BEGIN: its pn is dead and
                    # no peon will accept it — fail fast so the caller
                    # retries under the new term instead of burning the
                    # full timeout
                    raise ConnectionError("paxos term changed mid-propose")
                remaining = deadline - asyncio.get_running_loop().time()
                if remaining <= 0:
                    raise ConnectionError("paxos begin timed out (lost quorum?)")
                try:
                    await asyncio.wait_for(
                        self._phase_done.wait(), min(0.1, remaining)
                    )
                except asyncio.TimeoutError:
                    continue
            # commit: broadcast to every rank (stragglers outside the
            # voting quorum stay consistent; gaps trigger FETCH)
            await self._commit_local(version, value)
            for r in range(self.n_ranks):
                if r != self.rank:
                    await self._maybe_send(r, MMonPaxos(
                        COMMIT, pn, version, value, self.last_committed
                    ))
            return version

    async def _commit_local(self, version: int, value: bytes) -> None:
        if version <= self.last_committed:
            return
        self.values[version] = value
        self.last_committed = version
        self._uncommitted = None
        if self.store is not None:
            # durable before applied: a crash between the two replays
            # the value on restart (apply is idempotent/deterministic)
            await self.store.put_commit(version, value)
        await self._on_commit(version, value)
        if not self.caught_up.is_set() and version >= self._catchup_target:
            self.caught_up.set()

    async def handle_paxos(self, msg: MMonPaxos, from_rank: int) -> None:
        if msg.op == COLLECT:
            if msg.pn < self.accepted_pn:
                # we promised a higher pn (e.g. to a transient leader
                # that lost the next election): silence would starve
                # this leader's term — tell it to re-collect higher
                await self._maybe_send(from_rank, MMonPaxos(
                    NACK, self.accepted_pn, 0, b"", self.last_committed
                ))
                return
            if msg.pn >= self.accepted_pn:
                self.accepted_pn = msg.pn
                if self.store is not None:
                    # promise durably: a restarted peon must not accept
                    # an older pn it already promised against
                    await self.store.put_pns(self.accepted_pn, self.last_pn)
                un_v, un_val = self._uncommitted or (0, b"")
                await self._maybe_send(from_rank, MMonPaxos(
                    LAST, msg.pn, un_v, un_val, self.last_committed,
                    uncommitted_pn=self._uncommitted_pn if un_val else 0,
                ))
        elif msg.op == LAST:
            if msg.pn == self.accepted_pn and self.is_leader:
                self._collect_replies[from_rank] = msg
                if len(self._collect_replies) >= len(self.quorum) - 1:
                    await self._finish_collect()
        elif msg.op == BEGIN:
            if msg.pn < self.accepted_pn:
                await self._maybe_send(from_rank, MMonPaxos(
                    NACK, self.accepted_pn, 0, b"", self.last_committed
                ))
                return
            if msg.pn >= self.accepted_pn:
                self.accepted_pn = msg.pn
                self._uncommitted = (msg.version, msg.value)
                self._uncommitted_pn = msg.pn
                if self.store is not None:
                    # persist BEFORE the accept leaves this process:
                    # the leader counts us toward majority on it
                    await self.store.put_pns(self.accepted_pn, self.last_pn)
                    await self.store.put_uncommitted(msg.version, msg.pn, msg.value)
                await self._maybe_send(from_rank, MMonPaxos(
                    ACCEPT, msg.pn, msg.version, b"", self.last_committed
                ))
        elif msg.op == ACCEPT:
            if (
                self.is_leader
                and msg.pn == self.accepted_pn
                and msg.version == self._propose_version
                and self._phase_done
            ):
                self._accepts.add(from_rank)
                if len(self._accepts) >= self.majority():
                    self._phase_done.set()
        elif msg.op == COMMIT:
            # peons may receive commits out of step during catch-up;
            # apply in order only, fetch the gap from the leader
            if msg.version == self.last_committed + 1:
                await self._commit_local(msg.version, msg.value)
            elif msg.version > self.last_committed + 1:
                log.info(
                    "mon.%d: commit gap (have %d, got %d); fetching",
                    self.rank, self.last_committed, msg.version,
                )
                await self._maybe_send(from_rank, MMonPaxos(
                    FETCH, msg.pn, 0, b"", self.last_committed
                ))
        elif msg.op == NACK:
            if self.is_leader and msg.pn > self.accepted_pn:
                # a quorum member promised someone a higher pn: restart
                # phase 1 above it (Paxos::handle_collect/begin NAK ->
                # collect(oldpn+1) in the reference)
                log.info(
                    "mon.%d: pn %d NACKed (peer at %d); re-collecting",
                    self.rank, self.accepted_pn, msg.pn,
                )
                self.last_pn = max(self.last_pn, msg.pn)
                await self._leader_collect()
        elif msg.op == FETCH:
            if (
                msg.last_committed + 1 < self.first_committed
                and self._get_snapshot is not None
            ):
                # the peer predates our trimmed tail: ship a state
                # snapshot (store full-sync).  The version comes from
                # the snapshot ITSELF — the state machine can lag
                # last_committed by an in-flight apply, and advertising
                # a version the blob doesn't contain would silently
                # drop that op on the receiver.  Any gap above the
                # snapshot ships as ordinary commits right after.
                ver, blob = self._get_snapshot()
                await self._maybe_send(from_rank, MMonPaxos(
                    SYNC, self.accepted_pn, ver, blob,
                    self.last_committed,
                ))
                for v in range(ver + 1, self.last_committed + 1):
                    if v in self.values:
                        await self._maybe_send(from_rank, MMonPaxos(
                            COMMIT, self.accepted_pn, v, self.values[v],
                            self.last_committed,
                        ))
                return
            for v in range(msg.last_committed + 1, self.last_committed + 1):
                if v in self.values:
                    await self._maybe_send(from_rank, MMonPaxos(
                        COMMIT, self.accepted_pn, v, self.values[v],
                        self.last_committed,
                    ))
        elif msg.op == SYNC:
            if msg.version > self.last_committed and self._install_snapshot:
                await self._install_snapshot(msg.version, msg.value)
                self.last_committed = msg.version
                self.first_committed = msg.version + 1
                self.values = {
                    v: b for v, b in self.values.items() if v > msg.version
                }
                self._uncommitted = None
                if self.store is not None:
                    await self.store.put_snapshot(msg.version, msg.value)
                    await self.store.put_commit(msg.version, b"")
                    await self.store.trim_values(msg.version + 1)
                if not self.caught_up.is_set() and msg.version >= self._catchup_target:
                    self.caught_up.set()

"""Seeded deterministic event-schedule generation.

The OSDThrasher (qa/tasks/thrasher.py) draws its next action from a
live RNG while the cluster runs, so no two runs are alike and a failure
is unreproducible without the full teuthology log.  Here the WHOLE
event trace is generated up front as a pure function of ``(seed,
scenario)``: the runner then merely replays it against the cluster, so

- the same seed always yields the identical trace (asserted by
  :func:`trace_hash`, committed into the chaos artifact), and
- a failing seed replays the exact same thrash sequence for debugging
  (the ``ceph_test_rados --seed`` contract).

The generator is stateful *internally* — it tracks which OSDs its own
trace has killed/outed and which links it has partitioned, so traces
are always applicable (never reviving a live OSD, never exceeding the
down budget that would lose quorum/min_size) — but that state derives
only from the seed and scenario, never from the wall clock or the
cluster.

Counterpart of ``ceph_tpu/chaos/schedule.py``: the same traces and trace hashes.
"""

from __future__ import annotations

import hashlib
import json
import random
from dataclasses import dataclass, field

#: every event kind a schedule may emit (the thrasher's action
#: vocabulary + the netem verbs)
EVENT_KINDS = (
    "osd_kill",       # stop the daemon (store survives for the revive)
    "osd_revive",     # restart a killed osd on its surviving store
    "osd_out",        # mon: mark out (remap + backfill away)
    "osd_in",         # mon: mark in again
    "reweight",       # crush reweight an osd
    "mon_restart",    # bounce a monitor (quorum re-forms, catch-up)
    "pg_split",       # double a pool's pg_num
    "scrub",          # shallow scrub a random pg
    "deep_scrub",     # deep scrub a random pg
    "repair",         # pg repair a random pg
    "balance",        # run the upmap balancer
    "partition",      # netem: symmetric partition between two entities
    "heal_partition",  # netem: heal one active partition
    "drop_oneway",    # netem: silently drop src->dst
    "heal_oneway",    # netem: heal one active one-way drop
    "delay",          # netem: fixed per-send latency on a link
    "reorder",        # netem: bounded reordering on a link
    "netem_clear",    # netem: drop every active rule
    # disk-fault verbs (armed through common/fault_injector FAULTS
    # store points, keyed store.<op>.osd.<id>)
    "eio",            # one-shot EIO on an osd's next store read
    "bitflip",        # flip one stored bit at rest on the next read
    "torn_write",     # tear the osd's next transaction commit
    "disk_dead",      # sticky EIO on every read+write (dying disk)
    "slow_disk",      # sticky injected store-commit latency (a disk
                      # that still works but has gone SLOW — the
                      # degraded-disk scenario's beat: SLOW_OPS health,
                      # mgr outlier detection, scrub deprioritization)
    "disk_heal",      # clear every armed store fault on an osd
    # mgr-plane verbs (the mgr is NEVER in the data path: killing it
    # may only cost observability — the workload invariants must be
    # untouched, and report streams must resume after failover)
    "mgr_kill",       # stop a manager daemon (active or standby)
    "mgr_revive",     # restart a killed manager (fresh gid)
    # client-link netem verbs (the PR-10 objecter's resend/backoff/
    # deadline/map-wait paths under REAL partitions — the workload
    # client joins the blast radius; its recorded completions are the
    # ack-aware oracle)
    "client_partition",       # symmetric cut client <-> peer entity
    "heal_client_partition",  # heal one active client cut
    "client_drop",    # one-way silent drop on a client link (either
                      # direction: vanished requests or vanished acks
                      # — the resend-dedup-by-reqid case)
    "heal_client_drop",       # heal one active client drop
    "client_delay",   # fixed per-send latency on a client link
    # fullness-pressure verbs (the nearfull->backfillfull->full->heal
    # ladder driven live against small-capacity stores; application is
    # closed-loop — the runner writes/deletes ballast until the target
    # ratio is observed — but the TRACE stays pure in (seed, scenario))
    "fill",           # write ballast until every up osd >= args[ratio]
    "drain",          # delete ballast until usage falls below nearfull
    # rack-scale correlated-failure verbs (CRUSH failure domains under
    # live fire: the trace kills a WHOLE rack or host at once — args
    # carry the member osd list so replay needs no topology lookup,
    # and the budget guard below guarantees surviving domains always
    # retain >= k shards / >= 1 replica)
    "rack_kill",      # kill every osd of one rack (correlated loss)
    "host_kill",      # kill every osd of one host
    "rack_revive",    # revive every osd of a killed rack
    # control-plane netem verbs: the mon/mgr/mds links join the blast
    # radius (mode: delay / partition / drop toward the osd plane) —
    # the data-plane ack oracle must come through untouched.  mds
    # rules have armed-rule semantics today: chaos clusters run no
    # MDS, so the rule verifiably arms + heals without a data-path
    # bite (the verb exists so traces cover the whole control plane)
    "mon_netem",      # degrade one monitor's links
    "mgr_netem",      # degrade one manager's links
    "mds_netem",      # degrade one mds's links (armed-rule semantics)
    # cache-tier verbs (writeback tier over a base pool: the chaos
    # plane drives the PrimaryLogPG tier machinery — flush dirty
    # objects to the base, evict clean copies, promote-on-miss reads
    # — while the workload's versioned oracle judges last-write-wins
    # through every redirect)
    "tier_flush",     # CACHE_FLUSH one object from the hot pool
    "tier_evict",     # CACHE_EVICT one object from the hot pool
    "tier_promote",   # read via the base pool (promote-on-miss path)
)


@dataclass(frozen=True)
class ChaosEvent:
    """One scheduled action.  ``t`` is the virtual time offset (seconds
    from chaos start; the runner scales it), ``kind`` one of
    EVENT_KINDS, ``args`` the kind-specific parameters."""

    t: float
    kind: str
    args: dict = field(default_factory=dict)

    def to_json(self) -> dict:
        return {"t": self.t, "kind": self.kind, "args": dict(self.args)}


def trace_hash(events: list[ChaosEvent]) -> str:
    """Canonical sha256 over the event trace — the replay assertion:
    regenerating a seed must reproduce this hash bit-identically."""
    blob = json.dumps(
        [e.to_json() for e in events], sort_keys=True,
        separators=(",", ":"),
    ).encode()
    return hashlib.sha256(blob).hexdigest()


class _TraceState:
    """What the generator must remember about its own trace so every
    drawn event is applicable when replayed in order."""

    def __init__(self, n_osds: int, n_mons: int, n_mgrs: int = 0):
        self.alive = set(range(n_osds))     # daemons running
        self.in_set = set(range(n_osds))    # marked in
        self.partitions: list[tuple] = []   # active symmetric cuts
        self.oneways: list[tuple] = []      # active one-way drops
        self.n_mons = n_mons
        self.splits = 0
        self.disk_dead: set[int] = set()    # osds with a sticky-dead disk
        self.slow_disks: set[int] = set()   # osds with injected latency
        self.disk_faulted: set[int] = set()  # osds with ANY store fault
        self.last_damage = -1e9  # t of the last AT-REST damage event
        self.mgr_alive = set(range(n_mgrs))  # manager daemons running
        self.client_cuts: list[tuple] = []   # active client partitions
        self.client_drops: list[tuple] = []  # active client one-way drops


def _entity_pool(rng: random.Random, scenario: dict) -> list[tuple]:
    """Link endpoints netem rules may target: osd<->osd and, in
    multi-mon scenarios, osd<->mon links (never client links — the
    workload oracle needs its acks)."""
    ents = [("osd", i) for i in range(scenario["n_osds"])]
    if scenario.get("n_mons", 1) > 1:
        ents += [("mon", r) for r in range(scenario["n_mons"])]
    return ents


def _client_peer(rng: random.Random, scenario: dict) -> tuple:
    """The far end of a client-link netem rule: one specific OSD, or
    — about a quarter of draws — the ("osd", None) wildcard cutting
    the client off from the WHOLE data plane at once (mon links stay
    up: the session/command plane is the observer, never the target —
    the oracle judges the objecter's data path)."""
    if rng.random() < 0.25:
        return ("osd", None)
    return ("osd", rng.randrange(scenario["n_osds"]))


def generate_schedule(seed: int, scenario: dict) -> list[ChaosEvent]:
    """Draw ``scenario['n_events']`` events over ``scenario
    ['duration']`` virtual seconds, honoring the scenario's event-mix
    weights and its safety budgets.  Pure in ``(seed, scenario)``."""
    rng = random.Random(f"chaos:{seed}:{scenario['name']}")
    n_osds = scenario["n_osds"]
    n_mons = scenario.get("n_mons", 1)
    n_events = scenario.get("n_events", 10)
    duration = float(scenario.get("duration", 5.0))
    mix = dict(scenario.get("mix", {"osd_kill": 1.0}))
    # revive/heal verbs are implied counterparts, not independent
    # draws: the generator emits them to keep its budgets
    for implied in ("osd_revive", "osd_in", "heal_partition",
                    "heal_oneway"):
        mix.pop(implied, None)
    # at most this many osds simultaneously dead+out: keeps a k+m EC
    # pool writable while the thrash runs (the OSDThrasher's
    # min_in/max_dead budget)
    max_dead = scenario_max_dead(scenario)
    max_cuts = scenario.get("max_partitions", 1)
    pg_pools = [p["name"] for p in scenario.get("pools", [])] or ["rep"]

    st = _TraceState(n_osds, n_mons, scenario.get("n_mgrs", 0))
    kinds = sorted(mix)
    weights = [float(mix[k]) for k in kinds]
    times = sorted(round(rng.uniform(0.05, duration), 3)
                   for _ in range(n_events))
    events: list[ChaosEvent] = []

    def emit(t: float, kind: str, **args) -> None:
        events.append(ChaosEvent(t=t, kind=kind, args=args))

    # degraded-disk scenarios pin ONE guaranteed early slow_disk so
    # the mgr pipeline (reports -> analytics -> outlier -> SLOW_OPS)
    # always has a full observation window; the victim still derives
    # from the seed (pure in (seed, scenario) like every other draw)
    lead_at = scenario.get("slow_disk_at")
    if lead_at is not None:
        victim = rng.randrange(n_osds)
        st.slow_disks.add(victim)
        st.disk_faulted.add(victim)
        emit(round(float(lead_at), 3), "slow_disk", osd=victim,
             delay=float(scenario.get("slow_disk_delay", 0.5)))

    # client-netem scenarios pin ONE guaranteed early client partition
    # (the acceptance oracle demands a partition that verifiably
    # FIRED in every trace): the pinned cut always takes the
    # ("osd", None) wildcard — a specific osd may lead no PG, and a
    # cut nothing sends through proves nothing.  Only the ttl derives
    # from the seed; mix-drawn cuts keep their seed-varied peers.
    # the pinned cut lives OUTSIDE the mix budget (its own slot,
    # healed by ttl + trace end): letting a mix-drawn cut budget-pop
    # it could heal it milliseconds after it armed, and the oracle
    # would rightly flag a partition that never bit a send
    lead_cut = scenario.get("client_partition_at")
    pinned_cut = None
    if lead_cut is not None:
        pinned_cut = ("osd", None)
        emit(round(float(lead_cut), 3), "client_partition",
             peer=list(pinned_cut),
             ttl=round(rng.uniform(0.4, 1.0), 3))

    # fullness-pressure scenarios pin the whole gating ladder as a
    # scripted skeleton (like slow_disk_at: the ladder must ALWAYS
    # progress, only its timing and the outed victim vary with the
    # seed).  Order is the invariant under test: nearfull first, then
    # backfillfull BEFORE the osd_out so the triggered backfill meets
    # REJECT_TOOFULL live (recovery.py backfillfull gate), then full
    # (client writes must bounce ENOSPC), then drain + heal.  The
    # fill/drain application is closed-loop in the runner; the trace —
    # order, targets, victim — is pure in (seed, scenario).
    if scenario.get("fullness_script"):
        t_f = round(0.2 + rng.uniform(0.0, 0.3), 3)
        emit(t_f, "fill", level="nearfull",
             ratio=float(scenario.get("nearfull_fill", 0.86)))
        t_f = round(t_f + 0.3 + rng.uniform(0.0, 0.3), 3)
        emit(t_f, "fill", level="backfillfull",
             ratio=float(scenario.get("backfillfull_fill", 0.91)))
        victim = rng.randrange(n_osds)
        t_f = round(t_f + 0.2 + rng.uniform(0.0, 0.2), 3)
        st.in_set.discard(victim)
        emit(t_f, "osd_out", osd=victim)
        t_f = round(t_f + 0.3 + rng.uniform(0.0, 0.3), 3)
        emit(t_f, "fill", level="full",
             ratio=float(scenario.get("full_fill", 0.955)))
        t_f = round(t_f + 0.4 + rng.uniform(0.0, 0.4), 3)
        emit(t_f, "drain")
        # the generic trace-end wholeness below emits the osd_in

    # rack-scale correlated-failure skeleton: kill ONE whole failure
    # domain — every osd of a seed-chosen rack — dwell, revive, and
    # optionally follow with a single-host kill in a DIFFERENT rack.
    # Budget: the surviving racks must retain >= k shards (EC) or
    # >= 1 replica, which one-shard-per-rack placement guarantees
    # exactly when racks - 1 >= max(k, 1); the guard refuses to emit
    # an unsurvivable trace rather than emit one that loses data by
    # construction.  Rack scenarios keep osd_kill/osd_out OUT of
    # their mix so a mix draw can never double-kill a scripted victim.
    if scenario.get("rack_script"):
        topo = scenario["topology"]
        per_host = int(topo.get("osds_per_host", 1))
        hosts_per_rack = int(topo.get("hosts_per_rack", 1))
        per_rack = per_host * hosts_per_rack
        n_racks = int(topo["racks"])
        need = max(
            (p.get("k", p.get("size", 2))
             for p in scenario.get("pools", [])), default=1)
        if n_racks - 1 >= need:
            rack = rng.randrange(n_racks)
            osds = list(range(rack * per_rack, (rack + 1) * per_rack))
            t_k = round(0.4 + rng.uniform(0.0, 0.4), 3)
            st.alive.difference_update(osds)
            emit(t_k, "rack_kill", rack=rack, osds=osds)
            dwell = float(scenario.get(
                "rack_dwell", max(0.8, duration * 0.3)))
            t_r = round(t_k + dwell + rng.uniform(0.0, 0.3), 3)
            st.alive.update(osds)
            emit(t_r, "rack_revive", rack=rack, osds=osds)
            if scenario.get("host_kill_after"):
                # a second, smaller correlated loss after the rack
                # revives: one whole host in a different rack (its
                # members stay dead until trace-end wholeness)
                other = rng.choice(
                    [r for r in range(n_racks) if r != rack])
                host = (other * hosts_per_rack
                        + rng.randrange(hosts_per_rack))
                hosds = list(range(
                    host * per_host, (host + 1) * per_host))
                t_h = round(t_r + 0.3 + rng.uniform(0.0, 0.3), 3)
                st.alive.difference_update(hosds)
                emit(t_h, "host_kill", host=host, osds=hosds)

    # long-soak skeleton: ONE victim goes down early and stays down
    # for most of the trace while the paced workload churns every pg
    # log past the trim horizon (the scenario's conf pins tiny
    # osd_min/max_pg_log_entries), so the revived member PREDATES
    # every surviving log tail and recovery MUST take the backfill
    # path — the runner's check_backfill invariant demands the
    # backfill_started/backfill_completed counters prove it.  A
    # second, shorter kill lands while that backfill runs (the
    # backfill TARGET itself, or a seed-chosen live source member) to
    # prove the persisted cursor resumes an interrupted pass.
    if scenario.get("soak_script"):
        victim = rng.randrange(n_osds)
        t_k = round(0.3 + rng.uniform(0.0, 0.2), 3)
        st.alive.discard(victim)
        emit(t_k, "osd_kill", osd=victim)
        dwell = float(scenario.get("soak_outage", duration * 0.55))
        t_r = round(t_k + dwell + rng.uniform(0.0, 0.2), 3)
        st.alive.add(victim)
        emit(t_r, "osd_revive", osd=victim)
        mode = scenario.get("soak_interrupt", "target")
        if mode:
            if mode == "target":
                v2 = victim
            else:
                v2 = rng.choice(sorted(st.alive - {victim}))
            # fire just after the revive: the runner holds THIS kill
            # (await_backfill) until a backfill pass is verifiably in
            # flight, so the interrupt lands mid-transfer instead of
            # racing the revived member's boot — arming the gate
            # BEFORE the first pass can start is what makes the
            # mid-transfer hit deterministic (the trace itself stays
            # pure — the gate shifts delivery, not the event)
            t_k2 = round(t_r + 0.1 + rng.uniform(0.0, 0.1), 3)
            st.alive.discard(v2)
            emit(t_k2, "osd_kill", osd=v2, await_backfill=True)
            t_r2 = round(t_k2 + 0.4 + rng.uniform(0.0, 0.3), 3)
            st.alive.add(v2)
            emit(t_r2, "osd_revive", osd=v2)

    # control-plane blast-radius skeleton: one guaranteed beat per
    # plane — a mon link degradation (delay when the quorum cannot
    # spare a member, else partition), a mgr link fault, and an mds
    # rule (armed-rule semantics) — so every trace provably put the
    # control plane in the blast radius while the data-plane oracle
    # earned its acks.
    if scenario.get("control_netem"):
        t_c = round(0.3 + rng.uniform(0.0, 0.3), 3)
        emit(t_c, "mon_netem", rank=rng.randrange(n_mons),
             mode="partition" if n_mons >= 3 else "delay",
             seconds=round(rng.uniform(0.01, 0.04), 4),
             ttl=round(rng.uniform(0.5, 1.2), 3))
        if scenario.get("n_mgrs", 0) > 0:
            t_c = round(t_c + 0.3 + rng.uniform(0.0, 0.3), 3)
            emit(t_c, "mgr_netem",
                 mgr=rng.randrange(scenario["n_mgrs"]),
                 mode=rng.choice(["partition", "drop", "delay"]),
                 seconds=round(rng.uniform(0.01, 0.04), 4),
                 ttl=round(rng.uniform(0.5, 1.2), 3))
        t_c = round(t_c + 0.3 + rng.uniform(0.0, 0.3), 3)
        emit(t_c, "mds_netem", mds=0, mode="delay",
             seconds=round(rng.uniform(0.01, 0.04), 4),
             ttl=round(rng.uniform(0.5, 1.0), 3))

    for t in times:
        kind = rng.choices(kinds, weights=weights)[0]
        dead = sorted(set(range(n_osds)) - st.alive)
        outed = sorted(set(range(n_osds)) - st.in_set)
        down_ish = len(dead) + len(set(outed) - set(dead))
        if kind == "osd_kill":
            if down_ish >= max_dead:
                # budget spent: revive the longest-dead instead
                if dead:
                    emit(t, "osd_revive", osd=dead[0])
                    st.alive.add(dead[0])
                elif outed:
                    emit(t, "osd_in", osd=outed[0])
                    st.in_set.add(outed[0])
                continue
            victim = rng.choice(sorted(st.alive))
            st.alive.discard(victim)
            emit(t, "osd_kill", osd=victim)
        elif kind == "osd_out":
            if down_ish >= max_dead or len(st.in_set) <= 2:
                if outed:
                    emit(t, "osd_in", osd=outed[0])
                    st.in_set.add(outed[0])
                continue
            victim = rng.choice(sorted(st.in_set))
            st.in_set.discard(victim)
            emit(t, "osd_out", osd=victim)
        elif kind == "reweight":
            emit(t, "reweight", osd=rng.randrange(n_osds),
                 weight=round(rng.choice([0.25, 0.5, 0.75, 1.0]), 2))
        elif kind == "mon_restart":
            if n_mons < 2:
                continue  # single-mon cluster: a restart is an outage
            emit(t, "mon_restart", rank=rng.randrange(n_mons))
        elif kind == "pg_split":
            if st.splits >= scenario.get("max_splits", 1):
                continue
            st.splits += 1
            emit(t, "pg_split", pool=rng.choice(pg_pools))
        elif kind in ("scrub", "deep_scrub", "repair"):
            emit(t, kind, pool=rng.choice(pg_pools))
        elif kind in ("eio", "bitflip", "torn_write", "disk_dead"):
            # store faults against a LIVE osd (arming a dead daemon's
            # store exercises nothing).  AT-REST damage (bitflip,
            # disk_dead) respects a redundancy budget the way kills
            # respect max_dead: at most ONE outstanding dying disk,
            # and consecutive damage events at least damage_gap apart
            # so quarantine + background repair can restore
            # reconstructibility between hits — two unhealed rotten
            # copies of the same object is operator data loss
            # (exceeding m), not a cluster bug.  Over-budget draws
            # DOWNGRADE to a transient one-shot eio.
            victims = sorted(st.alive - st.disk_dead)
            if not victims:
                continue
            victim = rng.choice(victims)
            gap = float(scenario.get("damage_gap", 1.0))
            damaging = kind in ("bitflip", "disk_dead")
            if damaging and (
                st.disk_dead or t - st.last_damage < gap
            ):
                kind = "eio"
            elif kind == "disk_dead" and down_ish >= max_dead:
                kind = "eio"  # the victim will suicide: kill budget
            if kind == "disk_dead":
                st.alive.discard(victim)
                st.disk_dead.add(victim)
            if kind in ("bitflip", "disk_dead"):
                st.last_damage = t
            st.disk_faulted.add(victim)
            emit(t, kind, osd=victim)
        elif kind == "slow_disk":
            # one slow disk at a time: two simultaneously-slow members
            # of a size-2/k+1 pool is an availability study, not the
            # degraded-disk scenario's detection beat
            victims = sorted(st.alive - st.disk_dead - st.slow_disks)
            if st.slow_disks or not victims:
                continue
            victim = rng.choice(victims)
            st.slow_disks.add(victim)
            st.disk_faulted.add(victim)
            emit(t, "slow_disk", osd=victim,
                 delay=float(scenario.get("slow_disk_delay", 0.5)))
        elif kind == "mgr_kill":
            # no down-budget: losing EVERY mgr is legal (observability
            # gap, not data loss) — but a dead set yields the revive
            # instead so the trace keeps exercising failovers
            if not st.mgr_alive:
                dead_mgrs = sorted(
                    set(range(scenario.get("n_mgrs", 0))) - st.mgr_alive)
                if dead_mgrs:
                    emit(t, "mgr_revive", mgr=dead_mgrs[0])
                    st.mgr_alive.add(dead_mgrs[0])
                continue
            victim = rng.choice(sorted(st.mgr_alive))
            st.mgr_alive.discard(victim)
            emit(t, "mgr_kill", mgr=victim)
        elif kind == "balance":
            emit(t, "balance", max_swaps=8)
        elif kind == "partition":
            if len(st.partitions) >= max_cuts:
                cut = st.partitions.pop(rng.randrange(len(st.partitions)))
                emit(t, "heal_partition", a=list(cut[0]), b=list(cut[1]))
                continue
            ents = _entity_pool(rng, scenario)
            a, b = rng.sample(ents, 2)
            st.partitions.append((a, b))
            emit(t, "partition", a=list(a), b=list(b),
                 ttl=round(rng.uniform(0.3, 1.2), 3))
        elif kind == "drop_oneway":
            if len(st.oneways) >= max_cuts:
                link = st.oneways.pop(rng.randrange(len(st.oneways)))
                emit(t, "heal_oneway", src=list(link[0]), dst=list(link[1]))
                continue
            ents = _entity_pool(rng, scenario)
            a, b = rng.sample(ents, 2)
            st.oneways.append((a, b))
            emit(t, "drop_oneway", src=list(a), dst=list(b),
                 ttl=round(rng.uniform(0.3, 1.0), 3))
        elif kind == "delay":
            ents = _entity_pool(rng, scenario)
            a, b = rng.sample(ents, 2)
            emit(t, "delay", src=list(a), dst=list(b),
                 seconds=round(rng.uniform(0.005, 0.04), 4),
                 ttl=round(rng.uniform(0.3, 1.5), 3))
        elif kind == "reorder":
            ents = _entity_pool(rng, scenario)
            a, b = rng.sample(ents, 2)
            emit(t, "reorder", src=list(a), dst=list(b),
                 every=rng.choice([2, 3, 5]),
                 hold=round(rng.uniform(0.005, 0.03), 4),
                 ttl=round(rng.uniform(0.3, 1.5), 3))
        elif kind == "client_partition":
            max_client = scenario.get("max_client_cuts", 1)
            if len(st.client_cuts) >= max_client:
                cut = st.client_cuts.pop(
                    rng.randrange(len(st.client_cuts)))
                emit(t, "heal_client_partition", peer=list(cut))
                continue
            peer = _client_peer(rng, scenario)
            st.client_cuts.append(peer)
            emit(t, "client_partition", peer=list(peer),
                 ttl=round(rng.uniform(0.3, 1.0), 3))
        elif kind == "client_drop":
            max_client = scenario.get("max_client_cuts", 1)
            if len(st.client_drops) >= max_client:
                link = st.client_drops.pop(
                    rng.randrange(len(st.client_drops)))
                emit(t, "heal_client_drop", peer=list(link[0]),
                     to_client=link[1])
                continue
            peer = _client_peer(rng, scenario)
            # direction matters: dropping client->osd loses requests
            # (deadline/backoff beat); dropping osd->client loses ACKS
            # of APPLIED writes (the resend must dedup by reqid)
            to_client = rng.random() < 0.5
            st.client_drops.append((peer, to_client))
            emit(t, "client_drop", peer=list(peer), to_client=to_client,
                 ttl=round(rng.uniform(0.3, 0.8), 3))
        elif kind == "client_delay":
            peer = _client_peer(rng, scenario)
            emit(t, "client_delay", peer=list(peer),
                 seconds=round(rng.uniform(0.005, 0.05), 4),
                 ttl=round(rng.uniform(0.3, 1.5), 3))
        elif kind in ("mon_netem", "mgr_netem", "mds_netem"):
            # control-plane link faults self-heal by ttl (plus the
            # trace-end netem_clear), so they carry no trace state
            if kind == "mon_netem":
                who = {"rank": rng.randrange(n_mons)}
                mode = rng.choice(["delay", "partition", "drop"])
                if n_mons < 3 and mode == "partition":
                    # a quorum that cannot spare a member only gets
                    # its links SLOWED, never cut
                    mode = "delay"
            elif kind == "mgr_netem":
                n_mgrs = scenario.get("n_mgrs", 0)
                if n_mgrs < 1:
                    continue
                who = {"mgr": rng.randrange(n_mgrs)}
                mode = rng.choice(["delay", "partition", "drop"])
            else:
                who = {"mds": 0}
                mode = "delay"
            emit(t, kind, mode=mode,
                 seconds=round(rng.uniform(0.005, 0.04), 4),
                 ttl=round(rng.uniform(0.3, 1.0), 3), **who)
        elif kind in ("tier_flush", "tier_evict", "tier_promote"):
            tier = scenario.get("tier")
            if not tier:
                continue
            n_obj = int(scenario.get("workload", {}).get("objects", 3))
            emit(t, kind, base=tier["base"], hot=tier["hot"],
                 oid=f"{tier['base']}-obj{rng.randrange(n_obj)}")
        elif kind == "netem_clear":
            st.partitions.clear()
            st.oneways.clear()
            st.client_cuts.clear()
            st.client_drops.clear()
            emit(t, "netem_clear")
    # the trace always ends whole: every dead osd revives, every outed
    # osd returns, every cut heals — the runner's convergence invariant
    # judges a complete cluster, not a half-thrashed one
    t_end = round(duration + 0.05, 3)
    for cut in st.partitions:
        emit(t_end, "heal_partition", a=list(cut[0]), b=list(cut[1]))
    for link in st.oneways:
        emit(t_end, "heal_oneway", src=list(link[0]), dst=list(link[1]))
    for peer in st.client_cuts:
        emit(t_end, "heal_client_partition", peer=list(peer))
    if pinned_cut is not None:
        emit(t_end, "heal_client_partition", peer=list(pinned_cut))
    for peer, to_client in st.client_drops:
        emit(t_end, "heal_client_drop", peer=list(peer),
             to_client=to_client)
    emit(t_end, "netem_clear")
    for osd in sorted(st.disk_faulted):
        # every fault-touched disk heals at trace end: sticky-dead
        # disks must heal BEFORE the revive below (a restarted daemon
        # must not boot onto a store still returning EIO), and an
        # armed-but-unfired one-shot fault must not fire later, inside
        # the runner's post-thrash verification sweeps
        emit(t_end, "disk_heal", osd=osd)
    for osd in sorted(set(range(n_osds)) - st.alive):
        emit(t_end, "osd_revive", osd=osd)
    for osd in sorted(set(range(n_osds)) - st.in_set):
        emit(t_end, "osd_in", osd=osd)
    for mgr in sorted(set(range(scenario.get("n_mgrs", 0)))
                      - st.mgr_alive):
        emit(t_end, "mgr_revive", mgr=mgr)
    # scripted-ladder scenarios interleave pinned events with mix
    # draws: a STABLE sort restores replay order.  Gated — legacy
    # scenarios' committed trace hashes encode their emission order
    # (e.g. the degraded-disk slow_disk lead precedes earlier-t mix
    # draws) and must replay bit-identically forever.
    if (scenario.get("fullness_script") or scenario.get("rack_script")
            or scenario.get("soak_script")
            or scenario.get("control_netem")):
        events.sort(key=lambda e: e.t)
    return events


# -- trace schema + applicability (the fuzz plane's contract) ---------------
#
# The mutation engine (ceph_tpu/fuzz/mutate.py) edits raw event lists;
# everything below is what keeps its output runnable: a per-kind arg
# schema, per-scenario verb applicability, a validator that refuses a
# trace the runner could not replay, and a deterministic repair pass
# that normalizes an arbitrary edit back into a legal trace.  All of
# it is pure — no clock, no shared RNG — because mutant traces carry
# the same committed-hash contract as generated ones.

_INT = (int,)
_NUM = (int, float)

#: required args per event kind (optional args — ttl, await_backfill —
#: are not listed; extra keys are allowed)
EVENT_ARG_SCHEMA: dict[str, dict[str, tuple | type]] = {
    "osd_kill": {"osd": _INT}, "osd_revive": {"osd": _INT},
    "osd_out": {"osd": _INT}, "osd_in": {"osd": _INT},
    "reweight": {"osd": _INT, "weight": _NUM},
    "mon_restart": {"rank": _INT},
    "pg_split": {"pool": str},
    "scrub": {"pool": str}, "deep_scrub": {"pool": str},
    "repair": {"pool": str},
    "balance": {},
    "partition": {"a": list, "b": list},
    "heal_partition": {"a": list, "b": list},
    "drop_oneway": {"src": list, "dst": list},
    "heal_oneway": {"src": list, "dst": list},
    "delay": {"src": list, "dst": list, "seconds": _NUM},
    "reorder": {"src": list, "dst": list, "every": _INT, "hold": _NUM},
    "netem_clear": {},
    "eio": {"osd": _INT}, "bitflip": {"osd": _INT},
    "torn_write": {"osd": _INT}, "disk_dead": {"osd": _INT},
    "slow_disk": {"osd": _INT, "delay": _NUM},
    "disk_heal": {"osd": _INT},
    "mgr_kill": {"mgr": _INT}, "mgr_revive": {"mgr": _INT},
    "client_partition": {"peer": list},
    "heal_client_partition": {"peer": list},
    "client_drop": {"peer": list, "to_client": bool},
    "heal_client_drop": {"peer": list, "to_client": bool},
    "client_delay": {"peer": list, "seconds": _NUM},
    "fill": {"level": str, "ratio": _NUM}, "drain": {},
    "rack_kill": {"rack": _INT, "osds": list},
    "host_kill": {"host": _INT, "osds": list},
    "rack_revive": {"rack": _INT, "osds": list},
    "mon_netem": {"rank": _INT, "mode": str, "seconds": _NUM},
    "mgr_netem": {"mgr": _INT, "mode": str, "seconds": _NUM},
    "mds_netem": {"mds": _INT, "mode": str, "seconds": _NUM},
    "tier_flush": {"base": str, "hot": str, "oid": str},
    "tier_evict": {"base": str, "hot": str, "oid": str},
    "tier_promote": {"base": str, "hot": str, "oid": str},
}


def scenario_max_dead(scenario: dict) -> int:
    """The scenario's simultaneous dead+out budget: keeps a k+m EC
    pool writable while the thrash runs (the OSDThrasher's
    min_in/max_dead budget)."""
    n_osds = scenario["n_osds"]
    max_dead = scenario.get("max_dead", max(1, n_osds - 1 - max(
        p.get("k", p.get("size", 2)) + p.get("m", 0)
        for p in scenario.get("pools", [{"size": 2}])
    )))
    return max(1, min(max_dead, n_osds - 2))


def scenario_verbs(scenario: dict) -> tuple[str, ...]:
    """Every verb a LEGAL trace for this scenario may contain — the
    validator's vocabulary.  Scenario-dependent gates mirror the
    generator's own refusals (a verb the generator would never draw
    here is a verb the runner cannot meaningfully replay here)."""
    out = set(EVENT_KINDS)
    if scenario.get("n_mons", 1) < 2:
        out.discard("mon_restart")
    if not scenario.get("n_mgrs"):
        out -= {"mgr_kill", "mgr_revive", "mgr_netem"}
    if not scenario.get("client_netem"):
        out -= {"client_partition", "heal_client_partition",
                "client_drop", "heal_client_drop", "client_delay"}
    if not scenario.get("topology"):
        out -= {"rack_kill", "host_kill", "rack_revive"}
    if not scenario.get("tier"):
        out -= {"tier_flush", "tier_evict", "tier_promote"}
    if scenario.get("store") != "blockstore":
        # at-rest disk faults need a store whose lies surface like
        # real media errors (MemStore has no at-rest bytes to rot);
        # slow_disk/disk_heal stay — injected commit latency works on
        # any store and every fault-touched disk heals at trace end
        out -= {"eio", "bitflip", "torn_write", "disk_dead"}
    if not scenario.get("capacity_bytes"):
        # the fullness ladder needs small-capacity stores the
        # closed-loop ballast writer can actually push over a ratio
        out -= {"fill", "drain"}
    return tuple(sorted(out))


def applicable_verbs(scenario: dict) -> tuple[str, ...]:
    """The CROSS-BREEDING pool: verbs a mutant may inject into this
    scenario's traces and still be expected to run green.  Stricter
    than :func:`scenario_verbs` — the fuzzer's job is to find bugs,
    not to manufacture reds out of oracle preconditions:

    - fill/drain stay out everywhere (the application is closed-loop
      against store capacity; injected mid-trace they starve or stall
      foreign workloads);
    - rack verbs stay out (args carry topology member lists; only the
      scripted skeleton knows a survivable one);
    - kills/outs stay out of topology and fullness scenarios (their
      scripted ladders budget the failure pattern themselves — the
      same reason their mixes exclude them);
    - at-rest damage (bitflip/disk_dead) stays out — the generator
      meters damage with a redundancy budget (damage_gap, one dying
      disk); a mutant splicing a second hit is operator data loss,
      not a found bug.  Transient eio/torn_write join only self_heal
      scenarios (the repair sweep is the heal path for their debris);
    - slow_disk stays out of watch_events scenarios (a late SLOW_OPS
      clear reads as settle debris to check_events).
    """
    out = {
        "reweight", "scrub", "deep_scrub", "repair", "balance",
        "partition", "drop_oneway", "delay", "reorder", "netem_clear",
        "pg_split", "mon_netem", "mds_netem", "osd_kill", "osd_out",
    }
    if scenario.get("n_mons", 1) >= 2:
        out.add("mon_restart")
    if scenario.get("n_mgrs"):
        out |= {"mgr_kill", "mgr_netem"}
    if scenario.get("client_netem"):
        out |= {"client_partition", "client_drop", "client_delay"}
    if scenario.get("tier"):
        out |= {"tier_flush", "tier_evict", "tier_promote"}
    if scenario.get("store") == "blockstore" and scenario.get(
            "self_heal"):
        out |= {"eio", "torn_write"}
    if scenario.get("watch_events"):
        out.discard("slow_disk")
    if scenario.get("topology") or scenario.get("fullness_script"):
        out -= {"osd_kill", "osd_out"}
    return tuple(sorted(out))


def events_to_json(events: list[ChaosEvent]) -> list[dict]:
    return [e.to_json() for e in events]


def events_from_json(recs: list[dict]) -> list[ChaosEvent]:
    return [
        ChaosEvent(t=float(r["t"]), kind=r["kind"],
                   args=dict(r.get("args") or {}))
        for r in recs
    ]


class _ReplayState:
    """The validator/repairer's legality simulation — the same state
    discipline the generator keeps internally, replayed over an
    arbitrary event list."""

    def __init__(self, scenario: dict):
        n = scenario["n_osds"]
        self.n_osds = n
        self.n_mons = scenario.get("n_mons", 1)
        self.n_mgrs = scenario.get("n_mgrs", 0)
        self.alive = set(range(n))
        self.in_set = set(range(n))
        self.mgr_alive = set(range(self.n_mgrs))
        self.partitions: list[tuple] = []
        self.oneways: list[tuple] = []
        self.client_cuts: list[tuple] = []
        self.client_drops: list[tuple] = []
        self.faulted: set[int] = set()
        self.rack_dead: set[int] = set()  # dead via rack/host kills
        self.splits = 0
        self.max_dead = scenario_max_dead(scenario)
        self.max_cuts = scenario.get("max_partitions", 1)
        # the generator's pinned client cut (client_partition_at)
        # lives OUTSIDE the mix budget — its own slot
        self.max_client = scenario.get("max_client_cuts", 1) + (
            1 if scenario.get("client_partition_at") is not None
            else 0)
        self.max_splits = scenario.get("max_splits", 1)

    def down_budget_used(self) -> int:
        """Mix-killed/outed osds counted against max_dead (rack-script
        correlated kills run their own survivability budget)."""
        dead = (set(range(self.n_osds)) - self.alive) - self.rack_dead
        outed = set(range(self.n_osds)) - self.in_set
        return len(dead) + len(outed - dead)

    def whole(self) -> bool:
        return (self.alive == set(range(self.n_osds))
                and self.in_set == set(range(self.n_osds))
                and self.mgr_alive == set(range(self.n_mgrs))
                and not self.partitions and not self.oneways
                and not self.client_cuts and not self.client_drops
                and not self.faulted)


def _check_args(e: ChaosEvent) -> str | None:
    """Schema check one event; returns a violation string or None."""
    schema = EVENT_ARG_SCHEMA.get(e.kind)
    if schema is None:
        return f"unknown event kind {e.kind!r}"
    if not isinstance(e.args, dict):
        return f"{e.kind}: args is not a dict"
    for key, typ in sorted(schema.items()):
        if key not in e.args:
            return f"{e.kind}: missing arg {key!r}"
        if not isinstance(e.args[key], typ):
            return (f"{e.kind}: arg {key!r}={e.args[key]!r} is not "
                    f"{typ!r}")
    if not isinstance(e.t, _NUM):
        return f"{e.kind}: t={e.t!r} is not a number"
    return None


def _step(st: _ReplayState, e: ChaosEvent,
          scenario: dict) -> str | None:
    """Advance the legality simulation by one event; returns a
    violation string (state unchanged) or None (state advanced).
    Shared by validate_trace (reject) and repair_trace (drop)."""
    a = e.args
    k = e.kind

    def _osd_ok(o) -> bool:
        return 0 <= o < st.n_osds

    if k == "osd_kill":
        if not _osd_ok(a["osd"]) or a["osd"] not in st.alive:
            return f"osd_kill {a['osd']}: not alive"
        if (a["osd"] not in (set(range(st.n_osds)) - st.in_set)
                and st.down_budget_used() >= st.max_dead):
            return f"osd_kill {a['osd']}: max_dead budget spent"
        st.alive.discard(a["osd"])
    elif k == "osd_revive":
        if not _osd_ok(a["osd"]) or a["osd"] in st.alive:
            return f"osd_revive {a['osd']}: already alive"
        st.alive.add(a["osd"])
        st.rack_dead.discard(a["osd"])
    elif k == "osd_out":
        if not _osd_ok(a["osd"]) or a["osd"] not in st.in_set:
            return f"osd_out {a['osd']}: already out"
        if len(st.in_set) <= 2:
            return f"osd_out {a['osd']}: would leave < 2 in"
        if (a["osd"] in st.alive
                and st.down_budget_used() >= st.max_dead):
            return f"osd_out {a['osd']}: max_dead budget spent"
        st.in_set.discard(a["osd"])
    elif k == "osd_in":
        if not _osd_ok(a["osd"]) or a["osd"] in st.in_set:
            return f"osd_in {a['osd']}: already in"
        st.in_set.add(a["osd"])
    elif k in ("reweight", "eio", "bitflip", "torn_write",
               "slow_disk", "disk_dead"):
        if not _osd_ok(a["osd"]):
            return f"{k}: osd {a['osd']} out of range"
        if k != "reweight":
            if a["osd"] not in st.alive:
                return f"{k} {a['osd']}: arming a dead osd's store"
            st.faulted.add(a["osd"])
            if k == "disk_dead":
                if st.down_budget_used() >= st.max_dead:
                    return f"disk_dead {a['osd']}: max_dead budget"
                st.alive.discard(a["osd"])
    elif k == "disk_heal":
        if not _osd_ok(a["osd"]):
            return f"disk_heal: osd {a['osd']} out of range"
        st.faulted.discard(a["osd"])
    elif k == "mon_restart":
        if st.n_mons < 2:
            return "mon_restart: single-mon cluster"
        if not 0 <= a["rank"] < st.n_mons:
            return f"mon_restart: rank {a['rank']} out of range"
    elif k == "pg_split":
        if st.splits >= st.max_splits:
            return "pg_split: max_splits budget spent"
        st.splits += 1
    elif k in ("mgr_kill", "mgr_revive"):
        if not 0 <= a["mgr"] < st.n_mgrs:
            return f"{k}: mgr {a['mgr']} out of range"
        if k == "mgr_kill":
            if a["mgr"] not in st.mgr_alive:
                return f"mgr_kill {a['mgr']}: already dead"
            st.mgr_alive.discard(a["mgr"])
        else:
            if a["mgr"] in st.mgr_alive:
                return f"mgr_revive {a['mgr']}: already alive"
            st.mgr_alive.add(a["mgr"])
    elif k == "partition":
        if len(st.partitions) >= st.max_cuts:
            return "partition: max_partitions budget spent"
        st.partitions.append((tuple(a["a"]), tuple(a["b"])))
    elif k == "heal_partition":
        cut = (tuple(a["a"]), tuple(a["b"]))
        rcut = (cut[1], cut[0])
        if cut in st.partitions:
            st.partitions.remove(cut)
        elif rcut in st.partitions:
            st.partitions.remove(rcut)
    elif k == "drop_oneway":
        if len(st.oneways) >= st.max_cuts:
            return "drop_oneway: max_partitions budget spent"
        st.oneways.append((tuple(a["src"]), tuple(a["dst"])))
    elif k == "heal_oneway":
        link = (tuple(a["src"]), tuple(a["dst"]))
        if link in st.oneways:
            st.oneways.remove(link)
    elif k == "client_partition":
        if len(st.client_cuts) >= st.max_client:
            return "client_partition: max_client_cuts budget spent"
        st.client_cuts.append(tuple(a["peer"]))
    elif k == "heal_client_partition":
        peer = tuple(a["peer"])
        if peer in st.client_cuts:
            st.client_cuts.remove(peer)
    elif k == "client_drop":
        if len(st.client_drops) >= st.max_client:
            return "client_drop: max_client_cuts budget spent"
        st.client_drops.append((tuple(a["peer"]), a["to_client"]))
    elif k == "heal_client_drop":
        link = (tuple(a["peer"]), a["to_client"])
        if link in st.client_drops:
            st.client_drops.remove(link)
    elif k == "netem_clear":
        st.partitions.clear()
        st.oneways.clear()
        st.client_cuts.clear()
        st.client_drops.clear()
    elif k in ("rack_kill", "host_kill"):
        osds = set(a["osds"])
        if not osds <= st.alive:
            return f"{k}: members {sorted(osds - st.alive)} not alive"
        st.alive -= osds
        st.rack_dead |= osds
    elif k == "rack_revive":
        osds = set(a["osds"])
        if osds & st.alive:
            return (f"rack_revive: members "
                    f"{sorted(osds & st.alive)} already alive")
        st.alive |= osds
        st.rack_dead -= osds
    elif k == "mon_netem":
        if not 0 <= a["rank"] < st.n_mons:
            return f"mon_netem: rank {a['rank']} out of range"
        if a["mode"] == "partition" and st.n_mons < 3:
            return ("mon_netem: a quorum that cannot spare a member "
                    "only gets its links slowed, never cut")
    elif k == "mgr_netem":
        if not 0 <= a["mgr"] < st.n_mgrs:
            return f"mgr_netem: mgr {a['mgr']} out of range"
    # delay/reorder/scrub/deep_scrub/repair/balance/mds_netem/
    # client_delay/fill/drain/tier_*: stateless (or closed-loop in the
    # runner); schema + scenario_verbs gating is the whole contract
    return None


def validate_trace(events: list[ChaosEvent],
                   scenario: dict) -> list[str]:
    """Refuse a trace the runner could not replay: schema violations,
    out-of-vocabulary verbs, unsorted times, legality/budget breaks,
    or a trace that does not end whole.  Returns violation strings
    (empty = valid).  Every generated trace validates; every repaired
    mutant must too."""
    out: list[str] = []
    vocab = set(scenario_verbs(scenario))
    duration = float(scenario.get("duration", 5.0))
    st = _ReplayState(scenario)
    for i, e in enumerate(events):
        err = _check_args(e)
        if err is not None:
            out.append(f"event[{i}]: {err}")
            continue
        if e.kind not in vocab:
            out.append(f"event[{i}]: {e.kind} not applicable to "
                       f"scenario {scenario.get('name')!r}")
            continue
        if e.t < 0 or e.t > duration + 1.0:
            out.append(f"event[{i}]: t={e.t} outside "
                       f"[0, {duration + 1.0}]")
        # NOTE: list order IS replay order (the runner fires each
        # event after max(0, t - now)) — an out-of-order t is legal
        # and some legacy scenarios' committed traces rely on it, so
        # the legality simulation walks the list, not sorted times
        err = _step(st, e, scenario)
        if err is not None:
            out.append(f"event[{i}]: {err}")
    if not st.whole():
        out.append(
            "trace does not end whole: "
            f"dead={sorted(set(range(st.n_osds)) - st.alive)} "
            f"out={sorted(set(range(st.n_osds)) - st.in_set)} "
            f"dead_mgrs={sorted(set(range(st.n_mgrs)) - st.mgr_alive)} "
            f"cuts={len(st.partitions) + len(st.oneways)} "
            f"client_cuts={len(st.client_cuts) + len(st.client_drops)} "
            f"faulted={sorted(st.faulted)}")
    return out


def repair_trace(events: list[ChaosEvent],
                 scenario: dict) -> list[ChaosEvent]:
    """Deterministically normalize an arbitrary event-list edit into a
    legal trace: clamp times into the scenario window, stable-sort,
    drop events that are out of schema/vocabulary or that the legality
    simulation refuses, then append the canonical trace-end wholeness
    block (heal every cut, clear every fault, revive every body).  The
    output always passes :func:`validate_trace` — mutants never crash
    the runner on malformed input."""
    duration = float(scenario.get("duration", 5.0))
    vocab = set(scenario_verbs(scenario))
    clamped = [
        ChaosEvent(t=round(min(max(float(e.t), 0.05), duration), 3),
                   kind=e.kind, args=dict(e.args))
        for e in events
        if isinstance(e.t, _NUM)
    ]
    clamped.sort(key=lambda e: e.t)  # stable: equal-t order preserved
    st = _ReplayState(scenario)
    kept: list[ChaosEvent] = []
    for e in clamped:
        if _check_args(e) is not None or e.kind not in vocab:
            continue
        if _step(st, e, scenario) is None:
            kept.append(e)
    t_end = round(duration + 0.05, 3)
    for cut in st.partitions:
        kept.append(ChaosEvent(t_end, "heal_partition",
                               {"a": list(cut[0]), "b": list(cut[1])}))
    for link in st.oneways:
        kept.append(ChaosEvent(
            t_end, "heal_oneway",
            {"src": list(link[0]), "dst": list(link[1])}))
    for peer in st.client_cuts:
        kept.append(ChaosEvent(t_end, "heal_client_partition",
                               {"peer": list(peer)}))
    for peer, to_client in st.client_drops:
        kept.append(ChaosEvent(
            t_end, "heal_client_drop",
            {"peer": list(peer), "to_client": to_client}))
    kept.append(ChaosEvent(t_end, "netem_clear", {}))
    for osd in sorted(st.faulted):
        kept.append(ChaosEvent(t_end, "disk_heal", {"osd": osd}))
    for osd in sorted(set(range(st.n_osds)) - st.alive):
        kept.append(ChaosEvent(t_end, "osd_revive", {"osd": osd}))
    for osd in sorted(set(range(st.n_osds)) - st.in_set):
        kept.append(ChaosEvent(t_end, "osd_in", {"osd": osd}))
    for mgr in sorted(set(range(st.n_mgrs)) - st.mgr_alive):
        kept.append(ChaosEvent(t_end, "mgr_revive", {"mgr": mgr}))
    return kept

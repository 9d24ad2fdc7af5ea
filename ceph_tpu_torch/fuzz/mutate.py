"""Deterministic trace mutations — the fuzzer's edit engine.

Every mutant derives from ``(parent_trace_hash, mutation_seed)`` and
nothing else: the RNG is seeded from exactly that pair, so a corpus
entry's lineage re-derives its trace bit-identically forever (the same
committed-hash contract the scenario generators carry).  Raw edits may
produce anything; :func:`ceph_tpu_torch.chaos.schedule.repair_trace` then
normalizes the result back into a legal trace, so mutants can never
crash the runner on malformed input (libFuzzer's custom-mutator
discipline: mutate freely, always emit something the harness accepts).

Counterpart of ``ceph_tpu/fuzz/mutate.py``: the same results for the same
inputs (``tests/test_torch_fuzz.py``).
"""
# ctlint: pure-trace

from __future__ import annotations

import random

from ceph_tpu_torch.chaos.schedule import (
    ChaosEvent,
    _client_peer,
    _entity_pool,
    applicable_verbs,
    repair_trace,
    trace_hash,
)

#: the mutation catalog; a campaign must exercise several of these for
#: its corpus to count as coverage-guided (the artifact guard demands
#: >= 3 distinct kinds among admitted mutants)
MUTATION_KINDS = (
    "delete_window",     # drop a contiguous run of events
    "duplicate_window",  # replay a window again, shifted later
    "splice",            # move a window to a different time
    "swap_times",        # exchange two events' times (reorder)
    "retime",            # compress/stretch every gap, or jitter times
    "crossbreed",        # inject verbs from OTHER scenarios' domains
    "param_jitter",      # scale numeric args (ttl, delay, weight, ...)
)

#: numeric args param_jitter may scale (never ids or ratios: jittering
#: an osd id is a different event, jittering a fullness ratio breaks
#: the scripted ladder's calibration)
_JITTERABLE = ("ttl", "seconds", "delay", "hold", "weight")


def synth_event(rng: random.Random, kind: str, scenario: dict,
                t: float) -> ChaosEvent:
    """One freshly drawn event of ``kind``, with args mirroring the
    generator's own ranges — the crossbreed injection path.  The
    caller picks kinds from ``applicable_verbs(scenario)``; legality
    (budgets, liveness) is the repair pass's job, not this one's."""
    n_osds = scenario["n_osds"]
    n_mons = scenario.get("n_mons", 1)
    args: dict = {}
    if kind in ("osd_kill", "osd_out", "eio", "torn_write"):
        args = {"osd": rng.randrange(n_osds)}
    elif kind == "reweight":
        args = {"osd": rng.randrange(n_osds),
                "weight": round(rng.choice([0.25, 0.5, 0.75, 1.0]), 2)}
    elif kind == "slow_disk":
        args = {"osd": rng.randrange(n_osds),
                "delay": float(scenario.get("slow_disk_delay", 0.5))}
    elif kind == "mon_restart":
        args = {"rank": rng.randrange(n_mons)}
    elif kind in ("pg_split", "scrub", "deep_scrub", "repair"):
        pools = [p["name"] for p in scenario.get("pools", [])] or ["rep"]
        args = {"pool": rng.choice(pools)}
    elif kind == "balance":
        args = {"max_swaps": 8}
    elif kind == "partition":
        a, b = rng.sample(_entity_pool(rng, scenario), 2)
        args = {"a": list(a), "b": list(b),
                "ttl": round(rng.uniform(0.3, 1.2), 3)}
    elif kind == "drop_oneway":
        a, b = rng.sample(_entity_pool(rng, scenario), 2)
        args = {"src": list(a), "dst": list(b),
                "ttl": round(rng.uniform(0.3, 1.0), 3)}
    elif kind == "delay":
        a, b = rng.sample(_entity_pool(rng, scenario), 2)
        args = {"src": list(a), "dst": list(b),
                "seconds": round(rng.uniform(0.005, 0.04), 4),
                "ttl": round(rng.uniform(0.3, 1.5), 3)}
    elif kind == "reorder":
        a, b = rng.sample(_entity_pool(rng, scenario), 2)
        args = {"src": list(a), "dst": list(b),
                "every": rng.choice([2, 3, 5]),
                "hold": round(rng.uniform(0.005, 0.03), 4),
                "ttl": round(rng.uniform(0.3, 1.5), 3)}
    elif kind == "netem_clear":
        args = {}
    elif kind == "mgr_kill":
        args = {"mgr": rng.randrange(max(1, scenario.get("n_mgrs", 0)))}
    elif kind == "client_partition":
        args = {"peer": list(_client_peer(rng, scenario)),
                "ttl": round(rng.uniform(0.3, 1.0), 3)}
    elif kind == "client_drop":
        args = {"peer": list(_client_peer(rng, scenario)),
                "to_client": rng.random() < 0.5,
                "ttl": round(rng.uniform(0.3, 0.8), 3)}
    elif kind == "client_delay":
        args = {"peer": list(_client_peer(rng, scenario)),
                "seconds": round(rng.uniform(0.005, 0.05), 4),
                "ttl": round(rng.uniform(0.3, 1.5), 3)}
    elif kind == "mon_netem":
        mode = rng.choice(["delay", "partition", "drop"])
        if n_mons < 3 and mode == "partition":
            mode = "delay"
        args = {"rank": rng.randrange(n_mons), "mode": mode,
                "seconds": round(rng.uniform(0.005, 0.04), 4),
                "ttl": round(rng.uniform(0.3, 1.0), 3)}
    elif kind == "mgr_netem":
        args = {"mgr": rng.randrange(max(1, scenario.get("n_mgrs", 0))),
                "mode": rng.choice(["delay", "partition", "drop"]),
                "seconds": round(rng.uniform(0.005, 0.04), 4),
                "ttl": round(rng.uniform(0.3, 1.0), 3)}
    elif kind == "mds_netem":
        args = {"mds": 0, "mode": "delay",
                "seconds": round(rng.uniform(0.005, 0.04), 4),
                "ttl": round(rng.uniform(0.3, 1.0), 3)}
    elif kind in ("tier_flush", "tier_evict", "tier_promote"):
        tier = scenario["tier"]
        n_obj = int(scenario.get("workload", {}).get("objects", 3))
        args = {"base": tier["base"], "hot": tier["hot"],
                "oid": f"{tier['base']}-obj{rng.randrange(n_obj)}"}
    else:
        raise ValueError(f"synth_event: no recipe for {kind!r}")
    return ChaosEvent(t=round(t, 3), kind=kind, args=args)


def _window(rng: random.Random, n: int) -> tuple[int, int]:
    """A random [i, i+w) window over n events, w in 1..3."""
    w = min(n, rng.randint(1, 3))
    i = rng.randrange(n - w + 1)
    return i, i + w


def _apply_raw(rng: random.Random, kind: str,
               events: list[ChaosEvent],
               scenario: dict) -> list[ChaosEvent]:
    """One raw (possibly illegal) edit; repair follows."""
    duration = float(scenario.get("duration", 5.0))
    out = list(events)
    if not out and kind != "crossbreed":
        return out
    if kind == "delete_window":
        i, j = _window(rng, len(out))
        del out[i:j]
    elif kind == "duplicate_window":
        i, j = _window(rng, len(out))
        shift = round(rng.uniform(0.1, 1.0), 3)
        copy = [ChaosEvent(t=round(e.t + shift, 3), kind=e.kind,
                           args=dict(e.args)) for e in out[i:j]]
        out[j:j] = copy
    elif kind == "splice":
        i, j = _window(rng, len(out))
        base = round(rng.uniform(0.05, duration), 3)
        t0 = out[i].t
        moved = [ChaosEvent(t=round(base + (e.t - t0), 3),
                            kind=e.kind, args=dict(e.args))
                 for e in out[i:j]]
        del out[i:j]
        out.extend(moved)
    elif kind == "swap_times":
        if len(out) >= 2:
            i, j = sorted(rng.sample(range(len(out)), 2))
            ei, ej = out[i], out[j]
            out[i] = ChaosEvent(t=ej.t, kind=ei.kind,
                                args=dict(ei.args))
            out[j] = ChaosEvent(t=ei.t, kind=ej.kind,
                                args=dict(ej.args))
    elif kind == "retime":
        if rng.random() < 0.5:
            scale = rng.choice([0.5, 0.7, 1.4, 2.0])
            out = [ChaosEvent(t=round(e.t * scale, 3), kind=e.kind,
                              args=dict(e.args)) for e in out]
        else:
            out = [ChaosEvent(
                t=round(e.t + rng.uniform(-0.2, 0.2), 3),
                kind=e.kind, args=dict(e.args)) for e in out]
    elif kind == "crossbreed":
        pool = applicable_verbs(scenario)
        for _ in range(rng.randint(1, 3)):
            t = round(rng.uniform(0.1, duration), 3)
            out.append(synth_event(rng, rng.choice(pool), scenario, t))
    elif kind == "param_jitter":
        idx = [i for i, e in enumerate(out)
               if any(k in e.args for k in _JITTERABLE)]
        if idx:
            i = rng.choice(idx)
            e = out[i]
            args = dict(e.args)
            scale = rng.uniform(0.5, 2.0)
            for k in _JITTERABLE:
                if k in args and isinstance(args[k], (int, float)):
                    args[k] = round(float(args[k]) * scale, 4)
            out[i] = ChaosEvent(t=e.t, kind=e.kind, args=args)
    else:
        raise ValueError(f"unknown mutation kind {kind!r}")
    return out


def mutate(parent_events: list[ChaosEvent], scenario: dict,
           parent_hash: str,
           mutation_seed: int) -> tuple[list[ChaosEvent], str]:
    """Derive one schema-valid mutant from a parent trace.  Pure in
    ``(parent_hash, mutation_seed)`` — the parent's events are part of
    the lineage (the corpus stores them), the hash pins them.  Returns
    ``(events, mutation_kind)``; the events always pass
    ``validate_trace``.  If an edit collapses back to the parent (a
    deleted window the repair pass regrows, a no-op jitter), further
    kinds are drawn from the SAME stream, so the retry path is as
    deterministic as the happy path."""
    rng = random.Random(f"fuzz:{parent_hash}:{mutation_seed}")
    last: tuple[list[ChaosEvent], str] | None = None
    for _attempt in range(8):
        kind = rng.choice(MUTATION_KINDS)
        mutant = repair_trace(
            _apply_raw(rng, kind, parent_events, scenario), scenario)
        last = (mutant, kind)
        if trace_hash(mutant) != parent_hash:
            return last
    return last  # pathological parent: every edit round-trips

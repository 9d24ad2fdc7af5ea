"""Delta-debug minimization of red traces.

A fuzz-found failure is only useful once it is SMALL: ``ddmin``
(Zeller's delta debugging) reduces the event list to a 1-minimal
failing subset — removing any single remaining chunk makes the
failure vanish — then :func:`shrink_fields` shrinks what is left
in place (shorter ttls, earlier times).  Every candidate is
re-validated through the caller's predicate, which for live traces
re-runs the cluster on the repaired candidate; the minimized result
ships inline in a deterministic regression test exactly like
``tests/test_torch_stale_primary_regression.py``.

Counterpart of ``ceph_tpu/fuzz/minimize.py``: the same results for the same
inputs (``tests/test_torch_fuzz.py``).
"""
# ctlint: pure-trace

from __future__ import annotations

from collections.abc import Callable, Sequence

from ceph_tpu_torch.chaos.schedule import ChaosEvent, repair_trace


def ddmin(items: Sequence, failing: Callable[[list], bool]) -> list:
    """Classic ddmin: the smallest subset of ``items`` (in order) for
    which ``failing`` still returns True.  ``failing(list(items))``
    must hold on entry; the result is 1-minimal at chunk granularity 1
    (dropping any single element stops the failure)."""
    items = list(items)
    if not failing(items):
        raise ValueError("ddmin: the full input does not fail")
    n = 2
    while len(items) >= 2:
        start = 0
        chunk = max(1, len(items) // n)
        reduced = False
        while start < len(items):
            candidate = items[:start] + items[start + chunk:]
            if candidate and failing(candidate):
                items = candidate
                n = max(n - 1, 2)
                reduced = True
                break
            start += chunk
        if not reduced:
            if n >= len(items):
                break
            n = min(len(items), n * 2)
    return items


def shrink_fields(
    events: list[ChaosEvent], scenario: dict,
    failing: Callable[[list], bool],
) -> list[ChaosEvent]:
    """Field-level shrinking after ddmin: pull every event earlier
    (compress the timeline toward t=0.1) and halve jitterable numeric
    args, keeping each change only if the trace still fails."""
    def _try(cand: list[ChaosEvent]) -> bool:
        return bool(cand) and failing(cand)

    # compress the timeline: scale every t toward the front
    for scale in (0.25, 0.5, 0.75):
        if len(events) < 1:
            break
        t0 = events[0].t
        cand = [
            ChaosEvent(t=round(t0 + (e.t - t0) * scale, 3),
                       kind=e.kind, args=dict(e.args))
            for e in events
        ]
        if _try(cand):
            events = cand
            break
    # halve long-tail numeric args one event at a time
    for i in range(len(events)):
        e = events[i]
        args = dict(e.args)
        changed = False
        for k in ("ttl", "seconds", "delay", "hold"):
            v = args.get(k)
            if isinstance(v, (int, float)) and v > 0.05:
                args[k] = round(float(v) / 2, 4)
                changed = True
        if not changed:
            continue
        cand = list(events)
        cand[i] = ChaosEvent(t=e.t, kind=e.kind, args=args)
        if _try(cand):
            events = cand
    return events


def minimize_trace(
    events: list[ChaosEvent], scenario: dict,
    failing: Callable[[list], bool],
) -> list[ChaosEvent]:
    """Full minimization: ddmin over the event list, then field
    shrinking — ``failing`` receives REPAIRED candidates (the repair
    pass appends the trace-end wholeness block, so the predicate
    always sees a runnable trace; live predicates re-run the cluster
    on it)."""
    def _fails(subset: list[ChaosEvent]) -> bool:
        return failing(repair_trace(subset, scenario))

    kernel = ddmin(events, _fails)
    kernel = shrink_fields(kernel, scenario, _fails)
    return repair_trace(kernel, scenario)

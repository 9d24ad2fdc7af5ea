"""Deterministic messenger-level network emulation.

The messenger already carries the reference's *probabilistic* fault
knobs (``ms_inject_socket_failures`` — every Nth send tears the
connection; ``ms_inject_delay`` — uniform latency).  Those are great
for soak tests and useless for replay: which message dies depends on
global send order.  This shim adds the *deterministic* verbs the
thrasher needs, keyed by peer identity:

- **partition(a, b)** — symmetric cut: every send on the a<->b link
  raises ``ConnectionError`` (the peers' failure detectors see a dead
  link and react: sub-op failure, MOSDFailure, mon election);
- **drop_oneway(src, dst)** — src's sends to dst vanish silently while
  dst's replies still flow (the half-dead-NIC case heartbeats exist
  to catch);
- **delay(src, dst, seconds)** — fixed per-send latency on one link;
- **reorder(src, dst, every, hold)** — bounded reordering: every Nth
  send on the link is held ``hold`` seconds *before* entering the
  connection's serialized writer, so later messages overtake it —
  real reordering at the frame level, bounded by the hold window.

Rules match entities exactly (``("osd", 3)``) or by kind wildcard
(``("osd", None)``).  Both endpoints of a mini-cluster attach the same
shim, so symmetric rules bite in both directions.  Every verdict
counts into the ``chaos`` perf collection.

Counterpart of ``ceph_tpu/chaos/netem.py``: the same verdicts and counters.
"""

from __future__ import annotations

import asyncio

Entity = tuple  # ("osd", 3) / ("mon", 0) / ("osd", None) wildcard


def _match(rule_ent, ent) -> bool:
    return rule_ent[0] == ent[0] and (
        rule_ent[1] is None or rule_ent[1] == ent[1]
    )


def _norm(e) -> tuple:
    """Entities arrive as tuples or (from JSON traces) lists."""
    return (e[0], e[1])


class Netem:
    """One shim instance per cluster; attach to every messenger."""

    def __init__(self):
        self._partitions: list[tuple[Entity, Entity]] = []
        self._oneways: list[tuple[Entity, Entity]] = []
        self._delays: dict[tuple[Entity, Entity], float] = {}
        self._reorders: dict[tuple[Entity, Entity], tuple[int, float]] = {}
        self._reorder_count: dict[tuple, int] = {}
        self.stats = {
            "partitioned_sends": 0, "dropped_sends": 0,
            "delayed_sends": 0, "reordered_sends": 0,
            # client-link verdicts counted separately: the client-netem
            # oracle needs PROOF a partition/drop actually bit a
            # client send, not just that a rule was armed
            "client_partitioned_sends": 0, "client_dropped_sends": 0,
            "client_delayed_sends": 0,
        }

    def _counters(self):
        from ceph_tpu_torch.chaos import chaos_counters

        return chaos_counters()

    # -- rule management (the schedule's netem verbs) -------------------

    def attach(self, messenger) -> None:
        messenger.netem = self

    def detach(self, messenger) -> None:
        if getattr(messenger, "netem", None) is self:
            messenger.netem = None

    def partition(self, a, b) -> None:
        a, b = _norm(a), _norm(b)
        if (a, b) not in self._partitions:
            self._partitions.append((a, b))

    def heal_partition(self, a, b) -> None:
        a, b = _norm(a), _norm(b)
        for cut in ((a, b), (b, a)):
            if cut in self._partitions:
                self._partitions.remove(cut)

    def drop_oneway(self, src, dst) -> None:
        link = (_norm(src), _norm(dst))
        if link not in self._oneways:
            self._oneways.append(link)

    def heal_oneway(self, src, dst) -> None:
        link = (_norm(src), _norm(dst))
        if link in self._oneways:
            self._oneways.remove(link)

    def delay(self, src, dst, seconds: float) -> None:
        self._delays[(_norm(src), _norm(dst))] = float(seconds)

    def heal_delay(self, src, dst) -> None:
        self._delays.pop((_norm(src), _norm(dst)), None)

    def reorder(self, src, dst, every: int = 3, hold: float = 0.01) -> None:
        link = (_norm(src), _norm(dst))
        self._reorders[link] = (max(2, int(every)), float(hold))
        self._reorder_count.setdefault(link, 0)

    def heal_reorder(self, src, dst) -> None:
        self._reorders.pop((_norm(src), _norm(dst)), None)

    def clear(self) -> None:
        self._partitions.clear()
        self._oneways.clear()
        self._delays.clear()
        self._reorders.clear()
        self._reorder_count.clear()

    def active_rules(self) -> dict:
        return {
            "partitions": [list(map(list, c)) for c in self._partitions],
            "oneways": [list(map(list, c)) for c in self._oneways],
            "delays": {
                f"{s}->{d}": v for (s, d), v in self._delays.items()
            },
            "reorders": {
                f"{s}->{d}": list(v) for (s, d), v in self._reorders.items()
            },
        }

    # -- the send-path hook (called by Connection.send_message) ---------

    async def on_send(self, src: Entity, dst: Entity) -> bool:
        """Apply the active rules to one send.  Returns False when the
        message must be silently dropped; raises ConnectionError on a
        partitioned link; sleeps for delay/reorder holds.  Runs BEFORE
        the connection's send lock, so a held message is genuinely
        overtaken by later sends on the same connection."""
        client_link = src[0] == "client" or dst[0] == "client"
        for a, b in self._partitions:
            if (_match(a, src) and _match(b, dst)) or (
                _match(b, src) and _match(a, dst)
            ):
                self.stats["partitioned_sends"] += 1
                if client_link:
                    self.stats["client_partitioned_sends"] += 1
                self._counters().inc("netem_partitioned_sends")
                raise ConnectionError(
                    f"netem: {src} -> {dst} partitioned")
        for s, d in self._oneways:
            if _match(s, src) and _match(d, dst):
                self.stats["dropped_sends"] += 1
                if client_link:
                    self.stats["client_dropped_sends"] += 1
                self._counters().inc("netem_dropped_sends")
                return False
        for (s, d), secs in list(self._delays.items()):
            if _match(s, src) and _match(d, dst):
                self.stats["delayed_sends"] += 1
                if client_link:
                    self.stats["client_delayed_sends"] += 1
                self._counters().inc("netem_delayed_sends")
                await asyncio.sleep(secs)
        for (s, d), (every, hold) in list(self._reorders.items()):
            if _match(s, src) and _match(d, dst):
                link = (s, d)
                self._reorder_count[link] = (
                    self._reorder_count.get(link, 0) + 1
                )
                if self._reorder_count[link] % every == 0:
                    self.stats["reordered_sends"] += 1
                    self._counters().inc("netem_reordered_sends")
                    await asyncio.sleep(hold)
        return True

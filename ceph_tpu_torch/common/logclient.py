"""LogClient: the cluster-log channel every daemon embeds.

Behavioral twin of the reference LogClient/LogChannel
(src/common/LogClient.cc): a daemon logs operator-relevant events into
named channels — ``cluster`` for state changes (boot, markdown,
recovery, health) and ``audit`` for admin actions — and the client
ships them to the mon as :class:`~ceph_tpu_torch.msg.messages.MLog` batches,
where the LogMonitor twin (``mon/log_service.py``) paxos-replicates a
bounded ring serving ``ceph log last`` and the ``ceph -w`` follow
stream.

Reliability model (the LogClient contract):

- entries carry a per-daemon monotone ``seq``; they stay in a bounded
  resend buffer until the mon acks them (:class:`MLogAck` carries the
  highest committed seq), so a mon failover only delays delivery —
  the next flush resends to whichever mon the daemon re-homed to and
  the mon-side dedup (by ``(entity, seq)``) absorbs duplicates;
- the buffer is BOUNDED (``log_client_max_pending``): when a daemon
  logs faster than the mon drains, the oldest entries drop and a
  counter moves — the log plane must never grow without bound or
  stall the daemon;
- emission is rate-limited (``log_client_rate`` entries per flush
  interval, token-bucket): a log storm costs log entries, not memory
  or wire bandwidth;
- a daemon-local tail ring keeps the most recent entries of EVERY
  severity (below the ship threshold too) — the "recent in-memory log
  tail" a crash dump snapshots (common/crash.py).

Every send is fire-and-forget: the log plane is observability, never
the data path.
"""

from __future__ import annotations

import asyncio
import collections
import logging
import time

log = logging.getLogger("ceph_tpu_torch.common")

#: severity levels, index == wire value (log_client_level floor)
CLOG_LEVELS = ("debug", "info", "warn", "error", "sec")
CLOG_DEBUG, CLOG_INFO, CLOG_WARN, CLOG_ERROR, CLOG_SEC = range(5)


def format_entry(e: dict) -> str:
    """One human-readable ``ceph -w`` line for a log entry dict."""
    stamp = time.strftime("%H:%M:%S", time.localtime(e.get("stamp", 0)))
    level = CLOG_LEVELS[min(int(e.get("level", 1)), len(CLOG_LEVELS) - 1)]
    return (f"{stamp} {e.get('channel', 'cluster')} "
            f"[{level.upper():>5}] {e.get('entity', '?')}: "
            f"{e.get('message', '')}")


class LogChannel:
    """One named channel of a LogClient (``cluster`` / ``audit``)."""

    def __init__(self, client: "LogClient", name: str):
        self._client = client
        self.name = name

    def debug(self, message: str) -> None:
        self._client._append(self.name, CLOG_DEBUG, message)

    def info(self, message: str) -> None:
        self._client._append(self.name, CLOG_INFO, message)

    def warn(self, message: str) -> None:
        self._client._append(self.name, CLOG_WARN, message)

    def error(self, message: str) -> None:
        self._client._append(self.name, CLOG_ERROR, message)


class LogClient:
    """``entity`` is the daemon's log identity ("osd.0", "mgr.x");
    ``send`` an async callable shipping one Message to the daemon's
    current mon connection (None = local-only: tail ring still works,
    nothing goes to the wire — tests and monitors use this)."""

    def __init__(self, entity: str, conf, send=None, tail_max: int = 64):
        self.entity = entity
        self.conf = conf
        self.send = send
        self.cluster = LogChannel(self, "cluster")
        self.audit = LogChannel(self, "audit")
        self._seq = 0
        self._pending: collections.deque[dict] = collections.deque()
        self._tail: collections.deque[dict] = collections.deque(
            maxlen=tail_max)
        self._budget = conf["log_client_rate"]
        self.counters = collections.Counter()
        self._task: asyncio.Task | None = None
        self._stopping = False

    # -- emission ------------------------------------------------------

    def _append(self, channel: str, level: int, message: str) -> None:
        entry = {
            "seq": 0, "stamp": time.time(), "entity": self.entity,
            "channel": channel, "level": level, "message": str(message),
        }
        self._tail.append(dict(entry))
        self.counters["emitted"] += 1
        if level < self.conf["log_client_level"]:
            return  # below the ship threshold: tail-only
        if self._budget <= 0:
            self.counters["rate_dropped"] += 1
            return
        self._budget -= 1
        self._seq += 1
        entry["seq"] = self._seq
        self._pending.append(entry)
        maxp = self.conf["log_client_max_pending"]
        while len(self._pending) > maxp:
            self._pending.popleft()
            self.counters["overflow_dropped"] += 1

    def tail(self, n: int = 20) -> list[dict]:
        """Most recent entries (every severity) — the crash-dump tail."""
        return list(self._tail)[-n:]

    # -- flush loop ----------------------------------------------------

    def start(self) -> None:
        if self._task is None and self.send is not None:
            self._task = asyncio.ensure_future(self._flush_loop())

    async def stop(self) -> None:
        self._stopping = True
        if self._task is not None:
            self._task.cancel()
            self._task = None
        await self.flush()  # best-effort final drain (daemon death)

    async def _flush_loop(self) -> None:
        interval = self.conf["log_client_flush_interval"]
        while not self._stopping:
            await asyncio.sleep(interval)
            self._budget = self.conf["log_client_rate"]
            await self.flush()

    async def flush(self) -> None:
        """Ship every pending (unacked) entry; failures keep them
        pending for the next flush (resend-until-acked)."""
        if self.send is None or not self._pending:
            return
        # imported here: the host foundation (common/) loads without the
        # message set, which only a sending daemon needs
        from ceph_tpu_torch.msg.messages import MLog

        try:
            await self.send(MLog(
                entity=self.entity, entries=list(self._pending)))
            self.counters["flushes"] += 1
        except (ConnectionError, OSError, AttributeError,
                asyncio.TimeoutError):
            self.counters["flush_failures"] += 1

    def handle_ack(self, msg) -> None:
        """MLogAck from the mon: committed entries leave the buffer."""
        while self._pending and self._pending[0]["seq"] <= msg.last_seq:
            self._pending.popleft()
            self.counters["acked"] += 1

    def dump(self) -> dict:
        return {
            "entity": self.entity,
            "pending": len(self._pending),
            "last_seq": self._seq,
            "counters": dict(self.counters),
            "tail": self.tail(),
        }

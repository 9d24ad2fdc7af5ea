"""LogMonitor + health history/mute service: the mon side of the
cluster event plane.

Behavioral twin of the reference's LogMonitor (src/mon/LogMonitor.cc)
plus the health-mute/history slice of HealthMonitor:

- **Cluster log**: daemons' LogClients ship :class:`MLog` batches;
  the leader dedups by ``(entity, seq)`` and paxos-replicates new
  entries into a bounded ring, so ``ceph log last`` and the ``ceph
  -w`` follow cursor (a replicated global index) survive mon failover.
  The mon writes its own entries (audit records of admin writes,
  health transitions) straight through :meth:`_log_append`.
- **Health history**: a leader-only tick diffs the current health
  checks (the mon's own + the mgr digest's) against the replicated
  raised-set and commits raise/clear transition records — ``ceph
  health history`` distinguishes a new failure from a flapping one.
- **Mutes**: ``ceph health mute <code> [ttl] [--sticky]`` hides a
  check from the health status without hiding the truth (muted checks
  ride the ``muted`` block); a non-sticky mute auto-unmutes when its
  check clears, so the NEXT occurrence warns again (the reference's
  sticky semantics); TTLs expire lazily at render time.

Everything here is replicated state: it lands in the mon snapshot
(monitor.py ``_state_snapshot``) and replays losslessly.
"""

from __future__ import annotations

import logging
import time

from ceph_tpu_torch.msg.messages import MLog, MLogAck

log = logging.getLogger("ceph_tpu_torch.mon")


class LogServiceMixin:
    def _init_log_service(self) -> None:
        """Called from Monitor.__init__ (state must predate replay)."""
        # replicated: the bounded cluster-log ring + its global index
        self._clog: list[dict] = []
        self._clog_index = 0
        # replicated: per-entity last committed seq (MLog resend dedup)
        self._clog_last_seq: dict[str, int] = {}
        # replicated: bounded health-transition history + its index
        self._health_history: list[dict] = []
        self._health_hist_index = 0
        # replicated: code -> {"sticky", "until" (wall clock or None),
        # "at"} — the health-mute book
        self._health_mutes: dict[str, dict] = {}
        # volatile, leader-only: this mon's own clog seq allocator
        # (floored to the replicated last_seq so restarts never reuse)
        self._mon_log_next = 0
        self._health_tick_task = None

    # -- MLog intake (LogMonitor::preprocess/prepare_log) --------------

    async def _handle_log(self, msg: MLog) -> None:
        if not self.is_leader:
            # peons forward to the leader and ack optimistically: the
            # mini-cluster's forward hop is fire-and-forget, and the
            # leader-side (entity, seq) dedup absorbs any resend
            await self._forward_to_leader(msg)
            await self._log_ack(msg)
            return
        last = self._clog_last_seq.get(msg.entity, 0)
        fresh = [dict(e) for e in msg.entries if e.get("seq", 0) > last]
        if fresh:
            await self._propose({
                "op": "clog", "entity": msg.entity, "entries": fresh,
            })
        await self._log_ack(msg)

    @staticmethod
    async def _log_ack(msg: MLog) -> None:
        if not msg.entries or msg.conn is None:
            return
        try:
            await msg.conn.send_message(MLogAck(
                last_seq=max(int(e.get("seq", 0)) for e in msg.entries)))
        except (ConnectionError, OSError):
            pass

    async def _log_append(self, channel: str, level: int,
                          message: str) -> None:
        """A mon-origin cluster-log entry (audit records, health
        transitions), committed through the same replicated op so
        every quorum member serves it.  Leader only; no-ops silently
        otherwise (the caller's signal was leader-gated already)."""
        if not self.is_leader or getattr(self, "_replaying", False):
            return
        entity = f"mon.{self.rank}"
        self._mon_log_next = max(
            self._mon_log_next, self._clog_last_seq.get(entity, 0)) + 1
        try:
            await self._propose({
                "op": "clog", "entity": entity, "entries": [{
                    "seq": self._mon_log_next, "stamp": time.time(),
                    "channel": channel, "level": int(level),
                    "message": str(message),
                }],
            })
        except (ConnectionError, OSError):
            pass  # quorum mid-election: the log plane never blocks

    def _apply_clog_op(self, op: dict) -> None:
        """Deterministic ring append (every member, paxos order)."""
        entity = op["entity"]
        last = self._clog_last_seq.get(entity, 0)
        for e in op["entries"]:
            seq = int(e.get("seq", 0))
            if seq <= last:
                continue  # duplicate of an already-committed flush
            last = seq
            self._clog_index += 1
            self._clog.append({
                "index": self._clog_index,
                "stamp": float(e.get("stamp", 0.0)),
                "entity": entity,
                "channel": str(e.get("channel", "cluster")),
                "level": int(e.get("level", 1)),
                "message": str(e.get("message", "")),
            })
        self._clog_last_seq[entity] = last
        keep = self.conf["mon_cluster_log_max"]
        if len(self._clog) > keep:
            del self._clog[: len(self._clog) - keep]

    def _log_last(self, n: int = 20, channel: str = "",
                  since: int = 0) -> dict:
        """The ``ceph log last [n]`` / follow-cursor read: entries
        after ``since`` (a global index — the ``ceph -w`` cursor),
        newest ``n`` when ``since`` is 0.  Served from replicated
        state by ANY quorum member, so a follow stream survives mon
        failover by re-polling whichever mon answers."""
        entries = self._clog
        if channel:
            entries = [e for e in entries if e["channel"] == channel]
        if since > 0:
            out = [e for e in entries if e["index"] > since]
            if n > 0:
                out = out[:n]
        else:
            out = entries[-n:] if n > 0 else list(entries)
        return {"entries": out, "cursor": self._clog_index}

    # -- health transitions / history ----------------------------------

    def _raw_health_checks(self) -> dict:
        """Every current check, unmuted and unfiltered: the mon's own
        map-derived checks + the active mgr digest's module checks."""
        checks = dict(self._health_checks()["checks"])
        for name, chk in ((getattr(self, "_mgr_digest", None) or {})
                          .get("health", {}) or {}).items():
            checks[name] = chk
        return checks

    def _render_health(self, pgsum=None) -> dict:
        """The operator-facing health verdict: unmuted checks drive
        the status; muted checks stay visible in their own block
        (hiding a known failure must not hide the truth)."""
        base = self._health_checks(pgsum)
        checks = dict(base["checks"])
        for name, chk in ((getattr(self, "_mgr_digest", None) or {})
                          .get("health", {}) or {}).items():
            checks[name] = chk
        now = time.time()
        muted: dict[str, dict] = {}
        live: dict[str, dict] = {}
        for name, chk in checks.items():
            m = self._health_mutes.get(name)
            if m is not None and (m["until"] is None or m["until"] > now):
                muted[name] = chk
            else:
                live[name] = chk
        if any(c.get("severity") == "HEALTH_ERR" for c in live.values()):
            status = "HEALTH_ERR"
        else:
            status = "HEALTH_OK" if not live else "HEALTH_WARN"
        return {
            "status": status, "checks": live, "muted": muted,
            "mutes": {
                code: dict(m) for code, m in self._health_mutes.items()
            },
        }

    def _raised_codes(self) -> dict[str, str]:
        """code -> severity for checks whose LAST history event is a
        raise — derived from replicated history, so a fresh leader
        after failover diffs against the same baseline the old one
        committed (no duplicate raise records)."""
        out: dict[str, str] = {}
        for rec in self._health_history:
            if rec["event"] == "raised":
                out[rec["code"]] = rec.get("severity", "HEALTH_WARN")
            else:
                out.pop(rec["code"], None)
        return out

    def _start_health_tick(self) -> None:
        import asyncio

        if self.conf["mon_health_tick_interval"] > 0:
            self._health_tick_task = asyncio.ensure_future(
                self._health_tick())

    #: checks the mon derives itself (transitions of these also land
    #: in the cluster log; mgr-digest checks log at their signal site
    #: — e.g. SLOW_OPS at the mgr — to avoid double entries)
    _OWN_HEALTH_CODES = frozenset({
        "OSD_DOWN", "MON_DOWN", "PG_DEGRADED", "OSD_FULL",
        "OSD_BACKFILLFULL", "OSD_NEARFULL",
    })

    async def _health_tick(self) -> None:
        import asyncio

        interval = self.conf["mon_health_tick_interval"]
        own = self._OWN_HEALTH_CODES
        while True:
            await asyncio.sleep(interval)
            if not self.is_leader:
                continue
            try:
                cur = self._raw_health_checks()
            except Exception:
                log.exception("mon.%d: health sweep failed", self.rank)
                continue
            prev = self._raised_codes()
            items = []
            now = time.time()
            # a fresh leader that has not received an MMonMgrReport
            # digest yet has NO EVIDENCE about mgr-sourced checks:
            # judging them "cleared" would drop non-sticky mutes and
            # mint phantom clear/raise pairs across every mon failover
            have_digest = getattr(self, "_mgr_digest", None) is not None
            own = self._OWN_HEALTH_CODES
            for code, chk in sorted(cur.items()):
                if code not in prev:
                    items.append({
                        "code": code, "event": "raised",
                        "severity": chk.get("severity", "HEALTH_WARN"),
                        "summary": chk.get("summary", ""), "stamp": now,
                    })
            for code in sorted(prev):
                if code not in cur:
                    if code not in own and not have_digest:
                        continue  # absence of evidence, not a clear
                    items.append({
                        "code": code, "event": "cleared",
                        "severity": prev[code], "summary": "", "stamp": now,
                    })
            if not items:
                continue
            try:
                await self._propose({"op": "health_history",
                                     "items": items})
                for it in items:
                    if it["code"] in own:
                        verb = ("Health check failed"
                                if it["event"] == "raised"
                                else "Health check cleared")
                        lvl = 2 if it["event"] == "raised" else 1
                        await self._log_append(
                            "cluster", lvl,
                            f"{verb}: {it['summary']} ({it['code']})"
                            if it["summary"] else
                            f"{verb}: {it['code']}")
            except (ConnectionError, OSError):
                continue  # lost quorum mid-sweep; retry next tick

    def _apply_health_history_op(self, op: dict) -> None:
        for it in op["items"]:
            self._health_hist_index += 1
            self._health_history.append({
                "index": self._health_hist_index,
                "code": str(it["code"]),
                "event": str(it["event"]),
                "severity": str(it.get("severity", "HEALTH_WARN")),
                "summary": str(it.get("summary", "")),
                "stamp": float(it.get("stamp", 0.0)),
            })
            # a cleared check drops its non-sticky mute, so the NEXT
            # occurrence warns again (reference mute semantics)
            if it["event"] == "cleared":
                m = self._health_mutes.get(it["code"])
                if m is not None and not m.get("sticky"):
                    self._health_mutes.pop(it["code"], None)
        keep = self.conf["mon_health_history_max"]
        if len(self._health_history) > keep:
            del self._health_history[: len(self._health_history) - keep]

    def _apply_health_mute_op(self, op: dict) -> None:
        if op["op"] == "health_unmute":
            self._health_mutes.pop(op["code"], None)
            return
        self._health_mutes[op["code"]] = {
            "sticky": bool(op.get("sticky", False)),
            "until": (float(op["until"]) if op.get("until") else None),
            "at": float(op.get("at", 0.0)),
        }

    # -- snapshot plumbing ---------------------------------------------

    def _log_service_snapshot(self) -> dict:
        return {
            "clog": list(self._clog),
            "clog_index": self._clog_index,
            "clog_last_seq": dict(self._clog_last_seq),
            "health_history": list(self._health_history),
            "health_hist_index": self._health_hist_index,
            "health_mutes": {
                k: dict(v) for k, v in self._health_mutes.items()
            },
        }

    def _install_log_service(self, aux: dict) -> None:
        self._clog = list(aux.get("clog", []))
        self._clog_index = int(aux.get("clog_index", 0))
        self._clog_last_seq = {
            str(k): int(v)
            for k, v in (aux.get("clog_last_seq") or {}).items()
        }
        self._health_history = list(aux.get("health_history", []))
        self._health_hist_index = int(aux.get("health_hist_index", 0))
        self._health_mutes = {
            str(k): dict(v)
            for k, v in (aux.get("health_mutes") or {}).items()
        }

    def dump_log_service(self) -> dict:
        """Admin-socket view (debug aid)."""
        return {
            "entries": len(self._clog),
            "index": self._clog_index,
            "history": len(self._health_history),
            "mutes": sorted(self._health_mutes),
            "last_seq": dict(self._clog_last_seq),
        }


__all__ = ["LogServiceMixin"]

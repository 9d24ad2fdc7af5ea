"""MgrMonitor service: the MgrMap's PaxosService.

Behavioral twin of src/mon/MgrMonitor.cc: mgr daemons beacon in
(MMgrBeacon), the FIRST becomes active and the rest queue as standbys;
the map (active + standbys + enabled-module set) replicates through
paxos and is published to every subscriber as MMgrMap.  When the
active's beacons stop (or its daemon resets), the leader drops it and
promotes the first standby — standby failover, visible to every
daemon's MgrClient within one publish.

The active mgr's MMonMgrReport digests (per-OSD perf rows, analytics
summary, module health, rendered prometheus text) land here too —
volatile leader state, like the pg-stat book — and back `ceph osd
perf`, the `ceph status` mgr line and the dashboard's mgr views.
"""

from __future__ import annotations

import json
import logging
import time

from ceph_tpu_torch.msg.messages import MMgrBeacon, MMgrMap, MMonMgrReport

log = logging.getLogger("ceph_tpu_torch.mon")

#: modules enabled in a fresh map (mirror of mgr/modules.py
#: DEFAULT_MODULES without importing the mgr package into the mon)
_DEFAULT_MODULES = ("crash", "devicehealth", "progress", "prometheus")


class MgrServiceMixin:
    def _init_mgr_service(self) -> None:
        """Called from Monitor.__init__ (state must predate replay)."""
        self._mgr_map: dict = {
            "epoch": 0,
            "active": None,          # {"name", "gid", "addr": [h, p]}
            "standbys": [],          # same shape, promotion order
            "modules": sorted(_DEFAULT_MODULES),
        }
        self._mgr_last_beacon: dict[str, float] = {}
        self._mgr_digest: dict | None = None
        self._mgr_digest_at: float = 0.0
        self._mgr_tick_task = None

    # -- beacon intake -------------------------------------------------

    async def _handle_mgr_beacon(self, msg: MMgrBeacon) -> None:
        if not self.is_leader:
            await self._forward_to_leader(msg)
            return
        self._mgr_last_beacon[msg.name] = time.monotonic()
        rec = {"name": msg.name, "gid": msg.gid,
               "addr": [msg.host, msg.port]}
        if self._mgr_beacon_changes_map(rec):
            await self._propose({"op": "mgr_beacon", **rec})
        # always answer with the current map so a fresh mgr learns its
        # role immediately (publication also reaches subscribers)
        try:
            await msg.conn.send_message(self._mgr_map_msg())
        except (ConnectionError, OSError):
            pass

    def _mgr_beacon_changes_map(self, rec: dict) -> bool:
        m = self._mgr_map
        for existing in [m["active"], *m["standbys"]]:
            if existing and existing["name"] == rec["name"]:
                return (existing["gid"] != rec["gid"]
                        or existing["addr"] != rec["addr"])
        return True  # unknown mgr: joins the map

    # -- the replicated state machine ----------------------------------

    async def _apply_mgr_op(self, op: dict) -> None:
        """Deterministic MgrMap mutations (every quorum member, paxos
        order).  MgrMap epochs are its own sequence — mgr changes mint
        no osdmap epochs."""
        kind = op["op"]
        m = self._mgr_map
        changed = False
        if kind == "mgr_beacon":
            rec = {"name": op["name"], "gid": op["gid"],
                   "addr": list(op["addr"])}
            slot = None
            if m["active"] and m["active"]["name"] == rec["name"]:
                slot = "active"
                changed = m["active"] != rec
                m["active"] = rec
            else:
                for i, sb in enumerate(m["standbys"]):
                    if sb["name"] == rec["name"]:
                        slot = "standby"
                        changed = sb != rec
                        m["standbys"][i] = rec
                        break
            if slot is None:
                if m["active"] is None:
                    m["active"] = rec
                else:
                    m["standbys"].append(rec)
                changed = True
        elif kind == "mgr_down":
            name = op["name"]
            if m["active"] and m["active"]["name"] == name:
                m["active"] = (
                    m["standbys"].pop(0) if m["standbys"] else None)
                changed = True
            else:
                before = len(m["standbys"])
                m["standbys"] = [
                    sb for sb in m["standbys"] if sb["name"] != name]
                changed = len(m["standbys"]) != before
        elif kind == "mgr_module":
            mods = set(m["modules"])
            if op["enable"]:
                changed = op["module"] not in mods
                mods.add(op["module"])
            else:
                changed = op["module"] in mods
                mods.discard(op["module"])
            m["modules"] = sorted(mods)
        else:
            log.error("mon.%d: unknown mgr op %r", self.rank, kind)
            return
        if changed:
            m["epoch"] += 1
            await self._publish_mgr_map()

    # -- publication ---------------------------------------------------

    def _mgr_map_msg(self) -> MMgrMap:
        return MMgrMap(
            epoch=self._mgr_map["epoch"],
            blob=json.dumps(self._mgr_map).encode(),
        )

    async def _publish_mgr_map(self) -> None:
        if getattr(self, "_replaying", False):
            return  # subscribers re-learn the final map on subscribe
        msg = self._mgr_map_msg()
        # the mon's own MgrClient learns the map at the source
        mc = getattr(self, "mgr_client", None)
        if mc is not None:
            mc.handle_mgr_map(msg)
        for peer, conn in list(self._subscribers.items()):
            try:
                await conn.send_message(msg)
            except ConnectionError:
                self._subscribers.pop(peer, None)

    # -- liveness sweep (beacon grace -> failover) ---------------------

    def _start_mgr_tick(self) -> None:
        import asyncio

        if self.conf["mon_mgr_beacon_grace"] > 0:
            self._mgr_tick_task = asyncio.ensure_future(self._mgr_tick())

    async def _mgr_tick(self) -> None:
        import asyncio

        grace = self.conf["mon_mgr_beacon_grace"]
        was_leader = False
        while True:
            await asyncio.sleep(max(grace / 4, 0.05))
            if not self.is_leader:
                was_leader = False
                continue
            now = time.monotonic()
            if not was_leader:
                # fresh leadership: beacons were landing elsewhere —
                # one full grace before judging anyone
                was_leader = True
                m = self._mgr_map
                for rec in [m["active"], *m["standbys"]]:
                    if rec:
                        self._mgr_last_beacon[rec["name"]] = now
                continue
            m = self._mgr_map
            try:
                for rec in [m["active"], *list(m["standbys"])]:
                    if rec is None:
                        continue
                    last = self._mgr_last_beacon.get(rec["name"], 0.0)
                    if now - last > grace:
                        log.info("mon.%d: mgr.%s beacon timeout -> "
                                 "dropped from MgrMap", self.rank,
                                 rec["name"])
                        await self._propose({
                            "op": "mgr_down", "name": rec["name"]})
            except ConnectionError:
                continue  # lost quorum mid-sweep; retry next tick

    # -- digest intake -------------------------------------------------

    async def _handle_mgr_report(self, msg: MMonMgrReport) -> None:
        if not self.is_leader:
            await self._forward_to_leader(msg)
            return
        try:
            digest = json.loads(msg.blob or b"{}")
        except ValueError:
            return
        # only the ACTIVE mgr's digest counts (a demoted mgr's last
        # in-flight report must not shadow its successor's)
        act = self._mgr_map.get("active")
        if act is None or digest.get("gid") != act.get("gid"):
            return
        self._mgr_digest = digest
        self._mgr_digest_at = time.monotonic()

    # -- command surface helpers ---------------------------------------

    def _mgr_status_block(self) -> dict:
        m = self._mgr_map
        return {
            "epoch": m["epoch"],
            "active": m["active"]["name"] if m["active"] else None,
            "standbys": [sb["name"] for sb in m["standbys"]],
            "modules": list(m["modules"]),
            "available": m["active"] is not None,
        }

    def _mgr_stat(self) -> dict:
        """`ceph mgr stat`: map summary + digest freshness (what the
        chaos invariant polls to prove report streams resumed)."""
        now = time.monotonic()
        d = self._mgr_digest or {}
        return {
            **self._mgr_status_block(),
            "digest_age": (round(now - self._mgr_digest_at, 3)
                           if self._mgr_digest is not None else None),
            "reporting": d.get("daemons", []),
            "reports_rx": d.get("reports_rx", 0),
            "engine": d.get("engine", {}),
        }

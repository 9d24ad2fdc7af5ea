"""Monitor command surface — the MonCommands.h slice.

One dispatcher over every admin verb, delegating mutations to the
owning service mixins (reference src/mon/Monitor.cc handle_command ->
PaxosService::dispatch).
"""

from __future__ import annotations

import asyncio
import logging

from ceph_tpu_torch.ec import registry as ec_registry
from ceph_tpu_torch.msg.messages import MOSDScrub, MOSDScrubReply

log = logging.getLogger("ceph_tpu_torch.mon")


class CommandMixin:
    async def _command(
        self, cmd: dict[str, str], caps: dict[str, str] | None = None,
    ) -> tuple[int, str, bytes]:
        import errno
        import json

        prefix = cmd.get("prefix", "")
        if caps is not None:
            # MonCap admission (Monitor::_allowed_command): mutations
            # need mon w, everything else mon r — EXCEPT the auth
            # plane, which is admin-only end to end (the reference
            # tags MonCommands.h auth verbs with mon rwx): 'auth get'
            # returns secret keys and 'auth caps' rewrites grants, so
            # plain r/w must not reach either
            from ceph_tpu_torch.common.caps import capable

            if prefix.startswith("auth "):
                need = "rwx"
            else:
                need = "w" if prefix in self.WRITE_PREFIXES else "r"
            if not capable(caps, "mon", need):
                return -errno.EACCES, "access denied", b""
        mutating = prefix in self.WRITE_PREFIXES or prefix in (
            # not mutations, but only the leader ingests pg stats /
            # mgr digests and knows the live quorum: redirect so peons
            # don't serve an empty status plane.  `log last` / `health
            # history` are deliberately ABSENT: they serve replicated
            # state, so a follow stream keeps working on any member
            # through a mon failover.
            "status", "health", "pg stat", "df", "osd df",
            "osd perf", "mgr stat", "trace ls", "trace show",
            "progress", "crash ls", "crash info",
        )
        if mutating and not self.is_leader:
            leader = self.paxos.leader if self.paxos.leader is not None else -1
            return -errno.EAGAIN, f"ENOTLEADER {leader}", b""
        if prefix in self.WRITE_PREFIXES:
            # every accepted admin write lands in the AUDIT channel of
            # the replicated cluster log (the reference logs command
            # dispatch through LogChannel("audit"))
            await self._log_append("audit", 1, "from='client' cmd=" + str(
                {k: v for k, v in sorted(cmd.items())}) + ": dispatch")
        try:
            if prefix == "osd erasure-code-profile set":
                name = cmd["name"]
                profile = dict(
                    kv.split("=", 1) for kv in cmd.get("profile", "").split() if kv
                )
                profile.setdefault("plugin", "cuda")
                # instantiate once to validate + fill defaults
                ec_registry.factory(profile["plugin"], profile,
                                    device=self.device)
                await self._propose({
                    "op": "profile", "name": name, "profile": profile,
                })
                return 0, f"profile {name} set", b""
            if prefix == "osd pool create":
                return await self._pool_create(cmd)
            if prefix.startswith("auth "):
                return await self._auth_command(prefix, cmd)
            if prefix == "osd pool set":
                return await self._pool_set(cmd)
            if prefix == "osd pool rm":
                return await self._pool_rm(cmd)
            if prefix.startswith("osd tier "):
                return await self._tier_command(prefix, cmd)
            if prefix == "osd in":
                osd = int(cmd["id"])
                om = self.osdmap
                if not om.exists(osd):
                    return -errno.ENOENT, f"osd.{osd} does not exist", b""
                if not om.is_out(osd):
                    return 0, f"osd.{osd} is already in", b""
                await self._propose({"op": "in", "osd": osd})
                return 0, f"marked in osd.{osd}", b""
            if prefix == "osd pool selfmanaged-snap create":
                pid = self._pool_ids[cmd["pool"]]
                # serialize id allocation: two concurrent creates must
                # not both read snap_seq before either commits
                async with self._snap_alloc_lock(pid):
                    snapid = self.osdmap.pools[pid].snap_seq + 1
                    await self._propose({
                        "op": "snap_alloc", "pool": pid, "snapid": snapid,
                    })
                return 0, f"snap {snapid}", json.dumps(
                    {"snapid": snapid}).encode()
            if prefix == "osd pool selfmanaged-snap rm":
                pid = self._pool_ids[cmd["pool"]]
                snapid = int(cmd["snapid"])
                if snapid not in self.osdmap.pools[pid].removed_snaps:
                    await self._propose({
                        "op": "snap_rm", "pool": pid, "snapid": snapid,
                    })
                return 0, f"snap {snapid} removed", b""
            if prefix == "osd pool mksnap":
                pid = self._pool_ids[cmd["pool"]]
                name = cmd["snap"]
                async with self._snap_alloc_lock(pid):
                    pool = self.osdmap.pools[pid]
                    if name in pool.pool_snaps:
                        return -errno.EEXIST, f"snap {name} exists", b""
                    snapid = pool.snap_seq + 1
                    await self._propose({
                        "op": "snap_alloc", "pool": pid, "snapid": snapid,
                        "name": name,
                    })
                return 0, f"created pool snap {name}", json.dumps(
                    {"snapid": snapid}).encode()
            if prefix == "osd pool rmsnap":
                pid = self._pool_ids[cmd["pool"]]
                name = cmd["snap"]
                pool = self.osdmap.pools[pid]
                if name not in pool.pool_snaps:
                    return -errno.ENOENT, f"no snap {name}", b""
                await self._propose({
                    "op": "snap_rm", "pool": pid,
                    "snapid": pool.pool_snaps[name], "name": name,
                })
                return 0, f"removed pool snap {name}", b""
            if prefix == "osd down":
                osd = int(cmd["id"])
                if self.osdmap.is_up(osd):
                    await self._propose({"op": "down", "osd": osd})
                return 0, f"osd.{osd} down", b""
            if prefix == "osd out":
                osd = int(cmd["id"])
                if not self.osdmap.is_out(osd):
                    await self._propose({"op": "out", "osd": osd})
                return 0, f"osd.{osd} out", b""
            if prefix == "osd balance":
                import json

                from ceph_tpu_torch.osd.balancer import UpmapBalancer
                from ceph_tpu_torch.osd.mapenc import decode_osdmap, encode_osdmap

                try:
                    fd = self.osdmap.crush.type_id("host")
                except KeyError:
                    fd = 1
                # the census is seconds of pure computation: run it on a
                # SNAPSHOT in a worker thread so the event loop keeps
                # dispatching beacons (a blocked loop looks like every
                # OSD going silent at once)
                snapshot = decode_osdmap(encode_osdmap(self.osdmap))
                max_swaps = int(cmd.get("max_swaps", "64"))

                def _optimize():
                    bal = UpmapBalancer(snapshot, failure_domain_type=fd,
                                        device=self.device)
                    return bal.optimize(max_swaps=max_swaps)

                items = await asyncio.to_thread(_optimize)
                if items:
                    await self._propose({
                        "op": "upmap",
                        "items": [
                            [pg.pool, pg.ps, [list(p) for p in pairs]]
                            for pg, pairs in items.items()
                        ],
                    })
                return 0, f"{len(items)} upmap items installed", json.dumps(
                    {"swaps": len(items)}
                ).encode()
            if prefix in ("pg scrub", "pg deep-scrub", "pg repair"):
                return await self._scrub(
                    cmd, deep=prefix != "pg scrub",
                    repair=prefix == "pg repair")
            if prefix == "df":
                # `ceph df` (reference MgrStatMonitor/`df` detail):
                # cluster raw totals from beacon statfs + per-pool
                # logical usage aggregated from pg stats
                om = self.osdmap
                book = getattr(self, "_osd_statfs", {}) or {}
                live = {o: s for o, s in book.items() if om.exists(o)}
                pools: dict[str, dict] = {}
                for pgid, st in (getattr(self, "_pg_stats", {}) or {}).items():
                    pid = int(pgid.split(".")[0])
                    if pid not in om.pools:
                        continue
                    name = om.pool_names.get(pid, str(pid))
                    d = pools.setdefault(
                        name, {"id": pid, "objects": 0, "bytes_used": 0})
                    d["objects"] += int(st.get("objects", 0))
                    d["bytes_used"] += int(st.get("bytes", 0))
                data = json.dumps({
                    "stats": {
                        "total_bytes": sum(
                            int(s.get("total", 0)) for s in live.values()),
                        "total_used_bytes": sum(
                            int(s.get("used", 0)) for s in live.values()),
                        "total_avail_bytes": sum(
                            int(s.get("available", 0))
                            for s in live.values()),
                    },
                    "pools": pools,
                }).encode()
                return 0, "", data
            if prefix == "osd df":
                # `ceph osd df`: per-osd usage + fullness state
                om = self.osdmap
                book = getattr(self, "_osd_statfs", {}) or {}
                nodes = []
                for o in range(om.max_osd):
                    if not om.exists(o):
                        continue
                    sf = book.get(o, {})
                    t = int(sf.get("total", 0))
                    u = int(sf.get("used", 0))
                    state = []
                    if om.is_full(o):
                        state.append("full")
                    elif om.is_backfillfull(o):
                        state.append("backfillfull")
                    elif om.is_nearfull(o):
                        state.append("nearfull")
                    nodes.append({
                        "id": o,
                        "total": t,
                        "used": u,
                        "available": int(sf.get("available", 0)),
                        "utilization": (u / t) if t else 0.0,
                        "state": state,
                    })
                return 0, "", json.dumps({"nodes": nodes}).encode()
            if prefix == "status":
                om = self.osdmap
                pgsum = self._pg_summary()
                up = sum(om.is_up(o) for o in range(om.max_osd))
                inn = sum(
                    not om.is_out(o) for o in range(om.max_osd) if om.exists(o)
                )
                data = json.dumps({
                    "epoch": om.epoch,
                    "num_osds": sum(om.exists(o) for o in range(om.max_osd)),
                    "num_up_osds": up,
                    "num_in_osds": inn,
                    "quorum": sorted(self.paxos.quorum),
                    "pools": {
                        str(pid): {"name": name, "pg_num": om.pools[pid].pg_num}
                        for name, pid in self._pool_ids.items()
                    },
                    "pgs": pgsum,
                    "health": self._render_health(pgsum),
                    # the `ceph status` mgr line (reference mgrmap
                    # summary: "mgr: x(active), standbys: y")
                    "mgr": self._mgr_status_block(),
                    # the mgr progress module's events (recovery /
                    # rebalance completion + ETA), folded into status
                    "progress": (self._mgr_digest or {}).get(
                        "progress", {}),
                }).encode()
                return 0, "", data
            if prefix == "config set":
                who = cmd.get("who", "global")
                name, value = cmd["name"], cmd["value"]
                from ceph_tpu_torch.common.config import OPTIONS

                opt = OPTIONS.get(name)
                if opt is None:
                    return -errno.ENOENT, f"unknown option {name!r}", b""
                try:
                    opt.cast(value)
                except (ValueError, TypeError) as e:
                    return -errno.EINVAL, str(e), b""
                await self._propose({
                    "op": "config_set", "who": who,
                    "name": name, "value": value,
                })
                return 0, f"set {who}/{name}", b""
            if prefix == "config rm":
                await self._propose({
                    "op": "config_rm", "who": cmd.get("who", "global"),
                    "name": cmd["name"],
                })
                return 0, "removed", b""
            if prefix == "config dump":
                return 0, "", json.dumps(self._config_db).encode()
            if prefix == "config get":
                who = cmd.get("who", "global")
                kind = who.split(".")[0]
                merged: dict[str, str] = {}
                for sec in ("global", kind, who):
                    merged.update(self._config_db.get(sec, {}))
                if "name" in cmd:
                    if cmd["name"] not in merged:
                        return -errno.ENOENT, "not set", b""
                    return 0, "", merged[cmd["name"]].encode()
                return 0, "", json.dumps(merged).encode()
            if prefix == "osd pg-upmap-items":
                # explicit placement override pairs (reference
                # OSDMonitor osd pg-upmap-items): pgid from to [...]
                pool_id, ps = cmd["pgid"].split(".", 1)
                pool_id = int(pool_id)
                ps = int(ps, 16) if ps.startswith("0x") else int(ps)
                pool = self.osdmap.pools.get(pool_id)
                if pool is None:
                    return -errno.ENOENT, f"no pool {pool_id}", b""
                if not 0 <= ps < pool.pg_num:
                    return -errno.ENOENT, f"no pg {cmd['pgid']}", b""
                pairs_raw = cmd["pairs"].split()
                if len(pairs_raw) % 2:
                    return -errno.EINVAL, "pairs must be from/to pairs", b""
                items = [
                    [int(pairs_raw[i]), int(pairs_raw[i + 1])]
                    for i in range(0, len(pairs_raw), 2)
                ]
                for frm, to in items:
                    if not (self.osdmap.exists(frm)
                            and self.osdmap.exists(to)):
                        return (-errno.ENOENT,
                                f"osd {frm} or {to} does not exist", b"")
                await self._propose({
                    "op": "upmap",
                    "items": [[pool_id, ps, items]],
                })
                return 0, f"upmap set on {cmd['pgid']}", b""
            if prefix == "osd crush reweight":
                name = cmd["name"]
                om2 = self.osdmap
                if name.startswith("osd."):
                    item = int(name[4:])
                elif name in om2.crush.bucket_names:
                    item = om2.crush.bucket_names[name]
                else:
                    return -errno.ENOENT, f"no item {name!r}", b""
                if not any(
                    item in b.items for b in om2.crush.buckets.values()
                ):
                    return -errno.ENOENT, f"{name!r} not in the map", b""
                weight = int(float(cmd["weight"]) * 0x10000)
                await self._propose({
                    "op": "crush_reweight", "item": item,
                    "weight": weight,
                })
                return 0, f"reweighted {name} to {cmd['weight']}", b""
            if prefix == "osd crush add-bucket":
                # OSDMonitor 'osd crush add-bucket <name> <type>'
                name, tname = cmd["name"], cmd["type"]
                om2 = self.osdmap
                try:
                    om2.crush.type_id(tname)
                except KeyError:
                    return -errno.EINVAL, f"unknown type {tname!r}", b""
                if name in om2.crush.bucket_names:
                    return 0, f"bucket {name!r} already exists", b""
                await self._propose({
                    "op": "crush_add_bucket", "name": name,
                    "type": tname,
                })
                return 0, f"added bucket {name}", b""
            if prefix in ("osd crush move", "osd crush add"):
                # 'osd crush move <name> <loc>' relocates an existing
                # item; 'osd crush add osd.N <weight> <loc>' places a
                # device (create-or-move).  <loc> is type=name, e.g.
                # root=default or host=host3 (CrushWrapper::move_bucket
                # / insert_item)
                name = cmd["name"]
                loc = cmd.get("loc") or cmd.get("args", "")
                if "=" not in loc:
                    return -errno.EINVAL, f"bad location {loc!r}", b""
                _ltype, lname = loc.split("=", 1)
                om2 = self.osdmap
                if lname not in om2.crush.bucket_names:
                    return -errno.ENOENT, f"no bucket {lname!r}", b""
                if name.startswith("osd."):
                    item = int(name[4:])
                    if prefix == "osd crush add" and \
                            not om2.exists(item):
                        return -errno.ENOENT, \
                            f"osd.{item} does not exist", b""
                elif prefix == "osd crush add":
                    # the reference restricts 'crush add' to devices:
                    # an explicit weight on a bucket would desync the
                    # parent's stored weight from the subtree sum
                    return -errno.EINVAL, \
                        "'osd crush add' takes an osd.N id (use " \
                        "'osd crush move' for buckets)", b""
                elif name in om2.crush.bucket_names:
                    item = om2.crush.bucket_names[name]
                else:
                    return -errno.ENOENT, f"no item {name!r}", b""
                from ceph_tpu_torch.crush.builder import would_cycle

                if would_cycle(
                        om2.crush, item,
                        om2.crush.bucket_names[lname]):
                    return -errno.EINVAL, \
                        f"moving {name!r} under {lname!r} would " \
                        "create a loop", b""
                op = {
                    "op": "crush_move", "item_name": name,
                    "loc": lname,
                }
                if prefix == "osd crush add":
                    op["weight"] = int(float(cmd["weight"]) * 0x10000)
                await self._propose(op)
                return 0, f"moved {name} under {lname}", b""
            if prefix == "osd crush rm":
                name = cmd["name"]
                om2 = self.osdmap
                if name.startswith("osd."):
                    item = int(name[4:])
                elif name in om2.crush.bucket_names:
                    item = om2.crush.bucket_names[name]
                else:
                    return -errno.ENOENT, f"no item {name!r}", b""
                if item < 0 and om2.crush.buckets[item].items:
                    return -errno.ENOTEMPTY, \
                        f"bucket {name!r} is not empty", b""
                await self._propose({
                    "op": "crush_rm", "item_name": name,
                })
                return 0, f"removed {name}", b""
            if prefix == "osd pool autoscale-status":
                # the pg_autoscaler mgr module's sizing math
                # (reference src/pybind/mgr/pg_autoscaler).  Advisory
                # here; pools with pg_autoscale_mode=on get the advice
                # APPLIED by _autoscale_tick (pg splitting exists now)
                return 0, "", json.dumps(self._autoscale_rows()).encode()
            if prefix == "mgr dump":
                return 0, "", json.dumps(self._mgr_map).encode()
            if prefix == "mgr stat":
                return 0, "", json.dumps(self._mgr_stat()).encode()
            if prefix == "mgr digest":
                # the analytics/telemetry slice of the active mgr's
                # last MMonMgrReport — what the load harness
                # cross-checks its client-side percentiles against
                # (over the wire, so the whole report->digest->mon
                # chain is what gets verified)
                d = self._mgr_digest or {}
                return 0, "", json.dumps({
                    "active": d.get("active"), "ts": d.get("ts"),
                    "analytics": d.get("analytics", {}),
                    "osd_perf": d.get("osd_perf", {}),
                    "load_clients": d.get("load_clients", {}),
                    "health": sorted(d.get("health", {})),
                    "engine": d.get("engine", {}),
                }).encode()
            if prefix == "mgr module ls":
                from ceph_tpu_torch.mgr.modules import MODULE_REGISTRY

                return 0, "", json.dumps({
                    "enabled_modules": list(self._mgr_map["modules"]),
                    "available_modules": sorted(MODULE_REGISTRY),
                }).encode()
            if prefix in ("mgr module enable", "mgr module disable"):
                from ceph_tpu_torch.mgr.modules import MODULE_REGISTRY

                module = cmd["module"]
                if module not in MODULE_REGISTRY:
                    return -errno.ENOENT, f"no module {module!r}", b""
                enable = prefix.endswith("enable")
                await self._propose({
                    "op": "mgr_module", "module": module,
                    "enable": enable,
                })
                verb = "enabled" if enable else "disabled"
                return 0, f"module {module!r} {verb}", b""
            if prefix == "mgr fail":
                # drop the named (or active) mgr from the map NOW —
                # the operator's manual failover lever
                name = cmd.get("who", "")
                act = self._mgr_map.get("active")
                if not name and act is not None:
                    name = act["name"]
                known = [r["name"] for r in
                         [act, *self._mgr_map["standbys"]] if r]
                if name not in known:
                    return -errno.ENOENT, f"no mgr {name!r}", b""
                await self._propose({"op": "mgr_down", "name": name})
                return 0, f"mgr.{name} failed", b""
            if prefix == "osd perf":
                # per-OSD commit/apply latency from the mgr's
                # time-series store (reference `ceph osd perf`, served
                # by the mgr digest plane)
                d = self._mgr_digest or {}
                return 0, "", json.dumps({
                    "osd_perf_infos": [
                        {"id": int(osd), **row}
                        for osd, row in sorted(
                            d.get("osd_perf", {}).items(),
                            key=lambda kv: int(kv[0]))
                    ],
                    "source_mgr": d.get("active"),
                }).encode()
            if prefix == "trace ls":
                # cross-daemon trace summaries from the active mgr's
                # collector (rides the MMonMgrReport digest)
                d = self._mgr_digest or {}
                traces = d.get("traces", {})
                return 0, "", json.dumps({
                    "traces": traces.get("ls", []),
                    "source_mgr": d.get("active"),
                    "stats": traces.get("stats", {}),
                }).encode()
            if prefix == "trace show":
                d = self._mgr_digest or {}
                trees = (d.get("traces", {}) or {}).get("trees", {})
                tid = str(cmd["trace_id"])
                a = trees.get(tid)
                if a is None:
                    return (-errno.ENOENT,
                            f"trace {tid} not in the digest window "
                            "(only recent + slow traces ride the "
                            "digest; see `trace ls`)", b"")
                from ceph_tpu_torch.mgr.tracer import render_tree

                a = dict(a)
                a["rendered"] = render_tree(a["tree"])
                return 0, "", json.dumps(a).encode()
            if prefix == "health":
                # own checks + mgr-digest module checks, mute-filtered
                # (mon/log_service.py — the reference HealthMonitor +
                # MMonMgrReport health merge)
                h = self._render_health()
                return 0, h["status"], json.dumps(h).encode()
            if prefix == "health history":
                return 0, "", json.dumps({
                    "history": self._health_history,
                    "mutes": self._health_mutes,
                }).encode()
            if prefix == "health mute":
                code_name = cmd["code"]
                ttl = float(cmd.get("ttl") or
                            self.conf["mon_health_mute_ttl_default"])
                import time as _time

                await self._propose({
                    "op": "health_mute", "code": code_name,
                    "until": (_time.time() + ttl) if ttl > 0 else None,
                    "sticky": cmd.get("sticky", "") in
                    ("1", "true", "yes", "on"),
                    "at": _time.time(),
                })
                return 0, f"muted {code_name}" + (
                    f" for {ttl:g}s" if ttl > 0 else ""), b""
            if prefix == "health unmute":
                code_name = cmd["code"]
                if code_name not in self._health_mutes:
                    return -errno.ENOENT, f"{code_name} is not muted", b""
                await self._propose({
                    "op": "health_unmute", "code": code_name})
                return 0, f"unmuted {code_name}", b""
            if prefix == "log last":
                return 0, "", json.dumps(self._log_last(
                    n=int(cmd.get("n", "20")),
                    channel=cmd.get("channel", ""),
                    since=int(cmd.get("since", "0")),
                )).encode()
            if prefix == "progress":
                # recovery/rebalance progress events from the mgr
                # progress module (ride the MMonMgrReport digest)
                d = self._mgr_digest or {}
                prog = d.get("progress", {}) or {}
                return 0, "", json.dumps({
                    "events": prog.get("events", []),
                    "completed": prog.get("completed", []),
                    "source_mgr": d.get("active"),
                }).encode()
            if prefix == "crash ls":
                d = self._mgr_digest or {}
                crash = d.get("crash", {}) or {}
                return 0, "", json.dumps({
                    "crashes": crash.get("crashes", []),
                    "recent": crash.get("recent", 0),
                    "source_mgr": d.get("active"),
                }).encode()
            if prefix == "crash info":
                d = self._mgr_digest or {}
                cid = cmd["id"]
                for meta in (d.get("crash", {}) or {}).get("crashes", []):
                    if meta.get("crash_id") == cid:
                        return 0, "", json.dumps(meta).encode()
                return -errno.ENOENT, f"no crash {cid!r} in the " \
                    "collector window (see `crash ls`)", b""
            if prefix in ("crash archive", "crash archive-all"):
                # the shared crash_dir IS the posted record: archiving
                # marks dumps acknowledged in place; the mgr crash
                # module observes it on its next scan and RECENT_CRASH
                # clears
                from ceph_tpu_torch.common.crash import archive_crash

                cdir = self.conf["crash_dir"]
                if not cdir:
                    return -errno.EINVAL, \
                        "crash_dir is not configured on this mon", b""
                cid = None if prefix.endswith("-all") else cmd["id"]
                n = archive_crash(cdir, cid)
                return 0, f"archived {n} crash dump(s)", json.dumps(
                    {"archived": n}).encode()
            if prefix == "pg stat":
                book = getattr(self, "_pg_stats", {}) or {}
                return 0, "", json.dumps({
                    "pg_stats": book, "summary": self._pg_summary(),
                }).encode()
            return -errno.EINVAL, f"unknown command {prefix!r}", b""
        except KeyError as e:
            return -errno.EINVAL, f"missing arg {e}", b""
        except Exception as e:  # command errors must not kill the mon
            eno = getattr(e, "errno", None) or errno.EINVAL
            return -eno, str(e) or type(e).__name__, b""

    async def _scrub(self, cmd: dict[str, str], deep: bool,
                     repair: bool = False) -> tuple[int, str, bytes]:
        """Forward a scrub request to the PG's primary and return its
        report (OSDMonitor scrub command -> MOSDScrub to the OSD)."""
        import errno

        from ceph_tpu_torch.osd.types import pg_t

        pool_id, ps = cmd["pgid"].split(".", 1)
        pool_id, ps = int(pool_id), int(ps, 16) if ps.startswith("0x") else int(ps)
        om = self.osdmap
        if om.get_pg_pool(pool_id) is None:
            return -errno.ENOENT, f"no pool {pool_id}", b""
        _, _, _, primary = om.pg_to_up_acting_osds(pg_t(pool_id, ps), folded=True)
        if primary < 0:
            return -errno.EAGAIN, f"pg {cmd['pgid']} has no primary", b""
        addr = om.osd_addrs.get(primary)
        conn = self._subscribers.get(("osd", primary))
        if conn is None and addr is not None:
            conn = await self.messenger.connect_to(("osd", primary), *addr)
        if conn is None:
            return -errno.EAGAIN, f"primary osd.{primary} unreachable", b""
        tid = next(self._tids)
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._scrub_waiters[tid] = fut
        try:
            await conn.send_message(
                MOSDScrub(tid=tid, pool=pool_id, ps=ps, deep=deep,
                          repair=repair)
            )
            # shorter than the client command timeout (30s): a slow
            # scrub returns an error here instead of the client
            # resending and stacking duplicate scrubs
            reply: MOSDScrubReply = await asyncio.wait_for(fut, 25)
        except asyncio.TimeoutError:
            return -errno.ETIMEDOUT, "scrub did not finish in 25s", b""
        finally:
            self._scrub_waiters.pop(tid, None)
        return reply.result, "", reply.report

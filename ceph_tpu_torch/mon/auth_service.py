"""Auth service: the AuthMonitor plane.

Paxos-replicated entity/key/caps database with the admin command
surface (reference src/mon/AuthMonitor.cc prepare_command) mirrored
into the live messenger AuthContext.
"""

from __future__ import annotations

import logging

log = logging.getLogger("ceph_tpu_torch.mon")


class AuthServiceMixin:
    async def _apply_auth_op(self, op: dict) -> None:
        """Committed auth mutation (never mints an osdmap epoch)."""
        if op["op"] == "auth_upsert":
            self._auth_db[op["entity"]] = {
                "key": op["key"], "caps": dict(op["caps"]),
            }
        else:  # auth_del
            self._auth_db.pop(op["entity"], None)
        self._sync_auth_keyring()

    async def _auth_command(
        self, prefix: str, cmd: dict[str, str],
    ) -> tuple[int, str, bytes]:
        """The AuthMonitor command slice (src/mon/AuthMonitor.cc
        prepare_command): add / get-or-create / del / caps / get / ls.
        ``caps`` argument is a JSON object {"mon": "allow r", ...}."""
        import errno
        import json

        from ceph_tpu_torch.common.caps import CapsError, validate
        from ceph_tpu_torch.msg.auth import make_secret

        def parse_caps() -> dict[str, str]:
            raw = cmd.get("caps", "")
            caps = json.loads(raw) if raw else {}
            if not isinstance(caps, dict):
                raise CapsError("caps must be an object")
            validate(caps)
            return caps

        entity = cmd.get("entity", "")
        if prefix in ("auth add", "auth get-or-create", "auth del",
                      "auth caps", "auth get") and not entity:
            return -errno.EINVAL, "entity required", b""
        if entity in getattr(self, "_bootstrap_entities", set()):
            # construction-keyring identities are the cluster's root of
            # trust (client.admin bootstrap): the command plane must
            # not be able to rebind or delete them
            return -errno.EPERM, f"{entity} is a bootstrap entity", b""
        try:
            if prefix == "auth add":
                if entity in self._auth_db:
                    return -errno.EEXIST, f"entity {entity} exists", b""
                key = cmd.get("key") or make_secret().hex()
                try:
                    if len(bytes.fromhex(key)) not in (16, 24, 32):
                        raise ValueError
                except ValueError:
                    # never let a malformed key reach paxos: applying
                    # it would poison every restart's replay
                    return -errno.EINVAL, "key must be 16/24/32 hex bytes", b""
                await self._propose({
                    "op": "auth_upsert", "entity": entity, "key": key,
                    "caps": parse_caps(),
                })
                return 0, "added", json.dumps({"key": key}).encode()
            if prefix == "auth get-or-create":
                existing = self._auth_db.get(entity)
                if existing is not None:
                    if cmd.get("caps"):
                        if parse_caps() != existing["caps"]:
                            # the reference's EINVAL on caps mismatch:
                            # a get-or-create never silently diverges
                            # from what the caller asked for
                            return (-errno.EINVAL,
                                    "entity exists with different caps", b"")
                    return 0, "exists", json.dumps(
                        {"key": existing["key"]}).encode()
                key = make_secret().hex()
                await self._propose({
                    "op": "auth_upsert", "entity": entity, "key": key,
                    "caps": parse_caps(),
                })
                return 0, "created", json.dumps({"key": key}).encode()
            if prefix == "auth del":
                if entity not in self._auth_db:
                    return -errno.ENOENT, f"no entity {entity}", b""
                await self._propose({"op": "auth_del", "entity": entity})
                return 0, "removed", b""
            if prefix == "auth caps":
                rec = self._auth_db.get(entity)
                if rec is None:
                    return -errno.ENOENT, f"no entity {entity}", b""
                await self._propose({
                    "op": "auth_upsert", "entity": entity,
                    "key": rec["key"], "caps": parse_caps(),
                })
                return 0, "caps updated", b""
            if prefix == "auth get":
                rec = self._auth_db.get(entity)
                if rec is None:
                    return -errno.ENOENT, f"no entity {entity}", b""
                return 0, "", json.dumps(
                    {"entity": entity, **rec}).encode()
            if prefix == "auth ls":
                return 0, "", json.dumps({
                    e: {"caps": r["caps"]}
                    for e, r in sorted(self._auth_db.items())
                }).encode()
        except (CapsError, json.JSONDecodeError) as e:
            return -errno.EINVAL, f"bad caps: {e}", b""
        return -errno.EOPNOTSUPP, f"unknown {prefix!r}", b""

    def _sync_auth_keyring(self) -> None:
        """Mirror the paxos-committed auth database into the live
        AuthContext so grants/tickets reflect it immediately (the
        AuthMonitor -> KeyServer update path).  Statically-keyed
        bootstrap entities (construction keyring) stay untouched."""
        a = self.messenger.auth
        if a is None:
            return
        synced = getattr(self, "_auth_synced", set())
        for entity in synced - set(self._auth_db):
            a.keyring.pop(entity, None)
            a.caps_db.pop(entity, None)
        ok: set[str] = set()
        for entity, rec in self._auth_db.items():
            if entity in self._bootstrap_entities:
                continue  # never clobber the root of trust
            try:
                key = bytes.fromhex(rec["key"])
                if len(key) not in (16, 24, 32):
                    raise ValueError(len(key))
            except ValueError:
                # a poisoned record must degrade to "that entity can't
                # auth", never to "the monitor can't restart"
                log.error("mon.%d: unusable key for %s in auth db — "
                          "skipped", self.rank, entity)
                continue
            a.keyring[entity] = key
            a.caps_db[entity] = dict(rec["caps"])
            ok.add(entity)
        self._auth_synced = ok

"""Config service: the ConfigMonitor plane.

Centralized typed-option distribution (reference
src/mon/ConfigMonitor.cc): a paxos-replicated who->option database
pushed to subscribed daemons as MConfig sections and applied locally.
"""

from __future__ import annotations

import logging

from ceph_tpu_torch.msg.messages import MConfig

log = logging.getLogger("ceph_tpu_torch.mon")


class ConfigServiceMixin:
    async def _apply_config_op(self, op: dict) -> None:
        """Committed config mutation (never mints an osdmap epoch)."""
        if op["op"] == "config_set":
            db = self._config_db.setdefault(op["who"], {})
            db[op["name"]] = op["value"]
        else:  # config_rm
            self._config_db.get(op["who"], {}).pop(op["name"], None)
        self._apply_config_locally()
        await self._push_config()

    def _config_sections_for(self, who: tuple[str, int]) -> dict:
        """The sections addressing one entity, in precedence order
        (global < type < type.id), pre-merged for the receiver."""
        kind, ident = who
        out: dict[str, dict[str, str]] = {}
        for sec in ("global", kind, f"{kind}.{ident}"):
            if sec in self._config_db:
                out[sec] = dict(self._config_db[sec])
        return out

    def _apply_config_locally(self) -> None:
        for sec in ("global", "mon", f"mon.{self.rank}"):
            for name, value in self._config_db.get(sec, {}).items():
                try:
                    self.conf.set(name, value, source="mon")
                except (KeyError, ValueError):
                    pass

    async def _push_config(self) -> None:
        for peer, conn in list(self._subscribers.items()):
            secs = self._config_sections_for(peer)
            try:
                await conn.send_message(MConfig(sections=secs))
            except (ConnectionError, OSError):
                self._subscribers.pop(peer, None)

"""Per-daemon admin socket — the AdminSocket twin.

Behavioral twin of the reference's unix-domain admin socket
(src/common/admin_socket.h: every daemon serves `ceph daemon <sock>
<command>`): a JSON-line protocol over AF_UNIX — the client sends one
JSON object ``{"prefix": "...", ...}\\n`` and receives one JSON reply
line.  Commands register with a handler; the built-ins every daemon
gets are ``help``, ``version``, ``config show``, ``perf dump`` — OSDs
add the op-tracker dumps, the mon adds quorum status.
"""

from __future__ import annotations

import asyncio
import json
import logging
import os
from typing import Awaitable, Callable

log = logging.getLogger("ceph_tpu_torch.admin")

Handler = Callable[[dict], "dict | Awaitable[dict]"]


class AdminSocket:
    def __init__(self, path: str):
        self.path = path
        self._server: asyncio.AbstractServer | None = None
        self._commands: dict[str, tuple[str, Handler]] = {}
        self.register("help", "list registered commands", self._help)

    def register(self, prefix: str, desc: str, handler: Handler) -> None:
        self._commands[prefix] = (desc, handler)

    def _help(self, cmd: dict) -> dict:
        return {p: d for p, (d, _h) in sorted(self._commands.items())}

    async def start(self) -> None:
        if os.path.exists(self.path):
            os.unlink(self.path)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        self._server = await asyncio.start_unix_server(
            self._serve, path=self.path
        )

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            self._server = None
        try:
            os.unlink(self.path)
        except OSError:
            pass

    async def _serve(self, reader, writer) -> None:
        try:
            line = await reader.readline()
            if not line:
                return
            try:
                cmd = json.loads(line.decode())
            except ValueError:
                cmd = {"prefix": line.decode().strip()}
            prefix = cmd.get("prefix", "")
            ent = self._commands.get(prefix)
            if ent is None:
                out = {"error": f"unknown command {prefix!r}"}
            else:
                try:
                    res = ent[1](cmd)
                    if asyncio.iscoroutine(res):
                        res = await res
                    out = res
                except Exception as e:  # command errors must not kill us
                    log.exception("admin command %r failed", prefix)
                    out = {"error": f"{type(e).__name__}: {e}"}
            writer.write(json.dumps(out).encode() + b"\n")
            await writer.drain()
        finally:
            writer.close()


async def admin_command(path: str, cmd: dict | str) -> dict:
    """Client side (the `ceph daemon` tool)."""
    reader, writer = await asyncio.open_unix_connection(path)
    if isinstance(cmd, str):
        cmd = {"prefix": cmd}
    writer.write(json.dumps(cmd).encode() + b"\n")
    await writer.drain()
    line = await reader.readline()
    writer.close()
    return json.loads(line.decode())

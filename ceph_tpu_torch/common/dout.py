"""Per-subsystem leveled debug logging — the dout twin.

Behavioral twin of the reference's ``dout(n)`` macros + per-subsystem
debug levels (src/common/dout.h, src/common/subsys.h: every subsystem
has a level from config, e.g. ``debug_osd = 5``; a statement only
renders and emits when its level <= the subsystem's).  Levels are
config options (``debug_<subsys>``) and honor live updates through the
config observer mechanism, like ``ceph tell ... config set debug_osd``.
"""

from __future__ import annotations

import logging


class DoutLogger:
    """One subsystem's gated logger.  ``d.dout(level, fmt, *args)``
    emits only when ``level <= conf["debug_<subsys>"]``; the gate is a
    cached int refreshed by a config observer, so the hot path is one
    comparison (the reference's should_gather<sub, level>)."""

    def __init__(self, subsys: str, conf, name_suffix: str = ""):
        self.subsys = subsys
        self._log = logging.getLogger(
            f"ceph_tpu_torch.{subsys}" + (f".{name_suffix}" if name_suffix else "")
        )
        self._opt = f"debug_{subsys}"
        try:
            self.level = int(conf[self._opt])
        except KeyError:
            self.level = 1
        else:
            conf.add_observer([self._opt], self._on_change)

    def _on_change(self, changed: dict) -> None:
        self.level = int(changed[self._opt])

    def dout(self, level: int, fmt: str, *args) -> None:
        if level <= self.level:
            # dout semantics: everything surfaces as DEBUG-class
            # diagnostics; level 0 alone is operator-visible
            self._log.log(
                logging.INFO if level == 0 else logging.DEBUG, fmt, *args
            )

    def derr(self, fmt: str, *args) -> None:
        """dout(-1) — always emitted (src/common/dout.h derr)."""
        self._log.error(fmt, *args)

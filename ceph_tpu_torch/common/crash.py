"""Crash telemetry: persist-on-death dumps + the collection helpers.

The reference splits this across the daemon's signal handlers (which
write ``/var/lib/ceph/crash/<id>/meta``), the ``ceph-crash`` agent
(which posts dumps to the cluster) and the mgr ``crash`` module
(``ceph crash ls/info/archive`` + the RECENT_CRASH health warning).
Here the seams collapse onto a shared ``crash_dir``: daemons write one
JSON file per crash (:func:`record_crash`) on unhandled exit or
fault-injector-induced death, the mgr crash module scans the directory
each tick, and ``ceph crash archive`` marks dumps acknowledged in
place (the file IS the posted record).

A dump carries what the operator needs to triage without the daemon:
entity, wall-clock stamp, the exception + traceback (or the induced
reason), a fingerprint of the effective config, and the daemon's
recent in-memory log tail (LogClient's every-severity ring).
"""

from __future__ import annotations

import hashlib
import json
import logging
import os
import time
import traceback

log = logging.getLogger("ceph_tpu_torch.common")


def config_fingerprint(conf) -> str:
    """Stable hash of the effective configuration — two crashes with
    the same fingerprint ran the same config."""
    try:
        blob = json.dumps(conf.show(), sort_keys=True, default=str)
    except Exception:
        return "unknown"
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def record_crash(conf, entity: str, exc: BaseException | None = None,
                 reason: str = "", log_tail: list | None = None) -> str | None:
    """Persist one crash dump; returns the crash_id (None when
    ``crash_dir`` is unset — crash telemetry disabled).  Never raises:
    a dying daemon must not die harder because the crash disk is bad."""
    try:
        d = conf["crash_dir"]
        if not d:
            return None
        os.makedirs(d, exist_ok=True)
        now = time.time()
        crash_id = (
            time.strftime("%Y-%m-%dT%H-%M-%S", time.gmtime(now))
            + f".{time.time_ns() % 1_000_000_000:09d}_{entity}"
        )
        meta = {
            "crash_id": crash_id,
            "entity": entity,
            "timestamp": now,
            "reason": reason or (repr(exc) if exc is not None else ""),
            "exception": repr(exc) if exc is not None else None,
            "traceback": (
                "".join(traceback.format_exception(
                    type(exc), exc, exc.__traceback__))
                if exc is not None else ""
            ),
            "config_fingerprint": config_fingerprint(conf),
            "log_tail": list(log_tail or []),
            "process": os.getpid(),
            "archived": None,
        }
        tmp = os.path.join(d, f".{crash_id}.tmp")
        with open(tmp, "w") as f:
            json.dump(meta, f, indent=1, default=str)
        os.replace(tmp, os.path.join(d, f"{crash_id}.json"))
        return crash_id
    except Exception:
        log.exception("crash dump for %s failed", entity)
        return None


def scan_crashes(crash_dir: str) -> list[dict]:
    """Every parseable dump in the directory, oldest first."""
    out: list[dict] = []
    if not crash_dir or not os.path.isdir(crash_dir):
        return out
    for name in sorted(os.listdir(crash_dir)):
        if not name.endswith(".json"):
            continue
        try:
            with open(os.path.join(crash_dir, name)) as f:
                meta = json.load(f)
            if isinstance(meta, dict) and meta.get("crash_id"):
                out.append(meta)
        except (OSError, ValueError):
            continue
    out.sort(key=lambda m: m.get("timestamp", 0.0))
    return out


def archive_crash(crash_dir: str, crash_id: str | None = None) -> int:
    """Mark one dump (or, with ``crash_id=None``, every dump)
    acknowledged: archived dumps stay listable but stop counting
    toward RECENT_CRASH.  Returns how many dumps were newly archived."""
    n = 0
    for meta in scan_crashes(crash_dir):
        if crash_id is not None and meta["crash_id"] != crash_id:
            continue
        if meta.get("archived"):
            continue
        meta["archived"] = time.time()
        path = os.path.join(crash_dir, f"{meta['crash_id']}.json")
        tmp = path + ".tmp"
        try:
            with open(tmp, "w") as f:
                json.dump(meta, f, indent=1, default=str)
            os.replace(tmp, path)
            n += 1
        except OSError:
            continue
    return n

"""Transfer guard: the runtime check that steady-state launches move no
data between host and card but what they declare.

Counterpart of ``ceph_tpu/common/transfer_guard.py``, with the same API
(:func:`configure`, :func:`arm`, :func:`disarm`, :func:`active`,
:func:`no_implicit_transfers`, :func:`snapshot`, :func:`guard_counters`)
and counters (``BucketCounters("transfer_guard")``: ``guard_windows``,
``host_transfers``, ``host_exits``; the port declares no host exit
inside a window, so ``host_exits`` stays 0).  Every
steady-state launch the batchers dispatch — recovery decode, deep-scrub
crc and re-encode compare, the encode service's single-device group, the
mgr analytics digest — runs inside :func:`no_implicit_transfers`.

torch has no ``jax.transfer_guard``, so the port says what an implicit
transfer is.  Inside a window on device ``d``, each of these is one:

- an operand handed to a kernel wrapper that is not on ``d``
  (:func:`check_operands`, called by the wrappers' argument checks);
- on a card, a tensor op that copies between ``d`` and another device
  (``.to``, ``.cpu()``, ``copy_``) or forces a host sync from a tensor
  on ``d`` (``.item()``, ``bool()``, ``int()``), seen by a thread-local
  ``TorchDispatchMode`` over the window.

The launch's own upload and read-back are declared (:func:`upload`,
:func:`readback`, or a :func:`declared` block around a pinned-buffer
copy) and pass, as ``jax.device_put`` / ``device_get`` do in the
reference.  On the CPU the host is the launch's device, so only the
operand check applies there.

Where the reference answers a violation from its host path, the port
counts it in ``host_transfers`` and raises :class:`TransferGuardError`:
the launch fails and nothing answers in its place.

Arming: the guard judges only the steady state.  Daemons arm it after
their map-install warmup via :func:`configure` (``osd_transfer_guard``:
``auto`` arms there, ``on`` is armed from the start, ``off`` never;
``osd_transfer_guard_window`` delays it), which first primes the op
watch on their device (:func:`prime`).  Tests arm explicitly.
"""

from __future__ import annotations

import threading
import time
from contextlib import contextmanager

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ceph_tpu_torch.common.metrics import BucketCounters

#: "on" | "off" | "auto" — auto means "armed once arm() is called"
_DEFAULT_MODE = "auto"

_mode = _DEFAULT_MODE
_armed_at: float | None = None
_state = threading.local()
_counters: BucketCounters | None = None
#: the op watch's one-time set-up has been paid in this process (prime)
_primed = False


class TransferGuardError(RuntimeError):
    """An implicit host<->device transfer inside a guarded launch."""


def guard_counters() -> BucketCounters:
    """Process-wide transfer-guard perf collection (shape shared with
    the batchers' so chaos snapshots read one dict)."""
    global _counters
    if _counters is None:
        _counters = BucketCounters("transfer_guard")
    return _counters


def configure(mode: str | None = None,
              window_s: float | None = None, device=None) -> None:
    """Config wiring (osd_transfer_guard / osd_transfer_guard_window):
    sets the mode and — unless off — primes the op watch on ``device``
    (:func:`prime`) and arms after ``window_s``."""
    global _mode
    if mode is not None:
        _mode = mode
    if _mode != "off":
        if device is not None:
            prime(device)
        arm(window_s or 0.0)


def prime(device) -> None:
    """Pay the op watch's one-time cost now, off the steady state.  The
    first window a process opens on a card sets up PyTorch's Python
    dispatch mode, which takes seconds (6.9-9.4 s on an H100); unpaid,
    it lands on the first guarded decode, scrub or encode, which stalls
    that long while the cluster moves on.  Once a process; nothing to
    pay on the CPU, where windows install no watch."""
    global _primed
    dev = _as_device(device)
    if _primed or dev.type == "cpu":
        return
    with declared(), _Watch("prime", dev):
        torch.zeros(8, dtype=torch.uint8, device=dev).add_(1)
    _primed = True


def arm(delay_s: float = 0.0) -> None:
    """Engage the guard ``delay_s`` seconds from now (call after
    warmup: the steady state starts here)."""
    global _armed_at
    _armed_at = time.monotonic() + max(0.0, delay_s)


def disarm() -> None:
    global _armed_at, _mode
    _armed_at = None
    _mode = _DEFAULT_MODE


def active() -> bool:
    if _mode == "off":
        return False
    if _mode == "on":
        return True
    return _armed_at is not None and time.monotonic() >= _armed_at


def _window():
    """(kind, device) of this thread's innermost window, or None."""
    windows = getattr(_state, "windows", None)
    return windows[-1] if windows else None


def _declared_now() -> bool:
    return getattr(_state, "declared", 0) > 0


def _violation(kind: str, what: str):
    guard_counters().inc("host_transfers", k=kind)
    return TransferGuardError(
        f"implicit host<->device transfer in a guarded {kind} launch: {what}")


def check_operands(*tensors) -> None:
    """Kernel wrappers call this on their operands: inside a window,
    one that is not on the window's device is a counted violation and
    raises."""
    w = _window()
    if w is None or _declared_now():
        return
    kind, device = w
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.device != device:
            raise _violation(kind, f"operand on {t.device}, launch on {device}")


_COPIES = {"aten::_to_copy", "aten::copy_", "aten::_copy_from",
           "aten::_copy_from_and_resize"}


def _devices(args, kwargs):
    for a in (*args, *kwargs.values()):
        if isinstance(a, torch.Tensor):
            yield a.device
        elif isinstance(a, (list, tuple)):
            for x in a:
                if isinstance(x, torch.Tensor):
                    yield x.device


class _Watch(TorchDispatchMode):
    """The window's op watch on a card: copies across the window's
    device and host syncs from it, unless declared."""

    def __init__(self, kind: str, device: torch.device):
        super().__init__()
        self.kind = kind
        self.device = device

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if not _declared_now():
            name = func._schema.name
            if name == "aten::_local_scalar_dense":
                if args[0].device == self.device:
                    raise _violation(self.kind, f"host sync from {self.device}")
            elif name in _COPIES:
                devs = set(_devices(args, kwargs))
                dst = kwargs.get("device")
                if dst is not None:
                    devs.add(_as_device(dst))
                if self.device in devs and len(devs) > 1:
                    raise _violation(
                        self.kind, f"{name} between {sorted(map(str, devs))}")
        return func(*args, **kwargs)


def _as_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


@contextmanager
def no_implicit_transfers(kind: str, device):
    """Wrap ONE steady-state launch on ``device``: an implicit transfer
    inside the window is counted as ``host_transfers`` and raises
    :class:`TransferGuardError`.  No-op while the guard is disarmed."""
    if not active():
        yield
        return
    guard_counters().inc("guard_windows", k=kind)
    dev = _as_device(device)
    windows = getattr(_state, "windows", None)
    if windows is None:
        windows = _state.windows = []
    windows.append((kind, dev))
    try:
        if dev.type == "cpu":
            yield
        else:
            with _Watch(kind, dev):
                yield
    finally:
        windows.pop()


@contextmanager
def declared():
    """The launch's own upload or read-back (the twin of an explicit
    ``device_put`` / ``device_get``): copies inside pass the guard."""
    _state.declared = getattr(_state, "declared", 0) + 1
    try:
        yield
    finally:
        _state.declared -= 1


def upload(array: np.ndarray, device) -> torch.Tensor:
    """The declared host-to-device copy of a launch's input."""
    with declared():
        return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def readback(t: torch.Tensor) -> np.ndarray:
    """The declared device-to-host copy of a launch's result."""
    with declared():
        return t.cpu().numpy()


def snapshot() -> dict[str, int]:
    """{counter: value} for chaos snapshots (delta-checked)."""
    d = guard_counters().dump()
    return {
        "guard_windows": int(d.get("guard_windows", 0)),
        "host_transfers": int(d.get("host_transfers", 0)),
        "host_exits": 0,      # the port declares no host exit
    }

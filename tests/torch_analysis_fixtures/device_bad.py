# ctlint fixture: violates every device-discipline rule.  NEVER
# imported — parsed by tests/test_torch_static_analysis.py with a
# synthetic I/O-path module path.  The torch twin of
# tests/analysis_fixtures/device_bad.py, case for case.
import threading

import torch

from ceph_tpu_torch.ops import _build
from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul

_dispatch_lock = threading.Lock()


def rogue_kernel():
    # device-prewarm: a kernel library built and loaded (nvcc at first
    # use) with no prewarm registry entry
    return _build.library("rogue").ceph_rogue


def dispatch(bits, data):
    # device-raw-shape: raw len() straight into a shape-keyed wrapper
    out = gf_bitmatmul(bits, torch.zeros((1, 4, len(data)), dtype=torch.uint8,
                                         device="cuda"))
    with _dispatch_lock:
        # device-sync-under-lock: a wait for the card while the lock is held
        torch.cuda.synchronize()
    return out

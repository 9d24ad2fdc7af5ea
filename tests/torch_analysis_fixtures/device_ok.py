# ctlint fixture: the disciplined twin of device_bad.py — bucketed
# dims, no unregistered kernel loader, the wait outside the lock.
import threading

import torch

from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul
from ceph_tpu_torch.parallel.decode_batcher import pow2_bucket

_dispatch_lock = threading.Lock()


def dispatch(bits, data):
    w = pow2_bucket(len(data))
    out = gf_bitmatmul(bits, torch.zeros((1, 4, w), dtype=torch.uint8,
                                         device="cuda"))
    torch.cuda.synchronize()
    with _dispatch_lock:
        pass  # bookkeeping only under the lock
    return out

# ctlint fixture: violates every transfer rule.  NEVER imported —
# parsed by tests/test_torch_static_analysis.py with a synthetic
# I/O-path module path so device-host-sink is in scope.  The torch twin
# of tests/analysis_fixtures/transfer_bad.py, case for case.
import numpy as np
import torch

from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul


def launch(bits, batch):
    out = gf_bitmatmul(bits, torch.as_tensor(batch, device="cuda"))
    # device-host-sink: implicit host gather of the launch result
    host = np.asarray(out)
    # device-redundant-put: out never left the device
    again = out.to("cuda")
    # device-nondonated-inout: batch reassigned from its own launch
    # with no prewarm_registry.DONATED declaration
    batch = gf_bitmatmul(bits, batch)
    # device-implicit-sync: a device scalar steers control flow
    if out[0, 0, 0] > 0:
        host = host + 1
    return host, again, batch


def two_calls_away(bits, batch):
    # the interprocedural case: the sink lives in the helper below,
    # two frames from the launch
    return _persist(_relay(gf_bitmatmul(bits, torch.as_tensor(batch, device="cuda"))))


def _relay(result):
    return result


def _persist(result):
    return result.cpu()  # device-host-sink via the call graph

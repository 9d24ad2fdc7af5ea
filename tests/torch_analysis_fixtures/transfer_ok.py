# ctlint fixture: the clean twin of transfer_bad.py — declared
# transfers only, an in-place carry, no device-steered control flow.
# NEVER imported.
import torch

from ceph_tpu_torch.common import transfer_guard as tg
from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul, gf_bitmatmul_pallas_acc


def launch(bits, batch, carry, seed, device):
    # a declared upload in; the result STAYS device-resident
    out = gf_bitmatmul(bits, tg.upload(batch, device))
    # the in-place update is fine: position 2 (carry) is declared in
    # prewarm_registry.DONATED (the wrapper XORs into it and returns it)
    carry = gf_bitmatmul_pallas_acc(bits, out, carry, seed, tile_s=512)
    # predicates stay on device too
    flag = torch.any(carry)
    return carry, flag

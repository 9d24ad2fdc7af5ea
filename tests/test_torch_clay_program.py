"""The port's ``ClayRepairProgram`` against the JAX package's.

For every lost node of CLAY(4,2,5), (8,4,11), (8,3,10) and (4,5,8)
(q = 5: the kernel's larger Q), the port's program on the CPU (the plain
version of ``clay_repair.cu``'s schedule) and the reference's jitted
program (XLA on the CPU) rebuild the lost chunk from the same minimum-run
helper reads; both must equal the written chunk.  Then the numpy model of
the kernel on the schedule's host-built table (tests/test_torch_clay.py)
and the plain version equal the reference's program on random staged
helpers at an aligned and a ragged sub-chunk.  Tolerance 0.  One XLA
compile per program and sub-chunk, so this file holds only these cases.
"""

import gc

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ceph_tpu.ec import registry as ref_registry
from ceph_tpu.ec.plugins.clay_jit import ClayRepairProgram as RefProgram
from ceph_tpu_torch.ec import registry
from ceph_tpu_torch.ec.plugins import clay_cuda
from tests.test_torch_clay import kernel_model
from tests.xla_private import _private_xla_compiles  # noqa: F401

GEOMETRIES = [(4, 2, 5), (8, 4, 11), (8, 3, 10), (4, 5, 8)]
CASES = [(k, m, d, lost) for k, m, d in GEOMETRIES for lost in range(k + m)]
_CODED: dict = {}
_REF: dict = {}


@pytest.fixture(autouse=True, scope="module")
def _release_programs():
    """Drop the module's codes and reference programs when it ends, so
    their compiled executables (and memory mappings) go with them."""
    yield
    _REF.clear()
    _CODED.clear()
    gc.collect()
    jax.clear_caches()


def _coded(k, m, d):
    key = (k, m, d)
    if key not in _CODED:
        prof = {"k": str(k), "m": str(m), "d": str(d)}
        port = registry.factory("clay", dict(prof), device="cpu")
        ref = ref_registry.factory("clay", dict(prof))
        cs = port.get_chunk_size(k * 2048)
        data = np.random.default_rng(k + 10 * m).integers(0, 256, k * cs, dtype=np.uint8)
        _CODED[key] = (port, ref, cs, port.encode(set(range(k + m)), data))
    return _CODED[key]


def _ref_program(k, m, d, node, sc) -> RefProgram:
    """The reference's program of one lost node for one sub-chunk width,
    kept for the tests that share it (its trace caches the inner decode
    matrices as traced values, so a second width needs a program of its
    own)."""
    key = (k, m, d, node, sc)
    if key not in _REF:
        _REF[key] = RefProgram(_coded(k, m, d)[1], node)
    return _REF[key]


@pytest.mark.parametrize("k,m,d,lost", CASES)
def test_repair_program_equals_reference(k, m, d, lost):
    port, ref, cs, enc = _coded(k, m, d)
    sub = cs // port.sub_chunk_no
    minimum = port.minimum_to_decode({lost}, set(range(k + m)) - {lost})
    helpers = {c: np.concatenate([enc[c][o * sub:(o + n) * sub] for o, n in runs])
               for c, runs in minimum.items()}
    node = lost if lost < k else lost + port.nu
    prog = clay_cuda.ClayRepairProgram(port, node, device="cpu")
    got = prog.repair(helpers)
    assert np.array_equal(got, enc[lost])
    assert np.array_equal(got, _ref_program(k, m, d, node, sub).repair(helpers))
    H = prog.stage(helpers)
    assert H.device.type == "cpu" and tuple(H.shape) == (
        prog.schedule.n_helpers, prog.schedule.P, sub)
    assert torch.equal(prog.repair_device(H).reshape(-1), torch.from_numpy(enc[lost]))


@pytest.mark.parametrize("k,m,d,lost", CASES)
def test_kernel_model_equals_reference(k, m, d, lost):
    port, _ref, cs, _enc = _coded(k, m, d)
    node = lost if lost < k else lost + port.nu
    prog = clay_cuda.ClayRepairProgram(port, node, device="cpu")
    sched = prog.schedule
    rng = np.random.default_rng(1000 * k + lost)
    sub = cs // port.sub_chunk_no
    for sc in (sub, sub + 13):
        H = rng.integers(0, 256, (sched.n_helpers, sched.P, sc), dtype=np.uint8)
        H[prog.shortened] = 0
        want = np.asarray(_ref_program(k, m, d, node, sc).repair_device(jnp.asarray(H)))
        assert np.array_equal(kernel_model(H, sched), want), sc
        assert np.array_equal(clay_cuda.clay_repair_plain(torch.from_numpy(H), sched).numpy(),
                              want), sc
    # this node's programs have no later user: release them (each compiled
    # program holds memory mappings, see tests/xla_private.py)
    for sc in (sub, sub + 13):
        _REF.pop((k, m, d, node, sc), None)
    gc.collect()

"""Single-launch CLAY repair on the card.

Counterpart of ``ceph_tpu/ec/plugins/clay_jit.py``: the JAX package
traced the whole single-chunk repair (reference ErasureCodeClay.cc:462
repair_one_lost_chunk) into one jitted XLA program over device-resident
helper payloads.  Here the same traversal is a static schedule, built
once per (code, lost node) from the code's geometry and its inner
codecs' decode matrices, uploaded once and run by one launch of the
hand-written kernel ``ops/csrc/clay_repair.cu`` per repair.

The schedule has three stages, per repair plane p:

- **A** fills U for the K = k + nu survivors of the MDS decode: a copy
  of one helper sub-chunk, or a 2-term pair solve over the node's and
  its partner's coupled values (the (2,2) ``pft`` code's decode row);
- **B** is one MDS decode of the lost node's q-row over every plane;
- **C** recovers the lost chunk's coupled values: a copy of the lost
  node's U, or a 2-term solve over a q-row helper's C and its U.

The kernel runs them composed: the host folds the three stages of each
plane into one GF(2^8) combination per output (``RepairSchedule.coef``)
and expands each coefficient into the kernel's product tables
(:func:`product_tables`).

Operand order is the reference's: a pair's two coefficients are the
decode row over the survivors in sorted id order (``decode_matrix_for``'s
contract), which is the reference's swap of ``ins0`` and ``ins1`` where
``i0 > i1`` (clay_jit.py:124, 174).

Valid, as the reference's program is, for repairs with no aloof nodes
(d == k+m-1, the default CLAY deployment), and for byte-stream inner
codes (``reed_sol_van`` and ``cauchy``).

:func:`clay_repair` is the kernel's entry point: on a CUDA tensor it
launches the kernel or raises; on a CPU tensor it runs the plain
PyTorch version :func:`clay_repair_plain`, the same schedule with
GF(2^8) products by table lookup.  Its launches are counted
(:func:`launch_counts`).
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from ceph_tpu_torch.models.matrices import decode_matrix_for
from ceph_tpu_torch.ops.gf256 import gf_mul
from ceph_tpu_torch.ops.rs_kernels import _on_cpu, count_launch, resolve_device

#: the largest q the kernel takes (``kMaxQ`` in the source)
MAX_Q = 8
#: threads a block (``kThreads`` in the source)
THREADS = 128
#: columns per step of the plain version: bounds its int64 index tensors
_PLAIN_COLS = 1 << 16


@functools.lru_cache(maxsize=None)
def _pair_row(C_bytes: bytes, known: tuple[int, int], want: int) -> tuple[int, int]:
    """Coefficients of id ``want`` of the (2,2) pair code (coding matrix
    ``C_bytes``) over its ``known`` ids in sorted order."""
    C = np.frombuffer(C_bytes, dtype=np.uint8).reshape(2, 2)
    erased = sorted(set(range(4)) - set(known))
    D = decode_matrix_for(C, erased)
    row = D[erased.index(want)]
    return int(row[0]), int(row[1])


def _ordered(row: tuple[int, int], first: int, second: int) -> tuple[int, int]:
    """The decode row's coefficients for the operands (id ``first``, id
    ``second``), given the row over the sorted ids."""
    return row if first < second else (row[1], row[0])


class RepairSchedule:
    """The static schedule of one (CLAY geometry, lost node) repair.

    Stage A, per plane p and survivor j: ``a_h`` (helper row at plane p),
    ``b_h``/``b_p`` (partner helper row and plane), ``a_c``/``b_c``
    (coefficients; ``b_c`` 0 for a copy).  Stage B: ``d`` (Q, K), the
    inner MDS decode of the erased q-row from the survivors.  Stage C,
    per plane and erased node e: ``out_z`` (output sub-chunk), ``e_h``
    (helper row of e), ``c_h``/``c_u`` (coefficients of H[e_h, p] and of
    V[e]).  ``S``, ``inputs``, ``coef`` and ``table``: the stages
    composed, the kernel's form (:meth:`_compose`)."""

    def __init__(self, ec, lost_node: int):
        if ec.d != ec.k + ec.m - 1:
            raise ValueError("the single-launch repair needs d == k+m-1 "
                             "(no aloof nodes)")
        for name, inner in (("mds", ec.mds), ("pft", ec.pft)):
            if getattr(inner, "rows_per_chunk", None) != 1:
                raise ValueError(f"the single-launch repair needs a byte-stream "
                                 f"inner {name} code, not {type(inner).__name__}")
        q, t = ec.q, ec.t
        self.sub_chunk_no = ec.sub_chunk_no
        runs = ec.get_repair_subchunks(lost_node)
        self.zs = [z for index, count in runs for z in range(index, index + count)]
        pind = {z: i for i, z in enumerate(self.zs)}
        # the lost node's q-row is erased for the MDS decode; its other
        # members are still helpers (their C feeds stage C)
        erased = [lost_node - lost_node % q + i for i in range(q)]
        self.helper_nodes = [n for n in range(q * t) if n != lost_node]
        hidx = {n: i for i, n in enumerate(self.helper_nodes)}
        survivors = [n for n in range(q * t) if n not in erased]
        assert len(survivors) == ec.k + ec.nu, (survivors, ec.k, ec.nu)
        P, K, Q = len(self.zs), len(survivors), q
        self.P, self.K, self.Q = P, K, Q
        self.n_helpers = len(self.helper_nodes)
        pft_C = np.ascontiguousarray(ec.pft.coding_matrix, dtype=np.uint8).tobytes()

        self.a_h = np.zeros((P, K), np.int64)
        self.b_h = np.zeros((P, K), np.int64)
        self.b_p = np.zeros((P, K), np.int64)
        self.a_c = np.zeros((P, K), np.uint8)
        self.b_c = np.zeros((P, K), np.uint8)
        self.out_z = np.zeros((P, Q), np.int64)
        self.e_h = np.zeros((Q,), np.int64)
        self.c_h = np.zeros((P, Q), np.uint8)
        self.c_u = np.zeros((P, Q), np.uint8)
        for p, z in enumerate(self.zs):
            z_vec = ec._plane_vector(z)
            for j, node in enumerate(survivors):
                x, y = node % q, node // q
                _, node_sw, z_sw, (i0, i1, i2, _i3) = ec._pair_indices(x, y, z_vec, z)
                self.a_h[p, j] = hidx[node]
                if z_vec[y] == x:
                    self.a_c[p, j] = 1
                    continue
                ca, cb = _ordered(_pair_row(pft_C, (i0, i1), i2), i0, i1)
                self.a_c[p, j], self.b_c[p, j] = ca, cb
                self.b_h[p, j], self.b_p[p, j] = hidx[node_sw], pind[z_sw]
            for e_i, node in enumerate(erased):
                x, y = node % q, node // q
                _, _sw, z_sw, (i0, i1, i2, _i3) = ec._pair_indices(x, y, z_vec, z)
                if x == z_vec[y]:
                    # within repair planes only the lost node is dotted
                    assert node == lost_node, (node, lost_node)
                    self.out_z[p, e_i], self.c_u[p, e_i] = z, 1
                    continue
                self.e_h[e_i] = hidx[node]
                ch, cu = _ordered(_pair_row(pft_C, (i0, i2), i1), i0, i2)
                self.out_z[p, e_i], self.c_h[p, e_i], self.c_u[p, e_i] = z_sw, ch, cu
        # decode_matrix_for multiplies the first K surviving ids in order
        self.d = decode_matrix_for(np.asarray(ec.mds.coding_matrix, np.uint8), erased)
        assert self.d.shape == (Q, K)
        assert sorted(self.out_z.reshape(-1).tolist()) == list(range(self.sub_chunk_no))

        self._compose()
        self._tensors: dict[tuple[str, str], torch.Tensor] = {}

    def _compose(self) -> None:
        """The kernel's form: the three stages composed, per plane, into
        one GF(2^8) combination for each output e of the plane's shared
        inputs (the a- and b-operands of stage A, through stages B and C)
        and one private input (H[e_h, p] through stage C), with the
        product tables of each coefficient (see ``clay_repair.cu``).

        ``inputs`` (P, S + Q) int32: sub-chunk (row * P + plane) of each
        input, -1 for an absent private one; ``coef`` (P, S + 1, Q)
        uint8: the coefficient of input i (private row: S) in output e;
        ``table`` (P, 5Q(S + 1) + S + 2Q) int32: per plane the
        (S + 1) x Q product tables as 4 + 1 words (``product_tables``),
        then ``inputs``, then ``out_z``."""
        P, K, Q = self.P, self.K, self.Q
        shared = []
        for p in range(P):
            terms: dict[int, np.ndarray] = {}
            cu_d = gf_mul(self.c_u[p][:, None], self.d)                   # (Q, K)
            for j in range(K):
                for row, plane, c in ((self.a_h[p, j], p, self.a_c[p, j]),
                                      (self.b_h[p, j], self.b_p[p, j], self.b_c[p, j])):
                    if c:
                        key = int(row) * P + int(plane)
                        terms[key] = terms.get(key, np.zeros(Q, np.uint8)) ^ gf_mul(c, cu_d[:, j])
            shared.append(terms)
        S = max(len(t) for t in shared)
        self.S = S
        self.inputs = np.full((P, S + Q), -1, np.int32)
        self.coef = np.zeros((P, S + 1, Q), np.uint8)
        for p, terms in enumerate(shared):
            for e in range(Q):
                key = int(self.e_h[e]) * P + p
                if not self.c_h[p, e]:
                    continue
                if key in terms:  # never in a CLAY schedule: merged all the same
                    terms[key] = terms[key].copy()
                    terms[key][e] ^= self.c_h[p, e]
                else:
                    self.inputs[p, S + e] = key
                    self.coef[p, S, e] = self.c_h[p, e]
            for i, (key, c) in enumerate(sorted(terms.items())):
                self.inputs[p, i] = key
                self.coef[p, i] = c
            # padding inputs read sub-chunk 0 with zero coefficients
            self.inputs[p, len(terms):S] = 0
        tabs = product_tables(self.coef)                                   # (P, S+1, Q, 5)
        self.table = np.ascontiguousarray(np.concatenate([
            tabs[..., :4].reshape(P, -1), tabs[..., 4].reshape(P, -1),
            self.inputs, self.out_z.astype(np.int32)], axis=1).astype(np.int32))

    def on(self, device, name: str) -> torch.Tensor:
        """The schedule's array ``name`` on ``device``, uploaded once."""
        key = (str(torch.device(device)), name)
        t = self._tensors.get(key)
        if t is None:
            t = self._tensors[key] = torch.from_numpy(
                np.ascontiguousarray(getattr(self, name))).to(device)
        return t


def product_tables(coef: np.ndarray) -> np.ndarray:
    """(..., ) uint8 coefficients -> (..., 5) int32: the kernel's PRMT
    tables of each, T0[v] = c v and T1[v] = c (v << 3) for v < 8 as two
    words each (byte v of the pair), T2[v] = c (v << 6) for v < 4 as one
    word."""
    c = np.asarray(coef, np.uint8)[..., None]
    v = np.arange(8, dtype=np.uint8)
    t0, t1 = gf_mul(c, v), gf_mul(c, v << 3)
    t2 = gf_mul(c, (v[:4] << 6).astype(np.uint8))
    words = np.concatenate([t0, t1, t2], axis=-1)                     # (..., 20)
    return np.ascontiguousarray(words).view("<u4").view(np.int32)


# ---------------------------------------------------------------------------
# Plain PyTorch version (the CPU path and the card's yardstick)
# ---------------------------------------------------------------------------

_mul_tables: dict[str, torch.Tensor] = {}


def _mul_table(device) -> torch.Tensor:
    """GF(2^8) products as a flat (65536,) uint8 tensor, c * 256 + x."""
    key = str(torch.device(device))
    t = _mul_tables.get(key)
    if t is None:
        a = np.arange(256, dtype=np.uint8)
        t = _mul_tables[key] = torch.from_numpy(
            gf_mul(a[:, None], a[None, :]).reshape(-1).copy()).to(device)
    return t


def _mul(table: torch.Tensor, c: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return table[(c.to(torch.int64) << 8) | x.to(torch.int64)]


def clay_repair_plain(H: torch.Tensor, sched: RepairSchedule) -> torch.Tensor:
    """The schedule on torch tensors: (n_helpers, P, sc) uint8 ->
    (sub_chunk_no, sc) uint8, products by table lookup."""
    a_h, b_h, b_p, a_c, b_c, d, out_z, e_h, c_h, c_u = (
        sched.on(H.device, name) for name in
        ("a_h", "b_h", "b_p", "a_c", "b_c", "d", "out_z", "e_h", "c_h", "c_u"))
    table = _mul_table(H.device)
    P, Q, sc = sched.P, sched.Q, H.shape[-1]
    planes = torch.arange(P, device=H.device)[:, None]
    out = torch.empty((sched.sub_chunk_no, sc), dtype=torch.uint8, device=H.device)
    rows = out_z.reshape(-1)
    for c0 in range(0, sc, _PLAIN_COLS):
        h = H[..., c0:c0 + _PLAIN_COLS]
        U = (_mul(table, a_c[..., None], h[a_h, planes])
             ^ _mul(table, b_c[..., None], h[b_h, b_p]))                  # (P, K, w)
        V = torch.zeros((P, Q, h.shape[-1]), dtype=torch.uint8, device=H.device)
        for j in range(sched.K):
            V ^= _mul(table, d[None, :, j, None], U[:, j, None, :])
        R = (_mul(table, c_h[..., None], h[e_h[None, :], planes])
             ^ _mul(table, c_u[..., None], V))                             # (P, Q, w)
        out[rows, c0:c0 + _PLAIN_COLS] = R.reshape(P * Q, -1)
    return out


# ---------------------------------------------------------------------------
# The CUDA kernel
# ---------------------------------------------------------------------------

_fn = None


def _kernel():
    """ctypes handle of ``ceph_clay_repair``, built on first use."""
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.library("clay_repair").ceph_clay_repair
        fn.restype = ctypes.c_int
        fn.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,   # H, out, table
            ctypes.c_int, ctypes.c_int, ctypes.c_int,            # P, S, Q
            ctypes.c_longlong, ctypes.c_int,                     # sc, aligned
            ctypes.c_void_p,                                     # stream
        ]
        _fn = fn
    return _fn


def _check(H: torch.Tensor, sched: RepairSchedule) -> int:
    if not isinstance(H, torch.Tensor) or H.dtype != torch.uint8:
        raise TypeError("H must be a uint8 torch.Tensor")
    if H.dim() != 3 or tuple(H.shape[:2]) != (sched.n_helpers, sched.P):
        raise ValueError(f"H must be ({sched.n_helpers}, {sched.P}, sc), "
                         f"got {tuple(H.shape)}")
    return H.shape[2]


def clay_repair(H: torch.Tensor, sched: RepairSchedule) -> torch.Tensor:
    """The lost chunk, (sub_chunk_no, sc) uint8, from the staged helper
    sub-chunks H (n_helpers, P, sc).  On the card: one launch of
    ``clay_repair.cu`` (replaces the jitted XLA ``ClayRepairProgram._run``
    of ceph_tpu/ec/plugins/clay_jit.py:69); a refused launch raises.
    A thread takes two words (8 columns) where the cells are aligned,
    one where they are not (byte loads)."""
    sc = _check(H, sched)
    if _on_cpu(H):
        return clay_repair_plain(H, sched)
    if sched.Q > MAX_Q:
        raise ValueError(f"q={sched.Q}: the kernel takes q <= {MAX_Q}")
    if not H.is_contiguous():
        raise ValueError("H must be contiguous")
    out = torch.empty((sched.sub_chunk_no, sc), dtype=torch.uint8, device=H.device)
    if sc == 0:
        return out
    index = H.get_device()
    table = sched.on(H.device, "table")
    aligned = sc % 4 == 0 and H.data_ptr() % 4 == 0 and out.data_ptr() % 4 == 0
    args = (H.data_ptr(), out.data_ptr(), table.data_ptr(), sched.P, sched.S, sched.Q,
            sc, int(aligned))
    with torch.cuda.device(index):
        err = _kernel()(*args, torch._C._cuda_getCurrentRawStream(index))
    if err != 0:
        raise RuntimeError(f"clay_repair kernel launch failed: cudaError {err} "
                           f"(P={sched.P}, S={sched.S}, Q={sched.Q}, sc={sc}, "
                           f"aligned={aligned})")
    count_launch(clay_repair)
    return out


KERNEL_ENTRY_POINTS = (clay_repair,)


def reset_launch_counts() -> None:
    for fn in KERNEL_ENTRY_POINTS:
        fn.launches = 0


def launch_counts() -> dict[str, int]:
    """Kernel launches per entry point since the last reset."""
    return {fn.__name__: fn.launches for fn in KERNEL_ENTRY_POINTS}


reset_launch_counts()


# ---------------------------------------------------------------------------
# The program
# ---------------------------------------------------------------------------

def chunk_node(ec, chunk: int) -> int:
    """The CLAY node of chunk id ``chunk``: parity chunks sit after the
    nu shortened nodes."""
    return chunk if chunk < ec.k else chunk + ec.nu


class ClayRepairProgram:
    """The repair of one lost node for one CLAY geometry, on one device.

    ``helpers``: dict chunk id -> (P * sc,) uint8 payloads (the
    ``minimum_to_decode`` runs, concatenated, one stripe).  ``repair``
    returns the full (sub_chunk_no * sc,) chunk.  The schedule is built
    and uploaded once; every call is one launch on the card."""

    def __init__(self, ec, lost_node: int, *, device=None):
        self.device = resolve_device(device)
        self.ec = ec
        self.lost = lost_node
        self.schedule = RepairSchedule(ec, lost_node)
        self.zs = self.schedule.zs
        self.helper_nodes = self.schedule.helper_nodes
        #: rows of H that are shortened nodes: zeros
        self.shortened = [i for i, n in enumerate(self.helper_nodes)
                          if ec.k <= n < ec.k + ec.nu]
        self.schedule.on(self.device, "table")

    def repair(self, helpers: dict[int, np.ndarray]) -> np.ndarray:
        """helpers keyed by CHUNK id (as minimum_to_decode returns);
        payload = concatenated repair runs of one stripe."""
        return self.repair_device(self.stage(helpers)).cpu().numpy().reshape(-1)

    def repair_device(self, H: torch.Tensor) -> torch.Tensor:
        """H: the (n_helpers, P, sc) staged helpers on a device (see
        :meth:`stage`); returns the (sub_chunk_no, sc) chunk there."""
        return clay_repair(H, self.schedule)

    def stage(self, helpers: dict[int, np.ndarray]) -> torch.Tensor:
        """Upload helper payloads once, as (n_helpers, P, sc), the
        shortened nodes as zero rows; reuse across repair_device calls."""
        n_planes = len(self.zs)
        first = next(iter(helpers.values()))
        sc = len(first) // n_planes
        H = np.zeros((len(self.helper_nodes), n_planes, sc), np.uint8)
        for i, n in enumerate(self.helper_nodes):
            if i not in self.shortened:
                cid = n if n < self.ec.k else n - self.ec.nu
                H[i] = np.asarray(helpers[cid], np.uint8).reshape(n_planes, sc)
        return torch.from_numpy(H).to(self.device)

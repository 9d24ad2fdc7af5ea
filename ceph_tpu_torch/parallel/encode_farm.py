"""Erasure-encode farms over a mesh of devices in one process.

Counterpart of ``ceph_tpu/parallel/encode_farm.py``, which runs its two
strategies as ``shard_map`` programs over a ``jax.sharding.Mesh`` of the
process's local devices.  Here :class:`Mesh` is a grid of
``torch.device``s with named axes ('pg', 'shard'); a device may repeat,
so a (2, 2) mesh of ``cuda:0`` runs every path on one card and a (4, 2)
mesh of ``cpu`` runs them in the tests.  There is no
``torch.distributed``: that needs one process per rank, and the encode
service runs in one asyncio process, as the reference's does.

- **Data parallel over stripes** (:func:`batch_encode_dp`): a (B, k, S)
  stripe batch is split into equal slices over the ranks of ``axis``;
  each slice goes to its rank's device through the batched bit-matrix
  kernel (``rs_kernels.gf_bitmatmul``, store mode) and the results are
  gathered on the first rank's device as (B, m, S).
- **Chunk-sharded encode** (:func:`sharded_encode_tp`): rank r of
  ``axis`` (n ranks) takes data rows [r k/n, (r+1) k/n) and the matching
  columns of the bit-matrix, ``bitmat[:, 8 r k/n : 8 (r+1) k/n]``, and
  computes its partial with the store kernel, which gives it already
  reduced mod 2 and packed.  :func:`ceph_tpu_torch.ops.rs_kernels.gf_fold`
  XORs the n packed partials on the first rank's device.  The
  reference psums the int32 partials and then takes ``& 1``; the bytes
  are the same because (sum a_i) mod 2 = XOR (a_i mod 2), and within one
  process the fold moves 1/32 of the int32 partials' bytes.

The reference's input shardings (``dp_batch_sharding``,
``tp_data_sharding``, ``replicated_sharding``) have no counterpart: each
rank's slice is moved to its device inside the functions.
"""

from __future__ import annotations

import weakref

import numpy as np
import torch

from ceph_tpu_torch.ops.rs_kernels import gf_bitmatmul, gf_fold


def _indexed(dev: torch.device) -> torch.device:
    """``cuda`` as the index its tensors report (``cuda:0``), so devices
    compare equal to a tensor's."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


class Mesh:
    """A grid of devices with named axes: ``devices`` is an array of
    ``torch.device`` of the grid's shape, ``shape`` maps each axis name to
    its size (``{"pg": 4, "shard": 2}``)."""

    def __init__(self, devices, axis_names):
        grid = np.asarray(devices, dtype=object)
        names = (axis_names,) if isinstance(axis_names, str) else tuple(axis_names)
        if grid.ndim != len(names):
            raise ValueError(f"a {grid.ndim}-D device grid needs {grid.ndim} axis names, "
                             f"got {names}")
        self.devices = np.empty(grid.shape, dtype=object)
        for at, dev in np.ndenumerate(grid):
            self.devices[at] = _indexed(torch.device(dev))
        self.axis_names = names
        self.shape = dict(zip(names, grid.shape))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    def ranks(self, axis) -> list[torch.device]:
        """The devices along ``axis`` (a name or a tuple of names, the
        first varying slowest), every other axis at index 0: one device a
        shard of an operand sharded over ``axis`` and replicated over the
        rest."""
        names = (axis,) if isinstance(axis, str) else tuple(axis)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"mesh has no axis {a!r} (axes {self.axis_names})")
        grid = np.moveaxis(self.devices, [self.axis_names.index(a) for a in names],
                           list(range(len(names))))
        sub = grid[(slice(None),) * len(names) + (0,) * (grid.ndim - len(names))]
        return list(sub.reshape(-1))


#: (id of a bit-matrix, what, device) -> (weak reference to it, its
#: _version, the derived tensor): its copies on other devices and its
#: column blocks, made once while it lives
_derived: dict[tuple, tuple] = {}


def _derive(bitmat: torch.Tensor, what: tuple, device: torch.device, make) -> torch.Tensor:
    key = (id(bitmat), what, str(device))
    hit = _derived.get(key)
    if hit is not None and hit[0]() is bitmat and hit[1] == bitmat._version:
        return hit[2]
    t = make().to(device).contiguous()

    def drop(ref, key=key):
        if _derived.get(key, (None,))[0] is ref:
            del _derived[key]

    _derived[key] = (weakref.ref(bitmat, drop), bitmat._version, t)
    return t


def _replica(bitmat: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``bitmat`` on ``device`` (itself where it lies there)."""
    if bitmat.device == device:
        return bitmat
    return _derive(bitmat, ("replica",), device, lambda: bitmat)


def _columns(bitmat: torch.Tensor, r: int, n: int, device: torch.device) -> torch.Tensor:
    """Rank r's columns of n, ``bitmat[:, 8 r k/n : 8 (r+1) k/n]``, on
    ``device``."""
    w = bitmat.shape[1] // n
    return _derive(bitmat, ("columns", r, n), device, lambda: bitmat[:, r * w:(r + 1) * w])


def batch_encode_dp(mesh: Mesh, bitmat: torch.Tensor, batch: torch.Tensor,
                    axis="pg") -> torch.Tensor:
    """Encode a (B, k, S) stripe batch split over the ranks of ``axis``;
    returns (B, m, S) parity on the first rank's device.  B must divide
    evenly over the ranks."""
    ranks = mesh.ranks(axis)
    n = len(ranks)
    B, k, S = batch.shape
    if B % n:
        raise ValueError(f"batch {B} does not split over {n} ranks of {axis!r}")
    b = B // n
    m = bitmat.shape[0] // 8
    home = ranks[0]
    out = torch.empty((B, m, S), dtype=torch.uint8, device=home)
    for r, dev in enumerate(ranks):
        local = batch[r * b:(r + 1) * b].to(dev)
        bits = _replica(bitmat, dev)
        if dev == home:
            gf_bitmatmul(bits, local, out=out[r * b:(r + 1) * b])
        else:
            out[r * b:(r + 1) * b].copy_(gf_bitmatmul(bits, local))
    return out


def sharded_encode_tp(mesh: Mesh, bitmat: torch.Tensor, data: torch.Tensor,
                      axis: str = "shard") -> torch.Tensor:
    """Encode (k, S) data whose rows are split over the ranks of ``axis``:
    each rank's packed partial from its rows and its columns of the
    bit-matrix, then their XOR (one ``gf_fold``).  Returns (m, S) parity
    on the first rank's device."""
    ranks = mesh.ranks(axis)
    n = len(ranks)
    k, S = data.shape
    if k % n:
        raise ValueError(f"k = {k} data rows do not split over {n} ranks of {axis!r}")
    kk = k // n
    m = bitmat.shape[0] // 8
    home = ranks[0]
    partials = torch.empty((n, m, S), dtype=torch.uint8, device=home)
    for r, dev in enumerate(ranks):
        local = data[r * kk:(r + 1) * kk].to(dev)
        cols = _columns(bitmat, r, n, dev)
        if dev == home:
            gf_bitmatmul(cols, local, out=partials[r])
        else:
            partials[r].copy_(gf_bitmatmul(cols, local))
    return gf_fold(partials)

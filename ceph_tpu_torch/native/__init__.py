"""Native C++ host helpers, loaded via ctypes: crc32c, the region XOR
and the scalar CRUSH straw2 choose.

The reference keeps its data-plane utilities native (crc32c:
src/common/crc32c.cc + sctp_crc32.c; region XOR:
src/erasure-code/isa/xor_op.cc).  The port does the same: a small
C++ library compiled on first use with g++ (no pip deps) into this
directory, rebuilt when a source is newer than the library.  A
pure-Python table loop computes the same crc values, and numpy the same
XOR, where no toolchain is present (the crc loop is slow: a few MB/s).  ``crush_hash.cc`` holds the
rjenkins1 hashes and a whole straw2 bucket choose for the scalar CRUSH
interpreter (``crush/mapper.py``); the crush_ln tables are injected
from ``crush/_ln_tables.py`` at load.

Public API:
  crc32c(data, seed=-1)          -- reference ceph_crc32c semantics
  crc32c_zeros(length, seed=-1)  -- crc32c of ``length`` zero bytes
  xor_region(dst, src)           -- dst ^= src in place (uint8 arrays)
  straw2_lib()                   -- the library for the scalar mapper, or None
  available()                    -- True when the .so is loaded
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import threading

import numpy as np

_HERE = os.path.dirname(os.path.abspath(__file__))
_SO = os.path.join(_HERE, "_libceph_tpu_torch_native.so")
_SRCS = ["crc32c.cc", "crush_hash.cc"]

_lib = None
_lock = threading.Lock()
_build_failed = False


def _load():
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        srcs = [os.path.join(_HERE, s) for s in _SRCS]
        try:
            if not os.path.exists(_SO) or any(
                os.path.getmtime(s) > os.path.getmtime(_SO) for s in srcs
            ):
                tmp = _SO + f".tmp.{os.getpid()}"
                subprocess.run(
                    ["g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-o", tmp]
                    + srcs,
                    check=True,
                    capture_output=True,
                )
                os.replace(tmp, _SO)
            lib = ctypes.CDLL(_SO)
        except (OSError, subprocess.CalledProcessError):
            _build_failed = True
            return None
        lib.ceph_tpu_torch_crc32c.restype = ctypes.c_uint32
        lib.ceph_tpu_torch_crc32c.argtypes = [
            ctypes.c_uint32, ctypes.c_void_p, ctypes.c_size_t,
        ]
        lib.ceph_tpu_torch_xor_region.restype = None
        lib.ceph_tpu_torch_xor_region.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_size_t,
        ]
        u32 = ctypes.c_uint32
        lib.ceph_tpu_torch_straw2_choose.restype = ctypes.c_int32
        lib.ceph_tpu_torch_straw2_choose.argtypes = [
            u32, u32, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int32,
        ]
        lib.ceph_tpu_torch_set_ln_tables.restype = None
        lib.ceph_tpu_torch_set_ln_tables.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p,
        ]
        # the crush_ln tables: one table of truth, the generated module
        from ceph_tpu_torch.crush._ln_tables import LL_TBL, RH_LH_TBL

        rh = np.ascontiguousarray(RH_LH_TBL, dtype=np.int64)
        ll = np.ascontiguousarray(LL_TBL, dtype=np.int64)
        assert rh.size == 258 and ll.size == 256
        lib.ceph_tpu_torch_set_ln_tables(rh.ctypes.data, ll.ctypes.data)
        _lib = lib
    return _lib


def available() -> bool:
    return _load() is not None


# -- pure-python table loop -------------------------------------------------

_PY_TABLE: np.ndarray | None = None


def _py_table() -> np.ndarray:
    global _PY_TABLE
    if _PY_TABLE is None:
        t = np.zeros(256, dtype=np.uint32)
        for i in range(256):
            c = i
            for _ in range(8):
                c = (0x82F63B78 ^ (c >> 1)) if (c & 1) else (c >> 1)
            t[i] = c
        _PY_TABLE = t
    return _PY_TABLE


def _py_crc32c(data: bytes, seed: int) -> int:
    t = _py_table()
    crc = seed & 0xFFFFFFFF
    for b in data:
        crc = int(t[(crc ^ b) & 0xFF]) ^ (crc >> 8)
    return crc


# -- public API -------------------------------------------------------------

def crc32c(data, seed: int = 0xFFFFFFFF) -> int:
    """Reference ceph_crc32c(seed, data, len): reflected CRC32C table
    update, no init/final inversion (sctp_crc32.c:update_crc32)."""
    arr = np.ascontiguousarray(
        np.frombuffer(data, dtype=np.uint8)
        if isinstance(data, (bytes, bytearray, memoryview))
        else np.asarray(data, dtype=np.uint8).reshape(-1)
    )
    lib = _load()
    if lib is not None:
        return lib.ceph_tpu_torch_crc32c(
            seed & 0xFFFFFFFF, arr.ctypes.data, arr.nbytes
        )
    return _py_crc32c(arr.tobytes(), seed)


def crc32c_zeros(length: int, seed: int = 0xFFFFFFFF) -> int:
    """crc32c of ``length`` zero bytes (reference ceph_crc32c with a null
    buffer, crc32c.cc:39): the register advanced through the zeros."""
    lib = _load()
    if lib is not None:
        return lib.ceph_tpu_torch_crc32c(seed & 0xFFFFFFFF, None, length)
    t = _py_table()
    crc = seed & 0xFFFFFFFF
    for _ in range(length):
        if crc == 0:
            break
        crc = int(t[crc & 0xFF]) ^ (crc >> 8)
    return crc


def straw2_lib():
    """The loaded library if its straw2 choose is usable (ln tables
    injected), else None.  The scalar mapper binds the per-bucket call
    itself to keep its hot path free of indirection."""
    lib = _load()
    if lib is not None and lib.ceph_tpu_torch_ln_tables_ready():
        return lib
    return None


def xor_region(dst: np.ndarray, src: np.ndarray) -> None:
    """dst ^= src in place (both uint8, same length).  ``dst`` must be
    C-contiguous: a strided view would XOR into a copy."""
    assert dst.dtype == np.uint8 and src.dtype == np.uint8
    assert dst.flags.c_contiguous, "xor_region dst must be contiguous"
    assert dst.nbytes == src.nbytes
    lib = _load()
    if lib is not None:
        src = np.ascontiguousarray(src)
        lib.ceph_tpu_torch_xor_region(
            dst.ctypes.data, src.ctypes.data, dst.nbytes)
    else:
        np.bitwise_xor(dst, src, out=dst)

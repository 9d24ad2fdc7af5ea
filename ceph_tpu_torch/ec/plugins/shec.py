"""SHEC (shingled erasure code) plugin.

Counterpart of the JAX package's ``shec`` plugin (ceph_tpu/ec/plugins/
shec.py), with the same profile keys, search and chunk bytes.
Behavioral twin of the reference SHEC plugin
(src/erasure-code/shec/ErasureCodeShec.{h,cc},
ErasureCodePluginShec.cc): a non-MDS (k, m, c) code whose parity rows
cover overlapping "shingles" of the data chunks so that recovering one
lost chunk reads fewer than k helpers.  Profile keys and validation
ranges match the reference parse (ErasureCodeShec.cc:280-378): k/m/c
all-or-none with defaults (4, 3, 2), c <= m <= k, k <= 12, k+m <= 20;
``technique`` is ``multiple`` (default; split shingle groups chosen by
the recovery-efficiency metric) or ``single``.

Decode is the reference's exhaustive minimal-decoding-set search
(shec_make_decoding_matrix, ErasureCodeShec.cc:535-758): over all 2^m
parity subsets, find the smallest square submatrix over the erased+
covered columns that is invertible in GF(2^8), preferring fewer parity
rows; the resulting tables are LRU-cached per (want, avails) signature
like ErasureCodeShecTableCache.  Encode is the shared GF(2^8) matmul
path with the shingled matrix, and so are decode's two products (the
inverse over the selected rows, then the wanted parities re-encoded):
payloads of at least ``device_min_bytes`` run on the plugin's device
(the card unless the factory is given another), smaller ones on the
host.

w=16/32 (GF(2^16)/GF(2^32) symbol widths) are parsed like the reference
but not yet computed; they raise EINVAL at prepare time.
"""

from __future__ import annotations

import collections
import errno

import numpy as np

from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.plugins.matrix_base import MatrixErasureCode
from ceph_tpu_torch.models.matrices import shec_coding_matrix
from ceph_tpu_torch.ops.gf256 import gf_mat_inv

__erasure_code_version__ = "0.1.0"

MULTIPLE = 0
SINGLE = 1

#: decode-table LRU capacity (ErasureCodeShecTableCache semantics)
TABLE_CACHE_SIZE = 256


class ErasureCodeShec(MatrixErasureCode):
    # shingled local parities: not every k-subset decodes
    mds_any_k = False

    """Reed-Solomon-Vandermonde shingled code (the reference's only
    SHEC family, ErasureCodeShecReedSolomonVandermonde)."""

    DEFAULT_K = 4
    DEFAULT_M = 3
    DEFAULT_C = 2
    DEFAULT_W = 8

    def __init__(self, technique: int = MULTIPLE, *, device=None) -> None:
        super().__init__(device=device)
        self.technique = technique
        self.c = 0
        self._table_cache: collections.OrderedDict = collections.OrderedDict()

    # -- profile (ErasureCodeShec.cc:280-378) -------------------------------

    def parse(self, profile: dict) -> None:
        super().parse(profile)
        has = [key for key in ("k", "m", "c") if profile.get(key, "") != ""]
        if not has:
            self.k, self.m, self.c = self.DEFAULT_K, self.DEFAULT_M, self.DEFAULT_C
        elif len(has) != 3:
            raise ECError(errno.EINVAL, "(k, m, c) must all be chosen or none")
        else:
            self.k = self.to_int("k", profile, str(self.DEFAULT_K))
            self.m = self.to_int("m", profile, str(self.DEFAULT_M))
            self.c = self.to_int("c", profile, str(self.DEFAULT_C))
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise ECError(errno.EINVAL, f"(k, m, c)=({k}, {m}, {c}) must be positive")
        if m < c:
            raise ECError(errno.EINVAL, f"c={c} must be <= m={m}")
        if k > 12:
            raise ECError(errno.EINVAL, f"k={k} must be <= 12")
        if k + m > 20:
            raise ECError(errno.EINVAL, f"k+m={k + m} must be <= 20")
        if k < m:
            raise ECError(errno.EINVAL, f"m={m} must be <= k={k}")
        # invalid w values fall back to the default with a warning, they
        # are not an error (ErasureCodeShec.cc:354-372)
        try:
            w = int(str(profile.get("w", "") or self.DEFAULT_W), 0)
        except ValueError:
            w = self.DEFAULT_W
        if w not in (8, 16, 32):
            w = self.DEFAULT_W
        self.w = w
        if w != 8:
            raise ECError(
                errno.EINVAL,
                f"w={w} (GF(2^{w}) symbols) is not yet available here",
            )
        self.prepare(shec_coding_matrix(k, m, c, single=self.technique == SINGLE))
        self._table_cache.clear()

    # -- geometry (ErasureCodeShec.cc:60-68) --------------------------------

    def get_alignment(self) -> int:
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    # -- minimal decoding set search (ErasureCodeShec.cc:535-758) -----------

    def _make_decoding_tables(self, want_bits: tuple, avail_bits: tuple):
        """Returns (rows, cols, inv, minimum) for a want/avails
        signature, or raises ECError(EIO) when unrecoverable.

        rows: selected source chunk ids (avail data in shingle support +
        selected parity); cols: covered data chunk ids; inv: GF(2^8)
        inverse of the (dup, dup) submatrix with data[cols] = inv @
        sources; minimum: chunk-id set to read.
        """
        key = (want_bits, avail_bits)
        hit = self._table_cache.get(key)
        if hit is not None:
            self._table_cache.move_to_end(key)
            return hit
        k, m, M = self.k, self.m, self.coding_matrix
        want = list(want_bits)
        avails = list(avail_bits)
        # a wanted missing parity pulls its shingle's data chunks into want
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if M[i, j] > 0:
                        want[j] = 1

        mindup, minp = k + 1, k + 1
        best_rows: list[int] = []
        best_cols: list[int] = []
        best_inv: np.ndarray | None = None
        for pp in range(1 << m):
            parities = [i for i in range(m) if (pp >> i) & 1]
            ek = len(parities)
            if ek > minp:
                continue
            if any(not avails[k + i] for i in parities):
                continue
            tmprow = [0] * (k + m)
            tmpcol = [0] * k
            for j in range(k):
                if want[j] and not avails[j]:
                    tmpcol[j] = 1
            for i in parities:
                tmprow[k + i] = 1
                for j in range(k):
                    if M[i, j] != 0:
                        tmpcol[j] = 1
                        if avails[j] == 1:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_col = sum(tmpcol)
            if dup_row != dup_col:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best_rows, best_cols, best_inv = [], [], None
                break
            if dup < mindup:
                rows = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcol[j]]
                sub = np.zeros((dup, dup), dtype=np.uint8)
                for a, r in enumerate(rows):
                    for b, cj in enumerate(cols):
                        sub[a, b] = (1 if r == cj else 0) if r < k else M[r - k, cj]
                try:
                    inv = gf_mat_inv(sub)  # det != 0 check + table in one
                except np.linalg.LinAlgError:
                    continue
                mindup, minp = dup, ek
                best_rows, best_cols, best_inv = rows, cols, inv
        if mindup == k + 1:
            raise ECError(errno.EIO, "shec: no recover matrix for erasure pattern")

        minimum = [0] * (k + m)
        for r in best_rows:
            minimum[r] = 1
        for j in range(k):
            if want[j] and avails[j]:
                minimum[j] = 1
        for i in range(m):
            if want[k + i] and avails[k + i] and not minimum[k + i]:
                if any(M[i, j] > 0 and not want[j] for j in range(k)):
                    minimum[k + i] = 1

        result = (best_rows, best_cols, best_inv, minimum)
        self._table_cache[key] = result
        if len(self._table_cache) > TABLE_CACHE_SIZE:
            self._table_cache.popitem(last=False)
        return result

    def _bits(self, ids, n: int) -> tuple:
        v = [0] * n
        for i in ids:
            v[i] = 1
        return tuple(v)

    # -- interface overrides -------------------------------------------------

    def _minimum_to_decode(self, want_to_read, available_chunks):
        n = self.k + self.m
        for c in want_to_read | available_chunks:
            if not 0 <= c < n:
                raise ECError(errno.EINVAL, f"chunk id {c} out of range")
        _, _, _, minimum = self._make_decoding_tables(
            self._bits(want_to_read, n), self._bits(available_chunks, n)
        )
        return {i for i in range(n) if minimum[i]}

    def decode_payloads(self, available, want_chunks):
        """SHEC override of the MDS fast path: the base implementation
        inverts the first-k survivor submatrix, which can be singular
        for a shingled (non-MDS) code even when the pattern is
        recoverable.  Route ECUtil's batched payload decode through the
        minimal-decoding-set search instead (same algebra as
        decode_chunks, payload-length agnostic)."""
        n = self.k + self.m
        want = set(want_chunks)
        chunks = {
            s: np.ascontiguousarray(np.asarray(v, dtype=np.uint8).reshape(-1))
            for s, v in available.items()
        }
        length = len(next(iter(chunks.values()))) if chunks else 0
        decoded: dict[int, np.ndarray] = {}
        for c in range(n):
            s = self.chunk_index(c)
            decoded[s] = chunks[s] if s in chunks else np.zeros(length, np.uint8)
        self.decode_chunks(want, chunks, decoded)
        return {c: decoded[self.chunk_index(c)] for c in want}

    def decode_chunks(self, want_to_read, chunks, decoded) -> None:
        k, m, M = self.k, self.m, self.coding_matrix
        n = k + m
        avails = self._bits(set(chunks), n)
        erased = self._bits(
            [i for i in want_to_read if i not in chunks], n
        )
        if not any(erased):
            return
        rows, cols, inv, _ = self._make_decoding_tables(erased, avails)
        if rows:
            sources = np.stack([
                np.ascontiguousarray(decoded[r], dtype=np.uint8) for r in rows
            ])
            rec = self._apply_matrix(inv, sources)  # data chunks at cols, in order
            for i, cj in enumerate(cols):
                if not avails[cj]:
                    decoded[cj][...] = rec[i]
        # re-encode wanted missing parities from (now complete) data,
        # all in one matmul
        parity_rows = [i for i in range(m) if erased[k + i]]
        if parity_rows:
            data = np.stack([
                np.ascontiguousarray(decoded[j], dtype=np.uint8)
                for j in range(k)
            ])
            rec = self._apply_matrix(M[parity_rows], data)
            for t, i in enumerate(parity_rows):
                decoded[k + i][...] = rec[t]


def _make(profile: dict, device) -> ErasureCodeShec:
    technique = profile.get("technique") or "multiple"
    profile["technique"] = technique
    if technique == "multiple":
        return ErasureCodeShec(MULTIPLE, device=device)
    if technique == "single":
        return ErasureCodeShec(SINGLE, device=device)
    raise ECError(
        errno.ENOENT,
        f"technique={technique} is not a valid coding technique. "
        "Choose one of the following: multiple, single",
    )


def __erasure_code_init__(name: str, registry) -> None:
    from ceph_tpu_torch.ec.registry import ErasureCodePlugin

    class ShecPlugin(ErasureCodePlugin):
        def factory(self, profile: dict, *, device=None):
            ec = _make(profile, device)
            ec.init(profile)
            return ec

    registry.add(name, ShecPlugin())

"""Erasure-code interface + default base implementation.

Behavioral twin of the reference contract:

- abstract contract: ``ErasureCodeInterface``
  (reference src/erasure-code/ErasureCodeInterface.h:170-462);
- default implementations (padding, greedy minimum_to_decode, chunk
  remapping, profile parsing, CRUSH rule creation): ``ErasureCode``
  (reference src/erasure-code/ErasureCode.{h,cc}).

Chunk payloads are numpy uint8 arrays (the host-side twin of
``bufferlist``); the batched stripe API (``encode_stripes`` /
``decode_stripes``) carries torch tensors shaped (..., chunk, S) and is
the device hot path the OSD layer uses.  Errors raise :class:`ECError`
with a POSIX errno instead of returning negative ints.
"""

from __future__ import annotations

import abc
import errno
from typing import Iterable, Mapping

import numpy as np

#: Reference pads chunks to 32-byte SIMD lanes (ErasureCode.cc:42).  We
#: keep the same value so chunk sizes (and therefore on-wire/on-disk
#: layouts and the non-regression corpus) match bit-for-bit.
SIMD_ALIGN = 32


class ECError(OSError):
    """Erasure-code failure with reference-compatible errno."""

    def __init__(self, eno: int, msg: str):
        super().__init__(eno, msg)


class ErasureCodeInterface(abc.ABC):
    """Abstract systematic-code contract.

    Reference: src/erasure-code/ErasureCodeInterface.h:170-462.  Method
    names/semantics kept 1:1 so the OSD EC backend and the mon
    profile/rule path can treat every plugin uniformly.
    """

    @abc.abstractmethod
    def init(self, profile: dict, quiet: bool = False) -> None:
        """Parse and validate ``profile`` (free-form str->str map,
        ErasureCodeInterface.h:155); must set it for :meth:`get_profile`."""

    @abc.abstractmethod
    def get_profile(self) -> dict: ...

    @abc.abstractmethod
    def get_chunk_count(self) -> int:
        """k + m (ErasureCodeInterface.h:227)."""

    @abc.abstractmethod
    def get_data_chunk_count(self) -> int:
        """k (ErasureCodeInterface.h:236)."""

    def get_coding_chunk_count(self) -> int:
        """m (ErasureCodeInterface.h:245)."""
        return self.get_chunk_count() - self.get_data_chunk_count()

    def get_sub_chunk_count(self) -> int:
        """Sub-chunks per chunk; >1 only for vector codes (CLAY)
        (ErasureCodeInterface.h:252-259)."""
        return 1

    @abc.abstractmethod
    def get_chunk_size(self, stripe_width: int) -> int:
        """Aligned per-chunk size for an object of ``stripe_width`` bytes
        (ErasureCodeInterface.h:278)."""

    @abc.abstractmethod
    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        """Chunks (and per-chunk (sub-chunk offset, count) runs) to read
        to satisfy ``want_to_read`` (ErasureCodeInterface.h:297-300).
        Raises ECError(EIO) if undecodable."""

    @abc.abstractmethod
    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int]
    ) -> set[int]:
        """Cost-weighted variant (ErasureCodeInterface.h:326)."""

    @abc.abstractmethod
    def encode(
        self, want_to_encode: set[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        """Split+pad ``data`` into k chunks, compute m parity chunks,
        return the requested subset (ErasureCodeInterface.h:336-355)."""

    @abc.abstractmethod
    def encode_chunks(self, want_to_encode: set[int], encoded: dict[int, np.ndarray]) -> None:
        """Low-level: fill parity chunk buffers in ``encoded`` in place."""

    @abc.abstractmethod
    def decode(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        """Reconstruct ``want_to_read`` from available ``chunks``
        (ErasureCodeInterface.h:367-388)."""

    @abc.abstractmethod
    def decode_chunks(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: dict[int, np.ndarray],
    ) -> None: ...

    @abc.abstractmethod
    def get_chunk_mapping(self) -> list[int]:
        """Chunk-id → shard-id remap; empty = identity
        (ErasureCodeInterface.h:448)."""

    @abc.abstractmethod
    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Decode + concatenate the data chunks in order
        (ErasureCodeInterface.h:460)."""

    @abc.abstractmethod
    def create_rule(self, name: str, crush_map) -> int:
        """Add a CRUSH rule fit for this code to ``crush_map``, return
        rule id (ErasureCodeInterface.h:212)."""


def _as_u8(data: bytes | bytearray | memoryview | np.ndarray) -> np.ndarray:
    if isinstance(data, np.ndarray):
        return np.ascontiguousarray(data, dtype=np.uint8).reshape(-1)
    return np.frombuffer(bytes(data), dtype=np.uint8)


class ErasureCode(ErasureCodeInterface):
    """Default implementations shared by all matrix-code plugins.

    Reference: src/erasure-code/ErasureCode.{h,cc} — padding/split
    (`encode_prepare`, ErasureCode.cc:170-205), greedy minimum
    (`_minimum_to_decode`, :122-139), passthrough-or-reconstruct decode
    (`_decode`, :225-261), `mapping` profile key (`to_mapping`,
    :280-299), CRUSH rule creation (:70-102).
    """

    #: default CRUSH rule knobs (ErasureCode.cc:28-29)
    DEFAULT_RULE_ROOT = "default"
    DEFAULT_RULE_FAILURE_DOMAIN = "host"

    def __init__(self) -> None:
        self._profile: dict = {}
        self.chunk_mapping: list[int] = []
        self.rule_root = self.DEFAULT_RULE_ROOT
        self.rule_failure_domain = self.DEFAULT_RULE_FAILURE_DOMAIN
        self.rule_device_class = ""
        self.rule_osds_per_failure_domain = 0
        self.rule_num_failure_domains = 0

    # -- profile helpers (ErasureCode.cc:301-349 to_int/to_bool/to_string) --

    @staticmethod
    def to_int(name: str, profile: dict, default: str) -> int:
        v = profile.get(name, "")
        if v == "":
            profile[name] = default
            v = default
        try:
            return int(str(v), 0)
        except ValueError:
            raise ECError(
                errno.EINVAL, f"could not convert {name}={v!r} to int"
            ) from None

    @staticmethod
    def to_bool(name: str, profile: dict, default: str) -> bool:
        # empty values are replaced by the default in the stored
        # profile too (ErasureCode.cc to_bool writes profile[name])
        v = str(profile.get(name, ""))
        if v == "":
            profile[name] = default
            v = default
        return v.lower() in ("true", "1", "yes", "y", "on")

    @staticmethod
    def to_string(name: str, profile: dict, default: str) -> str:
        v = profile.get(name, "")
        if v == "":
            profile[name] = default
            v = default
        return str(v)

    # -- init / profile ------------------------------------------------------

    def init(self, profile: dict, quiet: bool = False) -> None:
        self.rule_root = self.to_string("crush-root", profile, self.DEFAULT_RULE_ROOT)
        self.rule_failure_domain = self.to_string(
            "crush-failure-domain", profile, self.DEFAULT_RULE_FAILURE_DOMAIN
        )
        self.rule_osds_per_failure_domain = self.to_int(
            "crush-osds-per-failure-domain", profile, "0"
        )
        self.rule_num_failure_domains = self.to_int(
            "crush-num-failure-domains", profile, "0"
        )
        self.rule_device_class = profile.get("crush-device-class", "")
        self.parse(profile)
        # store a *copy* (the reference's `_profile = profile` is a C++
        # copy, ErasureCode.h): later mutation of either side is
        # detected by the registry's factory cross-check
        self._profile = dict(profile)

    def parse(self, profile: dict) -> None:
        """Subclass hook; base parses the `mapping` key
        (ErasureCode.cc:262-299)."""
        self._to_mapping(profile)

    def _to_mapping(self, profile: dict) -> None:
        mapping = profile.get("mapping")
        if mapping is None:
            return
        data_pos = [i for i, c in enumerate(mapping) if c == "D"]
        coding_pos = [i for i, c in enumerate(mapping) if c != "D"]
        self.chunk_mapping = data_pos + coding_pos

    def get_profile(self) -> dict:
        return self._profile

    @staticmethod
    def sanity_check_k_m(k: int, m: int) -> None:
        """ErasureCode.cc:104-115."""
        if k < 2:
            raise ECError(errno.EINVAL, f"k={k} must be >= 2")
        if m < 1:
            raise ECError(errno.EINVAL, f"m={m} must be >= 1")

    def chunk_index(self, i: int) -> int:
        """Chunk i's shard position (ErasureCode.cc:117-120)."""
        return self.chunk_mapping[i] if i < len(self.chunk_mapping) else i

    def get_chunk_mapping(self) -> list[int]:
        return self.chunk_mapping

    # -- minimum_to_decode ---------------------------------------------------

    def _minimum_to_decode(
        self, want_to_read: set[int], available_chunks: set[int]
    ) -> set[int]:
        """Greedy default: wanted chunks if all available, else the first
        k available (ErasureCode.cc:122-139)."""
        if want_to_read <= available_chunks:
            return set(want_to_read)
        k = self.get_data_chunk_count()
        if len(available_chunks) < k:
            raise ECError(errno.EIO, "not enough available chunks to decode")
        return set(sorted(available_chunks)[:k])

    def minimum_to_decode(
        self, want_to_read: set[int], available: set[int]
    ) -> dict[int, list[tuple[int, int]]]:
        ids = self._minimum_to_decode(want_to_read, available)
        runs = [(0, self.get_sub_chunk_count())]
        return {i: list(runs) for i in ids}

    def minimum_to_decode_with_cost(
        self, want_to_read: set[int], available: Mapping[int, int]
    ) -> set[int]:
        return self._minimum_to_decode(want_to_read, set(available))

    # -- encode --------------------------------------------------------------

    def encode_prepare(self, raw: np.ndarray) -> dict[int, np.ndarray]:
        """Split ``raw`` into k zero-padded aligned chunks + m empty
        parity buffers, keyed by shard position (ErasureCode.cc:170-205)."""
        k = self.get_data_chunk_count()
        m = self.get_coding_chunk_count()
        blocksize = self.get_chunk_size(len(raw))
        if blocksize == 0:  # empty object: k+m empty chunks
            return {
                self.chunk_index(i): np.zeros(0, dtype=np.uint8)
                for i in range(k + m)
            }
        padded_chunks = k - len(raw) // blocksize
        encoded: dict[int, np.ndarray] = {}
        for i in range(k - padded_chunks):
            encoded[self.chunk_index(i)] = raw[i * blocksize : (i + 1) * blocksize].copy()
        if padded_chunks:
            tail = raw[(k - padded_chunks) * blocksize :]
            buf = np.zeros(blocksize, dtype=np.uint8)
            buf[: len(tail)] = tail
            encoded[self.chunk_index(k - padded_chunks)] = buf
            for i in range(k - padded_chunks + 1, k):
                encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        for i in range(k, k + m):
            encoded[self.chunk_index(i)] = np.zeros(blocksize, dtype=np.uint8)
        return encoded

    def encode(
        self, want_to_encode: set[int], data: bytes | np.ndarray
    ) -> dict[int, np.ndarray]:
        """ErasureCode.cc:207-223: prepare → encode_chunks → filter."""
        encoded = self.encode_prepare(_as_u8(data))
        self.encode_chunks(set(range(self.get_chunk_count())), encoded)
        return {i: c for i, c in encoded.items() if i in want_to_encode}

    # -- decode --------------------------------------------------------------

    def decode(
        self,
        want_to_read: set[int],
        chunks: Mapping[int, np.ndarray],
        chunk_size: int = 0,
    ) -> dict[int, np.ndarray]:
        return self._decode(want_to_read, chunks)

    def _decode(
        self, want_to_read: set[int], chunks: Mapping[int, np.ndarray]
    ) -> dict[int, np.ndarray]:
        """Passthrough when everything wanted is present, else fill
        placeholders and call decode_chunks (ErasureCode.cc:225-261)."""
        if want_to_read <= set(chunks):
            return {i: np.asarray(chunks[i]) for i in want_to_read}
        if not chunks:
            raise ECError(errno.EIO, "no chunks to decode from")
        k, m = self.get_data_chunk_count(), self.get_coding_chunk_count()
        blocksize = len(next(iter(chunks.values())))
        decoded: dict[int, np.ndarray] = {}
        for i in range(k + m):
            if i in chunks:
                decoded[i] = np.ascontiguousarray(chunks[i], dtype=np.uint8)
            else:
                decoded[i] = np.zeros(blocksize, dtype=np.uint8)
        self.decode_chunks(want_to_read, chunks, decoded)
        return decoded

    def decode_concat(self, chunks: Mapping[int, np.ndarray]) -> np.ndarray:
        """Decode + concatenate data chunks in mapped order
        (ErasureCode.cc decode_concat / ErasureCodeInterface.h:460)."""
        want = {self.chunk_index(i) for i in range(self.get_data_chunk_count())}
        decoded = self.decode(want, chunks)
        return np.concatenate(
            [decoded[self.chunk_index(i)] for i in range(self.get_data_chunk_count())]
        )

    # -- CRUSH rule ----------------------------------------------------------

    def create_rule(self, name: str, crush_map) -> int:
        """indep EC rule, single- or multi-OSD-per-failure-domain
        (ErasureCode.cc:70-102)."""
        from ceph_tpu_torch.crush import builder

        if self.rule_osds_per_failure_domain > 1 and self.rule_num_failure_domains < 1:
            raise ECError(
                errno.EINVAL,
                "crush-num-failure-domains must be >= 1 when "
                "crush-osds-per-failure-domain is specified",
            )
        try:
            return builder.create_ec_rule(
                crush_map,
                name,
                root_name=self.rule_root,
                failure_domain=self.rule_failure_domain,
                num_failure_domains=self.rule_num_failure_domains,
                osds_per_failure_domain=self.rule_osds_per_failure_domain,
                device_class=self.rule_device_class or None,
                mode="indep",
            )
        except LookupError as e:
            raise ECError(errno.ENOENT, str(e)) from None
        except ValueError as e:
            raise ECError(errno.EEXIST, str(e)) from None

"""Compressor plugin registry — the third plugin family.

Behavioral twin of the reference's compressor framework
(src/compressor/: Compressor::create + per-algorithm plugins
zlib/snappy/zstd/lz4/brotli behind a registry; on-wire negotiation in
src/msg/compressor_registry.cc).  Same contract here: named plugins
with ``compress(bytes) -> bytes`` / ``decompress(bytes) -> bytes``,
resolved via :func:`create`; algorithms whose libraries are absent in
this environment are simply not registered (the reference gates them
with build flags the same way).
"""

from __future__ import annotations

from typing import Callable, Protocol


class Compressor(Protocol):
    name: str

    def compress(self, data: bytes) -> bytes: ...
    def decompress(self, data: bytes) -> bytes: ...


class _Simple:
    def __init__(self, name: str, comp: Callable, decomp: Callable):
        self.name = name
        self._c, self._d = comp, decomp

    def compress(self, data: bytes) -> bytes:
        return self._c(bytes(data))

    def decompress(self, data: bytes) -> bytes:
        return self._d(bytes(data))


_REGISTRY: dict[str, Compressor] = {}


def register(name: str, compressor: Compressor) -> None:
    _REGISTRY[name] = compressor


def create(name: str) -> Compressor:
    """Compressor::create: resolve by algorithm name; raises KeyError
    listing what is available."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(
            f"no compressor {name!r}; available: {sorted(_REGISTRY)}"
        ) from None


def available() -> list[str]:
    return sorted(_REGISTRY)


def _register_builtins() -> None:
    import bz2 as _bz2
    import lzma as _lzma
    import zlib as _zlib

    register("none", _Simple("none", lambda d: d, lambda d: d))
    register("zlib", _Simple("zlib", _zlib.compress, _zlib.decompress))
    register("lzma", _Simple("lzma", _lzma.compress, _lzma.decompress))
    register("bz2", _Simple("bz2", _bz2.compress, _bz2.decompress))
    try:
        import zstandard as _zstd

        cctx = _zstd.ZstdCompressor()
        dctx = _zstd.ZstdDecompressor()
        register("zstd", _Simple("zstd", cctx.compress, dctx.decompress))
    except ImportError:  # pragma: no cover - env without zstandard
        pass
    for missing in ("snappy", "lz4", "brotli"):
        # the reference ships these as optional plugins; absent (or
        # differently-shaped) libraries simply stay unregistered
        try:
            mod = __import__(missing)
        except ImportError:
            continue
        comp = getattr(mod, "compress", None)
        decomp = getattr(mod, "decompress", None)
        if comp is None and missing == "lz4":
            # modern lz4 wheels expose lz4.frame, not top-level APIs —
            # and the submodule needs an explicit import
            try:
                import importlib

                frame = importlib.import_module("lz4.frame")
            except ImportError:
                continue
            comp = getattr(frame, "compress", None)
            decomp = getattr(frame, "decompress", None)
        if comp is not None and decomp is not None:
            register(missing, _Simple(missing, comp, decomp))


_register_builtins()

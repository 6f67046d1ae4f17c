"""Compressor: the pluggable compression registry.

Behavioral mirror of the reference compressor plugin system
(src/compressor/Compressor.h: Compressor::create(type) with
zlib/snappy/zstd/lz4 plugins loaded like EC plugins) — used by BlueStore
blobs and messenger payloads.  Python's baked-in zlib/lzma/bz2 provide
the codecs; the seam (registry + create + compress/decompress contract)
matches the reference so further codecs slot in.
"""

from __future__ import annotations

import bz2
import lzma
import zlib
from typing import Callable, Dict, Optional, Tuple


class Compressor:
    def __init__(self, name: str,
                 compress: Callable[[bytes], bytes],
                 decompress: Callable[[bytes], bytes]):
        self.name = name
        self._c = compress
        self._d = decompress

    def compress(self, data: bytes) -> bytes:
        return self._c(bytes(data))

    def decompress(self, blob: bytes) -> bytes:
        return self._d(bytes(blob))


_REGISTRY: Dict[str, Compressor] = {}


def register(name: str, compress, decompress) -> None:
    _REGISTRY[name] = Compressor(name, compress, decompress)


def create(name: str) -> Compressor:
    """Compressor::create analog; raises on unknown plugin."""
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unsupported compressor {name!r} "
                         f"(have {sorted(_REGISTRY)})")


def get_available() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


register("zlib", lambda d: zlib.compress(d, 6), zlib.decompress)
register("lzma", lzma.compress, lzma.decompress)
register("bz2", bz2.compress, bz2.decompress)
# "snappy" fallback: zlib level 1 (fast path; real snappy is not baked in)
register("snappy", lambda d: zlib.compress(d, 1), zlib.decompress)


def maybe_compress(name: str, data: bytes,
                   required_ratio: float = 0.875) -> Tuple[bool, bytes]:
    """BlueStore-style conditional compression: keep the compressed blob
    only when it beats the required ratio
    (bluestore_compression_required_ratio semantics)."""
    c = create(name)
    blob = c.compress(data)
    if len(blob) <= len(data) * required_ratio:
        return True, blob
    return False, data

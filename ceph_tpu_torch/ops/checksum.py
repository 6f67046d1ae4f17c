"""Typed checksum framework (reference src/common/Checksummer.h:12-27).

Counterpart of ``ceph_tpu/ops/checksum.py``.  Algorithms: crc32c,
crc32c_16, crc32c_8 (truncations, seed -1), xxhash32, xxhash64 — applied
per csum_block over an extent, as BlueStore does for its per-blob
checksums (reference BlueStore.cc:3703-3709 selection, :10177+
verify-on-read).  Eight or more crc32c blocks go through
``ops/crc32c.crc32c_batch`` on the checksummer's device; fewer take the
host table path, as do the xxhash algorithms (numpy, on the host).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ceph_tpu_torch.ops import crc32c as _crc
from ceph_tpu_torch.utils.device import resolve_device

XXH32_P1, XXH32_P2, XXH32_P3, XXH32_P4, XXH32_P5 = (
    2654435761, 2246822519, 3266489917, 668265263, 374761393)
XXH64_P1, XXH64_P2, XXH64_P3, XXH64_P4, XXH64_P5 = (
    11400714785074694791, 14029467366897019727, 1609587929392839161,
    9650029242287828579, 2870177450012600261)

M32 = np.uint32(0xFFFFFFFF)


def _rotl32(x, r):
    return ((x << np.uint32(r)) | (x >> np.uint32(32 - r))).astype(np.uint32)


def _rotl64(x, r):
    return ((x << np.uint64(r)) | (x >> np.uint64(64 - r))).astype(np.uint64)


def xxhash32(data: bytes, seed: int = 0) -> int:
    """XXH32 (single buffer, numpy-accelerated stripes)."""
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = len(buf)
    seed = np.uint32(seed)
    with np.errstate(over="ignore"):
        return _xxh32_body(buf, n, seed)


def _xxh32_body(buf, n, seed):
    p = 0
    if n >= 16:
        v = [seed + np.uint32(XXH32_P1) + np.uint32(XXH32_P2),
             seed + np.uint32(XXH32_P2), seed, seed - np.uint32(XXH32_P1)]
        nstripe = n // 16
        lanes = buf[: nstripe * 16].view("<u4").reshape(nstripe, 4)
        for i in range(nstripe):
            for j in range(4):
                v[j] = _rotl32(v[j] + lanes[i, j] * np.uint32(XXH32_P2), 13) \
                    * np.uint32(XXH32_P1)
        h = (_rotl32(v[0], 1) + _rotl32(v[1], 7) + _rotl32(v[2], 12)
             + _rotl32(v[3], 18))
        p = nstripe * 16
    else:
        h = seed + np.uint32(XXH32_P5)
    h = (h + np.uint32(n)).astype(np.uint32)
    while p + 4 <= n:
        lane = buf[p : p + 4].view("<u4")[0]
        h = _rotl32(h + lane * np.uint32(XXH32_P3), 17) * np.uint32(XXH32_P4)
        p += 4
    while p < n:
        h = _rotl32(h + buf[p] * np.uint32(XXH32_P5), 11) * np.uint32(XXH32_P1)
        p += 1
    h ^= h >> np.uint32(15)
    h = h * np.uint32(XXH32_P2)
    h ^= h >> np.uint32(13)
    h = h * np.uint32(XXH32_P3)
    h ^= h >> np.uint32(16)
    return int(h)


def xxhash64(data: bytes, seed: int = 0) -> int:
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    n = len(buf)
    with np.errstate(over="ignore"):
        seed = np.uint64(seed)
        p = 0
        if n >= 32:
            v = [seed + np.uint64(XXH64_P1) + np.uint64(XXH64_P2),
                 seed + np.uint64(XXH64_P2), seed, seed - np.uint64(XXH64_P1)]
            nstripe = n // 32
            lanes = buf[: nstripe * 32].view("<u8").reshape(nstripe, 4)
            for i in range(nstripe):
                for j in range(4):
                    v[j] = _rotl64(v[j] + lanes[i, j] * np.uint64(XXH64_P2), 31) \
                        * np.uint64(XXH64_P1)
            h = (_rotl64(v[0], 1) + _rotl64(v[1], 7) + _rotl64(v[2], 12)
                 + _rotl64(v[3], 18))
            for j in range(4):
                h = (h ^ _rotl64(v[j] * np.uint64(XXH64_P2), 31)
                     * np.uint64(XXH64_P1)) * np.uint64(XXH64_P1) \
                    + np.uint64(XXH64_P4)
            p = nstripe * 32
        else:
            h = seed + np.uint64(XXH64_P5)
        h = (h + np.uint64(n)).astype(np.uint64)
        while p + 8 <= n:
            k = buf[p : p + 8].view("<u8")[0]
            k = _rotl64(k * np.uint64(XXH64_P2), 31) * np.uint64(XXH64_P1)
            h = _rotl64(h ^ k, 27) * np.uint64(XXH64_P1) + np.uint64(XXH64_P4)
            p += 8
        if p + 4 <= n:
            k = np.uint64(buf[p : p + 4].view("<u4")[0])
            h = _rotl64(h ^ (k * np.uint64(XXH64_P1)), 23) \
                * np.uint64(XXH64_P2) + np.uint64(XXH64_P3)
            p += 4
        while p < n:
            h = _rotl64(h ^ (buf[p] * np.uint64(XXH64_P5)), 11) \
                * np.uint64(XXH64_P1)
            p += 1
        h ^= h >> np.uint64(33)
        h = h * np.uint64(XXH64_P2)
        h ^= h >> np.uint64(29)
        h = h * np.uint64(XXH64_P3)
        h ^= h >> np.uint64(32)
    return int(h)


class Checksummer:
    """Per-block checksum calculate/verify (reference Checksummer.h)."""

    CSUM_NONE = "none"
    ALGORITHMS = ("none", "crc32c", "crc32c_16", "crc32c_8",
                  "xxhash32", "xxhash64")
    VALUE_SIZE = {"none": 0, "crc32c": 4, "crc32c_16": 2, "crc32c_8": 1,
                  "xxhash32": 4, "xxhash64": 8}

    def __init__(self, algorithm: str = "crc32c", device=None):
        """``device``: where the crc32c batch path runs, CUDA unless the
        caller names the CPU."""
        if algorithm not in self.ALGORITHMS:
            raise ValueError(f"unknown csum algorithm {algorithm}")
        self.algorithm = algorithm
        self.device = resolve_device(device)

    def _one(self, block: bytes) -> int:
        a = self.algorithm
        if a == "crc32c":
            return _crc.crc32c(0xFFFFFFFF, block)
        if a == "crc32c_16":
            return _crc.crc32c(0xFFFFFFFF, block) & 0xFFFF
        if a == "crc32c_8":
            return _crc.crc32c(0xFFFFFFFF, block) & 0xFF
        if a == "xxhash32":
            return xxhash32(block)
        if a == "xxhash64":
            return xxhash64(block)
        return 0

    def calculate(self, csum_block_size: int, data: bytes) -> bytes:
        """Per-block checksum vector, little-endian packed."""
        assert len(data) % csum_block_size == 0
        vsize = self.VALUE_SIZE[self.algorithm]
        if vsize == 0:
            return b""
        n = len(data) // csum_block_size
        if self.algorithm.startswith("crc32c") and n >= 8:
            arr = np.frombuffer(memoryview(data), dtype=np.uint8).reshape(
                n, csum_block_size)
            blocks = torch.from_numpy(arr.copy()).to(self.device)
            vals = _crc.crc32c_batch(blocks).cpu().numpy().astype(np.uint64)
        else:
            vals = np.array(
                [self._one(data[i * csum_block_size : (i + 1) * csum_block_size])
                 for i in range(n)], dtype=np.uint64)
        out = np.zeros((n, vsize), dtype=np.uint8)
        for b in range(vsize):
            out[:, b] = (vals >> np.uint64(8 * b)).astype(np.uint8)
        return out.tobytes()

    def verify(self, csum_block_size: int, data: bytes,
               csum_data: bytes) -> Optional[int]:
        """Returns the byte offset of the first bad block, or None if OK
        (reference returns -1 offset convention via bad_csum)."""
        want = self.calculate(csum_block_size, data)
        vsize = self.VALUE_SIZE[self.algorithm]
        if vsize == 0:
            return None
        for i in range(len(want) // vsize):
            if want[i * vsize : (i + 1) * vsize] != \
                    csum_data[i * vsize : (i + 1) * vsize]:
                return i * csum_block_size
        return None

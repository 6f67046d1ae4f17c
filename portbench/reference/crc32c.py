"""crc32c (Castagnoli) for the benchmark's reference, plain NumPy.

Ceph's ``ceph_crc32c(seed, data)``: the reflected CRC-32C update
(polynomial 0x82F63B78) from a caller's seed, with no inversion before or
after.  A shard's stored crc is ``ceph_crc32c(0xFFFFFFFF, shard bytes)``.

Rows are cut into blocks; one table loop runs over every block of every
row at once from a zero state, and the blocks fold in order: the update is
linear, so ``crc(s, A || B) = Z_|B|(crc(s, A)) ^ crc(0, B)``, where
``Z_n`` is n zero bytes fed to the state.  Written from the definition;
imports nothing of the program.
"""

from __future__ import annotations

import functools

import numpy as np

POLY = 0x82F63B78


def _table() -> np.ndarray:
    t = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (POLY if c & 1 else 0)
        t[i] = c
    return t


TABLE = _table()


def crc32c(seed: int, data: bytes) -> int:
    """Byte at a time: the plain definition (slow; for small inputs)."""
    c = seed & 0xFFFFFFFF
    for b in data:
        c = int(TABLE[(c ^ b) & 0xFF]) ^ (c >> 8)
    return c


def _feed(state: np.ndarray, cols: np.ndarray) -> np.ndarray:
    """Feed the byte columns ``cols`` (n, lanes) to per-lane states."""
    c = state.astype(np.uint32)
    for row in cols:
        c = TABLE[(c ^ row) & 0xFF] ^ (c >> np.uint32(8))
    return c


@functools.lru_cache(maxsize=8)
def _zero_tables(n: int) -> np.ndarray:
    """(4, 256) tables of Z_n: Z_n(v) = XOR_b T[b][byte b of v]."""
    vals = (np.arange(256, dtype=np.uint32)[None, :]
            << (8 * np.arange(4, dtype=np.uint32))[:, None]).reshape(-1)
    zeros = np.zeros((n, vals.size), dtype=np.uint32)
    return _feed(vals, zeros).reshape(4, 256)


def _zero_apply(t: np.ndarray, v: np.ndarray) -> np.ndarray:
    return (t[0][v & 0xFF] ^ t[1][(v >> 8) & 0xFF]
            ^ t[2][(v >> 16) & 0xFF] ^ t[3][v >> 24])


def crc32c_rows(rows: np.ndarray, seed: int = 0xFFFFFFFF,
                block: int = 4096) -> np.ndarray:
    """(R, L) uint8 rows -> (R,) uint32 ``ceph_crc32c(seed, row)``."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    r, length = rows.shape
    if length == 0:
        return np.full(r, seed & 0xFFFFFFFF, dtype=np.uint32)
    if length % block:
        return np.array([crc32c(seed, row.tobytes()) for row in rows],
                        dtype=np.uint32)
    nb = length // block
    cols = np.ascontiguousarray(rows.reshape(r * nb, block).T)
    blocks = _feed(np.zeros(r * nb, dtype=np.uint32), cols).reshape(r, nb)
    t = _zero_tables(block)
    acc = np.full(r, seed & 0xFFFFFFFF, dtype=np.uint32)
    for b in range(nb):
        acc = _zero_apply(t, acc) ^ blocks[:, b]
    return acc

"""The at-rest plane layout of a shard, for the benchmark's reference.

A shard of L bytes stored as planes is an (8, L/8) matrix: plane row t,
byte i holds bit t of shard bytes 8i..8i+7, byte 8i+u at bit u.  Written
from that definition with NumPy's bit packing; imports nothing of the
program.
"""

from __future__ import annotations

import numpy as np


def rows_to_planes(rows: np.ndarray) -> np.ndarray:
    """(c, L) shard rows -> (c, 8, L/8) plane matrices."""
    rows = np.ascontiguousarray(rows, dtype=np.uint8)
    c, length = rows.shape
    if length % 8:
        raise ValueError(f"shard of {length} bytes is not whole groups of 8")
    groups = rows.reshape(c, length // 8, 8)                 # (c, i, u)
    bits = (groups[:, None, :, :] >> np.arange(8, dtype=np.uint8)
            [None, :, None, None]) & 1                        # (c, t, i, u)
    return np.packbits(bits, axis=3, bitorder="little")[..., 0]


def planes_to_rows(planes: np.ndarray) -> np.ndarray:
    """(c, 8, L/8) plane matrices -> (c, L) shard rows."""
    planes = np.ascontiguousarray(planes, dtype=np.uint8)
    c, _t, nb = planes.shape
    bits = np.unpackbits(planes[..., None], axis=3, bitorder="little")
    rows = (bits.astype(np.uint8) << np.arange(8, dtype=np.uint8)
            [None, :, None, None]).sum(axis=1, dtype=np.uint8)  # (c, i, u)
    return rows.reshape(c, nb * 8)

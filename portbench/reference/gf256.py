"""GF(2^8) arithmetic for the benchmark's reference, plain NumPy.

The field of Ceph's w=8 erasure codes: polynomial x^8+x^4+x^3+x^2+1
(0x11D), generator 2, as in ISA-L and jerasure's gf-complete.  Written
from those definitions; imports nothing of the program.
"""

from __future__ import annotations

import numpy as np

POLY = 0x11D


def _tables():
    exp = np.zeros(512, dtype=np.int64)
    log = np.zeros(256, dtype=np.int64)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= POLY
    exp[255:510] = exp[0:255]
    return exp, log


EXP, LOG = _tables()


def _mul_table() -> np.ndarray:
    a = np.arange(256)
    t = EXP[(LOG[a][:, None] + LOG[a][None, :])]
    t[0, :] = 0
    t[:, 0] = 0
    return t.astype(np.uint8)


MUL = _mul_table()


def mul(a: int, b: int) -> int:
    return int(MUL[a, b])


def inv(a: int) -> int:
    if a == 0:
        raise ZeroDivisionError("0 has no inverse in GF(2^8)")
    return int(EXP[255 - LOG[a]])


def matmul(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(r, k) @ (k, c) over GF(2^8), both uint8."""
    a = np.asarray(a, dtype=np.uint8)
    b = np.asarray(b, dtype=np.uint8)
    out = np.zeros((a.shape[0], b.shape[1]), dtype=np.uint8)
    for j in range(a.shape[1]):
        out ^= MUL[a[:, j][:, None], b[j][None, :]]
    return out


def mul_rows(coef: np.ndarray, rows: np.ndarray) -> np.ndarray:
    """(r, k) coefficients applied to (k, L) byte rows -> (r, L)."""
    coef = np.asarray(coef, dtype=np.uint8)
    out = np.zeros((coef.shape[0], rows.shape[1]), dtype=np.uint8)
    for i in range(coef.shape[0]):
        for j in range(coef.shape[1]):
            c = int(coef[i, j])
            if c == 1:
                out[i] ^= rows[j]
            elif c:
                out[i] ^= MUL[c][rows[j]]
    return out


def invert(a: np.ndarray) -> np.ndarray:
    """Inverse of a square GF(2^8) matrix by Gauss-Jordan elimination."""
    a = np.array(a, dtype=np.uint8)
    n = a.shape[0]
    b = np.eye(n, dtype=np.uint8)
    for col in range(n):
        piv = next((r for r in range(col, n) if a[r, col]), None)
        if piv is None:
            raise ValueError("singular matrix")
        if piv != col:
            a[[col, piv]] = a[[piv, col]]
            b[[col, piv]] = b[[piv, col]]
        s = inv(int(a[col, col]))
        a[col] = MUL[s][a[col]]
        b[col] = MUL[s][b[col]]
        for r in range(n):
            f = int(a[r, col])
            if r != col and f:
                a[r] ^= MUL[f][a[col]]
                b[r] ^= MUL[f][b[col]]
    return b


def bitmatrix(mat: np.ndarray) -> np.ndarray:
    """(r, k) byte matrix -> (8r, 8k) GF(2) matrix, jerasure's
    matrix_to_bitmatrix: entry (8i+t, 8j+u) is bit t of mat[i,j] * 2^u."""
    mat = np.asarray(mat, dtype=np.uint8)
    r, k = mat.shape
    out = np.zeros((8 * r, 8 * k), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            for u in range(8):
                p = mul(int(mat[i, j]), 1 << u)
                for t in range(8):
                    out[8 * i + t, 8 * j + u] = (p >> t) & 1
    return out

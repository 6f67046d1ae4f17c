"""GF(2^w) arithmetic for w in {8, 16, 32}, GF(2) inversion, and the
w-bit-word device packing.

Counterpart of ``ceph_tpu/ops/gfw.py``.  The fields are gf-complete's
defaults, the ones jerasure's matrix codes use (reference
jerasure_init.cc:27-37):

    w=8  : x^8  + x^4  + x^3 + x^2 + 1          (0x11d)
    w=16 : x^16 + x^12 + x^3 + x   + 1          (0x1100b)
    w=32 : x^32 + x^22 + x^2 + x   + 1          (0x100400007)

Host half (numpy and Python ints; these touch k x m words, never data):
``GFW``, ``expand_bitmatrix_w``, ``gfw_invert_matrix``,
``gf2_invert_matrix``.  Multiplication by a constant is GF(2)-linear, so a
word matrix expands to a bit-matrix exactly as ``gf8.expand_bitmatrix``
does for w=8.

Device half (torch, on whatever device the tensors live): chunks are
sequences of little-endian w-bit words, so bit t of a word is bit t%8 of
its byte t//8.  The byte layout ``unpack_bits_w``/``pack_bits_w``/
``bitmatrix_matmul_w``/``encode_batch_w`` and the packed bit-planar layout
``bytes_to_planar_w``/``planar_to_bytes_w`` are the ``gf8`` functions,
which take the word width; the planes feed kernel B1
(``gf8.planar_matmul``), which serves every w.
"""

from __future__ import annotations

import functools

import numpy as np

from ceph_tpu_torch.ops import gf8


class GFW:
    """Scalar GF(2^w) arithmetic over Python ints (host-side, tiny)."""

    POLY = {8: 0x11D, 16: 0x1100B, 32: 0x100400007}

    def __init__(self, w: int):
        if w not in self.POLY:
            raise ValueError(f"unsupported w={w}")
        self.w = w
        self.poly = self.POLY[w]
        self.mask = (1 << w) - 1

    def mul(self, a: int, b: int) -> int:
        """Carryless multiply mod the field polynomial."""
        a &= self.mask
        b &= self.mask
        r = 0
        while b:
            if b & 1:
                r ^= a
            b >>= 1
            a <<= 1
            if a >> self.w:
                a ^= self.poly
        return r

    def pow(self, a: int, n: int) -> int:
        r = 1
        a &= self.mask
        while n:
            if n & 1:
                r = self.mul(r, a)
            a = self.mul(a, a)
            n >>= 1
        return r

    def inv(self, a: int) -> int:
        if a == 0:
            raise ZeroDivisionError("gf inv(0)")
        return self.pow(a, (1 << self.w) - 2)

    def div(self, a: int, b: int) -> int:
        return self.mul(a, self.inv(b))

    def bitmat(self, a: int) -> np.ndarray:
        """(w, w) GF(2) matrix of multiply-by-a, LSB-first:
        out[t, u] = bit t of a * 2^u."""
        w = self.w
        out = np.zeros((w, w), dtype=np.uint8)
        for u in range(w):
            col = self.mul(a, 1 << u)
            for t in range(w):
                out[t, u] = (col >> t) & 1
        return out


@functools.lru_cache(maxsize=8)
def field(w: int) -> GFW:
    return GFW(w)


def expand_bitmatrix_w(mat: np.ndarray, w: int) -> np.ndarray:
    """Expand an (r, k) word matrix into its (rw, kw) GF(2) bit-matrix
    (jerasure's ``jerasure_matrix_to_bitmatrix`` for any w).  w=8 reads
    gf8's product tables, which give the same blocks."""
    if w == 8:
        return gf8.expand_bitmatrix(mat)
    gf = field(w)
    mat = np.asarray(mat, dtype=np.uint64)
    r, k = mat.shape
    out = np.zeros((r * w, k * w), dtype=np.uint8)
    for i in range(r):
        for j in range(k):
            out[i * w:(i + 1) * w, j * w:(j + 1) * w] = gf.bitmat(int(mat[i, j]))
    return out


def gfw_invert_matrix(a: np.ndarray, w: int) -> np.ndarray:
    """Gauss-Jordan inversion over GF(2^w) (jerasure ``invert_matrix``
    for the wide fields); raises ValueError when singular."""
    gf = field(w)
    a = [[int(x) for x in row] for row in np.asarray(a, dtype=np.uint64)]
    n = len(a)
    inv = [[1 if i == j else 0 for j in range(n)] for i in range(n)]
    for col in range(n):
        pivot = next((r for r in range(col, n) if a[r][col]), None)
        if pivot is None:
            raise ValueError(f"singular at column {col}")
        if pivot != col:
            a[col], a[pivot] = a[pivot], a[col]
            inv[col], inv[pivot] = inv[pivot], inv[col]
        scale = gf.inv(a[col][col])
        a[col] = [gf.mul(x, scale) for x in a[col]]
        inv[col] = [gf.mul(x, scale) for x in inv[col]]
        for r in range(n):
            if r != col and a[r][col]:
                f = a[r][col]
                a[r] = [x ^ gf.mul(f, y) for x, y in zip(a[r], a[col])]
                inv[r] = [x ^ gf.mul(f, y) for x, y in zip(inv[r], inv[col])]
    return np.array(inv, dtype=np.uint64)


def gf2_invert_matrix(a: np.ndarray) -> np.ndarray:
    """Invert a 0/1 matrix over GF(2) (the solve jerasure performs on the
    bit-matrix of a native bit-matrix code); raises ValueError when
    singular."""
    a = np.array(a, dtype=np.uint8) & 1
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("square matrix required")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        rows = np.nonzero(a[col:, col])[0]
        if rows.size == 0:
            raise ValueError(f"singular at column {col}")
        pivot = col + int(rows[0])
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        elim = np.nonzero(a[:, col])[0]
        for r in elim:
            if r != col:
                a[r] ^= a[col]
                inv[r] ^= inv[col]
    return inv


# ---------------------------------------------------------------------------
# Device half: the gf8 layout functions, which take the word width
# ---------------------------------------------------------------------------
#
# unpack_bits_w(data, word_bytes), pack_bits_w(bits, word_bytes),
# bitmatrix_matmul_w(bitmat, data, word_bytes),
# encode_batch_w(bitmat, data, word_bytes), bytes_to_planar_w(data, w) and
# planar_to_bytes_w(planes, w) are the reference's names for them.

unpack_bits_w = gf8.unpack_bits
pack_bits_w = gf8.pack_bits
bitmatrix_matmul_w = gf8.bitmatrix_matmul
encode_batch_w = gf8.encode_batch
bytes_to_planar_w = gf8.bytes_to_planar
planar_to_bytes_w = gf8.planar_to_bytes

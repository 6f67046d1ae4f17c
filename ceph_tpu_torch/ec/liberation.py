"""Minimal-density RAID-6 bit-matrix builders: liberation / blaum_roth /
liber8tion.

Counterpart of ``ceph_tpu/ec/liberation.py`` (numpy only).  Behavioral
reference: the jerasure native builders the reference's plugin calls —
``liberation_coding_bitmatrix``, ``blaum_roth_coding_bitmatrix``,
``liber8tion_coding_bitmatrix`` (reference ErasureCodeJerasure.cc:439,463,
494; the jerasure/gf-complete submodules are NOT checked out in the
reference, so the constructions are re-derived from their published
definitions).  All three are m=2 codes whose coding matrix is a native
(2w, kw) GF(2) bit-matrix — rows 0..w-1 are [I I ... I] (parity P = XOR of
all data), rows w..2w-1 are per-chunk w x w binary blocks X_j
(Q = sum X_j d_j):

- liberation (w prime, k <= w): X_j = cyclic shift of I by j, plus one
  extra bit at (i, (i+j-1) mod w) with i = (j*(w-1)/2) mod w for j > 0 —
  James Plank's Liberation codes ("The RAID-6 Liberation Codes", FAST'08).
- blaum_roth (w+1 prime, k <= w): X_j = multiplication by x^j in the ring
  GF(2)[x] / M_p(x), M_p(x) = 1 + x + ... + x^w, p = w + 1 (Blaum & Roth,
  "On lowest density MDS codes").  The reference tolerates w=7 (p=8 not
  prime) for backward compatibility (ErasureCodeJerasure.cc:446-459); the
  ring construction is still well-defined there, matching that behavior.
- liber8tion (w=8, k <= 8): X_j = the GF(2^8) bit-matrix of multiplying by
  g^j (g = 2, poly 0x11d).  NOTE: Plank's liber8tion matrices were found
  by computer search and are only published inside the jerasure submodule
  the reference checkout lacks; this deterministic construction has
  identical geometry, profile semantics, and 2-erasure MDS fault
  tolerance, but its parity BYTES differ from jerasure's searched
  matrices.

MDS for (k<=w, m=2) needs every X_j invertible and every X_i ^ X_j
invertible — checked exhaustively by tests/test_torch_liberation.py.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops import gf8


def _identity_row(k: int, w: int) -> np.ndarray:
    """(w, kw) block row [I I ... I]."""
    return np.tile(np.eye(w, dtype=np.uint8), (1, k))


def liberation_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) Liberation bit-matrix; requires w prime, 2 < w, k <= w."""
    if k > w:
        raise ValueError(f"liberation requires k <= w (k={k}, w={w})")
    mat = np.zeros((2 * w, k * w), dtype=np.uint8)
    mat[:w] = _identity_row(k, w)
    for j in range(k):
        for i in range(w):
            mat[w + i, j * w + (j + i) % w] = 1
        if j > 0:
            i = (j * ((w - 1) // 2)) % w
            mat[w + i, j * w + (i + j - 1) % w] = 1
    return mat


def _mult_by_x_ring(w: int) -> np.ndarray:
    """(w, w) GF(2) matrix of multiply-by-x in GF(2)[x]/M_p(x),
    M_p(x) = 1 + x + ... + x^w (p = w + 1).  Column u = x^(u+1) reduced:
    x^w == 1 + x + ... + x^(w-1)."""
    b = np.zeros((w, w), dtype=np.uint8)
    for u in range(w - 1):
        b[u + 1, u] = 1
    b[:, w - 1] = 1
    return b


def blaum_roth_coding_bitmatrix(k: int, w: int) -> np.ndarray:
    """(2w, kw) Blaum-Roth bit-matrix; MDS when w+1 is prime and k <= w."""
    if k > w:
        raise ValueError(f"blaum_roth requires k <= w (k={k}, w={w})")
    mat = np.zeros((2 * w, k * w), dtype=np.uint8)
    mat[:w] = _identity_row(k, w)
    b = _mult_by_x_ring(w)
    x = np.eye(w, dtype=np.uint8)
    for j in range(k):
        mat[w:, j * w:(j + 1) * w] = x
        x = (b @ x) & 1
    return mat


def liber8tion_coding_bitmatrix(k: int) -> np.ndarray:
    """(16, 8k) liber8tion-style bit-matrix, w=8, k <= 8 (see the module
    docstring for the deviation from Plank's searched matrices)."""
    w = 8
    if k > w:
        raise ValueError(f"liber8tion requires k <= 8 (k={k})")
    mat = np.zeros((2 * w, k * w), dtype=np.uint8)
    mat[:w] = _identity_row(k, w)
    g = 1
    for j in range(k):
        mat[w:, j * w:(j + 1) * w] = gf8.GF_BITMAT[g]
        g = int(gf8.GF_MUL[g, 2])
    return mat

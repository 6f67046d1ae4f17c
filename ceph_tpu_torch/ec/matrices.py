"""Coding-matrix builders for the ISA and jerasure plugins.

Counterpart of ``ceph_tpu/ec/matrices.py``.  Host-side numpy; these touch
k x m words, never data.  The constructions mirror the libraries the
reference wraps:

- ``reed_sol_vandermonde_coding_matrix`` / ``reed_sol_r6_coding_matrix``:
  jerasure reed_sol.c (reference ErasureCodeJerasure.cc:199,245);
- ``cauchy_original_coding_matrix`` / ``cauchy_good_coding_matrix``:
  jerasure cauchy.c (reference ErasureCodeJerasure.cc:301 family);
- ``isa_rs_matrix`` / ``isa_cauchy_matrix``: ISA-L gf_gen_rs_matrix /
  gf_gen_cauchy1_matrix (reference ErasureCodeIsa.h:38-40).

The plain names build over GF(2^8); the ``_w`` twins build the same
matrices over gf-complete's GF(2^16)/GF(2^32) with ``ops/gfw.py``.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops import gf8, gfw


def reed_sol_extended_vandermonde(rows: int, cols: int) -> np.ndarray:
    """Extended Vandermonde matrix (jerasure reed_sol.c).

    Row 0 is e_0, rows 1..rows-2 are [1, i, i^2, ...], last row is e_{cols-1}.
    """
    v = np.zeros((rows, cols), dtype=np.uint8)
    v[0, 0] = 1
    for i in range(1, rows - 1):
        for j in range(cols):
            v[i, j] = gf8.gf_pow(i, j)
    v[rows - 1, cols - 1] = 1
    return v


def _systematize_vandermonde(v: np.ndarray) -> np.ndarray:
    """Elementary column operations making the top cols x cols block
    identity: the elimination jerasure performs inside
    reed_sol_vandermonde_coding_matrix."""
    v = v.copy()
    rows, cols = v.shape
    for i in range(cols):
        if v[i, i] == 0:
            for j in range(i + 1, cols):
                if v[i, j] != 0:
                    v[:, [i, j]] = v[:, [j, i]]
                    break
            else:
                raise ValueError("vandermonde systematization failed")
        if v[i, i] != 1:
            inv = gf8.gf_inv(v[i, i])
            v[:, i] = gf8.gf_mul(v[:, i], inv)
        for j in range(cols):
            if j != i and v[i, j] != 0:
                factor = v[i, j]
                v[:, j] ^= gf8.gf_mul(factor, v[:, i])
    return v


def reed_sol_vandermonde_coding_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) coding matrix: systematized extended Vandermonde, bottom m
    rows, then jerasure's two normalizations (reed_sol.c): scale each
    parity column so parity row 0 is all ones, then scale each parity row
    i >= 1 so parity column 0 is all ones."""
    v = reed_sol_extended_vandermonde(k + m, k)
    v = _systematize_vandermonde(v)
    if not np.array_equal(v[:k], np.eye(k, dtype=np.uint8)):
        raise ValueError("vandermonde systematization failed")
    coding = v[k:].copy()
    for j in range(k):
        e = int(coding[0, j])
        if e not in (0, 1):
            coding[:, j] = gf8.gf_mul(coding[:, j], gf8.gf_inv(e))
    for i in range(1, m):
        e = int(coding[i, 0])
        if e not in (0, 1):
            coding[i] = gf8.gf_mul(coding[i], gf8.gf_inv(e))
    return coding


def reed_sol_r6_coding_matrix(k: int) -> np.ndarray:
    """RAID-6 matrix (jerasure reed_sol_r6_coding_matrix): P = XOR,
    Q = sum 2^j d_j."""
    mat = np.zeros((2, k), dtype=np.uint8)
    mat[0, :] = 1
    for j in range(k):
        mat[1, j] = gf8.gf_pow(2, j)
    return mat


def cauchy_original_coding_matrix(k: int, m: int) -> np.ndarray:
    """matrix[i][j] = 1 / (i XOR (m + j))  (jerasure cauchy.c)."""
    if k + m > 256:
        raise ValueError("k+m must be <= 256 for w=8")
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf8.gf_inv(i ^ (m + j))
    return mat


def _n_ones(x: int) -> int:
    """Number of ones in the 8x8 bit-matrix of multiply-by-x."""
    return int(gf8.GF_BITMAT[x].sum())


def cauchy_good_coding_matrix(k: int, m: int) -> np.ndarray:
    """Cauchy matrix scaled to minimize bit-matrix ones (jerasure
    cauchy_good_general_coding_matrix): scale each column so row 0 is all
    ones, then scale each later row by the divisor minimizing its ones."""
    mat = cauchy_original_coding_matrix(k, m)
    for j in range(k):
        if mat[0, j] != 1:
            inv = gf8.gf_inv(mat[0, j])
            mat[:, j] = gf8.gf_mul(mat[:, j], inv)
    for i in range(1, m):
        best = sum(_n_ones(int(e)) for e in mat[i])
        best_j = -1
        for j in range(k):
            if mat[i, j] != 1:
                inv = gf8.gf_inv(mat[i, j])
                total = sum(
                    _n_ones(int(gf8.gf_mul(e, inv))) for e in mat[i]
                )
                if total < best:
                    best = total
                    best_j = j
        if best_j != -1:
            inv = gf8.gf_inv(mat[i, best_j])
            mat[i] = gf8.gf_mul(mat[i], inv)
    return mat


def cauchy_original_coding_matrix_w(k: int, m: int, w: int) -> np.ndarray:
    """cauchy_orig over GF(2^w): matrix[i][j] = 1/(i ^ (m+j))."""
    if k + m > (1 << w):
        raise ValueError(f"k+m must be <= 2^{w}")
    f = gfw.field(w)
    mat = np.zeros((m, k), dtype=np.uint64)
    for i in range(m):
        for j in range(k):
            mat[i, j] = f.inv(i ^ (m + j))
    return mat


def cauchy_good_coding_matrix_w(k: int, m: int, w: int) -> np.ndarray:
    """cauchy_good over GF(2^w): the same ones-minimization as the w=8
    builder, counted over the w x w bit-matrices."""
    f = gfw.field(w)

    def n_ones(x: int) -> int:
        return int(f.bitmat(int(x)).sum())

    mat = cauchy_original_coding_matrix_w(k, m, w)
    for j in range(k):
        if mat[0, j] != 1:
            inv = f.inv(int(mat[0, j]))
            for i in range(m):
                mat[i, j] = f.mul(int(mat[i, j]), inv)
    for i in range(1, m):
        best = sum(n_ones(int(e)) for e in mat[i])
        best_j = -1
        for j in range(k):
            if mat[i, j] != 1:
                inv = f.inv(int(mat[i, j]))
                total = sum(n_ones(f.mul(int(e), inv)) for e in mat[i])
                if total < best:
                    best = total
                    best_j = j
        if best_j != -1:
            inv = f.inv(int(mat[i, best_j]))
            for j in range(k):
                mat[i, j] = f.mul(int(mat[i, j]), inv)
    return mat


def reed_sol_vandermonde_coding_matrix_w(k: int, m: int, w: int) -> np.ndarray:
    """(m, k) uint64 coding matrix over GF(2^w): the w=8 algorithm
    (extended Vandermonde, column systematization, jerasure's two
    normalizations) with gf-complete's default polynomial for w."""
    if w == 8:
        return reed_sol_vandermonde_coding_matrix(k, m).astype(np.uint64)
    gf = gfw.field(w)
    rows, cols = k + m, k
    v = [[0] * cols for _ in range(rows)]
    v[0][0] = 1
    for i in range(1, rows - 1):
        for j in range(cols):
            v[i][j] = gf.pow(i, j)
    v[rows - 1][cols - 1] = 1
    for i in range(cols):
        if v[i][i] == 0:
            for j in range(i + 1, cols):
                if v[i][j] != 0:
                    for r in range(rows):
                        v[r][i], v[r][j] = v[r][j], v[r][i]
                    break
            else:
                raise ValueError("vandermonde systematization failed")
        if v[i][i] != 1:
            inv = gf.inv(v[i][i])
            for r in range(rows):
                v[r][i] = gf.mul(v[r][i], inv)
        for j in range(cols):
            if j != i and v[i][j] != 0:
                f = v[i][j]
                for r in range(rows):
                    v[r][j] ^= gf.mul(f, v[r][i])
    coding = [row[:] for row in v[k:]]
    for j in range(k):
        e = coding[0][j]
        if e not in (0, 1):
            inv = gf.inv(e)
            for i in range(m):
                coding[i][j] = gf.mul(coding[i][j], inv)
    for i in range(1, m):
        e = coding[i][0]
        if e not in (0, 1):
            inv = gf.inv(e)
            coding[i] = [gf.mul(x, inv) for x in coding[i]]
    return np.array(coding, dtype=np.uint64)


def reed_sol_r6_coding_matrix_w(k: int, w: int) -> np.ndarray:
    """RAID-6 over GF(2^w): P = XOR, Q = sum 2^j d_j."""
    gf = gfw.field(w)
    mat = np.zeros((2, k), dtype=np.uint64)
    mat[0, :] = 1
    for j in range(k):
        mat[1, j] = gf.pow(2, j)
    return mat


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) parity rows of ISA-L gf_gen_rs_matrix: row r = [g^0..g^(k-1)],
    g = 2^r.  Row 0 is all ones (the XOR special case the reference keeps,
    ErasureCodeIsa.cc region_xor path)."""
    mat = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            mat[r, j] = p
            p = int(gf8.gf_mul(p, gen))
        gen = int(gf8.gf_mul(gen, 2))
    return mat


def isa_cauchy_matrix(k: int, m: int) -> np.ndarray:
    """(m, k) parity rows of ISA-L gf_gen_cauchy1_matrix: inv(i ^ j),
    i = k..k+m-1."""
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf8.gf_inv((k + i) ^ j)
    return mat


def generator_matrix(coding: np.ndarray) -> np.ndarray:
    """Full (k+m, k) generator: identity stacked on the coding rows."""
    m, k = coding.shape
    return np.vstack([np.eye(k, dtype=coding.dtype), coding])

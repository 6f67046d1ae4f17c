"""Coding-matrix builders for the ISA plugin.

Counterpart of ``ceph_tpu/ec/matrices.py:195-223``: ISA-L
gf_gen_rs_matrix / gf_gen_cauchy1_matrix semantics (reference
ErasureCodeIsa.h:38-40 selects kVandermonde / kCauchy), over GF(2^8).
Host-side numpy; these touch k x m bytes, never data.
"""

from __future__ import annotations

import numpy as np

from ceph_tpu_torch.ops import gf8


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

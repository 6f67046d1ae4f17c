"""Plain erasure codes for the benchmark's reference: what Ceph stores.

Written from the libraries Ceph's plugins wrap, in NumPy, importing
nothing of the program:

- ISA ``reed_sol_van`` (ISA-L ``gf_gen_rs_matrix``): parity row r is
  ``[g^0, g^1, ..., g^(k-1)]`` with ``g = 2^r``, applied byte by byte;
- jerasure ``cauchy_good`` (``cauchy_good_general_coding_matrix`` for
  m > 2: ``1/(i ^ (m+j))``, columns scaled so row 0 is ones, each later
  row scaled by the divisor that leaves its bit-matrix fewest ones), run
  as a bit-matrix code over packets: a chunk is blocks of w*packetsize
  bytes, block packet u is bit-row u, and parity packet (i, t) is the XOR
  of the data packets (j, u) whose bit-matrix entry is set.

An object is cut as Ceph's ECUtil::stripe_info_t cuts it: stripes of
k * unit bytes, the last zero-padded; shard j is chunk j of every stripe,
concatenated.  Both codes are stripe-local and the stripe unit is a
multiple of the packet block, so a whole shard row encodes at once.
"""

from __future__ import annotations

from typing import Dict, Mapping, Sequence

import numpy as np

from portbench.reference import gf256

W = 8


def isa_rs_matrix(k: int, m: int) -> np.ndarray:
    mat = np.zeros((m, k), dtype=np.uint8)
    gen = 1
    for r in range(m):
        p = 1
        for j in range(k):
            mat[r, j] = p
            p = gf256.mul(p, gen)
        gen = gf256.mul(gen, 2)
    return mat


def _ones(x: int) -> int:
    return int(gf256.bitmatrix(np.array([[x]], dtype=np.uint8)).sum())


def cauchy_good_matrix(k: int, m: int) -> np.ndarray:
    mat = np.zeros((m, k), dtype=np.uint8)
    for i in range(m):
        for j in range(k):
            mat[i, j] = gf256.inv(i ^ (m + j))
    for j in range(k):
        if mat[0, j] != 1:
            s = gf256.inv(int(mat[0, j]))
            mat[:, j] = [gf256.mul(int(v), s) for v in mat[:, j]]
    for i in range(1, m):
        best = sum(_ones(int(v)) for v in mat[i])
        best_j = -1
        for j in range(k):
            if mat[i, j] != 1:
                s = gf256.inv(int(mat[i, j]))
                total = sum(_ones(gf256.mul(int(v), s)) for v in mat[i])
                if total < best:
                    best, best_j = total, j
        if best_j != -1:
            s = gf256.inv(int(mat[i, best_j]))
            mat[i] = [gf256.mul(int(v), s) for v in mat[i]]
    return mat


class Code:
    """One erasure-code profile: its coding matrix and its byte or
    packet application."""

    def __init__(self, profile: Mapping):
        self.plugin = profile["plugin"]
        self.technique = profile["technique"]
        self.k = int(profile["k"])
        self.m = int(profile["m"])
        self.n = self.k + self.m
        key = (self.plugin, self.technique)
        if key == ("isa", "reed_sol_van"):
            self.coding = isa_rs_matrix(self.k, self.m)
            self.packetsize = 0
        elif key == ("jerasure", "cauchy_good"):
            self.coding = cauchy_good_matrix(self.k, self.m)
            self.packetsize = int(profile.get("packetsize", 2048))
        else:
            raise ValueError(f"no reference for {key}")
        # generator: identity over the data chunks, then the parity rows
        self.generator = np.concatenate(
            [np.eye(self.k, dtype=np.uint8), self.coding])

    # -- applying a byte matrix to chunk rows ---------------------------

    def _layout(self, rows: np.ndarray) -> np.ndarray:
        c, length = rows.shape
        p = self.packetsize
        if length % (W * p):
            raise ValueError(f"row of {length} bytes is not whole blocks "
                             f"of {W * p}")
        nb = length // (W * p)
        return (rows.reshape(c, nb, W, p).transpose(0, 2, 1, 3)
                .reshape(c * W, nb * p))

    def _unlayout(self, prow: np.ndarray, length: int) -> np.ndarray:
        cw, cols = prow.shape
        p = self.packetsize
        return (prow.reshape(cw // W, W, cols // p, p).transpose(0, 2, 1, 3)
                .reshape(cw // W, length))

    def apply(self, mat: np.ndarray, rows: np.ndarray) -> np.ndarray:
        """(r, c) byte matrix applied to (c, L) chunk rows -> (r, L), as
        this code applies it: bytewise, or as a bit-matrix on packets."""
        rows = np.ascontiguousarray(rows, dtype=np.uint8)
        if not self.packetsize:
            return gf256.mul_rows(mat, rows)
        bits = gf256.bitmatrix(mat)
        src = self._layout(rows)
        pad = (-src.shape[1]) % 8
        src64 = np.ascontiguousarray(
            np.pad(src, ((0, 0), (0, pad)))).view(np.uint64)
        out = np.zeros((bits.shape[0], src64.shape[1]), dtype=np.uint64)
        for i in range(bits.shape[0]):
            for j in np.nonzero(bits[i])[0]:
                out[i] ^= src64[j]
        out8 = out.view(np.uint8)[:, :src.shape[1]]
        return self._unlayout(out8, rows.shape[1])

    # -- the code -------------------------------------------------------

    def encode(self, data_rows: np.ndarray) -> np.ndarray:
        """(k, L) data chunk rows -> (k+m, L) all chunk rows."""
        return np.concatenate(
            [np.asarray(data_rows, dtype=np.uint8),
             self.apply(self.coding, data_rows)])

    def decode(self, rows: Mapping[int, np.ndarray],
               want: Sequence[int]) -> Dict[int, np.ndarray]:
        """Chunks ``want`` from at least k surviving chunk rows."""
        src = sorted(rows)[: self.k]
        if len(src) < self.k:
            raise ValueError(f"only {len(src)} of {self.k} chunks")
        inv = gf256.invert(self.generator[src])
        mat = gf256.matmul(self.generator[list(want)], inv)
        got = self.apply(mat, np.stack([rows[s] for s in src]))
        return {w: got[i] for i, w in enumerate(want)}

    # -- objects and stripes --------------------------------------------

    def shards(self, obj: bytes, unit: int) -> np.ndarray:
        """An object's (k+m, shard_len) shard rows, striped by ``unit``."""
        width = self.k * unit
        nstripes = -(-len(obj) // width)
        buf = np.zeros(nstripes * width, dtype=np.uint8)
        buf[: len(obj)] = np.frombuffer(obj, dtype=np.uint8)
        data = (buf.reshape(nstripes, self.k, unit).transpose(1, 0, 2)
                .reshape(self.k, nstripes * unit))
        return self.encode(data)

    def logical(self, shard_rows: np.ndarray, unit: int, size: int) -> bytes:
        """The object's bytes from its k data shard rows."""
        ns = shard_rows.shape[1] // unit
        data = (np.asarray(shard_rows[: self.k]).reshape(self.k, ns, unit)
                .transpose(1, 0, 2).reshape(-1))
        return data[:size].tobytes()

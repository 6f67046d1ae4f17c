"""The ISA-L-compatible codec.

Counterpart of ``ceph_tpu/ec/isa.py``, a behavioral mirror of reference
src/erasure-code/isa/ErasureCodeIsa.{h,cc}: matrix selection
kVandermonde/kCauchy (ErasureCodeIsa.h:38-40), chunk size = ceil(object/k)
rounded to 32 (ErasureCodeIsa.cc:65-78), decode via survivor submatrix
inversion (:274-305), decode-table caching keyed by the erasure signature
(ErasureCodeIsaTableCache.h:48).  The m=1 XOR case falls out naturally:
the first vandermonde parity row is all ones, so the planar matmul of that
row is the region XOR.  The 32-byte ISA alignment is a multiple of the
planar packing quantum (8 bytes), so every ISA chunk geometry rides the
bit-planar layout.
"""

from __future__ import annotations

import errno

import numpy as np

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.codec import MatrixCodec
from ceph_tpu_torch.ec.interface import ECError, ErasureCodeProfile

EC_ISA_ADDRESS_ALIGNMENT = 32


class ErasureCodeIsaDefault(MatrixCodec):
    DEFAULT_K = "7"
    DEFAULT_M = "3"

    def __init__(self, matrixtype: str = "reed_sol_van", device=None):
        super().__init__(device)
        self.technique = matrixtype

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        self.k = self.to_int("k", profile, self.DEFAULT_K)
        self.m = self.to_int("m", profile, self.DEFAULT_M)
        self.technique = self.to_string("technique", profile, "reed_sol_van")
        self.sanity_check_k(self.k)
        if self.technique not in ("reed_sol_van", "cauchy"):
            raise ECError(errno.EINVAL, f"technique {self.technique} not supported")
        if self.k + self.m > 256:
            raise ECError(errno.EINVAL, "k+m must be <= 256")

    def get_alignment(self) -> int:
        return EC_ISA_ADDRESS_ALIGNMENT

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        chunk_size = (object_size + self.k - 1) // self.k
        modulo = chunk_size % alignment
        if modulo:
            chunk_size += alignment - modulo
        return chunk_size

    def build_coding_matrix(self) -> np.ndarray:
        if self.technique == "cauchy":
            return matrices.isa_cauchy_matrix(self.k, self.m)
        return matrices.isa_rs_matrix(self.k, self.m)


def make_isa(profile: ErasureCodeProfile, device=None):
    codec = ErasureCodeIsaDefault(device=device)
    codec.init(profile)
    return codec

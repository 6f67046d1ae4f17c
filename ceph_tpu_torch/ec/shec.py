"""SHEC: shingled erasure codes (k, m, c).

Counterpart of ``ceph_tpu/ec/shec.py``, a behavioral mirror of reference
src/erasure-code/shec/ErasureCodeShec.{h,cc} and ErasureCodePluginShec.cc:
a Vandermonde RS matrix with a shingle pattern of zeros
(shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:456), the (m1, c1, m2,
c2) split chosen by the recovery-efficiency metric
(shec_calc_recovery_efficiency1, :415), per-erasure-pattern decode via a
minimal-subset search over parity combinations and GF Gaussian elimination
(shec_make_decoding_matrix, :526), and a decode-plan cache keyed by the
(want, avails) pattern (ErasureCodeShecTableCache).

Encode is the bytewise GF(2^w) matrix code of ``MatrixCodec``, so the
bit-planar layout runs kernel B1 on the card; only the decode plans differ
from an MDS code, and they are built on the host (k x k words).  A decode
plan may read fewer or more than k chunks, so the B1 matrices of a SHEC
decode are ``(len(want)*w, S*w)`` for the plan's S source chunks.
"""

from __future__ import annotations

import errno
from typing import Dict, List, Mapping, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.codec import MatrixCodec
from ceph_tpu_torch.ec.interface import ECError, ErasureCodeProfile
from ceph_tpu_torch.ops import gf8, gfw

MULTIPLE = 0
SINGLE = 1


def gfw_invert(mat: np.ndarray, w: int) -> np.ndarray:
    """gfw inversion with the gf8 SingularMatrixError contract."""
    try:
        return gfw.gfw_invert_matrix(mat, w)
    except ValueError as e:
        raise gf8.SingularMatrixError(str(e))


def _shingle_cost(k: int, m: int, c: int, r_eff_k: List[int]) -> int:
    """One shingle group's term of the recovery-efficiency metric; lowers
    ``r_eff_k`` to the shortest recovery span covering each data chunk."""
    total = 0
    for rr in range(m):
        span = ((rr + c) * k) // m - (rr * k) // m
        end = (((rr + c) * k) // m) % k
        cc = ((rr * k) // m) % k
        first = True
        while first or cc != end:
            first = False
            r_eff_k[cc] = min(r_eff_k[cc], span)
            cc = (cc + 1) % k
        total += span
    return total


def _calc_recovery_efficiency1(k: int, m1: int, m2: int, c1: int,
                               c2: int) -> float:
    """Reference shec_calc_recovery_efficiency1 (ErasureCodeShec.cc:415)."""
    if m1 < c1 or m2 < c2:
        return -1.0
    if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
        return -1.0
    r_eff_k = [100000000] * k
    r_e1 = float(_shingle_cost(k, m1, c1, r_eff_k))
    r_e1 += _shingle_cost(k, m2, c2, r_eff_k)
    r_e1 += sum(r_eff_k)
    return r_e1 / (k + m1 + m2)


def shec_coding_matrix(k: int, m: int, c: int, technique: int,
                       w: int = 8) -> np.ndarray:
    """Shingled (m, k) coding matrix (reference
    shec_reedsolomon_coding_matrix, ErasureCodeShec.cc:456): a Vandermonde
    RS matrix over GF(2^w) with shingle-patterned zeros."""
    if technique == MULTIPLE:
        c1_best, m1_best = -1, -1
        min_r_e1 = 100.0
        for c1 in range(c // 2 + 1):
            for m1 in range(m + 1):
                c2 = c - c1
                m2 = m - m1
                if m1 < c1 or m2 < c2:
                    continue
                if (m1 == 0 and c1 != 0) or (m2 == 0 and c2 != 0):
                    continue
                if (m1 != 0 and c1 == 0) or (m2 != 0 and c2 == 0):
                    continue
                r_e1 = _calc_recovery_efficiency1(k, m1, m2, c1, c2)
                if min_r_e1 - r_e1 > np.finfo(float).eps and r_e1 < min_r_e1:
                    min_r_e1 = r_e1
                    c1_best, m1_best = c1, m1
        m1, c1 = m1_best, c1_best
        m2, c2 = m - m1_best, c - c1_best
    else:
        m1, c1 = 0, 0
        m2, c2 = m, c

    if w == 8:
        mat = matrices.reed_sol_vandermonde_coding_matrix(k, m).astype(
            np.uint8)
    else:
        mat = matrices.reed_sol_vandermonde_coding_matrix_w(k, m, w)
    for base, mm, cc_ in ((0, m1, c1), (m1, m2, c2)):
        for rr in range(mm):
            end = ((rr * k) // mm) % k
            cc = (((rr + cc_) * k) // mm) % k
            while cc != end:
                mat[base + rr, cc] = 0
                cc = (cc + 1) % k
    return mat


class ErasureCodeShec(MatrixCodec):
    DEFAULT_K = 4
    DEFAULT_M = 3
    DEFAULT_C = 2

    def __init__(self, technique: int = MULTIPLE, device=None):
        super().__init__(device)
        self.technique = technique
        self.c = 0
        # decode-plan cache keyed by (want, avails) bit patterns
        # (ErasureCodeShecTableCache semantics)
        self._plan_cache: Dict[Tuple, Tuple] = {}
        # batched recovery bit-matrices per (erasures, want) pattern
        self._batch_cache: Dict[Tuple, Tuple] = {}

    # -- profile ------------------------------------------------------------

    def parse(self, profile: ErasureCodeProfile) -> None:
        super().parse(profile)
        has = [name in profile and profile[name] for name in ("k", "m", "c")]
        if not any(has):
            self.k, self.m, self.c = (self.DEFAULT_K, self.DEFAULT_M,
                                      self.DEFAULT_C)
        elif not all(has):
            raise ECError(errno.EINVAL, "(k, m, c) must all be chosen")
        else:
            try:
                self.k = int(profile["k"])
                self.m = int(profile["m"])
                self.c = int(profile["c"])
            except ValueError as e:
                raise ECError(errno.EINVAL, f"bad k/m/c: {e}")
        k, m, c = self.k, self.m, self.c
        if k <= 0 or m <= 0 or c <= 0:
            raise ECError(errno.EINVAL, "k, m, c must be positive")
        if m < c:
            raise ECError(errno.EINVAL, f"c={c} must be <= m={m}")
        if k > 12:
            raise ECError(errno.EINVAL, f"k={k} must be <= 12")
        if k + m > 20:
            raise ECError(errno.EINVAL, f"k+m={k+m} must be <= 20")
        if k < m:
            raise ECError(errno.EINVAL, f"m={m} must be <= k={k}")
        self.w = 8
        w = profile.get("w")
        if w:
            try:
                wv = int(w)
            except ValueError:
                wv = 8
            # the reference falls back to the default, no error
            self.w = wv if wv in (8, 16, 32) else 8

    def get_alignment(self) -> int:
        # reference ErasureCodeShecReedSolomonVandermonde::get_alignment:
        # k * w * sizeof(int)
        return self.k * self.w * 4

    def get_chunk_size(self, object_size: int) -> int:
        alignment = self.get_alignment()
        tail = object_size % alignment
        padded = object_size + (alignment - tail if tail else 0)
        assert padded % self.k == 0
        return padded // self.k

    def build_coding_matrix(self) -> np.ndarray:
        return shec_coding_matrix(self.k, self.m, self.c, self.technique,
                                  self.w)

    # -- field-width helpers (gf8 tables at w=8, gfw at w in {16, 32}) ------

    def _word_dtype(self):
        return np.uint8 if self.w == 8 else np.uint64

    def _invert(self, mat: np.ndarray) -> np.ndarray:
        if self.w == 8:
            return gf8.gf_invert_matrix(mat.astype(np.uint8))
        return gfw_invert(mat, self.w)

    def _mul(self, a: int, b_row: np.ndarray) -> np.ndarray:
        if self.w == 8:
            return gf8.gf_mul(a, b_row)
        gf = gfw.field(self.w)
        return np.array([gf.mul(a, int(x)) for x in b_row], dtype=np.uint64)

    # -- decode-plan search (reference shec_make_decoding_matrix, :526) -----

    def _make_decoding_plan(self, want: List[int], avails: List[int]):
        """Returns (srcs, cols, inv, minimum):
        srcs — chunk ids whose values feed the solve (rows of the system),
        cols — data chunk ids solved for (columns),
        inv  — GF inverse of the system matrix (None when nothing to solve),
        minimum — minimal chunk-id set to read.
        Raises ECError(EIO) when the pattern is unrecoverable."""
        k, m = self.k, self.m
        matrix = self.engine.coding
        want = list(want)
        # to re-encode a wanted erased parity, all data in its support is
        # wanted
        for i in range(m):
            if want[k + i] and not avails[k + i]:
                for j in range(k):
                    if matrix[i, j] > 0:
                        want[j] = 1

        key = (tuple(want), tuple(avails))
        cached = self._plan_cache.get(key)
        if cached is not None:
            return cached

        mindup = k + 1
        minp = k + 1
        best_srcs: List[int] = []
        best_cols: List[int] = []
        best_inv = None
        for pp in range(1 << m):
            p = [i for i in range(m) if pp & (1 << i)]
            ek = len(p)
            if ek > minp:
                continue
            if not all(avails[k + i] for i in p):
                continue
            tmprow = [0] * (k + m)
            tmpcolumn = [0] * k
            for i in range(k):
                if want[i] and not avails[i]:
                    tmpcolumn[i] = 1
            for i in p:
                tmprow[k + i] = 1
                for j in range(k):
                    if int(matrix[i, j]) != 0:
                        tmpcolumn[j] = 1
                        if avails[j] == 1:
                            tmprow[j] = 1
            dup_row = sum(tmprow)
            dup_column = sum(tmpcolumn)
            if dup_row != dup_column:
                continue
            dup = dup_row
            if dup == 0:
                mindup = 0
                best_srcs, best_cols, best_inv = [], [], None
                break
            if dup < mindup:
                srcs = [i for i in range(k + m) if tmprow[i]]
                cols = [j for j in range(k) if tmpcolumn[j]]
                tmpmat = np.zeros((dup, dup), dtype=self._word_dtype())
                for r, i in enumerate(srcs):
                    for cidx, j in enumerate(cols):
                        if i < k:
                            tmpmat[r, cidx] = 1 if i == j else 0
                        else:
                            tmpmat[r, cidx] = matrix[i - k, j]
                try:
                    inv = self._invert(tmpmat)
                except gf8.SingularMatrixError:
                    continue  # singular: determinant is zero, reject
                mindup = dup
                best_srcs, best_cols, best_inv = srcs, cols, inv
                minp = ek

        if mindup == k + 1:
            raise ECError(errno.EIO, "shec: can't find recover matrix")

        minimum = set(best_srcs)
        for i in range(k):
            if want[i] and avails[i]:
                minimum.add(i)
        for i in range(m):
            if want[k + i] and avails[k + i] and (k + i) not in minimum:
                for j in range(k):
                    if matrix[i, j] > 0 and not want[j]:
                        minimum.add(k + i)
                        break

        plan = (best_srcs, best_cols, best_inv, minimum)
        self._plan_cache[key] = plan
        return plan

    # -- interface ----------------------------------------------------------

    def minimum_to_decode(self, want_to_read: Set[int],
                          available_chunks: Set[int]) -> Set[int]:
        n = self.k + self.m
        for s in (want_to_read, available_chunks):
            for i in s:
                if i < 0 or i >= n:
                    raise ECError(errno.EINVAL, f"bad chunk id {i}")
        want = [1 if i in want_to_read else 0 for i in range(n)]
        avails = [1 if i in available_chunks else 0 for i in range(n)]
        _, _, _, minimum = self._make_decoding_plan(want, avails)
        return set(minimum)

    def _rows_apply(self, rows: np.ndarray, data: np.ndarray) -> np.ndarray:
        """(r, c) words x (c, S) bytes -> (r, S) bytes for one decode step,
        on the reference's choice of engine (its ``_matmul_host`` and
        ``_device_matmul``): the host tables for w=8 chunks under 4096
        bytes, the codec's device otherwise."""
        if self.w == 8 and data.shape[1] < 4096:
            return np.asarray(gf8.gf_matmul_ref(rows, data))
        bitmat = gfw.expand_bitmatrix_w(rows, self.w)
        return self.engine._apply(torch.from_numpy(bitmat).to(self.device),
                                  data)

    def decode_chunks(
        self,
        want_to_read: Set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        """Reference shec_matrix_decode (ErasureCodeShec.cc:756): solve the
        minimal system for erased wanted data chunks, then re-encode erased
        wanted parities from the (now complete) data row."""
        k, m = self.k, self.m
        n = k + m
        avails = [1 if i in chunks else 0 for i in range(n)]
        want = [1 if (i in want_to_read and i not in chunks) else 0
                for i in range(n)]
        if not any(want):
            return
        srcs, cols, inv, _ = self._make_decoding_plan(want, avails)
        if inv is not None and srcs:
            src_data = np.stack([
                np.asarray(decoded[i], dtype=np.uint8) for i in srcs])
            # reconstruct only the erased columns; available ones are
            # already in `decoded`
            out_rows = [ci for ci, j in enumerate(cols) if not avails[j]]
            if out_rows:
                out = self._rows_apply(inv[out_rows], src_data)
                for idx, ci in enumerate(out_rows):
                    decoded[cols[ci]][...] = out[idx]
        # re-encode wanted erased parity chunks from complete data
        parity_want = [i for i in range(m) if want[k + i]]
        if parity_want:
            data = np.stack([
                np.asarray(decoded[i], dtype=np.uint8) for i in range(k)])
            out = self._rows_apply(self.engine.coding[parity_want], data)
            for idx, i in enumerate(parity_want):
                decoded[k + i][...] = out[idx]

    def decode_batch(self, erasures: Tuple[int, ...], chunks,
                     want: Tuple[int, ...] = None) -> torch.Tensor:
        """Batched single-pattern reconstruction on the device: build the
        plan once, apply ONE recovery matrix to the whole stripe batch.
        ``erasures`` = every unavailable chunk id; ``want`` = the subset to
        rebuild (default all of them).

        Erased parity rows are handled by composing the coding row with the
        data-recovery expressions (the composition the reference performs
        chunk-at-a-time in shec_matrix_decode, ErasureCodeShec.cc:526-756):
        every data chunk j is either an available source (identity row) or
        a solved combination of the plan's sources (its inverse row), so
        parity i = coding[i] @ [data exprs] is itself one row over
        sources."""
        if want is None:
            want = tuple(erasures)
        bitmat, src_list = self._batch_plan(tuple(erasures), tuple(want))
        chunks = self.engine._to_dev(chunks)
        return self.engine._apply_batch(bitmat, chunks[:, list(src_list), :])

    def _planar_decode_plan(self, erasures, want):
        """Planar decode rides the same non-MDS plan construction (the
        MatrixCodec default of 'first k available' can be singular for
        SHEC's punctured coding matrix)."""
        return self._batch_plan(tuple(erasures), tuple(want))

    def _batch_plan(self, erasures: Tuple[int, ...],
                    want: Tuple[int, ...]):
        """(recovery bit-matrix on the device, source ids) for one erasure
        pattern, cached like the reference decode tables."""
        cache_key = (erasures, want)
        cached = self._batch_cache.get(cache_key)
        if cached is not None:
            return cached
        k = self.k
        n = k + self.m
        avails = [0 if i in erasures else 1 for i in range(n)]
        want_vec = [1 if i in want else 0 for i in range(n)]
        srcs, cols, inv, _ = self._make_decoding_plan(want_vec, avails)
        src_list = list(srcs)
        pos = {s: i for i, s in enumerate(src_list)}
        # available data chunks in an erased parity's support feed the
        # composition directly; extend the source list with them
        for e in want:
            if e >= k:
                for j in range(k):
                    if self.engine.coding[e - k, j] and avails[j] \
                            and j not in pos:
                        pos[j] = len(src_list)
                        src_list.append(j)
        nsrc = len(src_list)
        word_dtype = self._word_dtype()

        def data_expr(j: int) -> np.ndarray:
            """Row expressing data chunk j over src_list."""
            row = np.zeros(nsrc, dtype=word_dtype)
            if avails[j]:
                row[pos[j]] = 1
            else:
                ci = cols.index(j)
                for r_i, s in enumerate(srcs):
                    row[pos[s]] = inv[ci][r_i]
            return row

        rows = []
        for e in want:
            if e < k:
                rows.append(data_expr(e))
            else:
                crow = self.engine.coding[e - k]
                acc = np.zeros(nsrc, dtype=word_dtype)
                for j in range(k):
                    cj = int(crow[j])
                    if cj:
                        acc ^= self._mul(cj, data_expr(j)).astype(word_dtype)
                rows.append(acc)
        rmat = np.stack(rows).astype(word_dtype)
        bitmat = torch.from_numpy(
            gfw.expand_bitmatrix_w(rmat, self.w)).to(self.device)
        plan = (bitmat, tuple(src_list))
        self._batch_cache[cache_key] = plan
        return plan


def make_shec(profile: ErasureCodeProfile, device=None):
    technique_name = profile.get("technique") or "multiple"
    profile["technique"] = technique_name
    if technique_name == "multiple":
        technique = MULTIPLE
    elif technique_name == "single":
        technique = SINGLE
    else:
        raise ECError(
            errno.ENOENT,
            f"technique={technique_name} is not a valid coding technique")
    codec = ErasureCodeShec(technique, device=device)
    codec.init(profile)
    return codec

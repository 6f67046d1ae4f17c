"""Matrix codecs on a torch device.

Counterpart of ``ceph_tpu/ec/codec.py:130-252,305-418``: the engine and
codec behind the ISA plugin (reference ErasureCodeIsa.cc:128 encode,
:274-305 decode).  Where the reference calls ISA-L's ``ec_encode_data``,
the port computes the identical GF(2^8) math as one GF(2) matmul:

- byte layout (``encode_chunks``/``encode_batch`` and their decodes):
  ``gf8.bitmatrix_matmul``, a float32 ``torch.matmul`` on unpacked bits;
- bit-planar layout (``encode_planar``/``decode_planar``): the packed
  plane matmul ``gf8.planar_matmul``, which is the hand-written CUDA
  kernel on the card.

Only w=8 is ported; the w=16/32 fields arrive with the gfw slice, and the
packet-interleaved ``BitmatrixCodec`` family with the B2 slice.
"""

from __future__ import annotations

import errno
from typing import Dict, Mapping, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.table_cache import DecodeTableCache
from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.utils.perf import KERNELS


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  Raises when CUDA is asked for (or defaulted to) and absent;
    it never drops to the CPU on its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ceph_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def _record_kernel(kind: str, nbytes: int) -> None:
    KERNELS.inc(f"{kind}_calls")
    KERNELS.inc(f"{kind}_bytes", int(nbytes))


class _DeviceMatrixEngine:
    """Shared encode/decode engine over a (k+m, k) generator matrix, with
    its bit-matrices resident on ``device``."""

    def __init__(self, k: int, m: int, coding: np.ndarray, w: int = 8,
                 device=None):
        if w != 8:
            raise NotImplementedError(
                f"w={w}: the GF(2^16)/GF(2^32) fields arrive with the "
                "gfw slice of the port")
        self.k = k
        self.m = m
        self.w = w
        self.device = resolve_device(device)
        self.coding = np.asarray(coding).astype(np.uint8)
        self._enc_bitmat = torch.from_numpy(
            gf8.expand_bitmatrix(self.coding)).to(self.device)
        self.generator = matrices.generator_matrix(self.coding)
        self._decode_cache = DecodeTableCache()

    def _to_dev(self, data) -> torch.Tensor:
        if isinstance(data, torch.Tensor):
            return data.to(self.device)
        return torch.from_numpy(
            np.ascontiguousarray(data, dtype=np.uint8)).to(self.device)

    def _apply(self, bitmat, data: np.ndarray) -> np.ndarray:
        _record_kernel("ec_matmul", data.size)
        return gf8.bitmatrix_matmul(bitmat, self._to_dev(data)).cpu().numpy()

    def _apply_batch(self, bitmat, data) -> torch.Tensor:
        """(B, k, S) -> (B, r, S) on the device."""
        data = self._to_dev(data)
        _record_kernel("ec_matmul", data.numel())
        b, k, s = data.shape
        cols = data.permute(1, 0, 2).reshape(k, b * s)
        out = gf8.bitmatrix_matmul(bitmat, cols)
        return out.reshape(out.shape[0], b, s).permute(1, 0, 2).contiguous()

    def encode_parity(self, data: np.ndarray) -> np.ndarray:
        """(k, S) -> (m, S)."""
        return self._apply(self._enc_bitmat, data)

    def encode_parity_batch(self, data) -> torch.Tensor:
        """(B, k, S) -> (B, m, S), stays on the device."""
        return self._apply_batch(self._enc_bitmat, data)

    def decode_matrix(
        self, src_rows: Tuple[int, ...], out_rows: Tuple[int, ...]
    ) -> np.ndarray:
        """Recovery matrix R with chunk[out] = R @ chunk[src].

        ISA-L's decode construction (reference ErasureCodeIsa.cc:274-305):
        invert the k x k survivor submatrix of the generator; erased data
        rows come straight from the inverse, erased parity rows compose the
        coding row with the inverse."""
        sub = self.generator[list(src_rows)]
        inv = gf8.gf_invert_matrix(sub)
        rows = []
        for e in out_rows:
            if e < self.k:
                rows.append(inv[e])
            else:
                rows.append(gf8.gf_matmul_ref(
                    self.coding[e - self.k][None, :], inv)[0])
        return np.stack(rows).astype(np.uint8)

    def decode_bitmat(self, src_rows: Tuple[int, ...],
                      out_rows: Tuple[int, ...]) -> torch.Tensor:
        key = (src_rows, out_rows)
        bitmat = self._decode_cache.get(key)
        if bitmat is None:
            rmat = self.decode_matrix(src_rows, out_rows)
            bitmat = torch.from_numpy(gf8.expand_bitmatrix(rmat)).to(
                self.device)
            self._decode_cache.put(key, bitmat)
        return bitmat

    def reconstruct(self, src_rows: Tuple[int, ...],
                    out_rows: Tuple[int, ...],
                    data: np.ndarray) -> np.ndarray:
        """data (k, S) from src_rows -> (len(out_rows), S)."""
        return self._apply(self.decode_bitmat(src_rows, out_rows), data)

    def reconstruct_batch(self, src_rows: Tuple[int, ...],
                          out_rows: Tuple[int, ...], data) -> torch.Tensor:
        """(B, k, S) from src_rows -> (B, len(out_rows), S), on device."""
        return self._apply_batch(self.decode_bitmat(src_rows, out_rows), data)

    def reconstruct_batch_from(self, src_rows: Tuple[int, ...],
                               out_rows: Tuple[int, ...],
                               chunks) -> torch.Tensor:
        """Like reconstruct_batch but takes the FULL (B, n, S) chunk
        array and gathers the src rows on the device."""
        chunks = self._to_dev(chunks)
        return self.reconstruct_batch(src_rows, out_rows,
                                      chunks[:, list(src_rows), :])


def engine_from_reference(coding, k: int, m: int, w: int = 8,
                          enc_bitmat=None, device=None) -> _DeviceMatrixEngine:
    """Build the port's engine from the reference engine's numpy state
    (``engine.coding`` and ``np.asarray(engine._enc_bitmat)``).

    The bit-matrix the port derives from ``coding`` must equal the one it
    was given: at-rest planes written by one package are decoded by the
    other, so both must hold the same code."""
    coding = np.asarray(coding)
    if coding.shape != (m, k):
        raise ValueError(f"coding matrix {coding.shape}, want {(m, k)}")
    eng = _DeviceMatrixEngine(k, m, coding, w=w, device=device)
    if enc_bitmat is not None:
        given = np.asarray(enc_bitmat).astype(np.uint8)
        if not np.array_equal(eng._enc_bitmat.cpu().numpy(), given):
            raise AssertionError(
                "derived encode bit-matrix differs from the reference's")
    return eng


class MatrixCodec(ErasureCode):
    """Bytewise GF(2^w) matrix code; subclasses supply the coding matrix."""

    def __init__(self, device=None):
        super().__init__()
        self.device = resolve_device(device)
        self.engine: _DeviceMatrixEngine = None  # set by prepare()

    def build_coding_matrix(self) -> np.ndarray:
        raise NotImplementedError

    def prepare(self) -> None:
        self.engine = _DeviceMatrixEngine(
            self.k, self.m, self.build_coding_matrix(), w=self.w,
            device=self.device)

    # -- bit-planar device layout -------------------------------------------
    #
    # Stripe batches stay in packed bit-planar form (ec/planar.py) across
    # encode -> parity -> decode; each hop is ONE planar GF(2) matmul and
    # the byte layout exists only at the host boundary.

    def planar_supported(self, chunk_size: int) -> bool:
        from ceph_tpu_torch.ec.planar import PlanarBatch

        return PlanarBatch.supported(chunk_size, self.w)

    def to_planar(self, batch) -> "PlanarBatch":
        """(B, k-or-n, S) byte batch -> PlanarBatch on the codec's device."""
        from ceph_tpu_torch.ec.planar import PlanarBatch

        return PlanarBatch.from_batch(batch, w=self.w, device=self.device)

    def encode_planar(self, pb) -> "PlanarBatch":
        """PlanarBatch of the k data chunks -> PlanarBatch of the m parity
        chunks: one matmul on packed planes."""
        return pb.with_planes(
            gf8.planar_matmul(self.engine._enc_bitmat, pb.planes), self.m)

    def _planar_decode_plan(self, erasures, want):
        """(recovery bit-matrix, source chunk ids) for one erasure
        pattern; an MDS code takes the first k available chunks."""
        avail = tuple(i for i in range(self.k + self.m)
                      if i not in erasures)
        src = avail[: self.k]
        return self.engine.decode_bitmat(src, tuple(want)), src

    def decode_planar(self, erasures, pb, want=None) -> "PlanarBatch":
        """Planar reconstruction: ``pb`` holds all n chunks (erased rows
        ignored); returns a PlanarBatch of ``want`` (default: erasures)."""
        from ceph_tpu_torch.ec.planar import _select_chunk_rows

        if want is None:
            want = tuple(erasures)
        bitmat, src = self._planar_decode_plan(tuple(erasures), tuple(want))
        src_planes = _select_chunk_rows(pb.planes, self.w, tuple(src))
        return pb.with_planes(gf8.planar_matmul(bitmat, src_planes),
                              len(want))

    # -- single-stripe paths (reference-API compatible) ---------------------

    def encode_chunks(self, chunks: Dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        if data.shape[1] == 0:
            return
        parity = self.engine.encode_parity(data)
        for i in range(self.m):
            chunks[self.k + i][...] = parity[i]

    def decode_chunks(
        self,
        want_to_read: Set[int],
        chunks: Mapping[int, np.ndarray],
        decoded: Dict[int, np.ndarray],
    ) -> None:
        avail = sorted(chunks)
        if len(avail) < self.k:
            raise ECError(errno.EIO, "not enough chunks to decode")
        erased = tuple(i for i in range(self.k + self.m) if i not in chunks)
        src = tuple(avail[: self.k])
        data = np.stack([np.asarray(chunks[i], dtype=np.uint8) for i in src])
        out = self.engine.reconstruct(src, erased, data)
        for idx, e in enumerate(erased):
            decoded[e][...] = out[idx]

    # -- batched device paths ----------------------------------------------

    def encode_batch(self, data) -> torch.Tensor:
        return self.engine.encode_parity_batch(data)

    def stripe_unit(self, default: int) -> int:
        # round to the planar packing quantum (w BYTES: one packed plane
        # byte spans 8 field words)
        q = self.w
        return ((default + q - 1) // q) * q

    def decode_batch(self, erasures: Tuple[int, ...], chunks,
                     want: Tuple[int, ...] = None) -> torch.Tensor:
        """chunks: (B, k+m, S) with erased positions ignored (zeros ok).

        ``erasures`` lists EVERY unavailable chunk id (they are excluded
        from the source set); ``want`` selects which of them to rebuild
        (default: all).  Returns (B, len(want), S) on the device."""
        if want is None:
            want = tuple(erasures)
        avail = tuple(i for i in range(self.k + self.m) if i not in erasures)
        src = avail[: self.k]
        return self.engine.reconstruct_batch_from(src, tuple(want), chunks)

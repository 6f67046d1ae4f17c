"""Matrix and bit-matrix codecs on a torch device.

Counterpart of ``ceph_tpu/ec/codec.py``: the engines and codecs behind the
ISA and jerasure plugins (reference ErasureCodeIsa.cc:128 encode,
:274-305 decode; ErasureCodeJerasure.cc:156,260).  Where the reference
calls ISA-L's ``ec_encode_data`` or jerasure's encoders, the port computes
the identical math as one GF(2) matmul:

- ``MatrixCodec`` (ISA, jerasure reed_sol_*, SHEC, and LRC's layers):
  bytewise GF(2^w) codes, w in {8, 16, 32}.  The byte layout
  (``encode_chunks``/``encode_batch`` and their decodes) runs
  ``gfw.bitmatrix_matmul_w`` over w-bit words, a float32 ``torch.matmul``
  on unpacked bits; the bit-planar layout
  (``encode_planar``/``decode_planar``) runs the packed plane matmul
  ``gf8.planar_matmul`` on ``(r*w, k*w)`` bit-matrices, kernel B1 on the
  card, for every w.
- ``BitmatrixCodec`` (jerasure cauchy_* and the liberation family):
  packet-interleaved codes defined by an (m*w, k*w) 0/1 matrix.  The byte
  layout stays on ``gf8.bitmatrix_matmul`` with the matrix expanded over
  the 8 byte lanes; the packet-planar layout (``encode_planar``/
  ``decode_planar``) runs ``_planar_rows_matmul``, kernel B2 on the card.

The GF(2^16)/GF(2^32) fields use the scalar ``gfw`` field for their
coding, generator and decode matrices (k x m words, host).
"""

from __future__ import annotations

import errno
import functools
from typing import Dict, Mapping, Set, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ec import matrices
from ceph_tpu_torch.ec.base import ErasureCode
from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.table_cache import DecodeTableCache
from ceph_tpu_torch.ops import gf8, gf8_bytes_cuda, gfw
from ceph_tpu_torch.utils.device import resolve_device
from ceph_tpu_torch.utils.perf import KERNELS


def _record_kernel(kind: str, nbytes: int) -> None:
    KERNELS.inc(f"{kind}_calls")
    KERNELS.inc(f"{kind}_bytes", int(nbytes))


def _to_device(data, device) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data.to(device)
    return torch.from_numpy(
        np.ascontiguousarray(data, dtype=np.uint8)).to(device)


@functools.lru_cache(maxsize=64)
def _lane_expand(mat_bytes: bytes, shape, device: torch.device) -> torch.Tensor:
    """Kronecker-expand a 0/1 packet-selection matrix over the 8 byte
    lanes, as a uint8 tensor on ``device`` (cached per matrix and
    device)."""
    m01 = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(shape)
    return torch.from_numpy(np.kron(m01, np.eye(8, dtype=np.uint8))).to(device)


@functools.lru_cache(maxsize=64)
def _lane_blocks(mat_bytes: bytes, shape, device: torch.device) -> torch.Tensor:
    """Kernel B2's table of the lane-expanded matrix (block words and
    zero/identity/general classes, ``gf8_bytes_cuda.pack_blocks``), packed
    on the host once per matrix and device, keyed as ``_lane_expand``."""
    m01 = np.frombuffer(mat_bytes, dtype=np.uint8).reshape(shape)
    lane = np.kron(m01, np.eye(8, dtype=np.uint8))
    return torch.from_numpy(gf8_bytes_cuda.pack_blocks(lane)).to(device)


def _pkt_batch_apply(lane_mat: torch.Tensor, data: torch.Tensor, w: int,
                     p: int, src=None) -> torch.Tensor:
    """Packet-interleaved batch apply for bit-matrix codes.

    data (B, c, S) where every chunk is super-blocks of w*p bytes (packet
    row t of super-block s holds bit-plane t); lane_mat is the
    byte-lane-expanded (8rw, 8cw) selection matrix.  One matmul for the
    whole batch (jerasure_schedule_encode semantics over all stripes at
    once, reference ErasureCodeJerasure.cc:260).  ``src`` optionally
    selects source rows first."""
    if src is not None:
        data = data[:, list(src), :]
    b, c, s = data.shape
    ns = s // (w * p)
    rows = (data.reshape(b, c, ns, w, p).permute(1, 3, 0, 2, 4)
            .reshape(c * w, b * ns * p))
    out = gf8.bitmatrix_matmul(lane_mat, rows)          # (r*w, b*ns*p)
    r = out.shape[0] // w
    return (out.reshape(r, w, b, ns, p).permute(2, 0, 3, 1, 4)
            .reshape(b, r, s))


class _DeviceMatrixEngine:
    """Shared encode/decode engine over a (k+m, k) generator matrix, with
    its bit-matrices resident on ``device``.  w=8 uses the table-driven
    gf8 host helpers, w in {16, 32} the scalar gfw field."""

    def __init__(self, k: int, m: int, coding: np.ndarray, w: int = 8,
                 device=None):
        if w not in (8, 16, 32):
            raise ValueError(f"unsupported w={w}")
        self.k = k
        self.m = m
        self.w = w
        self.word_bytes = w // 8
        self.device = resolve_device(device)
        self.coding = np.asarray(coding).astype(
            np.uint8 if w == 8 else np.uint64)
        bits = gfw.expand_bitmatrix_w(self.coding, w)
        self._enc_bitmat = torch.from_numpy(bits).to(self.device)
        self.generator = matrices.generator_matrix(self.coding)
        self._decode_cache = DecodeTableCache()

    def _to_dev(self, data) -> torch.Tensor:
        return _to_device(data, self.device)

    def _apply(self, bitmat, data: np.ndarray) -> np.ndarray:
        _record_kernel("ec_matmul", data.size)
        out = gfw.bitmatrix_matmul_w(bitmat, self._to_dev(data),
                                     self.word_bytes)
        return out.cpu().numpy()

    def _apply_batch(self, bitmat, data) -> torch.Tensor:
        """(B, k, S) -> (B, r, S) on the device."""
        data = self._to_dev(data)
        _record_kernel("ec_matmul", data.numel())
        return gfw.encode_batch_w(bitmat, data, self.word_bytes)

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
        if self.w == 8:
            inv = gf8.gf_invert_matrix(sub)
            rows = []
            for e in out_rows:
                if e < self.k:
                    rows.append(inv[e])
                else:
                    rows.append(gf8.gf_matmul_ref(
                        self.coding[e - self.k][None, :], inv)[0])
            return np.stack(rows).astype(np.uint8)
        gf = gfw.field(self.w)
        inv = gfw.gfw_invert_matrix(sub, self.w)
        rows = []
        for e in out_rows:
            if e < self.k:
                rows.append(inv[e])
            else:
                crow = [int(x) for x in self.coding[e - self.k]]
                row = []
                for c in range(self.k):
                    acc = 0
                    for t in range(self.k):
                        acc ^= gf.mul(crow[t], int(inv[t][c]))
                    row.append(acc)
                rows.append(np.array(row, dtype=np.uint64))
        return np.stack(rows)

    def decode_bitmat(self, src_rows: Tuple[int, ...],
                      out_rows: Tuple[int, ...]) -> torch.Tensor:
        key = (src_rows, out_rows)
        bitmat = self._decode_cache.get(key)
        if bitmat is None:
            rmat = self.decode_matrix(src_rows, out_rows)
            bits = gfw.expand_bitmatrix_w(rmat, self.w)
            bitmat = torch.from_numpy(bits).to(self.device)
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


class _DeviceBitEngine:
    """Engine for NATIVE GF(2) bit-matrix codes (liberation family): the
    code is defined directly by an (m*w, k*w) 0/1 matrix with no byte
    matrix behind it.  Decode inverts the k*w x k*w survivor bit-matrix
    over GF(2) — the same solve jerasure performs on its bit-matrices."""

    def __init__(self, k: int, m: int, w: int, coding_bits: np.ndarray):
        self.k = k
        self.m = m
        self.w = w
        self.coding_bits = np.asarray(coding_bits, dtype=np.uint8)
        self.generator_bits = np.vstack(
            [np.eye(k * w, dtype=np.uint8), self.coding_bits])
        self._decode_cache = DecodeTableCache()

    def decode_bits(self, src: Tuple[int, ...],
                    out: Tuple[int, ...]) -> np.ndarray:
        key = (src, out)
        cached = self._decode_cache.get(key)
        if cached is not None:
            return cached
        k, w = self.k, self.w
        g = np.vstack([
            self.generator_bits[s * w:(s + 1) * w] for s in src])  # (kw, kw)
        inv = gfw.gf2_invert_matrix(g)
        rows = []
        for e in out:
            if e < k:
                rows.append(inv[e * w:(e + 1) * w])
            else:
                block = self.coding_bits[(e - k) * w:(e - k + 1) * w]
                rows.append((block.astype(np.int32) @ inv.astype(np.int32))
                            .astype(np.uint8) & 1)
        rmat = np.vstack(rows)
        self._decode_cache.put(key, rmat)
        return rmat


def _planar_rows_matmul(lane_bitmat: torch.Tensor, rows: torch.Tensor,
                        blocks: torch.Tensor) -> torch.Tensor:
    """Byte-operand GF(2) matmul for packet-planar rows (the 8x expansion
    rides in the lane-expanded matrix, ``blocks`` is its cached table):
    kernel B2 for a CUDA tensor, its plain version for a CPU tensor."""
    _record_kernel("ec_matmul", rows.numel())
    return gf8_bytes_cuda.bitmatrix_matmul(lane_bitmat, rows, blocks)


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


class BitmatrixCodec(MatrixCodec):
    """Packet-interleaved bit-matrix code (jerasure cauchy + liberation
    families).

    Chunk layout follows jerasure_schedule_encode: a chunk is a sequence of
    super-blocks of w*packetsize bytes; packet-row t of a super-block holds
    bits "t" of the w-bit field elements.  Encode selects and XORs packets
    according to the (m*w, k*w) bit-matrix: a GF(2) matmul with the
    bit-matrix Kronecker-expanded over the 8 byte lanes.

    Subclasses supply the bit-matrices: the cauchy family derives them from
    a GF(2^w) word matrix (the expansion is a ring homomorphism, so word
    inversion and bit inversion agree); the liberation family overrides
    ``_encode_bits``/``_decode_bits`` with native GF(2) constructions.
    """

    def __init__(self, device=None):
        super().__init__(device)
        self.packetsize = 2048

    def prepare(self) -> None:
        super().prepare()
        coding = self.engine.coding
        self._enc_bits = gfw.expand_bitmatrix_w(coding, self.w)

    # -- bit-matrix sources (overridden by native bit-matrix codes) ---------

    def _encode_bits(self) -> np.ndarray:
        """(m*w, k*w) GF(2) encode matrix (built once, by prepare)."""
        return self._enc_bits

    def _decode_bits(self, src: Tuple[int, ...],
                     out: Tuple[int, ...]) -> np.ndarray:
        """(len(out)*w, k*w) GF(2) recovery matrix over the src chunks."""
        return gfw.expand_bitmatrix_w(self.engine.decode_matrix(src, out),
                                      self.w)

    def _lane(self, m01: np.ndarray) -> torch.Tensor:
        m01 = np.ascontiguousarray(m01, dtype=np.uint8)
        return _lane_expand(m01.tobytes(), m01.shape, self.device)

    def _lane_and_blocks(self, m01: np.ndarray):
        """The lane-expanded matrix and its kernel table, both cached."""
        m01 = np.ascontiguousarray(m01, dtype=np.uint8)
        key = (m01.tobytes(), m01.shape, self.device)
        return _lane_expand(*key), _lane_blocks(*key)

    # -- packet layout ------------------------------------------------------

    def stripe_unit(self, default: int) -> int:
        quantum = self.w * self.packetsize
        return ((default + quantum - 1) // quantum) * quantum

    def _check_layout(self, s: int) -> None:
        if s % (self.w * self.packetsize):
            raise ECError(
                errno.EINVAL,
                f"chunk size {s} must be a multiple of w*packetsize = "
                f"{self.w * self.packetsize} (choose packetsize/profile "
                "accordingly, reference jerasure blocksize contract)")

    def _layout_rows(self, data: np.ndarray) -> np.ndarray:
        """(c, S) chunks -> (c*w, S/w) packet-row matrix."""
        c, s = data.shape
        w, p = self.w, self.packetsize
        self._check_layout(s)
        ns = s // (w * p)
        return (data.reshape(c, ns, w, p).transpose(0, 2, 1, 3)
                .reshape(c * w, ns * p))

    def _unlayout_rows(self, rows: np.ndarray, s: int) -> np.ndarray:
        cw, n = rows.shape
        w, p = self.w, self.packetsize
        c = cw // w
        ns = n // p
        return rows.reshape(c, w, ns, p).transpose(0, 2, 1, 3).reshape(c, s)

    def _apply_bitmat(self, m01: np.ndarray, rows: np.ndarray) -> np.ndarray:
        lane = self._lane(m01)
        _record_kernel("ec_matmul", rows.size)
        return gf8.bitmatrix_matmul(
            lane, _to_device(rows, self.device)).cpu().numpy()

    # -- single-stripe paths ------------------------------------------------

    def encode_chunks(self, chunks: Dict[int, np.ndarray]) -> None:
        data = np.stack([chunks[i] for i in range(self.k)])
        rows = self._layout_rows(data)
        prows = self._apply_bitmat(self._encode_bits(), rows)
        parity = self._unlayout_rows(prows, data.shape[1])
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
        rows = self._layout_rows(data)
        out_rows = self._apply_bitmat(self._decode_bits(src, erased), rows)
        out = self._unlayout_rows(out_rows, data.shape[1])
        for idx, e in enumerate(erased):
            decoded[e][...] = out[idx]

    # -- batched device paths (packet-aware, so batch and single-stripe
    #    bytes agree) --------------------------------------------------------

    def encode_batch(self, data) -> torch.Tensor:
        data = _to_device(data, self.device)
        self._check_layout(int(data.shape[2]))
        lane = self._lane(self._encode_bits())
        _record_kernel("ec_matmul", data.numel())
        return _pkt_batch_apply(lane, data, self.w, self.packetsize)

    def decode_batch(self, erasures: Tuple[int, ...], chunks,
                     want: Tuple[int, ...] = None) -> torch.Tensor:
        if want is None:
            want = tuple(erasures)
        avail = tuple(i for i in range(self.k + self.m) if i not in erasures)
        src = avail[: self.k]
        chunks = _to_device(chunks, self.device)
        self._check_layout(int(chunks.shape[2]))
        lane = self._lane(self._decode_bits(src, tuple(want)))
        _record_kernel("ec_matmul", chunks.numel())
        return _pkt_batch_apply(lane, chunks, self.w, self.packetsize, src)

    # -- packet-planar layout ----------------------------------------------
    #
    # Packet-interleaved chunks are already bit-planar: jerasure's w packets
    # of p bytes per super-block are packed bit-planes of the w-bit symbols.
    # The planar form is therefore the packet-row matrix (c*w, B*ns*p) of
    # raw bytes, and the matmul keeps the byte-lane Kronecker expansion.

    def planar_supported(self, chunk_size: int) -> bool:
        from ceph_tpu_torch.ec.planar import PlanarBatch

        return PlanarBatch.supported(chunk_size, self.w, "packet",
                                     self.packetsize)

    def to_planar(self, batch):
        from ceph_tpu_torch.ec.planar import PlanarBatch

        self._check_layout(int(batch.shape[2]))
        return PlanarBatch.from_batch(batch, w=self.w, device=self.device,
                                      layout="packet",
                                      packetsize=self.packetsize)

    def encode_planar(self, pb):
        lane, blocks = self._lane_and_blocks(self._encode_bits())
        return pb.with_planes(_planar_rows_matmul(lane, pb.planes, blocks),
                              self.m)

    def decode_planar(self, erasures, pb, want=None):
        from ceph_tpu_torch.ec.planar import _select_chunk_rows

        if want is None:
            want = tuple(erasures)
        avail = tuple(i for i in range(self.k + self.m) if i not in erasures)
        src = avail[: self.k]
        lane, blocks = self._lane_and_blocks(
            self._decode_bits(src, tuple(want)))
        src_rows = _select_chunk_rows(pb.planes, self.w, src)
        return pb.with_planes(_planar_rows_matmul(lane, src_rows, blocks),
                              len(want))

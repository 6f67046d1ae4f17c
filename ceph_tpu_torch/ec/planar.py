"""Bit-planar stripe-batch contract: the device layout for EC batches.

Counterpart of ``ceph_tpu/ec/planar.py``.  Two planar flavors, matching
the two codec families:

- ``bitpack`` (the matrix codecs: ISA, jerasure reed_sol_*, SHEC, LRC): a
  stripe batch ``(B, c, S)`` lives on the device as packed planes
  ``(c*w, B*S/w)`` uint8 with chunk-major plane rows (row ``j*w + t`` is
  bit-plane t of chunk j), built by ``gfw.bytes_to_planar_w`` over the
  shard-major ``(c, B*S)`` view.
- ``packet`` (the packet codecs: jerasure cauchy_*, liberation family):
  those chunks are already bit-interleaved at packet granularity
  (jerasure's w packets of p bytes per super-block are packed
  bit-planes), so their planar form is the packet-row matrix
  ``(c*w, B*ns*p)`` of raw bytes, for any w, and the matmul uses the
  byte-lane-expanded matrix (kernel B2).

Encode, parity and decode between the host boundaries are then pure
GF(2) matmuls, and either layout costs no memory over the byte form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ops import gfw
from ceph_tpu_torch.ops.profiling import record_planar_convert


def _batch_to_planes(batch: torch.Tensor, w: int) -> torch.Tensor:
    """(B, c, S) bytes -> (c*w, B*S/w) packed planes (shard-major cols)."""
    b, c, s = batch.shape
    return gfw.bytes_to_planar_w(batch.permute(1, 0, 2).reshape(c, b * s), w)


def _planes_to_batch(planes: torch.Tensor, b: int, c: int, s: int,
                     w: int) -> torch.Tensor:
    rows = gfw.planar_to_bytes_w(planes, w)
    return rows.reshape(c, b, s).permute(1, 0, 2).contiguous()


def _batch_to_planes_packet(batch: torch.Tensor, w: int,
                            p: int) -> torch.Tensor:
    """(B, c, S) packet-interleaved chunks -> (c*w, B*ns*p) packet rows."""
    b, c, s = batch.shape
    ns = s // (w * p)
    return (batch.reshape(b, c, ns, w, p).permute(1, 3, 0, 2, 4)
            .reshape(c * w, b * ns * p))


def _planes_to_batch_packet(rows: torch.Tensor, b: int, c: int, s: int,
                            w: int, p: int) -> torch.Tensor:
    ns = s // (w * p)
    return (rows.reshape(c, w, b, ns, p).permute(2, 0, 3, 1, 4)
            .reshape(b, c, s))


def _select_chunk_rows(planes: torch.Tensor, w: int,
                       ids: Tuple[int, ...]) -> torch.Tensor:
    """Gather whole chunks (= w-row blocks, any w) out of a plane matrix."""
    cw, npk = planes.shape
    sel = torch.as_tensor(list(ids), dtype=torch.long, device=planes.device)
    return planes.reshape(cw // w, w, npk).index_select(0, sel).reshape(
        len(ids) * w, npk)


class PlanarBatch:
    """Device-resident EC stripe batch in planar layout.

    ``planes``: the plane matrix (see the module docstring for the two
    flavors); ``nstripes``/``nchunks``/``chunk_size`` give the byte-layout
    geometry ``(B, c, S)``; ``layout`` is ``"bitpack"`` or ``"packet"``.
    The byte view is computed lazily and cached (``to_batch``), so a batch
    pays at most one conversion in each direction per client op."""

    __slots__ = ("planes", "nstripes", "nchunks", "chunk_size", "w",
                 "layout", "packetsize", "_batch")

    def __init__(self, planes, nstripes: int, nchunks: int, chunk_size: int,
                 w: int = 8, layout: str = "bitpack", packetsize: int = 0,
                 batch=None):
        self.planes = planes
        self.nstripes = nstripes
        self.nchunks = nchunks
        self.chunk_size = chunk_size
        self.w = w
        self.layout = layout
        self.packetsize = packetsize
        self._batch = batch

    @staticmethod
    def supported(chunk_size: int, w: int, layout: str = "bitpack",
                  packetsize: int = 0) -> bool:
        """Can this geometry round-trip losslessly?  bitpack needs packed
        groups that do not split field words across chunk boundaries,
        packet whole super-blocks of w*packetsize bytes."""
        if chunk_size <= 0:
            return False
        if layout == "packet":
            return packetsize > 0 and chunk_size % (w * packetsize) == 0
        return chunk_size % w == 0

    @classmethod
    def from_batch(cls, batch, w: int = 8, device=None,
                   layout: str = "bitpack",
                   packetsize: int = 0) -> "PlanarBatch":
        """(B, c, S) byte batch (numpy, or a tensor) -> planes on
        ``device`` (default: where the tensor lies)."""
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch,
                                                          dtype=np.uint8))
        if device is not None:
            batch = batch.to(device)
        b, c, s = (int(x) for x in batch.shape)
        if layout == "packet":
            planes = _batch_to_planes_packet(batch, w, packetsize)
        else:
            planes = _batch_to_planes(batch, w)
        record_planar_convert("to_planar", b * c * s)
        # the byte view is not kept: holding it beside the planes would
        # double the batch's device footprint; to_batch re-derives it
        return cls(planes, b, c, s, w, layout, packetsize)

    def with_planes(self, planes, nchunks: Optional[int] = None,
                    chunk_ids=None) -> "PlanarBatch":
        """Derived batch (parity or reconstructed chunks) with this
        batch's geometry; ``chunk_ids`` is only for callers' records."""
        del chunk_ids
        if nchunks is None:
            nchunks = int(planes.shape[0]) // self.w
        return PlanarBatch(planes, self.nstripes, nchunks, self.chunk_size,
                           self.w, self.layout, self.packetsize)

    def to_batch(self) -> torch.Tensor:
        """Byte-layout (B, c, S) view on the device, converted once and
        cached."""
        if self._batch is None:
            if self.layout == "packet":
                self._batch = _planes_to_batch_packet(
                    self.planes, self.nstripes, self.nchunks,
                    self.chunk_size, self.w, self.packetsize)
            else:
                self._batch = _planes_to_batch(
                    self.planes, self.nstripes, self.nchunks,
                    self.chunk_size, self.w)
            record_planar_convert(
                "to_bytes", self.nstripes * self.nchunks * self.chunk_size)
        return self._batch

    def select(self, ids: Tuple[int, ...]) -> "PlanarBatch":
        """Sub-batch of whole chunks (a device row gather)."""
        ids = tuple(int(i) for i in ids)
        return PlanarBatch(_select_chunk_rows(self.planes, self.w, ids),
                           self.nstripes, len(ids), self.chunk_size, self.w,
                           self.layout, self.packetsize)

    def concat(self, other: "PlanarBatch") -> "PlanarBatch":
        """data ++ parity along the chunk axis, staying planar."""
        if other.layout != self.layout or other.w != self.w:
            raise ValueError("concat of planar batches of different layouts")
        return PlanarBatch(torch.cat([self.planes, other.planes], dim=0),
                           self.nstripes, self.nchunks + other.nchunks,
                           self.chunk_size, self.w, self.layout,
                           self.packetsize)

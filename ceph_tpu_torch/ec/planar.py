"""Bit-planar stripe-batch contract: the device layout for EC batches.

Counterpart of ``ceph_tpu/ec/planar.py`` (its ``bitpack`` flavor, the one
the matrix codecs use; the ``packet`` flavor of the cauchy/liberation
codecs arrives with the B2 slice).  A stripe batch ``(B, c, S)`` lives on
the device as packed planes ``(c*8, B*S/8)`` uint8 with chunk-major plane
rows (row ``j*8 + t`` is bit-plane t of chunk j), built by
``gf8.bytes_to_planar`` over the shard-major ``(c, B*S)`` view.  Encode,
parity and decode between the host boundaries are then pure planar GF(2)
matmuls, and the layout costs no memory over the byte form.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.ops.profiling import record_planar_convert


def _batch_to_planes(batch: torch.Tensor) -> torch.Tensor:
    """(B, c, S) bytes -> (c*8, B*S/8) packed planes (shard-major cols)."""
    b, c, s = batch.shape
    return gf8.bytes_to_planar(batch.permute(1, 0, 2).reshape(c, b * s))


def _planes_to_batch(planes: torch.Tensor, b: int, c: int,
                     s: int) -> torch.Tensor:
    rows = gf8.planar_to_bytes(planes)
    return rows.reshape(c, b, s).permute(1, 0, 2).contiguous()


def _select_chunk_rows(planes: torch.Tensor, w: int,
                       ids: Tuple[int, ...]) -> torch.Tensor:
    """Gather whole chunks (= w-row blocks) out of a plane matrix."""
    cw, npk = planes.shape
    sel = torch.as_tensor(list(ids), dtype=torch.long, device=planes.device)
    return planes.reshape(cw // w, w, npk).index_select(0, sel).reshape(
        len(ids) * w, npk)


class PlanarBatch:
    """Device-resident EC stripe batch in planar layout.

    ``planes``: the (c*8, B*S/8) plane matrix; ``nstripes``/``nchunks``/
    ``chunk_size`` give the byte-layout geometry ``(B, c, S)``.  The byte
    view is computed lazily and cached (``to_batch``), so a batch pays at
    most one conversion in each direction per client op."""

    __slots__ = ("planes", "nstripes", "nchunks", "chunk_size", "w",
                 "_batch")

    def __init__(self, planes, nstripes: int, nchunks: int, chunk_size: int,
                 w: int = 8, batch=None):
        self.planes = planes
        self.nstripes = nstripes
        self.nchunks = nchunks
        self.chunk_size = chunk_size
        self.w = w
        self._batch = batch

    @staticmethod
    def supported(chunk_size: int, w: int) -> bool:
        """Can this geometry round-trip losslessly?  Packed groups must
        not split field words across chunk boundaries."""
        return chunk_size > 0 and chunk_size % w == 0

    @classmethod
    def from_batch(cls, batch, w: int = 8, device=None) -> "PlanarBatch":
        """(B, c, S) byte batch (numpy, or a tensor) -> planes on
        ``device`` (default: where the tensor lies)."""
        if w != 8:
            raise NotImplementedError(
                f"w={w}: wide-field planes arrive with the gfw slice")
        if not isinstance(batch, torch.Tensor):
            batch = torch.from_numpy(np.ascontiguousarray(batch,
                                                          dtype=np.uint8))
        if device is not None:
            batch = batch.to(device)
        b, c, s = (int(x) for x in batch.shape)
        planes = _batch_to_planes(batch)
        record_planar_convert("to_planar", b * c * s)
        # the byte view is not kept: holding it beside the planes would
        # double the batch's device footprint; to_batch re-derives it
        return cls(planes, b, c, s, w)

    def with_planes(self, planes, nchunks: Optional[int] = None,
                    chunk_ids=None) -> "PlanarBatch":
        """Derived batch (parity or reconstructed chunks) with this
        batch's geometry; ``chunk_ids`` is only for callers' records."""
        del chunk_ids
        if nchunks is None:
            nchunks = int(planes.shape[0]) // self.w
        return PlanarBatch(planes, self.nstripes, nchunks, self.chunk_size,
                           self.w)

    def to_batch(self) -> torch.Tensor:
        """Byte-layout (B, c, S) view on the device, converted once and
        cached."""
        if self._batch is None:
            self._batch = _planes_to_batch(
                self.planes, self.nstripes, self.nchunks, self.chunk_size)
            record_planar_convert(
                "to_bytes", self.nstripes * self.nchunks * self.chunk_size)
        return self._batch

    def select(self, ids: Tuple[int, ...]) -> "PlanarBatch":
        """Sub-batch of whole chunks (a device row gather)."""
        ids = tuple(int(i) for i in ids)
        return PlanarBatch(_select_chunk_rows(self.planes, self.w, ids),
                           self.nstripes, len(ids), self.chunk_size, self.w)

    def concat(self, other: "PlanarBatch") -> "PlanarBatch":
        """data ++ parity along the chunk axis, staying planar."""
        assert other.w == self.w
        return PlanarBatch(torch.cat([self.planes, other.planes], dim=0),
                           self.nstripes, self.nchunks + other.nchunks,
                           self.chunk_size, self.w)

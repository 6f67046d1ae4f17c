"""Striper: file/image byte ranges -> object extents.

Behavioral mirror of reference Striper::file_to_extents
(src/osdc/Striper.h:31-54, Striper.cc) over file_layout_t
(src/include/fs_types.h:84): a file is cut into PERIODS of
stripe_count * object_size bytes; within a period, stripe_unit blocks
round-robin across the period's stripe_count objects.  This is the
layout premise RBD images and CephFS files share.

Counterpart of ``ceph_tpu/cluster/striper.py``.  The extent math is pure
host arithmetic; the payload I/O it drives lands on the OSD batched
encode/decode paths.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Tuple


@dataclass(frozen=True)
class FileLayout:
    """file_layout_t analog."""

    stripe_unit: int = 1 << 22
    stripe_count: int = 1
    object_size: int = 1 << 22

    def validate(self) -> None:
        if self.stripe_unit <= 0 or self.stripe_count <= 0 \
                or self.object_size <= 0:
            raise ValueError("layout fields must be positive")
        if self.object_size % self.stripe_unit:
            raise ValueError("object_size must be a multiple of stripe_unit")


@dataclass
class ObjectExtent:
    """One contiguous byte range inside one object (reference
    ObjectExtent): buffer_extents maps it back into the logical buffer."""

    oid: str
    objectno: int
    offset: int
    length: int
    buffer_extents: List[Tuple[int, int]] = field(default_factory=list)


def file_to_extents(object_format: str, layout: FileLayout,
                    offset: int, length: int) -> List[ObjectExtent]:
    """Map a logical (offset, length) range to object extents
    (reference Striper::file_to_extents).  ``object_format`` is the
    object-name pattern taking the object number (e.g.
    "rbd_data.{image}.%016x")."""
    layout.validate()
    su = layout.stripe_unit
    sc = layout.stripe_count
    os_ = layout.object_size
    su_per_object = os_ // su

    lookup: Dict[int, ObjectExtent] = {}
    order: List[int] = []
    pos = offset
    left = length
    while left > 0:
        blockno = pos // su
        stripeno = blockno // sc
        stripepos = blockno % sc
        objectsetno = stripeno // su_per_object
        objectno = objectsetno * sc + stripepos
        block_start = (stripeno % su_per_object) * su
        block_off = pos % su
        x_offset = block_start + block_off
        x_len = min(left, su - block_off)

        ex = lookup.get(objectno)
        if ex is None:
            ex = ObjectExtent(oid=object_format % objectno,
                              objectno=objectno,
                              offset=x_offset, length=x_len)
            lookup[objectno] = ex
            order.append(objectno)
        else:
            # a linear logical range touches each object in increasing,
            # adjacent in-object offsets, so fragments always coalesce
            assert ex.offset + ex.length == x_offset, (ex, x_offset)
            ex.length += x_len
        ex.buffer_extents.append((pos - offset, x_len))
        pos += x_len
        left -= x_len
    return [lookup[k] for k in order]


class StripedReader:
    """Assemble a logical buffer from per-object reads."""

    @staticmethod
    def assemble(extents: List[ObjectExtent],
                 object_data: Dict[str, bytes], length: int,
                 relative: bool = False) -> bytes:
        """``relative=True``: blobs are already extent-relative (start at
        ex.offset), avoiding object-sized zero padding on the hot path."""
        out = bytearray(length)
        for ex in extents:
            blob = object_data.get(ex.oid, b"")
            # the object may be short/absent (sparse): zero-fill
            src = blob[: ex.length] if relative else \
                blob[ex.offset: ex.offset + ex.length]
            src = src + b"\0" * (ex.length - len(src)) \
                if len(src) < ex.length else src
            off_in_ex = 0
            for buf_off, ln in ex.buffer_extents:
                out[buf_off: buf_off + ln] = src[off_in_ex: off_in_ex + ln]
                off_in_ex += ln
        return bytes(out)

    @staticmethod
    def scatter(extents: List[ObjectExtent],
                data: bytes) -> Dict[str, List[Tuple[int, bytes]]]:
        """Split a logical write buffer into per-object (offset, bytes)."""
        out: Dict[str, List[Tuple[int, bytes]]] = {}
        for ex in extents:
            off_in_ex = 0
            chunks = []
            for buf_off, ln in ex.buffer_extents:
                chunks.append(data[buf_off: buf_off + ln])
                off_in_ex += ln
            out.setdefault(ex.oid, []).append(
                (ex.offset, b"".join(chunks)))
        return out

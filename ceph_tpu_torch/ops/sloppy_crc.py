"""SloppyCRCMap: best-effort per-extent write-path CRC tracking.

Behavioral mirror of reference src/common/SloppyCRCMap.{h,cc}: record a
crc32c per fixed-size block as writes happen, invalidate partially
overwritten blocks, and compare a read against the recorded CRCs to
catch bit-rot between write and read (the FileStore integrity option).
Counterpart of ``ceph_tpu/ops/sloppy_crc.py`` on the port's host crc32c.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

from ceph_tpu_torch.ops.crc32c import crc32c


class SloppyCRCMap:
    def __init__(self, block_size: int = 65536):
        self.block_size = block_size
        self.crc: Dict[int, int] = {}     # block index -> crc32c

    def write(self, offset: int, data: bytes) -> None:
        bs = self.block_size
        pos = offset
        end = offset + len(data)
        while pos < end:
            b = pos // bs
            bstart = b * bs
            if pos == bstart and end >= bstart + bs:
                # full block: record its crc
                chunk = data[pos - offset: pos - offset + bs]
                self.crc[b] = crc32c(0xFFFFFFFF, chunk)
                pos = bstart + bs
            else:
                # partial overwrite: the stored crc no longer applies
                self.crc.pop(b, None)
                pos = min(end, bstart + bs)

    def read(self, offset: int, data: bytes) -> List[Tuple[int, int, int]]:
        """Verify a read against recorded CRCs; returns mismatches as
        (block, expected, got) triples (reference read(...) conflict
        reporting)."""
        bs = self.block_size
        out = []
        pos = offset
        end = offset + len(data)
        while pos < end:
            b = pos // bs
            bstart = b * bs
            if pos == bstart and end >= bstart + bs and b in self.crc:
                got = crc32c(0xFFFFFFFF,
                             data[pos - offset: pos - offset + bs])
                if got != self.crc[b]:
                    out.append((b, self.crc[b], got))
            pos = min(end, bstart + bs)
        return out

    def truncate(self, size: int) -> None:
        last = size // self.block_size
        for b in [b for b in self.crc if b >= last]:
            del self.crc[b]

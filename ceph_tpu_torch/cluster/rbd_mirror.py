"""rbd-mirror: journal-based asynchronous image replication.

Behavioral analog of the reference rbd-mirror daemon
(src/tools/rbd_mirror/ + src/journal/): images with the
journaling feature append every mutation to a per-image journal
(cls-atomic sequence allocation, cluster/objclass.py rbd_journal);
this daemon tails those journals and REPLAYS the events onto a peer
pool/cluster image (ImageReplayer::handle_replay analog), tracks its
committed position, and TRIMS the source journal behind it (the
reference's client-commit + object trim).

One-directional primary->secondary replication of all journaled images
in the source pool; the secondary image is created on first sight.
Failover = stop mirroring and promote (open the secondary read/write) —
the reference's promote/demote dance is an orchestration layer above
this replay core.  Counterpart of ``ceph_tpu/cluster/rbd_mirror.py``.
"""

from __future__ import annotations

import asyncio
import pickle
from typing import Dict, Optional

from ceph_tpu_torch.cluster.rbd import RBD, Image


class MirrorDaemon:
    """Replays source-pool image journals onto the destination pool."""

    def __init__(self, src_ioctx, dst_ioctx, poll_interval: float = 0.1):
        self.src = RBD(src_ioctx)
        self.dst = RBD(dst_ioctx)
        self.poll = poll_interval
        # image -> committed (replayed + trimmed) journal position
        self.positions: Dict[str, int] = {}
        self._dst_images: Dict[str, Image] = {}
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.replayed = 0

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._run())

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass

    async def _run(self) -> None:
        while not self._stopped:
            try:
                await self.sync_once()
            except asyncio.CancelledError:
                raise
            except Exception:
                # hiccup OR poison entry: the daemon must outlive it —
                # a dead replay task is silent replication loss.  Count
                # so operators can see a stuck mirror.
                self.errors = getattr(self, "errors", 0) + 1
            await asyncio.sleep(self.poll)

    async def sync_once(self) -> int:
        """One replay pass over every journaled source image; returns
        the number of events applied."""
        n = 0
        for name in await self.src.list():
            img = await self.src.open(name)
            if not img.header.journaling:
                continue
            n += await self._replay_image(img)
        return n

    async def _replay_image(self, src_img: Image) -> int:
        name = src_img.header.name
        journal_oid = f"rbd_journal.{name}"
        try:
            omap = await self.src.ioctx.omap_get(journal_oid)
        except (IOError, FileNotFoundError):
            return 0
        pos = self.positions.get(name, 0)
        pending = sorted(
            (int(k), v) for k, v in omap.items()
            if not k.startswith("_") and int(k) > pos)
        if not pending:
            return 0
        dst_img = await self._dst_image(src_img)
        for seq, blob in pending:
            event = pickle.loads(blob)
            await self._apply(dst_img, event)
            pos = seq
            self.replayed += 1
        self.positions[name] = pos
        # commit: trim the source journal behind the replayed position
        await self.src.ioctx.execute(journal_oid, "rbd_journal", "trim",
                                     str(pos).encode())
        return len(pending)

    async def _dst_image(self, src_img: Image) -> Image:
        name = src_img.header.name
        img = self._dst_images.get(name)
        if img is not None:
            return img
        try:
            img = await self.dst.open(name)
        except FileNotFoundError:
            lay = src_img.header.layout
            await self.dst.create(name, size=src_img.header.size,
                                  stripe_unit=lay.stripe_unit,
                                  stripe_count=lay.stripe_count,
                                  object_size=lay.object_size)
            img = await self.dst.open(name)
        self._dst_images[name] = img
        return img

    async def _apply(self, dst_img: Image, event) -> None:
        kind = event[0]
        if kind == "write":
            _, offset, data = event
            if offset + len(data) > dst_img.header.size:
                await dst_img.resize(offset + len(data))
            await dst_img.write(offset, data)
        elif kind == "resize":
            await dst_img.resize(event[1])
        else:
            raise IOError(f"unreplayable journal event {kind!r}")

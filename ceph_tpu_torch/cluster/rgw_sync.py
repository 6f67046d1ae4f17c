"""RGW multisite sync: replay a peer zone's bucket-index logs.

Behavioral analog of the reference multisite machinery (src/rgw/
rgw_sync.cc metadata sync, rgw_data_sync.cc data sync): zones are
independent RGW deployments (here: separate pools or clusters); each
zone's gateway appends every index mutation to a per-bucket index log
(cls_rgw bilog) and registers changed buckets in a zone datalog.  An
RGWSyncAgent in the DESTINATION zone polls the source datalog, replays
bilog entries past its persisted per-bucket marker (incremental sync),
and falls back to a FULL bucket sync when its marker has been trimmed
out of the source's log window — the same full/incremental split as
RGWDataSyncCR.  Active-active pairs run one agent in each direction;
entries carry their ORIGIN zone, and an agent skips entries that
originated in its own zone, which is what terminates the replication
loop (the reference tags ops with zone short-ids for the same reason).

Conflict policy is last-writer-wins by entry order per bucket key —
the reference resolves with object mtime/epoch squashing; documented
simplification.  Counterpart of ``ceph_tpu/cluster/rgw_sync.py``.
"""

from __future__ import annotations

import asyncio
from typing import Dict, Optional

from ceph_tpu_torch.cluster.rgw import RGW

SYNC_STATUS_OID = ".sync.status"   # per-source-zone markers (omap)


class RGWSyncAgent:
    """One-direction sync: pull changes from ``src`` into ``dst``
    (run a second agent for the reverse direction = active-active)."""

    def __init__(self, src: RGW, dst: RGW, interval: float = 0.5):
        self.src = src
        self.dst = dst
        self.interval = interval
        self._task: Optional[asyncio.Task] = None
        self._stopped = False
        self.stats = {"applied": 0, "full_syncs": 0, "skipped_echo": 0}
        # full-sync delete guard: dst-only keys younger than this are
        # kept (a peer's reverse agent may not have shipped them yet)
        self.full_sync_delete_grace = 60.0

    # -- markers (persisted in the DESTINATION zone) ------------------------

    async def _markers(self) -> Dict[str, int]:
        try:
            om = await self.dst.ioctx.omap_get(SYNC_STATUS_OID)
        except (FileNotFoundError, IOError):
            return {}
        pref = f"{self.src.zone}/"
        return {k[len(pref):]: int(v) for k, v in om.items()
                if k.startswith(pref)}

    async def _set_marker(self, bucket: str, seq: int) -> None:
        # omap_set auto-creates (the meta txn touches the object)
        await self.dst.ioctx.omap_set(
            SYNC_STATUS_OID,
            {f"{self.src.zone}/{bucket}": str(seq).encode()})

    # -- sync ---------------------------------------------------------------

    async def sync_once(self) -> int:
        """One pass over the source datalog; returns entries applied."""
        applied = 0
        datalog = await self.src.datalog()
        markers = await self._markers()
        # metadata sync-lite: peer buckets exist here too
        src_buckets = set(await self.src.list_buckets())
        dst_buckets = set(await self.dst.list_buckets())
        for b in src_buckets - dst_buckets:
            try:
                await self.dst.create_bucket(b)
            except FileExistsError:
                pass
        for bucket, head in datalog.items():
            marker = markers.get(bucket, 0)
            if head <= marker:
                continue
            tail, _ = await self.src.bilog_window(bucket)
            if marker < tail:
                applied += await self._full_sync(bucket)
                marker = tail
            applied += await self._incremental(bucket, marker)
        return applied

    async def _incremental(self, bucket: str, marker: int) -> int:
        n = 0
        last = None
        for seq, e in await self.src.bilog_entries(bucket, marker):
            if e.get("origin") == self.dst.zone:
                # our own change reflected back: consume without applying
                self.stats["skipped_echo"] += 1
            else:
                await self._apply(bucket, e)
                n += 1
            last = seq
        if last is not None:
            # ONE marker write per pass: _apply is idempotent under
            # re-replay, so a crash mid-pass only re-applies this page
            await self._set_marker(bucket, last)
        return n

    async def _apply(self, bucket: str, e: Dict) -> None:
        key = e["key"]
        if e["op"] == "put":
            try:
                meta, data = await self.src.get_object(bucket, key)
            except FileNotFoundError:
                return  # deleted again since; a later entry covers it
            await self.dst.put_object(bucket, key, data, meta=meta,
                                      origin=e.get("origin",
                                                   self.src.zone))
        elif e["op"] == "delete":
            try:
                await self.dst.delete_object(
                    bucket, key, origin=e.get("origin", self.src.zone))
            except FileNotFoundError:
                pass
        self.stats["applied"] += 1

    async def _full_sync(self, bucket: str) -> int:
        """Marker fell out of the source log window: reconcile the whole
        bucket against the source listing (reference full-sync shard
        sweep) — upserting changed objects AND deleting destination keys
        the source no longer has (their delete entries were trimmed)."""
        self.stats["full_syncs"] += 1
        n = 0
        marker = ""
        src_keys = set()
        while True:
            res = await self.src.list_objects(bucket, marker=marker,
                                              max_keys=256)
            for meta in res.keys:
                src_keys.add(meta.key)
                cur = None
                try:
                    cur = await self.dst.head_object(bucket, meta.key)
                except FileNotFoundError:
                    pass
                if cur is None or cur.etag != meta.etag:
                    _, data = await self.src.get_object(bucket, meta.key)
                    await self.dst.put_object(
                        bucket, meta.key, data, meta=meta,
                        origin=self.src.zone)
                    n += 1
            if not res.is_truncated:
                break
            marker = res.next_marker
        # deletes: reconcile dst-only keys, but NEVER recent local writes
        # (an active-active peer's reverse agent may not have shipped
        # them to the source yet — the reference squashes by object
        # version; we guard by mtime, documented simplification)
        import time as _time

        grace = _time.time() - self.full_sync_delete_grace
        dres = await self.dst.list_objects(bucket, max_keys=1_000_000)
        for meta in dres.keys:
            if meta.key not in src_keys and meta.mtime < grace:
                try:
                    await self.dst.delete_object(bucket, meta.key,
                                                 origin=self.src.zone)
                    n += 1
                except FileNotFoundError:
                    pass
        return n

    # -- daemon -------------------------------------------------------------

    def start(self) -> None:
        self._task = asyncio.get_event_loop().create_task(self._loop())

    async def _loop(self) -> None:
        while not self._stopped:
            try:
                await self.sync_once()
            except Exception:
                # transient (peer down); next tick retries — counted so
                # a permanently-failing agent is visible in its stats
                self.stats["errors"] = self.stats.get("errors", 0) + 1
            await asyncio.sleep(self.interval)

    async def stop(self) -> None:
        self._stopped = True
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except (asyncio.CancelledError, Exception):
                pass

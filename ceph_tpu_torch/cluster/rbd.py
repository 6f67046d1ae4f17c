"""RBD: block images striped over RADOS objects.

Behavioral analog of the reference librbd core data path
(src/librbd/: images are a header object holding metadata plus
"rbd_data.<id>.%016x" objects laid out by the Striper; src/osdc/Striper
drives the extent math).  Implemented: create/open/remove, size/resize,
striped read/write at arbitrary offsets, REAL snapshots (selfmanaged
RADOS snaps + clone-on-write at the OSD: snap reads are point-in-time,
reference librbd snap_create -> ioctx selfmanaged snaps + SnapContext),
clone with copy-on-write copy-up from the parent snap (reference
librbd::CloneRequest / CopyupRequest), and stats.  The data path rides
IoCtx, so EC pools, recovery, and scrub all apply to images unchanged.
Counterpart of ``ceph_tpu/cluster/rbd.py``.
"""

from __future__ import annotations

import asyncio
import pickle
import time
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from ceph_tpu_torch.utils.deadline import deadline_of, remaining
from ceph_tpu_torch.utils.lockdep import DepLock

from ceph_tpu_torch.cluster.objecter import IoCtx
from ceph_tpu_torch.cluster.striper import (
    FileLayout,
    StripedReader,
    file_to_extents,
)


def _chaos(io: IoCtx, name: str) -> None:
    """Client-library chaos seam: interrupt this front-door
    transaction AT THIS INSTANT when the client config arms ``name``
    (the application "died" mid-op; a retry models its restart).  One
    falsy test when unarmed — the no-op contract."""
    if not io.objecter.config.chaos_crash_point:
        return
    from ceph_tpu_torch.chaos.points import maybe_interrupt

    maybe_interrupt(io.objecter.config, name)


@dataclass
class ImageHeader:
    """rbd_header.<name> contents (librbd image metadata analog)."""

    name: str
    size: int
    layout: FileLayout
    snaps: Dict[str, int] = field(default_factory=dict)  # name -> rados snap
    snap_sizes: Dict[int, int] = field(default_factory=dict)  # id -> size
    # clone parentage (librbd parent_info): (parent image, parent snapid);
    # reads of unwritten child extents fall through to the parent snap
    parent: Optional[tuple] = None
    # clone children per snap (the reference's rbd_children registry):
    # snap name -> [(child image name, registration stamp)].  A snap
    # with live children is pinned — snap_remove refuses it (reference:
    # protected snapshots), which is what keeps clone parents immutable
    # while children still copy-up from them.  The stamp bounds the
    # dangling-child prune: a registration whose header is missing may
    # be a clone that CRASHED mid-create (prunable) or one still in
    # flight between registration and header write — only entries older
    # than the grace window are deemed dead.
    children: Dict[str, List[tuple]] = field(default_factory=dict)
    # journaling feature (reference RBD_FEATURE_JOURNALING,
    # src/journal/): mutations append to the image journal BEFORE the
    # data write, so rbd-mirror can replay them elsewhere
    journaling: bool = False


class RBD:
    """Image admin surface (reference librbd::RBD)."""

    def __init__(self, ioctx: IoCtx):
        self.ioctx = ioctx

    @staticmethod
    def _header_oid(name: str) -> str:
        return f"rbd_header.{name}"

    async def create(self, name: str, size: int,
                     stripe_unit: int = 1 << 20,
                     stripe_count: int = 1,
                     object_size: int = 1 << 22,
                     journaling: bool = False) -> None:
        layout = FileLayout(stripe_unit=stripe_unit,
                            stripe_count=stripe_count,
                            object_size=object_size)
        layout.validate()
        hdr = ImageHeader(name=name, size=size, layout=layout,
                          journaling=journaling)
        try:
            await self.ioctx.stat(self._header_oid(name))
            raise FileExistsError(name)
        except FileNotFoundError:
            pass
        await self.ioctx.write_full(self._header_oid(name),
                                    pickle.dumps(hdr))

    async def remove(self, name: str) -> None:
        img = await self.open(name)
        await img._remove_data()
        try:
            # the image journal dies with the image, or a recreated
            # same-name image would inherit (and mirrors would replay)
            # the dead image's events
            await self.ioctx.remove(f"rbd_journal.{name}")
        except FileNotFoundError:
            pass
        await self.ioctx.remove(self._header_oid(name))

    async def list(self) -> List[str]:
        return sorted(
            oid[len("rbd_header."):]
            for oid in await self.ioctx.list_objects()
            if oid.startswith("rbd_header."))

    async def open(self, name: str) -> "Image":
        try:
            blob = await self.ioctx.read(self._header_oid(name))
        except FileNotFoundError:
            raise FileNotFoundError(f"image {name}")
        hdr: ImageHeader = pickle.loads(blob)
        return Image(self.ioctx, hdr)

    async def clone(self, parent_name: str, snap_name: str,
                    child_name: str, timeout: float = None) -> None:
        """COW clone of a parent snapshot (reference librbd::CloneRequest):
        the child starts with NO data objects; reads fall through to the
        parent snap, writes copy-up the touched object first.

        Two-step transaction, crash-consistent: (1) register the child
        in the parent's children table — the snap is now pinned against
        removal BEFORE any child can depend on it; (2) write the child
        header.  A client dying between the two (``rbd_clone_mid``)
        leaves a dangling child entry, which ``snap_remove`` prunes (a
        registered child whose header never landed pins nothing); a
        retry is idempotent (re-registering is a set-insert)."""
        dl = deadline_of(timeout)
        parent = await self.open(parent_name)
        psid = parent.header.snaps.get(snap_name)
        if psid is None:
            raise FileNotFoundError(f"{parent_name}@{snap_name}")
        size = parent.header.snap_sizes.get(psid, parent.header.size)
        hdr = ImageHeader(name=child_name, size=size,
                          layout=parent.header.layout,
                          parent=(parent_name, psid))
        try:
            await self.ioctx.stat(self._header_oid(child_name),
                                  timeout=remaining(dl))
            raise FileExistsError(child_name)
        except FileNotFoundError:
            pass
        kids = parent.header.children.setdefault(snap_name, [])
        if child_name not in [c for c, _ in kids]:
            kids.append((child_name, time.time()))
            await parent._save_header(timeout=remaining(dl))
        _chaos(self.ioctx, "rbd_clone_mid")
        await self.ioctx.write_full(self._header_oid(child_name),
                                    pickle.dumps(hdr),
                                    timeout=remaining(dl))


class Image:
    """Open image handle (reference librbd::Image).

    Data ops run through a private IoCtx carrying this image's
    SnapContext (librbd keeps its own per-image snapc the same way), so
    snapshots of one image never affect another image's writes.

    ``CLONE_PRUNE_GRACE``: how old a header-less child registration
    must be before ``snap_remove`` deems the cloning client dead and
    prunes its pin (younger registrations may be clones mid-create)."""

    CLONE_PRUNE_GRACE = 30.0

    def __init__(self, ioctx: IoCtx, header: ImageHeader):
        self.ioctx = ioctx
        self._io = IoCtx(ioctx.objecter, ioctx.pool_id)
        self.header = header
        self._fmt = f"rbd_data.{header.name}.%016x"
        self._parent: Optional["Image"] = None
        # per-object copy-up serialization (librbd CopyupRequest holds the
        # object context lock): without it, a second concurrent writer's
        # copy-up write_full could land AFTER the first writer's partial
        # write and clobber its acknowledged bytes with parent data
        self._copyup_locks: Dict[int, asyncio.Lock] = {}
        self._apply_snapc()

    def _apply_snapc(self) -> None:
        sids = sorted(self.header.snaps.values(), reverse=True)
        if sids:
            self._io.set_snap_context(sids[0], sids)
        else:
            self._io._snapc = None

    # -- image journal (reference src/journal JournalRecorder) -------------

    @property
    def _journal_oid(self) -> str:
        return f"rbd_journal.{self.header.name}"

    async def _journal_event(self, event: tuple,
                             timeout: float = None) -> None:
        """Append one replayable event BEFORE applying it (the librbd
        journaling contract: the journal is authoritative for replay)."""
        if not self.header.journaling:
            return
        reply = await self._io.objecter.op_submit(
            self._io.pool_id, self._journal_oid,
            [("exec", {"cls": "rbd_journal", "method": "append",
                       "indata": pickle.dumps(event)})],
            timeout=timeout)
        if reply.result != 0:
            raise IOError(f"journal append -> {reply.result}")

    async def _get_parent(self) -> Optional["Image"]:
        if self.header.parent is None:
            return None
        if self._parent is None:
            pname, _ = self.header.parent
            self._parent = await RBD(self.ioctx).open(pname)
        return self._parent

    # -- metadata -----------------------------------------------------------

    def size(self) -> int:
        return self.header.size

    async def _save_header(self, timeout: float = None) -> None:
        await self.ioctx.write_full(
            RBD._header_oid(self.header.name), pickle.dumps(self.header),
            timeout=timeout)

    async def _refresh_header(self, timeout: float = None) -> None:
        """Re-read the header from RADOS (librbd refresh on header
        watch).  Snapshot mutations refresh FIRST: a stale handle
        otherwise cannot see children a clone registered through its
        own freshly-opened parent handle — and would happily remove a
        snapshot those clones still copy-up from)."""
        blob = await self.ioctx.read(RBD._header_oid(self.header.name),
                                     timeout=timeout)
        self.header = pickle.loads(blob)
        self._apply_snapc()

    async def resize(self, new_size: int) -> None:
        """Grow or shrink; shrinking removes whole dead OBJECT SETS and
        zeroes the partially-live tail, so a later grow reads zeros, not
        resurrected bytes (librbd resize + trim)."""
        await self._journal_event(("resize", new_size))
        old = self.header.size
        if new_size < old:
            layout = self.header.layout
            period = layout.object_size * layout.stripe_count
            live_sets = (new_size + period - 1) // period
            old_sets = (old + period - 1) // period
            # zero the live tail of the last partially-used period
            tail_end = min(old, live_sets * period)
            if tail_end > new_size:
                zeros = b"\0" * (tail_end - new_size)
                await self.write(new_size, zeros, _size_check=old,
                                 _journal=False)
            # drop every object of fully-dead sets (through the snapc io:
            # a snapshotted image's shrink must clone-on-write, so snaps
            # keep reading the pre-shrink bytes)
            for objno in range(live_sets * layout.stripe_count,
                               old_sets * layout.stripe_count):
                try:
                    await self._io.remove(self._fmt % objno)
                except (IOError, FileNotFoundError):
                    pass
        self.header.size = new_size
        await self._save_header()

    async def snap_create(self, snap_name: str,
                          timeout: float = None) -> int:
        """Point-in-time snapshot (reference librbd snap_create:
        selfmanaged RADOS snap id + SnapContext on subsequent writes, so
        the OSD clone-on-writes every later mutation).

        Crash-consistency: the snap only EXISTS once the header save
        lands — a client dying between the id allocation and the save
        (``rbd_snap_pre_header``) leaks one snap id and nothing else
        (no header lists it, no SnapContext carries it, so no read can
        ever resolve to it and no write COWs against it); the retried
        create allocates a fresh id and is the one that counts."""
        dl = deadline_of(timeout)
        await self._refresh_header(timeout=remaining(dl))
        if snap_name in self.header.snaps:
            raise FileExistsError(snap_name)
        sid = await self._io.selfmanaged_snap_create()
        self.header.snaps[snap_name] = sid
        self.header.snap_sizes[sid] = self.header.size
        _chaos(self._io, "rbd_snap_pre_header")
        self._apply_snapc()
        await self._save_header(timeout=remaining(dl))
        return sid

    async def snap_remove(self, snap_name: str,
                          timeout: float = None) -> None:
        """Drops the snap and lets the OSD trimmer reclaim its clones.
        Refused while clone children depend on it (reference: a
        protected snapshot with children returns -EBUSY) — that pin is
        what keeps clone parents immutable.  Children registered by a
        clone that died before its header landed (``rbd_clone_mid``)
        are pruned here: a header-less child pins nothing."""
        dl = deadline_of(timeout)
        await self._refresh_header(timeout=remaining(dl))
        kids = self.header.children.get(snap_name, [])
        if kids:
            live = []
            now = time.time()
            for child, stamp in kids:
                try:
                    await self.ioctx.stat(RBD._header_oid(child),
                                          timeout=remaining(dl))
                    live.append((child, stamp))
                except FileNotFoundError:
                    # header missing: either the cloning client died
                    # mid-create (prunable) or it is STILL IN FLIGHT
                    # between registration and header write — inside
                    # the grace window the registration keeps its pin
                    # (removing the snap under a live clone would be
                    # silent child data loss)
                    if now - stamp <= self.CLONE_PRUNE_GRACE:
                        live.append((child, stamp))
            if live != kids:
                if live:
                    self.header.children[snap_name] = live
                else:
                    self.header.children.pop(snap_name, None)
                await self._save_header(timeout=remaining(dl))
            if live:
                raise OSError(16, f"snapshot {snap_name} has clone "
                                  f"children "
                                  f"{[c for c, _ in live]}")
        sid = self.header.snaps.pop(snap_name)
        self.header.snap_sizes.pop(sid, None)
        self.header.children.pop(snap_name, None)
        self._apply_snapc()
        await self._save_header(timeout=remaining(dl))
        await self._io.selfmanaged_snap_remove(sid)

    def snap_list(self) -> Dict[str, int]:
        return dict(self.header.snaps)

    # -- data path ----------------------------------------------------------

    async def write(self, offset: int, data: bytes,
                    _size_check: int = None,
                    _journal: bool = True,
                    timeout: float = None) -> None:
        dl = deadline_of(timeout)
        limit = self.header.size if _size_check is None else _size_check
        if offset + len(data) > limit:
            raise ValueError("write past end of image")
        if _journal:
            # internal writes (resize tail-zeroing) must NOT journal:
            # they are implied by the journaled resize event, and their
            # pre-shrink offsets would make the mirror re-grow the
            # secondary past the shrunken size
            await self._journal_event(("write", offset, bytes(data)),
                                      timeout=remaining(dl))
        extents = file_to_extents(self._fmt, self.header.layout,
                                  offset, len(data))
        per_object = StripedReader.scatter(extents, data)
        if self.header.parent is not None:
            # COW copy-up (librbd CopyupRequest): a partial write to an
            # object the child has never written must first materialize
            # the parent snap's bytes, or the untouched part of the
            # object would read back as zeros
            objno_of = {ex.oid: ex.objectno for ex in extents}
            await asyncio.gather(*[
                self._copyup(oid, objno_of[oid], deadline=dl)
                for oid in per_object])
        # per-object writes run concurrently; each is an atomic OSD op
        await asyncio.gather(*[
            self._io.write(oid, blob, offset=obj_off,
                           timeout=remaining(dl))
            for oid, parts in per_object.items()
            for obj_off, blob in parts])

    async def _copyup(self, oid: str, objno: int,
                      deadline: float = None) -> None:
        """Idempotent by construction, which is what makes a client
        dying at ``rbd_copyup_mid`` (parent bytes read, child object
        not yet written) safe to retry: the stat re-checks the child,
        the parent snap read is immutable, and the write_full lands the
        identical bytes — a half-done copy-up is indistinguishable from
        one that never started."""
        lock = self._copyup_locks.setdefault(objno, DepLock("rbd.copyup"))
        async with lock:
            try:
                await self._io.stat(oid, timeout=remaining(deadline))
                return  # child already has this object
            except FileNotFoundError:
                pass
            parent = await self._get_parent()
            if parent is None:
                return
            _, psid = self.header.parent
            try:
                pdata = await parent._io.read(parent._fmt % objno,
                                              snapid=psid,
                                              timeout=remaining(deadline))
            except FileNotFoundError:
                return  # parent sparse here too
            _chaos(self._io, "rbd_copyup_mid")
            if pdata:
                await self._io.write_full(oid, pdata,
                                          timeout=remaining(deadline))

    async def read(self, offset: int, length: int,
                   snap_name: str = None,
                   timeout: float = None) -> bytes:
        """Point-in-time read when ``snap_name`` is given (reference
        librbd snap_set + read: each object read resolves to the clone
        covering the snap at the OSD); unwritten extents of a cloned
        child fall through to the parent snap."""
        dl = deadline_of(timeout)
        snapid = None
        size = self.header.size
        if snap_name is not None:
            snapid = self.header.snaps[snap_name]
            size = self.header.snap_sizes.get(snapid, size)
        length = min(length, max(0, size - offset))
        if length == 0:
            return b""
        extents = file_to_extents(self._fmt, self.header.layout,
                                  offset, length)

        async def fetch(ex):
            try:
                return ex.oid, await self._io.read(
                    ex.oid, offset=ex.offset, length=ex.length,
                    snapid=snapid, timeout=remaining(dl))
            except FileNotFoundError:
                pass
            parent = await self._get_parent()
            if parent is not None:
                _, psid = self.header.parent
                try:
                    return ex.oid, await parent._io.read(
                        parent._fmt % ex.objectno, offset=ex.offset,
                        length=ex.length, snapid=psid,
                        timeout=remaining(dl))
                except FileNotFoundError:
                    pass
            return ex.oid, b""  # sparse: never written

        got = dict(await asyncio.gather(*[fetch(ex) for ex in extents]))
        return StripedReader.assemble(extents, got, length, relative=True)

    async def _remove_data(self) -> None:
        layout = self.header.layout
        period = layout.object_size * layout.stripe_count
        n_sets = (self.header.size + period - 1) // period
        n_objs = n_sets * layout.stripe_count
        for objno in range(n_objs):
            try:
                await self._io.remove(self._fmt % objno)
            except (IOError, FileNotFoundError):
                pass

    async def stat(self) -> Dict:
        return {"size": self.header.size,
                "stripe_unit": self.header.layout.stripe_unit,
                "stripe_count": self.header.layout.stripe_count,
                "object_size": self.header.layout.object_size,
                "snaps": self.snap_list()}

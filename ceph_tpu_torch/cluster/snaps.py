"""Object snapshots: SnapContext, SnapSet, clone naming + read resolution.

Counterpart of ``ceph_tpu/cluster/snaps.py``.

Behavioral analog of the reference snapshot axis that every storage
surface builds on: struct SnapContext (src/common/snap_types.h:41 — seq
+ existent snaps, descending), struct SnapSet (src/osd/osd_types.h:4431
— per-head clone directory: clones ascending, clone_snaps descending,
clone_size), clone-on-write in PrimaryLogPG::make_writeable
(src/osd/PrimaryLogPG.cc:7019), and snap-read resolution in
PrimaryLogPG::find_object_context.

Storage model: clones are ordinary store objects named by
``clone_oid(head, cloneid)``; a store-level ``clone`` transaction op
copies data+xattrs shard-locally (EC pools clone each shard in place —
no data moves over the wire, the ECBackend rollback/clone philosophy).
The SnapSet is pickled into the head's "ss" xattr while the head exists
and onto the snapdir object after head deletion (the reference's snapdir
ghobject)."""

from __future__ import annotations

import pickle
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

# clone/snapdir object naming: NUL can't appear in client oids (the
# tools/librados layer rejects it), so these keys never collide and are
# filtered from client listings by _list_pg_objects
_SEP = "\x00snap\x00"
_SNAPDIR = "\x00snapdir"

SNAP_HEAD: Optional[int] = None  # read the live object


def clone_oid(oid: str, cloneid: int) -> str:
    return f"{oid}{_SEP}{cloneid:016d}"


def snapdir_oid(oid: str) -> str:
    return f"{oid}{_SNAPDIR}"


def is_snap_key(name: str) -> bool:
    """True for clone/snapdir store keys (hidden from client listings)."""
    return _SEP in name or name.endswith(_SNAPDIR)


def head_of(name: str) -> str:
    if _SEP in name:
        return name.split(_SEP, 1)[0]
    if name.endswith(_SNAPDIR):
        return name[: -len(_SNAPDIR)]
    return name


@dataclass(frozen=True)
class SnapContext:
    """snap_types.h:41 — seq is the newest snap id the writer knows;
    snaps lists existent snaps, descending."""

    seq: int = 0
    snaps: Tuple[int, ...] = ()

    def is_valid(self) -> bool:
        if self.snaps and self.seq < self.snaps[0]:
            return False
        return all(self.snaps[i] > self.snaps[i + 1]
                   for i in range(len(self.snaps) - 1))


@dataclass
class SnapSet:
    """osd_types.h:4431 — the per-object clone directory."""

    seq: int = 0
    clones: List[int] = field(default_factory=list)         # ascending
    clone_snaps: Dict[int, List[int]] = field(default_factory=dict)
    clone_size: Dict[int, int] = field(default_factory=dict)
    # snapc.seq at head (re)creation: snaps taken at-or-before it existed
    # before the head did, so they must never resolve to it (the
    # reference encodes this through object_info/whiteout bookkeeping)
    head_since: int = 0
    # mutation counter: stamped onto the snapdir store object so (a)
    # version-gated backfill notices snapset changes (setattr alone never
    # bumps a store version) and (b) a stale snap_sync push can never
    # overwrite a newer snapset (see _handle_push)
    version: int = 0

    def encode(self) -> bytes:
        return pickle.dumps(self)

    @staticmethod
    def decode(blob: Optional[bytes]) -> "SnapSet":
        return pickle.loads(blob) if blob else SnapSet()

    # -- clone-on-write decision (make_writeable, PrimaryLogPG.cc:7019) --

    def needs_clone(self, snapc: Optional[SnapContext],
                    head_exists: bool) -> bool:
        """A mutation under ``snapc`` must preserve the pre-write head
        when snaps newer than our seq exist and there is a head to
        preserve."""
        if snapc is None or not head_exists:
            return False
        return snapc.seq > self.seq and \
            any(s > self.seq for s in snapc.snaps)

    def add_clone(self, snapc: SnapContext, head_size: int) -> int:
        """Record the clone for the snaps in (self.seq, snapc.seq];
        returns the clone id (== snapc.seq, as the reference names
        clones by the snapc seq at write time)."""
        newest = [s for s in snapc.snaps if s > self.seq]  # descending
        cloneid = snapc.seq
        self.clones.append(cloneid)
        self.clone_snaps[cloneid] = newest
        self.clone_size[cloneid] = head_size
        self.seq = snapc.seq
        self.version += 1
        return cloneid

    def advance_seq(self, snapc: Optional[SnapContext]) -> None:
        if snapc is not None and snapc.seq > self.seq:
            self.seq = snapc.seq
            self.version += 1

    # -- snap-read resolution (find_object_context) ----------------------

    def resolve_read(self, snapid: Optional[int],
                     head_exists: bool) -> Tuple[str, Optional[int]]:
        """-> ("head", None) | ("clone", cloneid) | ("enoent", None).

        First clone with cloneid >= snapid serves the read iff the snap
        falls inside its coverage (>= the oldest snap the clone was made
        for); no such clone -> the head (which represents all states
        since the newest clone) if it exists."""
        if snapid is None:
            return ("head", None) if head_exists else ("enoent", None)
        for c in self.clones:
            if c >= snapid:
                covered = self.clone_snaps.get(c, [])
                if covered and snapid >= covered[-1]:
                    return ("clone", c)
                return ("enoent", None)
        if head_exists and snapid > self.head_since:
            return ("head", None)
        return ("enoent", None)

    # -- trimming (snap removal) -----------------------------------------

    def trim(self, removed: set) -> Tuple[List[int], bool]:
        """Drop removed snaps from clone coverage; returns (clone ids
        whose coverage became empty — their objects must be deleted,
        dirty)."""
        dead: List[int] = []
        dirty = False
        for c in list(self.clones):
            snaps = self.clone_snaps.get(c, [])
            kept = [s for s in snaps if s not in removed]
            if kept != snaps:
                dirty = True
                if kept:
                    self.clone_snaps[c] = kept
                else:
                    dead.append(c)
                    self.clones.remove(c)
                    self.clone_snaps.pop(c, None)
                    self.clone_size.pop(c, None)
        if dirty:
            self.version += 1
        return dead, dirty

    @property
    def empty(self) -> bool:
        return not self.clones and self.seq == 0


# -- store-facing helpers (shared by both PG backends) ---------------------
#
# The SnapSet lives in the "ss" xattr of the snapdir object — ONE
# location whether or not the head exists (the reference migrates it
# between head and snapdir; a fixed home is simpler and equivalent).
# All ops are plain store-transaction tuples so they ride the replicated
# txn fan-out / EC sub-write pre_ops unchanged.

def load_snapset(store, coll: str, oid: str) -> SnapSet:
    return SnapSet.decode(store.getattr(coll, snapdir_oid(oid), "ss"))


def make_writeable_ops(store, coll: str, oid: str,
                       snapc_raw, head_size: int):
    """Clone-on-write decision for a mutation of ``oid`` under snapc
    (PrimaryLogPG::make_writeable analog).  Returns (pre_ops, cloned):
    store-level ops to apply atomically BEFORE the mutation.  snapc_raw
    is the wire form (seq, (snaps...)) or None."""
    if snapc_raw is None:
        return [], False
    snapc = SnapContext(seq=snapc_raw[0], snaps=tuple(snapc_raw[1]))
    if not snapc.is_valid():
        return [], False
    ss = load_snapset(store, coll, oid)
    head_exists = store.stat(coll, oid) is not None
    ops = []
    cloned = False
    if ss.needs_clone(snapc, head_exists):
        cid = ss.add_clone(snapc, head_size)
        ops.append(("clone", coll, oid, clone_oid(oid, cid)))
        cloned = True
    else:
        if snapc.seq <= ss.seq and (head_exists or
                                    snapc.seq <= ss.head_since):
            return [], False  # nothing new to record
        if not head_exists and snapc.seq > ss.head_since:
            # head (re)creation: snaps <= snapc.seq predate it
            ss.head_since = snapc.seq
            ss.version += 1
        ss.advance_seq(snapc)
    ops.extend(snapset_ops(coll, oid, ss))
    return ops, cloned


def snapset_ops(coll: str, head: str, ss: SnapSet):
    """Persist a SnapSet: the xattr plus a version stamp on the snapdir
    store object (setattr alone never bumps a store version, which would
    make version-gated backfill skip snapset changes forever)."""
    sd = snapdir_oid(head)
    return [("setattr", coll, sd, "ss", ss.encode()),
            ("set_version", coll, sd, ss.version)]


def prune_clone_ops(store, coll: str, head: str, ss: SnapSet):
    """Remove-ops for clone objects the SnapSet no longer lists."""
    live = {clone_oid(head, c) for c in ss.clones}
    prefix = head + _SEP
    return [("remove", coll, name) for name in store.list_objects(coll)
            if name.startswith(prefix) and name not in live]


def trim_ops(store, coll: str, snapdir_key: str, removed: set):
    """Snap-trim one object's snapset (reference PrimaryLogPG::SnapTrimmer):
    returns store ops deleting fully-trimmed clones + persisting the
    shrunk snapset, or [] when this object is untouched."""
    head = head_of(snapdir_key)
    ss = SnapSet.decode(store.getattr(coll, snapdir_key, "ss"))
    dead, dirty = ss.trim(removed)
    if not dirty:
        return []
    ops = [("remove", coll, clone_oid(head, c)) for c in dead]
    ops.extend(snapset_ops(coll, head, ss))
    return ops

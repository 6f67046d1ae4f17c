"""ObjectStore + Transaction, with a MemStore implementation.

Counterpart of ``ceph_tpu/cluster/store.py``.

Mirrors the reference's storage contract (src/os/ObjectStore.h:1470-1498):
every mutation is an ordered, atomic Transaction of typed ops applied to
collections of objects (data + xattrs + omap), and MemStore
(src/os/memstore/MemStore.cc) is the in-RAM implementation backing tests
and the dev cluster.
"""

from __future__ import annotations

import pickle
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster.optracker import mark_current
from ceph_tpu_torch.ec import planar_store


@dataclass
class Obj:
    data: bytearray = field(default_factory=bytearray)
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    omap: Dict[str, bytes] = field(default_factory=dict)
    version: int = 0
    # at-rest data layout: None = classic bytes; planar_store.LAYOUT_PLANAR
    # means ``data`` holds the shard's (8, L/8) packed bit-plane matrix
    # serialized row-major (round 19).  Same byte length either way, so
    # _used/statfs/stat need no layout awareness.
    layout: Optional[str] = None


class Transaction:
    """Ordered op list; atomic at queue_transaction."""

    def __init__(self):
        self.ops: List[Tuple] = []

    def create_collection(self, coll: str):
        self.ops.append(("create_collection", coll))
        return self

    def remove_collection(self, coll: str):
        self.ops.append(("remove_collection", coll))
        return self

    def write(self, coll: str, oid: str, offset: int, data: bytes):
        self.ops.append(("write", coll, oid, offset, bytes(data)))
        return self

    def write_planar(self, coll: str, oid: str, plane_off: int,
                     data: bytes, total_cols: int):
        """Planar-at-rest shard write (round 19): land ``data`` — an
        (8, wc) plane-column window serialized row-major — at plane
        column ``plane_off`` (= byte offset / 8) and size the object to
        exactly ``total_cols`` columns (= shard bytes / 8).  One op
        covers the byte path's write+truncate pair, and the object's
        layout becomes planar."""
        self.ops.append(("write_planar", coll, oid, plane_off,
                         bytes(data), total_cols))
        return self

    def truncate(self, coll: str, oid: str, size: int):
        self.ops.append(("truncate", coll, oid, size))
        return self

    def remove(self, coll: str, oid: str):
        self.ops.append(("remove", coll, oid))
        return self

    def clone(self, coll: str, src: str, dst: str):
        """Full-object copy (data + xattrs + omap), the COW primitive of
        the snapshot axis (reference ObjectStore::Transaction::clone)."""
        self.ops.append(("clone", coll, src, dst))
        return self

    def rb_capture(self, coll: str, oid: str, rb_oid: str, key: str):
        """Snapshot THIS store's current state of ``oid`` into the
        rollback journal object's omap under ``key`` — evaluated locally
        by each member so a fanned-out transaction captures each member's
        OWN pre-op bytes (EC shards differ per member; the reference
        attaches rollback info to the local transaction the same way,
        ecbackend.rst:10-27)."""
        self.ops.append(("rb_capture", coll, oid, rb_oid, key))
        return self

    def setattr(self, coll: str, oid: str, name: str, value: bytes):
        self.ops.append(("setattr", coll, oid, name, bytes(value)))
        return self

    def rmattr(self, coll: str, oid: str, name: str):
        self.ops.append(("rmattr", coll, oid, name))
        return self

    def omap_set(self, coll: str, oid: str, kv: Dict[str, bytes]):
        self.ops.append(("omap_set", coll, oid, dict(kv)))
        return self

    def omap_rmkeys(self, coll: str, oid: str, keys: List[str]):
        self.ops.append(("omap_rmkeys", coll, oid, list(keys)))
        return self

    def touch(self, coll: str, oid: str):
        self.ops.append(("touch", coll, oid))
        return self

    def set_version(self, coll: str, oid: str, version: int):
        self.ops.append(("set_version", coll, oid, version))
        return self

    def encode(self) -> bytes:
        return pickle.dumps(self.ops)

    @classmethod
    def decode(cls, blob: bytes) -> "Transaction":
        t = cls()
        t.ops = pickle.loads(blob)
        return t


class ObjectStore:
    # disk fault injector (ceph_tpu/chaos/disk.py DiskInjector), the
    # filestore_debug_inject_read_err analog; None (the default) keeps
    # every hot path to a single `is None` test
    chaos = None

    def mount(self) -> None: ...

    def umount(self) -> None: ...

    def debug_bitrot(self, coll: str, oid: str, bit: int) -> None:
        """Flip one stored bit WITHOUT touching any checksum — the
        silent-corruption seam the disk injector drives."""
        raise NotImplementedError

    def statfs(self) -> Tuple[int, int]:
        """(total_bytes, used_bytes) — reference ObjectStore::statfs."""
        return (0, 0)

    def queue_transaction(self, txn: Transaction) -> None:
        raise NotImplementedError

    def read(self, coll: str, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        raise NotImplementedError

    def read_planar(self, coll: str, oid: str) -> bytes:
        raise NotImplementedError

    def object_layout(self, coll: str, oid: str) -> Optional[str]:
        """At-rest layout tag (None = bytes / missing / unsupported)."""
        return None

    def stat(self, coll: str, oid: str) -> Optional[int]:
        raise NotImplementedError


class MemStore(ObjectStore):
    def __init__(self, device_bytes: int = 1 << 30):
        self._colls: Dict[str, Dict[str, Obj]] = {}
        self._lock = threading.RLock()
        # advertised AND enforced capacity (memstore_device_bytes
        # analog): statfs reports against it, and (round 16) a
        # transaction whose net data growth would exceed it is refused
        # whole with ENOSPC — the store-level backstop beneath the
        # mon's full-flag protection.  Used bytes are maintained
        # incrementally (_used) so neither statfs nor admission pays an
        # all-objects scan on the hot path.
        self.device_bytes = device_bytes
        self._used = 0

    # -- transaction application (atomic under lock) -----------------------

    def _txn_growth(self, txn: Transaction) -> int:
        """Net DATA bytes this transaction would add (write extensions,
        upward truncates, clones), credited for its own removes/shrinks
        — so a delete-and-rewrite txn admits whenever its net effect
        fits.  Attr/omap bytes are not counted, matching statfs."""
        grow = 0
        sizes: Dict[Tuple[str, str], int] = {}

        def cur(coll: str, oid: str) -> int:
            key = (coll, oid)
            if key not in sizes:
                o = self._colls.get(coll, {}).get(oid)
                sizes[key] = len(o.data) if o is not None else 0
            return sizes[key]

        for op in txn.ops:
            kind = op[0]
            if kind == "write":
                _, coll, oid, offset, data = op
                new = max(cur(coll, oid), offset + len(data))
                grow += new - sizes[(coll, oid)]
                sizes[(coll, oid)] = new
            elif kind == "write_planar":
                _, coll, oid, _plane_off, _data, total_cols = op
                # one op fixes the final size exactly: 8 plane rows of
                # total_cols packed bytes == the shard's byte length, so
                # planar admission counts TRUE plane bytes (satellite:
                # same ENOSPC behavior as the byte anchor)
                new = 8 * total_cols
                grow += new - cur(coll, oid)
                sizes[(coll, oid)] = new
            elif kind == "truncate":
                _, coll, oid, size = op
                grow += size - cur(coll, oid)
                sizes[(coll, oid)] = size
            elif kind == "clone":
                _, coll, src, dst = op
                grow += cur(coll, src) - cur(coll, dst)
                sizes[(coll, dst)] = sizes[(coll, src)]
            elif kind == "remove":
                _, coll, oid = op
                grow -= cur(coll, oid)
                sizes[(coll, oid)] = 0
            elif kind == "remove_collection":
                for oid, o in self._colls.get(op[1], {}).items():
                    grow -= len(o.data)
                    sizes[(op[1], oid)] = 0
        return grow

    def _check_capacity(self, txn: Transaction) -> None:
        """Refuse a transaction whose net data growth would exceed the
        enforced capacity — WHOLE, before any byte lands (atomicity,
        like the injected ENOSPC).  Deletes and shrinks (grow <= 0)
        always admit, so a full store can dig itself out.  Shared by
        MemStore and the journal-backed FileStore subclass (which must
        check BEFORE journaling, or replay would re-meet the frame)."""
        if not self.device_bytes:
            return
        with self._lock:
            grow = self._txn_growth(txn)
            if grow > 0 and self._used + grow > self.device_bytes:
                raise OSError(
                    28, f"store full: {self._used} used + "
                        f"{grow} > {self.device_bytes}")

    def queue_transaction(self, txn: Transaction) -> None:
        if self.chaos is not None:
            # injected ENOSPC refuses the WHOLE txn before any byte
            # lands (atomicity preserved)
            self.chaos.on_write(txn)
        self._check_capacity(txn)
        self._commit(txn)
        if self.chaos is not None:
            self.chaos.maybe_rot(self, txn)
        # store-commit boundary on the current op's timeline (no-op
        # outside a tracked dispatch — recovery, replicas, scrub)
        mark_current("store:commit")

    def _commit(self, txn: Transaction) -> None:
        with self._lock:
            for op in txn.ops:
                self._apply(op)

    def _apply(self, op: Tuple) -> None:
        kind = op[0]
        if kind == "create_collection":
            self._colls.setdefault(op[1], {})
        elif kind == "remove_collection":
            dropped = self._colls.pop(op[1], None)
            if dropped:
                self._used -= sum(len(o.data) for o in dropped.values())
        elif kind == "touch":
            self._coll(op[1]).setdefault(op[2], Obj())
        elif kind == "write":
            _, coll, oid, offset, data = op
            o = self._coll(coll).setdefault(oid, Obj())
            old = len(o.data)
            end = offset + len(data)
            if o.layout == planar_store.LAYOUT_PLANAR:
                # byte write onto a planar object: the object leaves
                # planar-at-rest.  A full rewrite just drops the layout;
                # a partial overlay must land on LOGICAL bytes, so
                # materialize once (counted relayout) before splicing.
                if not (offset == 0 and old <= end):
                    o.data[:] = planar_store.planes_to_shard(
                        planar_store.blob_to_planes(bytes(o.data)),
                        seam="relayout")
                o.layout = None
            if offset == 0 and len(o.data) <= end:
                # full rewrite/extend from 0 (the EC full-shard write):
                # one copy, no zero-fill of bytes about to be replaced
                o.data[:] = data
            else:
                if len(o.data) < end:
                    o.data.extend(b"\0" * (end - len(o.data)))
                o.data[offset:end] = data
            o.version += 1
            self._used += len(o.data) - old
        elif kind == "write_planar":
            _, coll, oid, plane_off, data, total_cols = op
            o = self._coll(coll).setdefault(oid, Obj())
            old = len(o.data)
            window = planar_store.blob_to_planes(data)
            if o.data and o.layout == planar_store.LAYOUT_PLANAR:
                cur = planar_store.blob_to_planes(bytes(o.data))
            elif o.data:
                # a planar write landing on a byte-at-rest object: the
                # config gate flipped mid-life — convert once, counted
                # (zero-pad to the 8-byte packing quantum; EC shards are
                # stripe-unit aligned so this is a non-EC-object guard)
                raw = bytes(o.data)
                if len(raw) % 8:
                    raw += b"\0" * (8 - len(raw) % 8)
                cur = planar_store.shard_to_planes(raw, seam="relayout")
            else:
                cur = None
            merged = planar_store.splice_columns(
                cur, plane_off, window, total_cols)
            o.data[:] = planar_store.planes_to_blob(merged)
            o.layout = planar_store.LAYOUT_PLANAR
            o.version += 1
            self._used += len(o.data) - old
        elif kind == "truncate":
            _, coll, oid, size = op
            o = self._coll(coll).setdefault(oid, Obj())
            old = len(o.data)
            if o.layout == planar_store.LAYOUT_PLANAR and old != size:
                # byte truncate of a planar object cuts PLANE ROWS, not
                # logical bytes — leave planar first (counted relayout)
                o.data[:] = planar_store.planes_to_shard(
                    planar_store.blob_to_planes(bytes(o.data)),
                    seam="relayout")
                o.layout = None
            if len(o.data) > size:
                del o.data[size:]
            else:
                o.data.extend(b"\0" * (size - len(o.data)))
            o.version += 1
            self._used += len(o.data) - old
        elif kind == "remove":
            dropped = self._coll(op[1]).pop(op[2], None)
            if dropped is not None:
                self._used -= len(dropped.data)
        elif kind == "clone":
            _, coll, src, dst = op
            s = self._coll(coll).get(src)
            if s is not None:
                prev = self._coll(coll).get(dst)
                self._used += len(s.data) - \
                    (len(prev.data) if prev is not None else 0)
                self._coll(coll)[dst] = Obj(
                    data=bytearray(s.data), xattrs=dict(s.xattrs),
                    omap=dict(s.omap), version=s.version,
                    layout=s.layout)
        elif kind == "rb_capture":
            _, coll, oid, rb_oid, key = op
            o = self._coll(coll).get(oid)
            rec = {
                "oid": oid, "existed": o is not None, "chunk_off": 0,
                "old_range": bytes(o.data) if o else b"",
                "old_total": len(o.data) if o else 0,
                "old_attrs": ({k: o.xattrs.get(k)
                               for k in ("shard", "size", "hinfo_crc")}
                              if o else {}),
                "old_version": o.version if o else 0,
                # at-rest layout travels with the rollback record so a
                # rewind restores planar objects AS planar (pg.py
                # rewind_divergent_log dispatches on it)
                "layout": o.layout if o else None,
            }
            self._coll(coll).setdefault(rb_oid, Obj()).omap[key] = \
                pickle.dumps(rec)
        elif kind == "setattr":
            _, coll, oid, name, value = op
            self._coll(coll).setdefault(oid, Obj()).xattrs[name] = value
        elif kind == "rmattr":
            _, coll, oid, name = op
            o = self._coll(coll).get(oid)
            if o is not None:
                o.xattrs.pop(name, None)
        elif kind == "omap_set":
            _, coll, oid, kv = op
            self._coll(coll).setdefault(oid, Obj()).omap.update(kv)
        elif kind == "omap_rmkeys":
            _, coll, oid, keys = op
            o = self._coll(coll).get(oid)
            if o is not None:
                for k in keys:
                    o.omap.pop(k, None)
        elif kind == "set_version":
            _, coll, oid, version = op
            self._coll(coll).setdefault(oid, Obj()).version = version
        else:
            raise ValueError(f"unknown transaction op {kind}")

    def _coll(self, coll: str) -> Dict[str, Obj]:
        return self._colls.setdefault(coll, {})

    # -- reads -------------------------------------------------------------

    def read(self, coll: str, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        if self.chaos is not None:
            self.chaos.on_read(coll, oid)
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            if o is None:
                raise FileNotFoundError(f"{coll}/{oid}")
            if o.layout == planar_store.LAYOUT_PLANAR and o.data:
                # byte view of a planar object OUTSIDE the sanctioned
                # seams (egress of last resort): correct, but it books
                # the ``unseamed`` counter the steady-state contract
                # pins to zero — EC hot paths must use read_planar.
                data = planar_store.planes_to_shard(  # graftlint: ignore[planar-conversion-hygiene]
                    planar_store.blob_to_planes(bytes(o.data)),
                    seam="unseamed")
                if length is None:
                    return data[offset:]
                return data[offset : offset + length]
            if length is None:
                return bytes(o.data[offset:])
            return bytes(o.data[offset : offset + length])

    def read_planar(self, coll: str, oid: str) -> bytes:
        """The at-rest plane blob of a planar object, as stored — ZERO
        layout conversion.  Callers gate on object_layout first; a
        byte-at-rest object raises (mixed generations are the caller's
        relayout decision, not a silent conversion here)."""
        if self.chaos is not None:
            self.chaos.on_read(coll, oid)
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            if o is None:
                raise FileNotFoundError(f"{coll}/{oid}")
            if o.layout != planar_store.LAYOUT_PLANAR:
                raise ValueError(f"{coll}/{oid} is not planar-at-rest")
            return bytes(o.data)

    def object_layout(self, coll: str, oid: str) -> Optional[str]:
        """At-rest layout tag (None = bytes / missing object)."""
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return None if o is None else o.layout

    def debug_bitrot(self, coll: str, oid: str, bit: int) -> None:
        """Silent in-place bit flip (no version bump, no attr change):
        only a checksum-verifying reader — deep scrub comparing against
        the stored hinfo crc — can tell."""
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            if o is None or not o.data:
                raise FileNotFoundError(f"{coll}/{oid}")
            byte, shift = divmod(bit % (len(o.data) * 8), 8)
            o.data[byte] ^= 1 << shift

    def stat(self, coll: str, oid: str) -> Optional[int]:
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return None if o is None else len(o.data)

    def get_version(self, coll: str, oid: str) -> int:
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return 0 if o is None else o.version

    def getattr(self, coll: str, oid: str, name: str) -> Optional[bytes]:
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return None if o is None else o.xattrs.get(name)

    def omap_get(self, coll: str, oid: str) -> Dict[str, bytes]:
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return {} if o is None else dict(o.omap)

    def get_xattrs(self, coll: str, oid: str) -> Dict[str, bytes]:
        with self._lock:
            o = self._colls.get(coll, {}).get(oid)
            return {} if o is None else dict(o.xattrs)

    def list_objects(self, coll: str) -> List[str]:
        with self._lock:
            return sorted(self._colls.get(coll, {}))

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._colls)

    def _recount_used(self) -> None:
        """Rebuild the incremental used-bytes counter from the object
        map — for mount paths that restore ``_colls`` wholesale (the
        FileStore checkpoint load) instead of replaying ops."""
        with self._lock:
            self._used = sum(len(o.data) for c in self._colls.values()
                             for o in c.values())

    def statfs(self) -> Tuple[int, int]:
        with self._lock:
            return (self.device_bytes, self._used)

"""BlueStore-analog: block-device layout, extent allocator, kv-backed
onode metadata, checksum verified on EVERY read.

Counterpart of ``ceph_tpu/cluster/bluestore.py``.

Behavioral mirror of the reference's flagship store
(src/os/bluestore/BlueStore.cc): object DATA lives in 4 KiB blocks on a
raw block "device" (one flat file here) placed by a bitmap allocator
(BitmapAllocator analog); per-object metadata — extent map, per-block
crc32c, xattrs, omap, version — is an ONODE in a write-ahead-logged kv
(the RocksDB/BlueFS analog: append-only WAL + checkpoint, kept tiny and
replayed at mount); every read recomputes block checksums against the
onode (_verify_csum, BlueStore.cc:9012,3703-3709 — silent media
corruption surfaces as EIO, never as returned garbage).

Write path is COW: new bytes land in FRESHLY allocated blocks; old
blocks free once the onode points at the new ones, so a torn write can
never corrupt committed data.  Transactions ride the kv WAL whole
(i.e. small writes are journaled — the shape of BlueStore's DEFERRED
write path; the reference skips the journal for large non-deferred
writes, a documented simplification here), and replay re-runs them
against fresh allocations idempotently.

Unlike FileStore's pickle-the-world checkpoint, checkpointing is
O(onode metadata): object DATA never rewrites on checkpoint — the block
device holds it exactly once.

Block checksums are computed in batches, not one call per block: every
block a transaction (or a replayed WAL frame) writes is staged, and when
the transaction's ops have run, one ``crc32c_rows`` call over an
``(n_blocks, BLOCK)`` array computes all their csums; a read verifies all
the blocks it touches in one such call.  The csum values, block numbers
and the EIO on a mismatch are the reference's.  The WAL and the kv
checkpoint are pickles of this package's own classes; each package reads
only its own files.
"""

from __future__ import annotations

import os
import pickle
import struct
import threading
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.cluster.store import ObjectStore, Transaction
from ceph_tpu_torch.ec import planar_store
from ceph_tpu_torch.ops import crc32c as crcmod

BLOCK = 4096
SUPER_BLOCKS = 16                    # reserved: superblock region
_FRAME = struct.Struct("<I")


@dataclass
class Onode:
    """Per-object metadata (bluestore_onode_t analog)."""

    size: int = 0
    blocks: List[int] = field(default_factory=list)   # logical idx -> blkno
    csums: List[int] = field(default_factory=list)    # per-block crc32c
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    omap: Dict[str, bytes] = field(default_factory=dict)
    version: int = 0
    # at-rest data layout (round 19): None = bytes; planar8 means the
    # blocks hold the shard's packed bit-plane matrix row-major.  Read
    # with getattr(o, "layout", None) — kv checkpoints written before
    # this field existed unpickle without it.
    layout: Optional[str] = None


class BitmapAllocator:
    """Free-block bitmap (reference BitmapAllocator): first-fit block
    allocation; contiguity is incidental (extents are per-block)."""

    def __init__(self, n_blocks: int):
        self.free = bytearray(b"\x01" * n_blocks)
        self.hint = 0
        self.n_free = n_blocks

    def alloc(self, n: int) -> List[int]:
        if n > self.n_free:
            raise OSError(28, "ENOSPC: block device full")
        out: List[int] = []
        i = self.hint
        total = len(self.free)
        scanned = 0
        while len(out) < n and scanned <= total:
            if self.free[i]:
                self.free[i] = 0
                out.append(i)
            i = (i + 1) % total
            scanned += 1
        if len(out) < n:           # bitmap said free but scan missed: bug
            for b in out:
                self.free[b] = 1
            raise OSError(28, "ENOSPC: allocator inconsistency")
        self.hint = i
        self.n_free -= n
        return out

    def release(self, blocks: List[int]) -> None:
        for b in blocks:
            if not self.free[b]:
                self.free[b] = 1
                self.n_free += 1


class BlueStore(ObjectStore):
    def __init__(self, path: str, size: int = 256 << 20,
                 checkpoint_every: int = 512, fsync: bool = False):
        self.path = path
        self.device_size = size
        # the superblock region is reserved: allocatable blocks must all
        # land INSIDE the declared device size
        self.n_blocks = max(0, size // BLOCK - SUPER_BLOCKS)
        self.fsync = fsync
        self.checkpoint_every = checkpoint_every
        self._onodes: Dict[str, Dict[str, Onode]] = {}   # coll -> oid -> onode
        self._lock = threading.RLock()
        self._dev = None
        self._wal = None
        self._since_ckpt = 0
        self._mounted = False
        self.alloc = BitmapAllocator(self.n_blocks)
        # blocks written by the running transaction whose csums are not
        # computed yet: blkno -> the bytes written, and the (onode, idx,
        # blkno) slots that take their csum at ``_flush_csums``
        self._staged: Dict[int, bytes] = {}
        self._staged_slots: List[Tuple[Onode, int, int]] = []

    # -- paths -------------------------------------------------------------

    @property
    def _block_path(self):
        return os.path.join(self.path, "block")

    @property
    def _kv_path(self):
        return os.path.join(self.path, "kv.ckpt")

    @property
    def _wal_path(self):
        return os.path.join(self.path, "kv.wal")

    # -- mount/umount ------------------------------------------------------

    def mount(self) -> None:
        os.makedirs(self.path, exist_ok=True)
        if not os.path.exists(self._block_path):
            with open(self._block_path, "wb") as f:
                f.truncate(self.device_size)
        # r+b, NOT append mode: append mode ignores seek() on write and
        # every block would land at EOF
        self._dev = open(self._block_path, "r+b")
        if os.path.exists(self._kv_path):
            with open(self._kv_path, "rb") as f:
                self._onodes = pickle.load(f)
        # freelist BEFORE replay: replayed writes allocate fresh blocks,
        # and an all-free bitmap would hand them blocks the checkpointed
        # onodes already own — clobbering committed data
        self._rebuild_allocator()
        # WAL replay: metadata txns since the last kv checkpoint
        if os.path.exists(self._wal_path):
            with open(self._wal_path, "rb") as f:
                while True:
                    hdr = f.read(4)
                    if len(hdr) < 4:
                        break
                    (n,) = _FRAME.unpack(hdr)
                    blob = f.read(n)
                    if len(blob) < n:
                        break  # torn tail: discard
                    txn = Transaction.decode(blob)
                    with self._lock:
                        self._apply_txn(txn, replay=True)
        self._wal = open(self._wal_path, "ab")
        self._mounted = True

    def _rebuild_allocator(self) -> None:
        """Free map = everything not referenced by an onode (the mount-
        time freelist rebuild, reference fsck/allocation recovery)."""
        self.alloc = BitmapAllocator(self.n_blocks)
        used: List[int] = []
        for coll in self._onodes.values():
            for o in coll.values():
                used.extend(b for b in o.blocks if b >= 0)
        for b in used:
            if self.alloc.free[b]:
                self.alloc.free[b] = 0
                self.alloc.n_free -= 1

    def umount(self) -> None:
        if self._mounted:
            self.checkpoint()
            self._wal.close()
            self._wal = None
            self._dev.close()
            self._dev = None
            self._mounted = False

    def crash(self, torn_tail: bool = False, lose_frames: int = 0) -> None:
        """Power-cut stop (chaos disk injector): close WITHOUT the
        clean kv checkpoint, drop RAM onode state, optionally damage the
        kv WAL tail (torn frame / lost frames).  mount() then replays
        checkpoint + surviving WAL over the block device like a machine
        that lost power mid-write."""
        from ceph_tpu_torch.cluster.filestore import _damage_journal

        if not self._mounted:
            return
        self._wal.close()
        self._wal = None
        self._dev.close()
        self._dev = None
        self._mounted = False
        self._onodes = {}
        self._since_ckpt = 0
        self._staged.clear()
        self._staged_slots.clear()
        _damage_journal(self._wal_path, torn_tail, lose_frames)

    def debug_bitrot(self, coll: str, oid: str, bit: int) -> None:
        """Flip one bit of the object's stored data ON THE DEVICE,
        leaving the onode csums untouched: the next read of that block
        raises EIO (the csum-verify path) — silent media corruption
        exactly as BlueStore meets it."""
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            if o is None or o.size == 0:
                raise FileNotFoundError(f"{coll}/{oid}")
            bit %= o.size * 8
            idx = (bit // 8) // BLOCK
            blkno = o.blocks[idx]
            if blkno < 0:
                raise ValueError(f"{coll}/{oid} block {idx} is a hole")
            off = (SUPER_BLOCKS + blkno) * BLOCK + (bit // 8) % BLOCK
            self._dev.seek(off)
            cur = self._dev.read(1)
            self._dev.seek(off)
            self._dev.write(bytes([cur[0] ^ (1 << (bit % 8))]))
            self._dev.flush()

    def checkpoint(self) -> None:
        """Atomic ONODE-kv snapshot + WAL truncate: O(metadata), never
        O(data) — the block device is untouched."""
        tmp = self._kv_path + ".tmp"
        with self._lock:
            if self._wal is None:
                return
            with open(tmp, "wb") as f:
                pickle.dump(self._onodes, f)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, self._kv_path)
            self._wal.close()
            self._wal = open(self._wal_path, "wb")
            self._since_ckpt = 0

    # -- block IO ----------------------------------------------------------

    def _write_block(self, o: Onode, idx: int, blkno: int,
                     data: bytes) -> None:
        """Write one block to the device and stage it: its csum lands
        in ``o.csums[idx]`` at the transaction's ``_flush_csums``."""
        assert len(data) <= BLOCK
        if len(data) < BLOCK:
            data = data + b"\0" * (BLOCK - len(data))
        off = (SUPER_BLOCKS + blkno) * BLOCK
        self._dev.seek(off)
        self._dev.write(data)
        self._staged[blkno] = data
        self._staged_slots.append((o, idx, blkno))

    def _flush_csums(self) -> None:
        """csums of every block staged since the last flush, in ONE
        batched crc call (the reference's per-block ``crc32c(~0,
        block)`` values).  A slot whose onode has since moved on to
        another block (COW overwrite, truncate, remove) keeps what it
        has."""
        if not self._staged:
            return
        blknos = list(self._staged)
        rows = np.frombuffer(b"".join(self._staged[b] for b in blknos),
                             dtype=np.uint8).reshape(len(blknos), BLOCK)
        crcs = dict(zip(blknos, crcmod.crc32c_rows(rows)))
        for o, idx, blkno in self._staged_slots:
            if idx < len(o.blocks) and o.blocks[idx] == blkno:
                o.csums[idx] = crcs[blkno]
        self._staged.clear()
        self._staged_slots.clear()

    def _read_blocks(self, coll: str, oid: str, o: Onode, first: int,
                     last: int) -> bytes:
        """Blocks ``first..last`` of ``o``, csum-verified on EVERY read
        (BlueStore.cc:9012) in one batched crc call: silent media
        corruption becomes EIO — for the first bad block, as a per-block
        check would raise it — never returned bytes.  Holes read as
        zeros; a block staged by the running transaction reads back as
        written (its csum is not computed yet)."""
        chunks: List[bytes] = []
        check: List[Tuple[int, int, int]] = []   # (chunk, idx, blkno)
        for idx in range(first, last + 1):
            blkno = o.blocks[idx]
            if blkno < 0:
                chunks.append(b"\0" * BLOCK)      # hole
                continue
            staged = self._staged.get(blkno)
            if staged is not None:
                chunks.append(staged)
                continue
            self._dev.seek((SUPER_BLOCKS + blkno) * BLOCK)
            chunks.append(self._dev.read(BLOCK))
            check.append((len(chunks) - 1, idx, blkno))
        if check:
            rows = np.frombuffer(b"".join(chunks[c] for c, _i, _b in check),
                                 dtype=np.uint8).reshape(len(check), BLOCK)
            got = crcmod.crc32c_rows(rows)
            for (_c, idx, blkno), crc in zip(check, got):
                if crc != o.csums[idx]:
                    raise IOError(f"csum mismatch {coll}/{oid} block {idx} "
                                  f"(blk {blkno})")
        return b"".join(chunks)

    def _read_block(self, coll: str, oid: str, o: Onode, idx: int) -> bytes:
        return self._read_blocks(coll, oid, o, idx, idx)

    # -- transaction application -------------------------------------------

    def queue_transaction(self, txn: Transaction) -> None:
        if not self._mounted:
            raise RuntimeError("BlueStore not mounted")
        if self.chaos is not None:
            # injected ENOSPC: refuse the whole txn up front, exactly
            # like the real up-front capacity check below
            self.chaos.on_write(txn)
        with self._lock:
            # up-front capacity check: a mid-transaction ENOSPC would
            # leave half-applied onode state with no rollback, which the
            # next checkpoint would bless as committed truth
            need = self._txn_block_cost(txn)
            if need > self.alloc.n_free:
                raise OSError(28, f"ENOSPC: txn needs {need} blocks, "
                                  f"{self.alloc.n_free} free")
            # apply (COW into fresh blocks) then WAL-commit the txn;
            # crash replay re-applies idempotently over fresh blocks
            self._apply_txn(txn)
            blob = txn.encode()
            self._wal.write(_FRAME.pack(len(blob)) + blob)
            self._wal.flush()
            if self.fsync:
                os.fsync(self._wal.fileno())
            self._dev.flush()
        # store-commit boundary on the current op's timeline: the txn is
        # WAL-durable here (no-op outside a tracked dispatch)
        from ceph_tpu_torch.cluster.optracker import mark_current

        mark_current("store:commit")
        self._since_ckpt += 1
        if self._since_ckpt >= self.checkpoint_every:
            self.checkpoint()
        if self.chaos is not None:
            self.chaos.maybe_rot(self, txn)

    def _apply_txn(self, txn: Transaction, replay: bool = False) -> None:
        """Run a transaction's ops, then checksum every block they
        wrote in one batch — also when an op raises, so the onodes hold
        the csums of whatever the ops before it wrote."""
        try:
            for op in txn.ops:
                self._apply(op, replay=replay)
        finally:
            self._flush_csums()

    def _txn_block_cost(self, txn: Transaction) -> int:
        """Worst-case fresh-block demand of a transaction (write ops COW
        every touched block; clones copy the whole source)."""
        need = 0
        for op in txn.ops:
            if op[0] == "write":
                _, _, _, offset, data = op
                if data:
                    need += (offset + len(data) - 1) // BLOCK \
                        - offset // BLOCK + 1
            elif op[0] == "write_planar":
                # whole-matrix COW rewrite: blocks of the FINAL size
                # (old blocks free only after the onode repoints)
                _, _, _, _, _, total_cols = op
                need += (8 * total_cols + BLOCK - 1) // BLOCK
            elif op[0] == "truncate":
                need += 1                       # partial-tail rewrite
            elif op[0] == "clone":
                src = self._onodes.get(op[1], {}).get(op[2])
                if src is not None:
                    need += sum(1 for b in src.blocks if b >= 0)
        return need

    def _coll(self, coll: str) -> Dict[str, Onode]:
        return self._onodes.setdefault(coll, {})

    def _onode(self, coll: str, oid: str) -> Onode:
        return self._coll(coll).setdefault(oid, Onode())

    def _free_onode(self, o: Onode) -> None:
        self.alloc.release([b for b in o.blocks if b >= 0])

    def _apply(self, op: Tuple, replay: bool = False) -> None:
        kind = op[0]
        if kind == "create_collection":
            self._onodes.setdefault(op[1], {})
        elif kind == "remove_collection":
            for o in self._onodes.pop(op[1], {}).values():
                self._free_onode(o)
        elif kind == "touch":
            self._onode(op[1], op[2])
        elif kind == "write":
            _, coll, oid, offset, data = op
            o = self._coll(coll).get(oid)
            if o is not None and \
                    getattr(o, "layout", None) == planar_store.LAYOUT_PLANAR:
                # byte write onto a planar object: it leaves planar-at-
                # rest.  A partial overlay must land on LOGICAL bytes,
                # so materialize once (counted relayout) first.
                end = offset + len(data)
                if not (offset == 0 and o.size <= end) and o.size:
                    raw = self._read_all_replay_ok(coll, oid, o, replay)
                    logical = planar_store.planes_to_shard(
                        planar_store.blob_to_planes(raw), seam="relayout")
                    self._do_truncate(coll, oid, 0, replay)
                    self._do_write(coll, oid, 0, logical, replay)
                o.layout = None
            self._do_write(coll, oid, offset, data, replay)
        elif kind == "write_planar":
            _, coll, oid, plane_off, data, total_cols = op
            self._do_write_planar(coll, oid, plane_off, data, total_cols,
                                  replay)
        elif kind == "truncate":
            _, coll, oid, size = op
            o = self._coll(coll).get(oid)
            if o is not None and o.size != size and o.size and \
                    getattr(o, "layout", None) == planar_store.LAYOUT_PLANAR:
                # byte truncate of a planar object cuts PLANE ROWS, not
                # logical bytes — leave planar first (counted relayout)
                raw = self._read_all_replay_ok(coll, oid, o, replay)
                logical = planar_store.planes_to_shard(
                    planar_store.blob_to_planes(raw), seam="relayout")
                self._do_truncate(coll, oid, 0, replay)
                self._do_write(coll, oid, 0, logical, replay)
                o.layout = None
            self._do_truncate(coll, oid, size, replay)
        elif kind == "remove":
            o = self._coll(op[1]).pop(op[2], None)
            if o is not None:
                self._free_onode(o)
        elif kind == "clone":
            _, coll, src, dst = op
            self._do_clone(coll, src, dst, replay)
        elif kind == "rb_capture":
            _, coll, oid, rb_oid, key = op
            o = self._coll(coll).get(oid)
            try:
                data = self._read_all(coll, oid, o) if o is not None \
                    else b""
            except IOError:
                if not replay:
                    raise
                # replay over blocks a later pre-crash txn reused: the
                # record is unrecoverable, but a dead rollback record
                # must not make the store unmountable
                data = b""
                o = None
            rec = {
                "oid": oid, "existed": o is not None, "chunk_off": 0,
                "old_range": data,
                "old_total": o.size if o else 0,
                "old_attrs": ({k: o.xattrs.get(k)
                               for k in ("shard", "size", "hinfo_crc")}
                              if o else {}),
                "old_version": o.version if o else 0,
                # at-rest layout travels with the rollback record so a
                # rewind restores planar objects AS planar
                "layout": getattr(o, "layout", None) if o else None,
            }
            self._onode(coll, rb_oid).omap[key] = pickle.dumps(rec)
        elif kind == "setattr":
            _, coll, oid, name, value = op
            self._onode(coll, oid).xattrs[name] = value
        elif kind == "rmattr":
            _, coll, oid, name = op
            o = self._coll(coll).get(oid)
            if o is not None:
                o.xattrs.pop(name, None)
        elif kind == "omap_set":
            _, coll, oid, kv = op
            self._onode(coll, oid).omap.update(kv)
        elif kind == "omap_rmkeys":
            _, coll, oid, keys = op
            o = self._coll(coll).get(oid)
            if o is not None:
                for k in keys:
                    o.omap.pop(k, None)
        elif kind == "set_version":
            _, coll, oid, version = op
            self._onode(coll, oid).version = version
        else:
            raise ValueError(f"unknown transaction op {kind}")

    def _do_write(self, coll, oid, offset, data, replay) -> None:
        """COW block write: touched blocks get FRESH allocations; the old
        blocks free once the onode points at the new ones."""
        o = self._onode(coll, oid)
        if not data:
            return
        end = offset + len(data)
        n_blocks = (max(o.size, end) + BLOCK - 1) // BLOCK
        while len(o.blocks) < n_blocks:
            o.blocks.append(-1)          # holes
            o.csums.append(0)
        for idx in range(offset // BLOCK, (end - 1) // BLOCK + 1):
            bstart = idx * BLOCK
            lo = max(offset, bstart) - bstart      # in-block range
            hi = min(end, bstart + BLOCK) - bstart
            if lo > 0 or hi < BLOCK:
                try:
                    cur = self._read_block(coll, oid, o, idx) \
                        if o.blocks[idx] >= 0 else b"\0" * BLOCK
                except IOError:
                    if not replay:
                        raise
                    cur = b"\0" * BLOCK   # replay over reused blocks
                block = bytearray(cur)
            else:
                block = bytearray(BLOCK)
            block[lo:hi] = data[(bstart + lo) - offset:
                                (bstart + hi) - offset]
            (new_blk,) = self.alloc.alloc(1)
            self._write_block(o, idx, new_blk, bytes(block))
            if o.blocks[idx] >= 0:
                self.alloc.release([o.blocks[idx]])
            o.blocks[idx] = new_blk
        o.size = max(o.size, end)

    def _read_all_replay_ok(self, coll, oid, o, replay) -> bytes:
        """_read_all, but WAL replay over blocks a later pre-crash txn
        reused yields zeros instead of failing the mount."""
        try:
            return self._read_all(coll, oid, o)
        except IOError:
            if not replay:
                raise
            return b"\0" * o.size

    def _do_write_planar(self, coll, oid, plane_off, data, total_cols,
                         replay) -> None:
        """Planar-at-rest shard write: splice the (8, wc) plane-column
        window into the object's plane matrix and rewrite it whole —
        COW into fresh blocks like every other write.  A full rewrite
        (the common EC case: whole-shard window, plane_off 0) never
        reads the old blocks; only a windowed splice (RMW delta) does.
        Documented simplification vs per-block surgery: shard objects
        are a handful of blocks, and the COW rewrite keeps csums and
        crash replay identical to the byte path."""
        o = self._onode(coll, oid)
        window = planar_store.blob_to_planes(data)
        full_rewrite = plane_off == 0 and window.shape[1] >= total_cols
        cur = None
        if o.size and not full_rewrite:
            raw = self._read_all_replay_ok(coll, oid, o, replay)
            if len(raw) % 8:
                raw += b"\0" * (8 - len(raw) % 8)
            if getattr(o, "layout", None) == planar_store.LAYOUT_PLANAR:
                cur = planar_store.blob_to_planes(raw)
            else:
                # planar write landing on a byte-at-rest object: the
                # config gate flipped mid-life — convert once, counted
                cur = planar_store.shard_to_planes(raw, seam="relayout")
        merged = planar_store.splice_columns(
            cur, plane_off, window, total_cols)
        self._do_truncate(coll, oid, 0, replay)
        self._do_write(coll, oid, 0, planar_store.planes_to_blob(merged),
                       replay)
        o.size = 8 * total_cols
        o.layout = planar_store.LAYOUT_PLANAR

    def _do_truncate(self, coll, oid, size, replay) -> None:
        o = self._onode(coll, oid)
        n_blocks = (size + BLOCK - 1) // BLOCK
        if size < o.size:
            dead = [b for b in o.blocks[n_blocks:] if b >= 0]
            self.alloc.release(dead)
            del o.blocks[n_blocks:]
            del o.csums[n_blocks:]
            # zero the tail of the last partial block (COW)
            if size % BLOCK and o.blocks and o.blocks[-1] >= 0:
                try:
                    cur = bytearray(self._read_block(
                        coll, oid, o, len(o.blocks) - 1))
                except IOError:
                    if not replay:
                        raise
                    cur = bytearray(BLOCK)
                cur[size % BLOCK:] = b"\0" * (BLOCK - size % BLOCK)
                (nb,) = self.alloc.alloc(1)
                self._write_block(o, len(o.blocks) - 1, nb, bytes(cur))
                self.alloc.release([o.blocks[-1]])
                o.blocks[-1] = nb
        else:
            while len(o.blocks) < n_blocks:
                o.blocks.append(-1)
                o.csums.append(0)
        o.size = size

    def _do_clone(self, coll, src, dst, replay) -> None:
        s = self._coll(coll).get(src)
        if s is None:
            return
        old = self._coll(coll).pop(dst, None)
        if old is not None:
            self._free_onode(old)
        d = Onode(size=s.size, xattrs=dict(s.xattrs), omap=dict(s.omap),
                  version=s.version, layout=getattr(s, "layout", None))
        # physical copy block-by-block (no refcounted blobs — documented
        # simplification of the reference's shared-blob clone).  The
        # source is read and verified in one batch; only when that fails
        # does the copy read block by block, so a bad block raises (or,
        # in replay, reads as zeros) exactly where a per-block copy meets
        # it.
        whole = None
        if s.blocks:
            try:
                whole = self._read_blocks(coll, src, s, 0, len(s.blocks) - 1)
            except IOError:
                pass
        for idx, blk in enumerate(s.blocks):
            if blk < 0:
                d.blocks.append(-1)
                d.csums.append(0)
                continue
            if whole is not None:
                data = whole[idx * BLOCK:(idx + 1) * BLOCK]
            else:
                try:
                    data = self._read_block(coll, src, s, idx)
                except IOError:
                    if not replay:
                        raise
                    data = b"\0" * BLOCK
            (nb,) = self.alloc.alloc(1)
            d.blocks.append(nb)
            d.csums.append(0)
            self._write_block(d, idx, nb, data)
        self._coll(coll)[dst] = d

    # -- reads (ObjectStore contract, csum-verified) -----------------------

    def _read_all(self, coll: str, oid: str, o: Onode) -> bytes:
        if not o.blocks:
            return b""
        return self._read_blocks(coll, oid, o, 0, len(o.blocks) - 1)[: o.size]

    def read(self, coll: str, oid: str, offset: int = 0,
             length: Optional[int] = None) -> bytes:
        if self.chaos is not None:
            self.chaos.on_read(coll, oid)
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            if o is None:
                raise FileNotFoundError(f"{coll}/{oid}")
            if getattr(o, "layout", None) == planar_store.LAYOUT_PLANAR \
                    and o.size:
                # byte view of a planar object OUTSIDE the sanctioned
                # seams (egress of last resort): logical byte 8i+u needs
                # column i of ALL 8 plane rows, so the whole object is
                # read and csum-verified; books the ``unseamed``
                # counter the steady-state contract pins to zero.
                data = planar_store.planes_to_shard(  # graftlint: ignore[planar-conversion-hygiene]
                    planar_store.blob_to_planes(self._read_all(
                        coll, oid, o)), seam="unseamed")
                if length is None:
                    return data[offset:]
                return data[offset : offset + length]
            end = o.size if length is None else min(o.size,
                                                    offset + length)
            if offset >= end:
                return b""
            # touch (and csum-verify) ONLY the blocks in range — a 4 KiB
            # read of a 4 MiB object must not verify all 1024 blocks
            first, last = offset // BLOCK, (end - 1) // BLOCK
            out = self._read_blocks(coll, oid, o, first, last)
            lo = offset - first * BLOCK
            return out[lo: lo + (end - offset)]

    def read_planar(self, coll: str, oid: str) -> bytes:
        """The at-rest plane blob as stored — ZERO layout conversion
        (csum-verified block reads).  Callers gate on object_layout; a
        byte-at-rest object raises."""
        if self.chaos is not None:
            self.chaos.on_read(coll, oid)
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            if o is None:
                raise FileNotFoundError(f"{coll}/{oid}")
            if getattr(o, "layout", None) != planar_store.LAYOUT_PLANAR:
                raise ValueError(f"{coll}/{oid} is not planar-at-rest")
            return self._read_all(coll, oid, o)

    def object_layout(self, coll: str, oid: str) -> Optional[str]:
        """At-rest layout tag (None = bytes / missing object)."""
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return None if o is None else getattr(o, "layout", None)

    def stat(self, coll: str, oid: str) -> Optional[int]:
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return None if o is None else o.size

    def get_version(self, coll: str, oid: str) -> int:
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return 0 if o is None else o.version

    def getattr(self, coll: str, oid: str, name: str) -> Optional[bytes]:
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return None if o is None else o.xattrs.get(name)

    def get_xattrs(self, coll: str, oid: str) -> Dict[str, bytes]:
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return {} if o is None else dict(o.xattrs)

    def omap_get(self, coll: str, oid: str) -> Dict[str, bytes]:
        with self._lock:
            o = self._onodes.get(coll, {}).get(oid)
            return {} if o is None else dict(o.omap)

    def list_objects(self, coll: str) -> List[str]:
        with self._lock:
            return sorted(self._onodes.get(coll, {}))

    def list_collections(self) -> List[str]:
        with self._lock:
            return sorted(self._onodes)

    def statfs(self) -> Tuple[int, int]:
        """O(1) from the allocator (BlueStore::statfs)."""
        with self._lock:
            used = (self.n_blocks - self.alloc.n_free) * BLOCK
            return (self.device_size, used)

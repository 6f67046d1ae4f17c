"""FileSystem: a POSIX-ish file layer over RADOS (CephFS analog).

Behavioral analog of the reference's CephFS core shape (src/mds/ +
src/client/): file DATA is striped over a data pool by the same Striper
layout files share with RBD (file_layout_t, src/include/fs_types.h:84),
while METADATA — the directory tree, dentries, inodes — lives in a
metadata pool as omap-backed directory objects (the reference MDS stores
dirfrags exactly this way: one omap entry per dentry).  The "MDS" here
is a library-side metadata service over IoCtx ops (single-writer
semantics per directory object come from the OSD's per-PG ordering);
subtree partitioning across MDS ranks is future work.

Inodes: pickled dataclasses in the dentry omap value.  Data objects:
"<ino>.%016x" like the reference's file objects.  Counterpart of
``ceph_tpu/cluster/fs.py``.
"""

from __future__ import annotations

import asyncio
import pickle
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

from ceph_tpu_torch.cluster.objecter import IoCtx
from ceph_tpu_torch.cluster.striper import (
    FileLayout,
    StripedReader,
    file_to_extents,
)

ROOT_INO = 1


@dataclass
class Inode:
    """inode_t subset (reference mdstypes)."""

    ino: int
    mode: str                  # "dir" | "file"
    size: int = 0
    layout: Optional[FileLayout] = None
    mtime: float = 0.0


class FileSystem:
    """Mount-like handle (reference client/Client.cc surface subset)."""

    def __init__(self, meta_ioctx: IoCtx, data_ioctx: IoCtx,
                 layout: Optional[FileLayout] = None):
        self.meta = meta_ioctx
        self.data = data_ioctx
        self.layout = layout or FileLayout(
            stripe_unit=1 << 16, stripe_count=1, object_size=1 << 20)

    # -- metadata primitives ------------------------------------------------

    @staticmethod
    def _dir_oid(ino: int) -> str:
        return f"dir.{ino:x}"

    async def mkfs(self) -> None:
        """Create the root directory object (reference: mds newfs)."""
        await self.meta.write_full(self._dir_oid(ROOT_INO),
                                   pickle.dumps(Inode(ROOT_INO, "dir")))
        await self.meta.omap_set("meta.next_ino",
                                 {"next": str(ROOT_INO + 1).encode()})

    async def _alloc_ino(self) -> int:
        # ino allocator in the meta pool (reference inotable): the
        # read-increment-write runs INSIDE the OSD via the object-class
        # seam, atomic under the PG lock — concurrent creates can never
        # collide
        out = await self.meta.execute("meta.next_ino", "inotable", "alloc")
        return int(out)

    async def _lookup_dir(self, path: str,
                          snapid: Optional[int] = None) -> Tuple[int, str]:
        """Resolve the parent directory of ``path``; returns
        (parent_ino, leaf_name).  ``snapid`` walks the dirfrags as they
        were at that (meta-pool) snapshot — the CephFS .snap read path."""
        parts = [p for p in path.split("/") if p]
        if not parts:
            raise IsADirectoryError("/")
        ino = ROOT_INO
        for name in parts[:-1]:
            entries = await self.meta.omap_get(self._dir_oid(ino),
                                               snapid=snapid)
            blob = entries.get(name)
            if blob is None:
                raise FileNotFoundError(f"{name} in {path}")
            inode: Inode = pickle.loads(blob)
            if inode.mode != "dir":
                raise NotADirectoryError(name)
            ino = inode.ino
        return ino, parts[-1]

    async def _resolve(self, path: str,
                       snapid: Optional[int] = None
                       ) -> Tuple[int, str, Inode]:
        """ONE walk: (parent_ino, leaf, inode) — callers must not re-walk
        (each component costs an omap round trip)."""
        parent, leaf = await self._lookup_dir(path, snapid=snapid)
        entries = await self.meta.omap_get(self._dir_oid(parent),
                                           snapid=snapid)
        blob = entries.get(leaf)
        if blob is None:
            raise FileNotFoundError(path)
        return parent, leaf, pickle.loads(blob)

    async def _get(self, path: str,
                   snapid: Optional[int] = None) -> Inode:
        if path.strip("/") == "":
            return Inode(ROOT_INO, "dir")
        return (await self._resolve(path, snapid=snapid))[2]

    async def _set_dentry(self, parent: int, name: str,
                          inode: Inode) -> None:
        await self.meta.omap_set(self._dir_oid(parent),
                                 {name: pickle.dumps(inode)})

    async def set_size(self, path: str, size: int) -> None:
        """Extend a file inode's size (the MDS applies this for client
        data writes — the caps writeback analog).  GROW-ONLY: the value
        is computed from the writer's possibly lease-stale stat, so a
        blind absolute write could truncate a concurrent writer's
        committed extension; max() keeps size-writeback monotonic (the
        reference orders size changes through the Locker for the same
        reason).  Explicit truncation would be its own op."""
        import time as _time

        parent, leaf, inode = await self._resolve(path)
        if inode.mode != "file":
            raise IsADirectoryError(path)
        inode.size = max(inode.size, size)
        inode.mtime = _time.time()
        await self._set_dentry(parent, leaf, inode)

    # -- namespace ops ------------------------------------------------------

    async def _link_dentry(self, parent: int, leaf: str,
                           inode: Inode, path: str) -> None:
        """Create-exclusive dentry insert through the object-class seam:
        the check-then-set runs INSIDE the OSD under PG serialization, so
        concurrent creates of one path cannot both succeed."""
        try:
            await self.meta.execute(
                self._dir_oid(parent), "dirfrag", "link",
                pickle.dumps({"name": leaf,
                              "value": pickle.dumps(inode)}))
        except IOError as e:
            if "-17" in str(e):  # EEXIST from the class method
                raise FileExistsError(path) from None
            raise

    async def mkdir(self, path: str) -> int:
        parent, leaf = await self._lookup_dir(path)
        ino = await self._alloc_ino()
        await self.meta.write_full(self._dir_oid(ino),
                                   pickle.dumps(Inode(ino, "dir")))
        await self._link_dentry(parent, leaf, Inode(ino, "dir"), path)
        return ino

    async def create(self, path: str,
                     layout: Optional[FileLayout] = None) -> int:
        parent, leaf = await self._lookup_dir(path)
        ino = await self._alloc_ino()
        inode = Inode(ino, "file", size=0,
                      layout=layout or self.layout, mtime=time.time())
        await self._link_dentry(parent, leaf, inode, path)
        return ino

    async def listdir(self, path: str = "/",
                      snapid: Optional[int] = None) -> List[str]:
        inode = await self._get(path, snapid=snapid)
        if inode.mode != "dir":
            raise NotADirectoryError(path)
        return sorted(await self.meta.omap_get(self._dir_oid(inode.ino),
                                               snapid=snapid))

    async def stat(self, path: str,
                   snapid: Optional[int] = None) -> Inode:
        return await self._get(path, snapid=snapid)

    async def unlink(self, path: str) -> None:
        parent, leaf, inode = await self._resolve(path)
        if inode.mode == "dir":
            if await self.meta.omap_get(self._dir_oid(inode.ino)):
                raise OSError(39, "directory not empty", path)
            await self.meta.remove(self._dir_oid(inode.ino))
        else:
            await self._purge_data(inode)
        await self.meta.omap_rmkeys(self._dir_oid(parent), [leaf])

    async def rename(self, src: str, dst: str) -> None:
        sparent, sleaf, inode = await self._resolve(src)
        dparent, dleaf = await self._lookup_dir(dst)
        if (sparent, sleaf) == (dparent, dleaf):
            return  # POSIX: rename onto itself is a no-op
        existing = (await self.meta.omap_get(
            self._dir_oid(dparent))).get(dleaf)
        if existing is not None:
            # POSIX: replacing a file purges it; a directory must be empty
            old: Inode = pickle.loads(existing)
            if old.mode == "dir":
                if await self.meta.omap_get(self._dir_oid(old.ino)):
                    raise OSError(39, "directory not empty", dst)
                await self.meta.remove(self._dir_oid(old.ino))
            else:
                await self._purge_data(old)
        await self._set_dentry(dparent, dleaf, inode)
        await self.meta.omap_rmkeys(self._dir_oid(sparent), [sleaf])

    # -- file I/O -----------------------------------------------------------

    def _fmt(self, ino: int) -> str:
        return f"{ino:x}.%016x"

    async def write(self, path: str, offset: int, data: bytes) -> None:
        parent, leaf, inode = await self._resolve(path)
        if inode.mode != "file":
            raise IsADirectoryError(path)
        layout = inode.layout or self.layout
        extents = file_to_extents(self._fmt(inode.ino), layout,
                                  offset, len(data))
        per_object = StripedReader.scatter(extents, data)
        await asyncio.gather(*[
            self.data.write(oid, blob, offset=obj_off)
            for oid, parts in per_object.items()
            for obj_off, blob in parts])
        if offset + len(data) > inode.size:
            inode.size = offset + len(data)
        inode.mtime = time.time()
        await self._set_dentry(parent, leaf, inode)

    async def read(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        inode = await self._get(path)
        if inode.mode != "file":
            raise IsADirectoryError(path)
        if length is None:
            length = max(0, inode.size - offset)
        length = min(length, max(0, inode.size - offset))
        if length == 0:
            return b""
        layout = inode.layout or self.layout
        extents = file_to_extents(self._fmt(inode.ino), layout,
                                  offset, length)

        async def fetch(ex):
            try:
                return ex.oid, await self.data.read(
                    ex.oid, offset=ex.offset, length=ex.length)
            except FileNotFoundError:
                return ex.oid, b""

        got = dict(await asyncio.gather(*[fetch(ex) for ex in extents]))
        return StripedReader.assemble(extents, got, length, relative=True)

    async def _purge_data(self, inode: Inode) -> None:
        layout = inode.layout or self.layout
        period = layout.object_size * layout.stripe_count
        n_sets = (inode.size + period - 1) // period
        for objno in range(n_sets * layout.stripe_count):
            try:
                await self.data.remove(self._fmt(inode.ino) % objno)
            except FileNotFoundError:
                pass  # sparse/never-written object; real errors propagate

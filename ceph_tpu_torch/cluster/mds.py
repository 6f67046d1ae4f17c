"""MDS daemon: the metadata SERVER for the CephFS-analog.

Counterpart of ``ceph_tpu/cluster/mds.py``.  Moves fs.py's metadata
authority out of the client library into a daemon, the reference's
MDSRank shape (src/mds/MDSRank.cc): clients send metadata ops
(MClientRequest) to the active MDS, which serializes them, journals them
WRITE-AHEAD into a RADOS-backed metadata journal
(src/mds/journal.cc MDLog analog — an omap event log in
the meta pool), applies them through the cls-atomic dirfrag engine
(cluster/fs.py, kept as the storage layer), and replies with short-TTL
read leases (Locker caps-lite, src/mds/Locker.cc: the
client may cache a lookup until the lease expires; every mutation goes
to the MDS, so two clients always observe a single serialized order).

An MDS restart REPLAYS unapplied journal events before serving
(MDSRank::boot_start replay stage).  Active MDS addresses ride the
cluster map via rank-tagged beacons (MDSMap-lite).

MULTI-ACTIVE subtree partitioning (the Migrator analog — see
the subtree-authority section) and fs SNAPSHOTS (SnapServer-lite: the
.snap pseudo-paths over pool-level selfmanaged COW, metadata included
via the dirfrag exec/omap SnapContext seam).
"""

from __future__ import annotations

import asyncio
import pickle
import time
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.fs import FileSystem, Inode
from ceph_tpu_torch.cluster.messenger import (
    Addr,
    Connection,
    Dispatcher,
    EntityName,
    Messenger,
)
from ceph_tpu_torch.cluster.monclient import MonTargeter
from ceph_tpu_torch.utils import Config, DepLock, PerfCounters
from ceph_tpu_torch.utils.device import resolve_device_index

JOURNAL_OID = "mds_journal.0"   # rank 0 (kept name: store compat)
SUBTREE_OID = "mds_subtrees"    # omap {dir path: owner rank} (auth table)


@dataclass
class MClientRequest(M.Message):
    """Client metadata op (reference MClientRequest)."""

    tid: int = 0
    client: str = ""                  # incarnation-unique client identity
    op: str = ""                      # mkdir|create|stat|listdir|...
    args: Tuple = ()


@dataclass
class MClientReply(M.Message):
    tid: int = 0
    result: int = 0
    data: object = None
    error: str = ""
    lease_ttl: float = 0.0            # read-cacheable until now+ttl
    snapc: Optional[Tuple] = None     # data-pool write context (stat)
    snapid: Optional[int] = None      # data-pool read snap (.snap stat)


@dataclass
class MMDSBeacon(M.Message):
    """MDS -> mon registration (reference MMDSBeacon)."""

    addr: Optional[Tuple] = None
    rank: int = 0


def norm_path(path: str) -> str:
    return "/" + "/".join(p for p in str(path).split("/") if p)


def owner_rank(subtrees: Dict[str, int], path: str) -> int:
    """Longest-prefix subtree authority lookup — ONE implementation
    shared by daemon routing and client targeting, so the two can never
    disagree (component-boundary aware)."""
    path = norm_path(path)
    best, best_len = 0, -1
    for prefix, rank in subtrees.items():
        if prefix == "/" or path == prefix or \
                path.startswith(prefix + "/"):
            if len(prefix) > best_len:
                best, best_len = rank, len(prefix)
    return best


# journal ops that mutate dirfrag state (everything except pure reads)
_MUTATING = {"mkdir", "create", "unlink", "rename", "set_size"}
# ops routed by subtree authority (args[0] is always the primary path)
_ROUTED = _MUTATING | {"stat", "listdir", "snap_create", "snap_rm",
                       "export_dir"}


class MDSDaemon(Dispatcher):
    def __init__(self, mon_addr, meta_pool: int, data_pool: int,
                 config: Optional[Config] = None, rank: int = 0,
                 device=None):
        """``device``: where the rank's own RADOS client keeps its map
        (CUDA unless the caller names the CPU; raises without a card)."""
        self.rank = rank
        self.device = resolve_device_index(device)
        self.config = Config(**config.show()) if config else Config()
        self.messenger = Messenger(
            EntityName("mds", rank),
            secret=self.config.auth_secret(),
            auth=self.config.cephx_context(f"mds.{rank}"),
            config=self.config)
        self.messenger.add_dispatcher(self)
        self.mon_addr = mon_addr
        # beacons hunt across the monmap (the reference sends them to
        # ``mon_addr`` as given, which fails for a list of monitors)
        self.monc = MonTargeter(self.messenger, mon_addr)
        self.meta_pool = meta_pool
        self.data_pool = data_pool
        self.perf = PerfCounters(f"mds.{rank}")
        from ceph_tpu_torch.utils import AdminSocket

        self.asok = AdminSocket()
        self.asok.register_common(self.perf, self.config)
        self.asok.register(
            "status", lambda cmd: {"rank": self.rank,
                                   "meta_pool": self.meta_pool,
                                   "data_pool": self.data_pool},
            "this MDS rank's identity")
        self._client = None               # our own RADOS client
        self.fs: Optional[FileSystem] = None
        self._lock = DepLock("mds.big_lock")  # the single-MDS big lock
        # self-discarding background-task registry (the messenger/osd
        # _track pattern; task-spawn lint invariant)
        self._tasks: set = set()
        self._stopped = False
        self.lease_ttl = self.config.mds_lease_ttl
        # completed-request cache (the OSD reqid dup cache's MDS twin,
        # reference MDCache request dedup): a client retry of a mutating
        # op whose reply was merely delayed gets the ORIGINAL reply
        # instead of a spurious EEXIST/ENOENT re-execution
        from collections import OrderedDict as _OD

        self._completed: "_OD[Tuple[str, int], MClientReply]" = _OD()
        # chaos crash points: the MDS is a daemon, so an
        # armed seam crashes it through the launcher's callback like an
        # OSD.  The MDS has no local store (all state lives in RADOS),
        # so "power cut" = stop serving at this instant; the restarted
        # rank replays its journal.
        self._chaos_crash_cb = None

    def _chaos_point(self, name: str) -> None:
        """Named crash seam (the OSD._chaos_point twin for MDS ranks):
        when the armed ``chaos_crash_point`` matches, this rank dies AT
        THIS INSTANT — ``_stopped`` flips before anything else runs,
        teardown is handed to the launcher's callback, and ChaosCrash
        unwinds the current request like a task dying mid-await.  One
        falsy test when unarmed (no-op contract).

        The armed value may be a CHAIN ("mds_journal_mid,mds_replay_mid"):
        firing pops the head and arms the remainder in this rank's
        config — and since a restarted rank RESUMES its per-rank config,
        the chain spans incarnations (crash mid-append, then crash the
        next boot's replay of that very event).  An empty remainder
        disarms, so a replay-seam point can never crash-loop the rank.
        """
        if not self.config.chaos_crash_point or self._stopped:
            return
        from ceph_tpu_torch.chaos import ChaosCrash
        from ceph_tpu_torch.chaos.counters import CHAOS
        from ceph_tpu_torch.chaos.points import resolve_fire

        if not resolve_fire(self.config, name):
            return
        self._stopped = True
        CHAOS.inc("crash_points_fired")
        CHAOS.inc("mds_crash_points_fired")
        cb = self._chaos_crash_cb
        if cb is not None:
            # the callback task is OWNED BY THE LAUNCHER (it outlives
            # this daemon's stop())
            cb(name)
        raise ChaosCrash(f"mds chaos crash point {name!r} fired")

    # -- lifecycle ---------------------------------------------------------

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        from ceph_tpu_torch.cluster.objecter import RadosClient

        addr = await self.messenger.bind(host, port)
        self._client = RadosClient(self.mon_addr, name=f"mds{self.rank}",
                                   config=self.config, device=self.device)
        await self._client.connect()
        # HOLD these instances: ioctx() mints a fresh IoCtx per call,
        # and the snapshot SnapContexts install onto these exact objects
        self._meta_io = self._client.ioctx(self.meta_pool)
        self._data_io = self._client.ioctx(self.data_pool)
        meta_io, data_io = self._meta_io, self._data_io
        self.fs = FileSystem(meta_io, data_io)
        try:
            await self.fs.stat("/")
        except FileNotFoundError:
            await self.fs.mkfs()
        await self._load_subtrees(create=(self.rank == 0))
        await self._load_snaptable()
        await self._replay_journal()
        await self._beacon()
        loop = asyncio.get_event_loop()
        self._track(loop.create_task(self._beacon_loop()))
        return addr

    # -- subtree authority (Migrator analog) --------------------------------
    #
    # Reference src/mds/Migrator.h:52: multi-active MDS partitions the
    # namespace into subtrees, each owned by one rank; export_dir moves
    # authority.  In this framework EVERY dirfrag lives in shared RADOS,
    # so "migration" is an authority-table flip (one atomic omap write) —
    # no cache or journal segments travel, and the per-op WRITE-AHEAD
    # journal means there is no unflushed state to hand over.  Requests
    # that land on the wrong rank bounce with ESTALE + the owner hint and
    # the client retargets (the reference's forward-to-auth).

    async def _load_subtrees(self, create: bool = False) -> None:
        io = self._meta_io
        try:
            om = await io.omap_get(SUBTREE_OID)
        except (FileNotFoundError, IOError):
            om = {}
        if not om:
            if create:
                await io.omap_set(SUBTREE_OID, {"/": b"0"})
            om = {"/": b"0"}
        self.subtrees = {p: int(r) for p, r in om.items()}

    @staticmethod
    def _norm(path: str) -> str:
        return norm_path(path)

    def _owner_rank(self, path: str) -> int:
        return owner_rank(self.subtrees, path)

    async def _export_dir(self, path: str, target: int) -> None:
        """Move subtree authority (Migrator::export_dir): one atomic
        authority-table write; the journal is already flushed per-op."""
        path = self._norm(path)
        io = self._meta_io
        await self.fs.stat(path)  # must exist (and be resolvable)
        await io.omap_set(SUBTREE_OID, {path: str(target).encode()})
        await self._load_subtrees()
        self.perf.inc("mds_exports")

    # -- snapshots (SnapServer/SnapRealm-lite) ------------------------------
    #
    # Reference src/mds/SnapServer.h snaptable + snaprealms: a snapshot
    # of directory D freezes D's subtree.  Here both pools already COW
    # under selfmanaged SnapContexts (dirfrag omaps included, via the
    # exec/omap snapc seam), so an fs snapshot = allocate one snapid in
    # each pool, record (name -> ids, dir) in the snaptable object, and
    # extend every MDS's write SnapContext.  The realm is GLOBAL (one
    # context covers the whole fs — objects outside the snapped dir may
    # grow clones if modified, which costs space, never correctness);
    # .snap path reads resolve with the recorded ids.

    SNAPTABLE_OID = "mds_snaptable"

    async def _load_snaptable(self) -> None:
        io = self._meta_io
        try:
            om = await io.omap_get(self.SNAPTABLE_OID)
        except (FileNotFoundError, IOError):
            om = {}
        self.snaptable = {name: pickle.loads(blob)
                          for name, blob in om.items()}
        self._install_snapc()

    def _install_snapc(self) -> None:
        metas = sorted((v["meta_id"] for v in self.snaptable.values()),
                       reverse=True)
        datas = sorted((v["data_id"] for v in self.snaptable.values()),
                       reverse=True)
        self._meta_io.set_snap_context(metas[0] if metas else 0,
                                       metas)
        self._data_io.set_snap_context(datas[0] if datas else 0, datas)

    def _data_snapc(self) -> Tuple[int, Tuple[int, ...]]:
        datas = tuple(sorted((v["data_id"]
                              for v in self.snaptable.values()),
                             reverse=True))
        return (datas[0] if datas else 0, datas)

    async def _snap_create(self, dirpath: str, name: str) -> int:
        dirpath = self._norm(dirpath)
        ino = await self.fs.stat(dirpath)
        if ino.mode != "dir":
            raise NotADirectoryError(dirpath)
        if name in self.snaptable:
            raise FileExistsError(f"{dirpath}/.snap/{name}")
        meta_id = await self._meta_io.selfmanaged_snap_create()
        data_id = await self._data_io.selfmanaged_snap_create()
        rec = {"dir": dirpath, "meta_id": meta_id, "data_id": data_id,
               "stamp": time.time()}
        # omap_set auto-creates (the meta txn touches the object)
        await self._meta_io.omap_set(self.SNAPTABLE_OID,
                                     {name: pickle.dumps(rec)})
        await self._load_snaptable()
        return data_id

    async def _snap_rm(self, dirpath: str, name: str) -> None:
        rec = self.snaptable.get(name)
        if rec is None or rec["dir"] != self._norm(dirpath):
            raise FileNotFoundError(f"{dirpath}/.snap/{name}")
        io = self._meta_io
        await io.omap_rmkeys(self.SNAPTABLE_OID, [name])
        try:
            await self._meta_io.selfmanaged_snap_remove(rec["meta_id"])
            await self._data_io.selfmanaged_snap_remove(rec["data_id"])
        except (IOError, OSError, TimeoutError, ConnectionError):
            pass  # trimming is advisory; the table entry is gone
        await self._load_snaptable()

    def _split_snap_path(self, path: str):
        """'/d/.snap/name[/rest]' -> (live '/d[/rest]', snap record) or
        (path, None)."""
        parts = [p for p in path.split("/") if p]
        if ".snap" not in parts:
            return self._norm(path), None
        i = parts.index(".snap")
        if i + 1 >= len(parts):
            return self._norm(path), "LIST"   # '/d/.snap' itself
        name = parts[i + 1]
        rec = self.snaptable.get(name)
        if rec is None:
            raise FileNotFoundError(path)
        base = self._norm("/" + "/".join(parts[:i]))
        d = rec["dir"]
        if base != d and not (d == "/" or base.startswith(d + "/")):
            raise FileNotFoundError(path)
        live = "/" + "/".join(parts[:i] + parts[i + 2:])
        return self._norm(live), rec

    def _track(self, task: asyncio.Task) -> asyncio.Task:
        from ceph_tpu_torch.utils.tasks import track_task

        return track_task(self._tasks, task)

    async def stop(self) -> None:
        self._stopped = True
        for t in list(self._tasks):
            t.cancel()
        if self._client is not None:
            await self._client.shutdown()
        await self.messenger.shutdown()

    async def _beacon(self) -> None:
        await self.monc.send(
            MMDSBeacon(addr=self.messenger.my_addr, rank=self.rank))

    async def _beacon_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.config.mds_beacon_interval)
            await self._beacon()
            # converge shared tables across ranks (subtree authority +
            # snap contexts); cheap omap reads
            try:
                await self._load_subtrees()
                await self._load_snaptable()
            except Exception:
                # table convergence retries next beacon; counted so a
                # persistently-failing load is visible in perf dump
                self.perf.inc("mds_table_load_errors")

    # -- journal (MDLog analog) --------------------------------------------

    @property
    def _journal_oid(self) -> str:
        # per-rank journals (reference: each MDSRank owns its own MDLog)
        return f"mds_journal.{self.rank}"

    async def _journal_append(self, seq: int, event: Tuple) -> None:
        """WRITE-AHEAD: the event lands in the journal before any
        dirfrag mutation (journal.cc: EUpdate logged before apply)."""
        io = self._meta_io
        await io.omap_set(self._journal_oid,
                          {f"{seq:016d}": pickle.dumps(event)})

    async def _journal_commit(self, seq: int) -> None:
        """Advance applied-through and TRIM the applied events (MDLog
        segment expiry): the journal holds only the unapplied tail, so
        restart replay is O(tail), not O(all ops ever)."""
        io = self._meta_io
        await io.setxattr(self._journal_oid, "applied", str(seq).encode())
        try:
            events = await io.omap_get(self._journal_oid)
            dead = [k for k in events if int(k) <= seq]
            if dead:
                await io.omap_rmkeys(self._journal_oid, dead)
        except (IOError, FileNotFoundError):
            pass

    async def _journal_state(self) -> Tuple[int, Dict[str, bytes]]:
        io = self._meta_io
        try:
            events = await io.omap_get(self._journal_oid)
        except (IOError, FileNotFoundError):
            events = {}
        try:
            applied = int(await io.getxattr(self._journal_oid, "applied"))
        except (KeyError, IOError, FileNotFoundError, ValueError):
            applied = 0
        return applied, events

    async def _replay_journal(self) -> None:
        """Apply journal events beyond the applied watermark (MDSRank
        replay): a crash between append and apply re-runs the event;
        the dirfrag ops tolerate replays (EEXIST/ENOENT mean the
        event's effect is already present).

        Hardening (found by the mds-journal-replay scenario): a
        TRANSIENT apply failure (meta-pool op timeout while the
        cluster is still converging) used to be swallowed alongside the
        idempotent-replay errors — the watermark then advanced past the
        never-applied event and the trim ATE IT, silently losing an
        acked metadata op.  Now transient failures retry, and if they
        persist the replay commits only the contiguous applied prefix
        and fails the boot loudly: trim can never pass an unreplayed
        segment, and the next boot replays it again."""
        applied, events = await self._journal_state()
        top = applied
        for key in sorted(events):
            seq = int(key)
            if seq <= applied:
                continue
            event = pickle.loads(events[key])
            self._chaos_point("mds_replay_mid")
            for attempt in range(3):
                try:
                    await self._apply(event)
                    self.perf.inc("mds_journal_replays")
                    break
                except (FileExistsError, FileNotFoundError):
                    break  # replayed event already (partially) applied
                except (IOError, OSError, TimeoutError,
                        ConnectionError):
                    if attempt == 2:
                        if top > applied:
                            await self._journal_commit(top)
                        raise
                    await asyncio.sleep(0.2 * (attempt + 1))
            top = max(top, seq)
        if top > applied:
            await self._journal_commit(top)
        self._seq = top

    async def _apply(self, event: Tuple) -> object:
        op = event[0]
        if op == "mkdir":
            return await self.fs.mkdir(event[1])
        if op == "create":
            return await self.fs.create(event[1])
        if op == "unlink":
            return await self.fs.unlink(event[1])
        if op == "rename":
            return await self.fs.rename(event[1], event[2])
        if op == "set_size":
            return await self.fs.set_size(event[1], event[2])
        raise ValueError(f"unknown journal op {op}")

    # -- request serving ---------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg) -> bool:
        from ceph_tpu_torch.cluster import messages as _M

        if self._stopped:
            # a crashed rank serves nothing (the power-cut contract);
            # the client's retry loop re-resolves the restarted rank
            return True
        if isinstance(msg, _M.MCommand):
            # 'ceph daemon mds.N ...' admin surface
            result, data = await self.asok.dispatch(msg.cmd)
            await conn.send(_M.MCommandReply(
                tid=msg.tid, result=result, data=data))
            return True
        if not isinstance(msg, MClientRequest):
            return False
        self.perf.inc("mds_requests")
        dup_key = (msg.client, msg.tid)
        try:
            # subtree authority routing (the reference forwards to auth;
            # we bounce with ESTALE + owner hint and the client retargets)
            if msg.op in _ROUTED and msg.args:
                path = str(msg.args[0])
                live, _snap = (path, None)
                if ".snap" in path:
                    live, _snap = self._split_snap_path(path)
                owner = self._owner_rank(live)
                if owner != self.rank:
                    await self._load_subtrees()  # maybe stale: re-check
                    owner = self._owner_rank(live)
                if owner != self.rank:
                    await conn.send(MClientReply(
                        tid=msg.tid, result=-116, error=str(owner)))
                    self.perf.inc("mds_bounced")
                    return True
            if msg.op in _MUTATING:
                # snapshots are a read-only namespace: a literal '.snap'
                # component in a mutation would create a shadowed dentry
                # (the reference returns EPERM from the snap realm check)
                for a in msg.args[:2 if msg.op == "rename" else 1]:
                    if ".snap" in [p for p in str(a).split("/") if p]:
                        await conn.send(MClientReply(
                            tid=msg.tid, result=-1,
                            error=".snap is a reserved name"))
                        return True
            if msg.op == "rename":
                if self._owner_rank(msg.args[0]) != \
                        self._owner_rank(msg.args[1]):
                    # cross-subtree rename needs multi-MDS transactions
                    # (reference slave requests); refused like early
                    # multi-active — copy+unlink instead
                    await conn.send(MClientReply(
                        tid=msg.tid, result=-18,
                        error="cross-subtree rename"))
                    return True
            if msg.op in _MUTATING:
                async with self._lock:     # the MDS serialization point
                    cached = self._completed.get(dup_key)
                    if cached is not None:
                        self.perf.inc("mds_dup_requests")
                        await conn.send(cached)
                        return True
                    # authority can flip while we queued for the lock
                    # (export_dir is lock-serialized too): re-check, or
                    # two ranks could mutate one subtree unserialized
                    if msg.args and self._owner_rank(
                            str(msg.args[0])) != self.rank:
                        await conn.send(MClientReply(
                            tid=msg.tid, result=-116,
                            error=str(self._owner_rank(
                                str(msg.args[0])))))
                        return True
                    self._seq += 1
                    seq = self._seq
                    await self._journal_append(seq, (msg.op,) + msg.args)
                    # journalled but not yet applied: a crash here is
                    # the canonical replay case (append -> apply gap)
                    self._chaos_point("mds_journal_mid")
                    data = await self._apply((msg.op,) + msg.args)
                    await self._journal_commit(seq)
                reply = MClientReply(tid=msg.tid, result=0, data=data)
            elif msg.op == "stat":
                live, rec = self._split_snap_path(str(msg.args[0]))
                if rec == "LIST":
                    raise FileNotFoundError(msg.args[0])
                snapid = rec["meta_id"] if rec else None
                ino = await self.fs.stat(live, snapid=snapid)
                reply = MClientReply(
                    tid=msg.tid, result=0, data=pickle.dumps(ino),
                    lease_ttl=self.lease_ttl,
                    snapc=self._data_snapc(),
                    snapid=rec["data_id"] if rec else None)
            elif msg.op == "listdir":
                live, rec = self._split_snap_path(str(msg.args[0]))
                if rec == "LIST":
                    # '/d/.snap': the dir's snapshot names
                    base = self._norm(live[: -len("/.snap")]
                                      if live.endswith("/.snap") else live)
                    names = sorted(n for n, r in self.snaptable.items()
                                   if r["dir"] == base)
                else:
                    names = await self.fs.listdir(
                        live, snapid=rec["meta_id"] if rec else None)
                reply = MClientReply(tid=msg.tid, result=0, data=names,
                                     lease_ttl=self.lease_ttl)
            elif msg.op in ("snap_create", "snap_rm", "export_dir"):
                # durable admin mutations: dup-cached like journal ops,
                # so a retry after a lost reply gets the ORIGINAL answer
                # instead of a spurious EEXIST/ENOENT
                barrier = 0.0
                async with self._lock:
                    cached = self._completed.get(dup_key)
                    if cached is not None:
                        self.perf.inc("mds_dup_requests")
                        await conn.send(cached)
                        return True
                    if msg.op == "snap_create":
                        data = await self._snap_create(msg.args[0],
                                                       msg.args[1])
                        reply = MClientReply(tid=msg.tid, result=0,
                                             data=data)
                        # lease barrier OUTSIDE the lock: clients cache
                        # stat replies (and their data snapc) up to
                        # lease_ttl, and other ranks adopt the snaptable
                        # on their beacon tick — by reply time every rank
                        # refreshed and every pre-refresh lease expired,
                        # so no write can miss the new COW context (caps
                        # revocation by timeout).  The lock is NOT held:
                        # this rank's own snapc is already installed.
                        barrier = self.lease_ttl + \
                            self.config.mds_beacon_interval
                    elif msg.op == "snap_rm":
                        await self._snap_rm(msg.args[0], msg.args[1])
                        reply = MClientReply(tid=msg.tid, result=0)
                    else:
                        await self._export_dir(msg.args[0],
                                               int(msg.args[1]))
                        reply = MClientReply(tid=msg.tid, result=0)
                    self._completed[dup_key] = reply
                if barrier:
                    await asyncio.sleep(barrier)
            else:
                reply = MClientReply(tid=msg.tid, result=-95,
                                     error=f"bad op {msg.op}")
        except FileExistsError as e:
            reply = MClientReply(tid=msg.tid, result=-17, error=str(e))
        except FileNotFoundError as e:
            reply = MClientReply(tid=msg.tid, result=-2, error=str(e))
        except NotADirectoryError as e:
            reply = MClientReply(tid=msg.tid, result=-20, error=str(e))
        except Exception as e:
            self.perf.inc("mds_errors")
            reply = MClientReply(tid=msg.tid, result=-5, error=repr(e))
        if msg.op in _MUTATING or msg.op in ("snap_create", "snap_rm",
                                             "export_dir"):
            self._completed[dup_key] = reply
            while len(self._completed) > 3000:
                self._completed.popitem(last=False)
        try:
            await conn.send(reply)
        except (ConnectionError, OSError, RuntimeError):
            pass
        return True


class MDSClient:
    """Client-side CephFS surface through the MDS (reference Client.cc):
    metadata ops go to the active MDS (address from the cluster map,
    MDSMap-lite); file DATA rides the striper straight to the OSDs.
    stat/listdir replies carry a read lease — cached until expiry, so
    repeated lookups don't round-trip (Locker caps-lite)."""

    def __init__(self, rados_client, data_pool: int,
                 meta_pool: Optional[int] = None):
        self.client = rados_client
        self.objecter = rados_client.objecter
        self.data_io = rados_client.ioctx(data_pool)
        self.meta_io = rados_client.ioctx(meta_pool) \
            if meta_pool is not None else None
        self._tid = 0
        self._lease: Dict[Tuple, Tuple[float, object]] = {}
        self._subtrees: Dict[str, int] = {"/": 0}

    def _mds_addr(self, rank: int = 0):
        addrs = getattr(self.objecter.osdmap, "mds_addrs", None) or {}
        addr = addrs.get(rank)
        if addr is None and rank == 0:
            addr = getattr(self.objecter.osdmap, "mds_addr", None)
        if addr is None:
            raise ConnectionError(f"no active MDS rank {rank} in the map")
        return tuple(addr)

    def _owner_rank(self, path: str) -> int:
        return owner_rank(self._subtrees, path)

    async def _refresh_subtrees(self) -> None:
        if self.meta_io is None:
            return
        try:
            om = await self.meta_io.omap_get("mds_subtrees")
            self._subtrees = {p: int(r) for p, r in om.items()}
        except (FileNotFoundError, IOError):
            pass

    async def _call(self, op: str, *args, timeout: float = 30.0):
        self._tid += 1
        tid = self._tid
        deadline = asyncio.get_event_loop().time() + timeout
        rank = self._owner_rank(args[0]) if args else 0
        while True:
            # fresh future per attempt: wait_for CANCELS on timeout, and
            # re-awaiting a cancelled future would kill the retry loop
            fut = asyncio.get_event_loop().create_future()
            self.objecter._mds_inflight[tid] = fut
            try:
                await self.objecter.messenger.send_message(
                    MClientRequest(tid=tid,
                                   client=self.objecter.client_name,
                                   op=op, args=tuple(args)),
                    self._mds_addr(rank))
                reply = await asyncio.wait_for(fut, timeout=5.0)
                if reply.result == -116:
                    # wrong rank: adopt the owner hint / fresh subtree
                    # map and retarget (reference forward-to-auth)
                    self.objecter._mds_inflight.pop(tid, None)
                    await self._refresh_subtrees()
                    try:
                        rank = int(reply.error)
                    except (TypeError, ValueError):
                        rank = self._owner_rank(args[0]) if args else 0
                    if asyncio.get_event_loop().time() > deadline:
                        raise TimeoutError(f"mds op {op} kept bouncing")
                    continue
                break
            except (ConnectionError, OSError, asyncio.TimeoutError):
                # MDS restarting: refresh the map for the new address;
                # the MDS dup cache makes the mutating retry safe
                self.objecter._mds_inflight.pop(tid, None)
                if asyncio.get_event_loop().time() > deadline:
                    raise TimeoutError(f"mds op {op} timed out")
                try:
                    await self.objecter._refresh_map()
                    await self._refresh_subtrees()
                    rank = self._owner_rank(args[0]) if args else 0
                except (IOError, OSError, TimeoutError,
                        ConnectionError):
                    pass  # stale map/rank: the retry loop re-resolves
                await asyncio.sleep(0.2)
        if reply.result == -17:
            raise FileExistsError(reply.error)
        if reply.result == -2:
            raise FileNotFoundError(reply.error)
        if reply.result == -20:
            raise NotADirectoryError(reply.error)
        if reply.result == -18:
            raise OSError(18, f"cross-device: {reply.error}")
        if reply.result != 0:
            raise IOError(f"mds {op}: {reply.result} {reply.error}")
        return reply

    # -- metadata surface --------------------------------------------------

    async def mkdir(self, path: str) -> int:
        self._lease.clear()
        return (await self._call("mkdir", path)).data

    async def create(self, path: str) -> int:
        self._lease.clear()
        return (await self._call("create", path)).data

    async def unlink(self, path: str) -> None:
        self._lease.clear()
        await self._call("unlink", path)

    async def rename(self, src: str, dst: str) -> None:
        self._lease.clear()
        await self._call("rename", src, dst)

    async def stat(self, path: str) -> Inode:
        ino, _ = await self._stat_full(path)
        return ino

    async def _stat_full(self, path: str):
        """(inode, snapid) — also adopts the reply's data-pool write
        SnapContext (the caps-carried snapc analog), so subsequent data
        writes COW correctly across fs snapshots."""
        now = time.monotonic()
        hit = self._lease.get(("stat", path))
        if hit is not None and hit[0] > now:
            return hit[1]
        reply = await self._call("stat", path)
        ino = pickle.loads(reply.data)
        if reply.snapc is not None:
            seq, snaps = reply.snapc
            self.data_io.set_snap_context(seq, list(snaps))
        out = (ino, reply.snapid)
        if reply.lease_ttl > 0:
            self._lease[("stat", path)] = (now + reply.lease_ttl, out)
        return out

    # -- snapshots (.snap surface) ------------------------------------------

    async def snap_create(self, dirpath: str, name: str) -> int:
        """mkdir dir/.snap/name analog (reference ceph fs snapshots)."""
        self._lease.clear()
        return (await self._call("snap_create", dirpath, name)).data

    async def snap_rm(self, dirpath: str, name: str) -> None:
        self._lease.clear()
        await self._call("snap_rm", dirpath, name)

    async def export_dir(self, path: str, rank: int) -> None:
        """Move subtree authority to ``rank`` (Migrator::export_dir)."""
        self._lease.clear()
        await self._call("export_dir", path, rank)
        await self._refresh_subtrees()

    async def listdir(self, path: str = "/") -> List[str]:
        now = time.monotonic()
        hit = self._lease.get(("ls", path))
        if hit is not None and hit[0] > now:
            return hit[1]
        reply = await self._call("listdir", path)
        if reply.lease_ttl > 0:
            self._lease[("ls", path)] = (now + reply.lease_ttl, reply.data)
        return reply.data

    # -- data surface (direct to OSDs, reference file I/O semantics) -------

    _DEFAULT_LAYOUT = None

    def _file_layout(self, ino: Inode):
        if ino.layout is not None:
            return ino.layout
        from ceph_tpu_torch.cluster.striper import FileLayout

        return FileLayout(stripe_unit=1 << 16, stripe_count=1,
                          object_size=1 << 20)  # fs.py default layout

    async def write(self, path: str, offset: int, data: bytes) -> None:
        ino, snapid = await self._stat_full(path)
        if snapid is not None:
            raise PermissionError(f"{path}: snapshots are read-only")
        from ceph_tpu_torch.cluster.striper import StripedReader, file_to_extents

        fmt = f"{ino.ino:x}.%016x"   # fs.py FileSystem._fmt layout
        extents = file_to_extents(fmt, self._file_layout(ino),
                                  offset, len(data))
        per_object = StripedReader.scatter(extents, data)
        await asyncio.gather(*[
            self.data_io.write(oid, blob, offset=obj_off)
            for oid, parts in per_object.items()
            for obj_off, blob in parts])
        new_size = max(ino.size, offset + len(data))
        if new_size != ino.size:
            self._lease.pop(("stat", path), None)
            await self._call("set_size", path, new_size)

    async def read(self, path: str, offset: int = 0,
                   length: Optional[int] = None) -> bytes:
        ino, snapid = await self._stat_full(path)
        from ceph_tpu_torch.cluster.striper import StripedReader, file_to_extents

        if length is None:
            length = max(0, ino.size - offset)
        length = min(length, max(0, ino.size - offset))
        if length == 0:
            return b""
        fmt = f"{ino.ino:x}.%016x"
        extents = file_to_extents(fmt, self._file_layout(ino),
                                  offset, length)

        async def fetch(ex):
            try:
                return ex.oid, await self.data_io.read(
                    ex.oid, offset=ex.offset, length=ex.length,
                    snapid=snapid)
            except FileNotFoundError:
                return ex.oid, b""

        got = dict(await asyncio.gather(*[fetch(ex) for ex in extents]))
        return StripedReader.assemble(extents, got, length, relative=True)

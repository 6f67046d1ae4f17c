"""Wire messages (reference src/messages/ analog).

Counterpart of ``ceph_tpu/cluster/messages.py``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster.messenger import Addr, Message
from ceph_tpu_torch.osdmap.osdmap import PGid


# -- mon <-> daemons --------------------------------------------------------


@dataclass
class MPing(Message):
    stamp: float = 0.0
    reply: bool = False


@dataclass
class MOSDBoot(Message):
    osd_id: int = -1
    addr: Optional[Addr] = None
    instance: int = 0   # per-daemon-start nonce (addr-reuse fencing)


@dataclass
class MOSDFailure(Message):
    failed_osd: int = -1
    reporter: int = -1


@dataclass
class MOSDAlive(Message):
    """OSD beacon (reference MOSDBeacon): liveness + store usage +
    blocked-op telemetry for the mon's SLOW_OPS health check."""

    osd_id: int = -1
    statfs: Optional[Tuple[int, int]] = None   # (total_bytes, used_bytes)
    slow_ops: Optional[Tuple[int, float]] = None  # (count, oldest_age_s)
    # event-loop profiler feed (ceph_tpu/trace/loopmon.py): (last_lag_s,
    # window_max_s) since the previous beacon; None when the sampler is
    # off.  Drives the mon's LOOP_LAG health check beside SLOW_OPS.
    loop_lag: Optional[Tuple[float, float]] = None
    # integrity feed (round 16): (unrepaired inconsistent objects, PGs
    # holding any) on this OSD's primary PGs — drives the mon's
    # PG_INCONSISTENT / OSD_SCRUB_ERRORS health checks, raised while
    # nonzero and cleared by the next clean beacon like SLOW_OPS.
    scrub_stats: Optional[Tuple[int, int]] = None
    # recovery feed (round 21): primary PGs still owing a peering or
    # backfill round, and the map epoch this beacon judged them under.
    # Drives the mon's PG_RECOVERING check: an epoch older than the
    # last placement change means the claim is stale (pessimistic).
    unclean_pgs: Optional[int] = None
    map_epoch: int = 0


# throttle-full admission pushback result (EBUSY): distinct from the
# -11 misdirect hint on purpose — a pushed-back client must NOT refresh
# its map (the target is right, the daemon is full); it shrinks its
# congestion window and retries after a jittered backoff.  The errno
# alone is NOT the discriminator: op handlers can legitimately return
# -16 (cls lock contention), so pushback replies additionally set
# MOSDOpReply.throttled — the out-of-band flag clients key off.
THROTTLED = -16

# op verbs that mutate object state — shared by the OSD's dedup/caps
# logic and the objecter's cache-overlay targeting so the two can never
# drift (a verb classified differently on the two sides would route
# writes to the read tier)
MUTATING_OPS = frozenset({
    "write_full", "write", "delete", "setxattr", "rmxattr",
    "omap_set", "omap_rmkeys", "exec",
    "append", "truncate", "zero", "create",
    "copy_from", "rollback"})


@dataclass
class MLog(Message):
    """Cluster-log events daemon -> mon (reference MLog,
    src/messages/MLog.h; entries per src/common/LogEntry.h: who, stamp,
    priority, message).  The mon's log service Paxos-replicates them."""

    entries: Tuple = ()   # of (who: str, stamp: float, prio: str, msg: str)


@dataclass
class MOSDPGTemp(Message):
    """Primary -> mon temp-mapping request (reference MOSDPGTemp):
    ``osds`` empty asks the mon to CLEAR the pg's temp entry — sent by
    the acting primary once every up-member is backfilled current, the
    handoff that completes an elastic reshape."""

    pgid: Optional[PGid] = None
    osds: Tuple[int, ...] = ()
    epoch: int = 0       # sender's map epoch (staleness witness)
    osd_id: int = -1     # sender: the mon only honors a clear from a
                         # member of the live temp entry (a blip-degraded
                         # non-donor "primary" must not drop the handoff)


@dataclass
class MMonSubscribe(Message):
    what: str = "osdmap"
    addr: Optional[Addr] = None
    since: int = 0  # subscriber's current epoch; 0 = send the full map
    # the subscriber's refresh number, echoed on the map message that
    # answers it (0: none), so a refresh waits for its own answer and
    # not for a push already in flight
    tid: int = 0


@dataclass
class MOSDMapMsg(Message):
    epoch: int = 0
    osdmap_blob: bytes = b""
    sub_tid: int = 0  # the MMonSubscribe.tid this answers (0: a push)


@dataclass
class MOSDIncMapMsg(Message):
    """Incremental map delta chain: apply in order on top of prev_epoch
    (reference OSDMap::Incremental distribution)."""

    prev_epoch: int = 0
    epoch: int = 0
    inc_blobs: List[bytes] = field(default_factory=list)
    sub_tid: int = 0  # the MMonSubscribe.tid this answers (0: a push)


@dataclass
class MMonCommand(Message):
    cmd: Dict[str, Any] = field(default_factory=dict)
    tid: int = 0


@dataclass
class MMonCommandReply(Message):
    tid: int = 0
    result: int = 0
    data: Any = None


# -- mon <-> mon (election + paxos) ----------------------------------------


@dataclass
class MMonElection(Message):
    """Election protocol (reference src/mon/Elector.cc MMonElection):
    op in {"propose", "ack", "victory"}."""

    op: str = "propose"
    epoch: int = 0
    rank: int = -1
    quorum: List[int] = field(default_factory=list)
    # the candidate's paxos last_committed (round 14): peers holding
    # newer committed state refuse to defer, so a revived blank monitor
    # cannot win leadership (and fork map epochs) before catching up
    last_committed: int = 0


@dataclass
class MMonPaxos(Message):
    """Paxos phases (reference src/mon/Paxos.cc and MMonPaxos):
    op in {"collect", "last", "begin", "accept", "commit", "lease"}."""

    op: str = "collect"
    pn: int = 0
    rank: int = -1
    epoch: int = 0             # election epoch (lease fencing)
    last_committed: int = 0
    version: int = 0           # version being proposed / committed
    value: bytes = b""         # pickled payload
    uncommitted_pn: int = 0
    uncommitted_version: int = 0
    uncommitted_value: bytes = b""
    catch_up: List[Tuple[int, bytes]] = field(default_factory=list)


# -- client <-> osd ---------------------------------------------------------


@dataclass
class MOSDOp(Message):
    """Client op (reference MOSDOp): ops are (opname, kwargs) pairs."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None
    oid: str = ""
    ops: List[Tuple[str, Dict[str, Any]]] = field(default_factory=list)
    epoch: int = 0
    # snapshot axis (reference MOSDOp carries both): snapc governs
    # clone-on-write for mutations, snapid selects the snap a read sees
    snapc: Optional[Tuple[int, Tuple[int, ...]]] = None
    snapid: Optional[int] = None
    # absolute wall-clock deadline of the CLIENT's total op budget: OSDs
    # drop the op at dequeue once it passes (nobody awaits the reply),
    # and sub-ops inherit it so replicas shed dead work too
    deadline: Optional[float] = None


@dataclass
class MOSDOpReply(Message):
    reqid: Tuple[str, int] = ("", 0)
    result: int = 0
    data: Any = None
    epoch: int = 0
    # True ONLY for admission-throttle pushback: result=-16 alone is
    # ambiguous (a cls lock EBUSY is an op RESULT to surface, not a
    # congestion signal to retry)
    throttled: bool = False


@dataclass
class MOSDOpBatch(Message):
    """A client tick's ops for ONE OSD in ONE frame (round 18): each
    item is a complete MOSDOp, resolved/admitted per item on the OSD —
    the client-edge twin of MOSDECSubOpWriteBatch.  Collapses the
    per-op frame churn the objecter coalescer measured dominating the
    saturation knee."""

    items: List[Any] = field(default_factory=list)
    epoch: int = 0


@dataclass
class MOSDOpReplyBatch(Message):
    """A reply tick's acks for ONE client conn in ONE frame: each item
    is a complete MOSDOpReply (result, data, epoch, throttled, and the
    reply-leg trace all per item).  Ops the OSD SHED (expired deadline)
    are absent — their clients must stay un-acked, exactly the
    MOSDECSubOpWriteBatchReply per-item rule."""

    items: List[Any] = field(default_factory=list)


@dataclass
class MCommand(Message):
    """Daemon-directed admin command (reference MCommand / the admin
    socket surface: 'ceph tell osd.N <cmd>')."""

    tid: int = 0
    cmd: Dict[str, Any] = field(default_factory=dict)


@dataclass
class MCommandReply(Message):
    tid: int = 0
    result: int = 0
    data: Any = None


@dataclass
class MMgrReport(Message):
    """Perf-counter stream to the mgr (reference MMgrReport,
    MgrClient::send_report, src/mgr/MgrClient.cc:232)."""

    daemon: str = ""
    counters: Dict[str, Any] = field(default_factory=dict)
    stamp: float = 0.0


@dataclass
class MMgrBeacon(Message):
    """Mgr announces itself to the mon (reference MMgrBeacon)."""

    addr: Optional[Addr] = None


@dataclass
class MWatchNotify(Message):
    """Watcher callback delivery (reference MWatchNotify): sent by the
    primary OSD to every registered watcher when a notify op fires."""

    pool: int = -1
    oid: str = ""
    notify_id: int = 0
    cookie: int = 0
    payload: bytes = b""


# -- osd <-> osd (replication / EC / recovery) ------------------------------


@dataclass
class MOSDRepOp(Message):
    """Replica transaction (reference MOSDRepOp): carries the pg log entry
    so every member's log advances identically with the mutation."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None
    txn_blob: bytes = b""
    entry: Any = None            # pglog.LogEntry
    epoch: int = 0
    # inherited from the parent client op (None for recovery traffic):
    # an expired sub-write is dead work — the primary's client is gone
    deadline: Optional[float] = None


@dataclass
class MOSDRepOpReply(Message):
    reqid: Tuple[str, int] = ("", 0)
    result: int = 0


@dataclass
class MOSDECSubOpWrite(Message):
    """Shard write (reference MOSDECSubOpWrite, ECBackend.cc:921).

    chunk_off/shard_size carry the RMW sub-range: data lands at chunk_off
    within the shard, which is then truncated/zero-extended to shard_size
    (zero stripes encode to zero parity — the code is linear — so extension
    commutes with encode)."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None
    oid: str = ""
    shard: int = -1
    data: bytes = b""
    chunk_off: int = 0
    shard_size: Optional[int] = None
    # store-level ops applied atomically BEFORE the shard write (COW
    # clone of the pre-write shard, snapset persistence, clone trims) —
    # the shard-local analog of the replicated txn fan-out
    pre_ops: List[Tuple] = field(default_factory=list)
    hinfo: Dict[str, Any] = field(default_factory=dict)
    entry: Any = None            # pglog.LogEntry
    epoch: int = 0
    deadline: Optional[float] = None  # inherited parent-op deadline
    # at-rest layout of ``data`` (round 19): None = shard bytes;
    # "planar8" = the (8, len/8) packed bit-plane matrix row-major, to
    # be landed via Transaction.write_planar — wire, store, and kernel
    # agree on layout so the steady state never converts
    layout: Optional[str] = None


@dataclass
class MOSDECSubOpWriteReply(Message):
    reqid: Tuple[str, int] = ("", 0)
    result: int = 0


@dataclass
class MOSDECSubOpWriteBatch(Message):
    """A dispatch tick's shard sub-writes for ONE peer in ONE frame
    (round 11): each item is a complete MOSDECSubOpWrite, applied in
    list order.  Collapses the per-op frame/ack churn of the fan-out —
    the wire analog of the tick's coalesced encode."""

    items: List[Any] = field(default_factory=list)
    epoch: int = 0


@dataclass
class MOSDECSubOpWriteBatchReply(Message):
    """Per-item acks for a sub-write batch: (reqid, result, shard)
    triples.  Items the replica SHED (expired deadline) are absent —
    their primaries must stay un-acked, exactly like the unbatched
    path's no-reply contract."""

    results: List[Tuple] = field(default_factory=list)


@dataclass
class MOSDECSubOpRead(Message):
    """Shard read (reference handle_sub_read, ECBackend.cc:986).
    off/length select a chunk sub-range (None = whole shard)."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None
    oid: str = ""
    shard: int = -1
    off: int = 0
    length: Optional[int] = None
    deadline: Optional[float] = None  # inherited parent-op deadline


@dataclass
class MOSDECSubOpReadReply(Message):
    reqid: Tuple[str, int] = ("", 0)
    result: int = 0
    shard: int = -1
    data: bytes = b""
    hinfo: Dict[str, Any] = field(default_factory=dict)
    # at-rest layout of ``data`` (round 19): None = shard bytes;
    # "planar8" = packed bit-planes straight off the store (full-shard
    # reads only — sub-range reads always ship bytes)
    layout: Optional[str] = None


@dataclass
class MOSDPGPush(Message):
    """Recovery push (reference push/pull recovery, ReplicatedBackend).
    op="push" writes the object; op="delete" removes it (a logged delete
    replayed onto a stale member)."""

    pgid: Optional[PGid] = None
    oid: str = ""
    shard: int = -1  # -1 for replicated full object
    op: str = "push"
    data: bytes = b""
    version: int = 0
    entry: Any = None            # pglog.LogEntry
    xattrs: Dict[str, bytes] = field(default_factory=dict)
    # op="rewind": the primary's ``PGState.interval_epoch``; a member
    # refuses a rewind from an interval older than its newest peering
    # query's (None: no check)
    interval: Optional[int] = None


@dataclass
class MOSDPGPushReply(Message):
    pgid: Optional[PGid] = None
    oid: str = ""
    result: int = 0


@dataclass
class MOSDScrub(Message):
    """Scrub-map request from the primary (reference MOSDRepScrub)."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None


@dataclass
class MOSDScrubMap(Message):
    """Member's scrub map: oid -> (version, size, computed_crc,
    stored_crc) (reference ScrubMap exchange)."""

    reqid: Tuple[str, int] = ("", 0)
    pgid: Optional[PGid] = None
    objects: Dict[str, Tuple[int, int, int, Optional[int]]] = \
        field(default_factory=dict)

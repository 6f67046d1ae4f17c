"""PG state + persistent pg log plumbing (reference src/osd/PG.h/cc).

Counterpart of ``ceph_tpu/cluster/pg.py``.

Split out of osd.py along the reference's PG seam: PGState is the
pg_info_t/pg_log_t analog; PGLogMixin carries the incremental on-store
log persistence every mutation rides (PG::write_if_dirty) and the
recovery-time full rewrite/load paths."""

from __future__ import annotations

import asyncio
import contextlib
import contextvars
import pickle
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster import pglog
from ceph_tpu_torch.cluster.pglog import LogEntry, PGInfo, PGLog
from ceph_tpu_torch.cluster.store import Transaction
from ceph_tpu_torch.osdmap.osdmap import PGid, ceph_stable_mod
from ceph_tpu_torch.analysis import racecheck
from ceph_tpu_torch.utils.lockdep import DepLock

# the client reqid whose op vector is currently executing (set around
# _execute_client_ops by the mutation-dedup wrapper); _log_mutation stamps
# it into primary-minted log entries so dup protection replicates with
# the log.  A ContextVar so interleaved client tasks can't cross-stamp.
CURRENT_CLIENT_REQID: contextvars.ContextVar = contextvars.ContextVar(
    "ceph_tpu_current_client_reqid", default=None)

# the wall-clock deadline of the client op currently executing (set
# around _dispatch_client_op): sub-writes/sub-reads fanned out under it
# inherit the parent deadline so replicas can shed dead work.  None for
# recovery/scrub traffic, which has no client waiting.
CURRENT_OP_DEADLINE: contextvars.ContextVar = contextvars.ContextVar(
    "ceph_tpu_current_op_deadline", default=None)


# the per-PG metadata object holding the persisted log + last_update
# (reference: the pgmeta ghobject, PG::_init / read_info)
PGMETA = "_pgmeta_"
# per-PG rollback journal: omap keyed by entry seq holding the local
# pre-write state of EC shard mutations (reference: the rollback info
# ECBackend attaches to local transactions,
# doc/dev/osd_internals/erasure_coding/ecbackend.rst:10-27)
PGRB = "_pgrb_"

@dataclass
class PGState:
    pgid: PGid
    up: List[int] = field(default_factory=list)
    acting: List[int] = field(default_factory=list)
    primary: int = -1
    # pg_info_t analog: every mutation advances last_update and appends to
    # the log (reference PG.h pg_log)
    last_update: pglog.Eversion = pglog.ZERO
    # newest version known acked by EVERY acting member (reference
    # last_complete / min_last_complete_ondisk): entries above it may be
    # rolled back during peering, entries at or below never are
    last_complete: pglog.Eversion = pglog.ZERO
    log: PGLog = field(default_factory=PGLog)
    # per-PG op serialization domain (reference PG lock / ShardedOpWQ,
    # src/osd/OSD.h:1599): mutations hold this across their whole
    # fan-out so concurrent writes order identically on all replicas.
    # DepLock so orderings against the daemon/messenger locks enter the
    # lockdep graphs; all PGs share one name — per-task nesting of two
    # PG locks is self-ordering lockdep cannot model, and the reference
    # likewise registers one lockdep id per lock NAME
    lock: DepLock = field(default_factory=lambda: DepLock("pg.lock"))
    # reqid -> cached replies of completed mutations (reference pg_log
    # dup tracking, osd_pg_log_dups_tracked): a resent non-idempotent op
    # (exec, delete, ...) returns its original reply instead of
    # re-executing.  In-memory only — a primary restart forgets dups the
    # way a reference OSD forgets dups past the trimmed log.
    reqid_replies: "OrderedDict[Tuple, List]" = field(
        default_factory=OrderedDict)
    # reqids currently executing: a dup that races its first instance
    # waits for that instance's replies rather than re-executing
    reqid_inflight: Dict[Tuple, asyncio.Future] = field(
        default_factory=dict)
    # in-flight client mutations awaiting their fan-out acks: version
    # -> acked?  Insertion order IS version order (registered under the
    # PG lock right after version assignment), and the commit watermark
    # only advances over the contiguous resolved prefix — an op whose
    # acks land out of order can never bless an earlier still-pending
    # write (see PGLogMixin._frontier_done)
    pipeline_pending: "OrderedDict[pglog.Eversion, bool]" = field(
        default_factory=OrderedDict)
    # crash-restart frontier reconstruction: logged entries
    # above the persisted watermark whose fan-out acks died with the
    # previous process life.  They sit in pipeline_pending as OPEN
    # entries (so last_complete cannot bless them) until peering
    # verifies every acting member holds them (roll forward) or rewinds
    # them; a recovery round is not complete while any remain.
    frontier_recovering: set = field(default_factory=set)
    # per-object write serialization for the pipelined RMW path (round
    # 12, reference ECBackend::start_rmw wait queue): read-merge-encode
    # runs under the OBJECT's lock, not the PG's, so one object's RMW
    # can never interleave with (or lose) another write to the same
    # object while the rest of the PG proceeds.  Entries are created on
    # demand and dropped when uncontended (see OSD._obj_write_lock).
    obj_locks: Dict[str, object] = field(default_factory=dict)
    obj_lock_refs: Dict[str, int] = field(default_factory=dict)
    # objects currently known inconsistent.  Feeds the beacon's scrub_stats and so the mon's
    # PG_INCONSISTENT / OSD_SCRUB_ERRORS health flow: raise while
    # non-empty, clear when the repairs land.
    inconsistent: set = field(default_factory=set)
    # the map epoch at which this OSD saw the PG's acting set or primary
    # last change (reference same_interval_since).  A primary's EC
    # client write carries it and acks only if it is still current when
    # every sub-write ack is in (``_ec_commit_finish``).
    interval_epoch: int = 0
    # the newest interval a peering query for this PG announced to this
    # member: a client sub-write of an older interval is refused, so an
    # old primary that has not seen the new map yet cannot complete a
    # write that the new primary's peering already ruled out
    peer_interval: int = 0

    def frontier_acked(self, seq: int) -> bool:
        """Is seq a RESOLVED (fully acked) frontier entry that the
        contiguous-prefix watermark merely hasn't swept yet?  Reads may
        serve such a generation: its durability is established even
        though last_complete is held back by an earlier open entry."""
        return any(ok and v[1] == seq
                   for v, ok in self.pipeline_pending.items())

    def info(self) -> PGInfo:
        return PGInfo(last_update=self.last_update, log_tail=self.log.tail,
                      last_complete=self.last_complete)


@dataclass
class MOSDPGQuery(M.Message):
    pgid: Optional[PGid] = None
    # the querying primary's ``PGState.interval_epoch`` (0: none)
    interval: int = 0


@dataclass
class MOSDPGQueryReply(M.Message):
    pgid: Optional[PGid] = None
    objects: Dict[str, int] = field(default_factory=dict)  # oid -> seq
    info: Optional[PGInfo] = None
    log: Optional[PGLog] = None


def _coll(pgid: PGid) -> str:
    return f"pg_{pgid.pool}_{pgid.seed}"



class PGLogMixin:
    """Persistent pg-log state carried by the OSD daemon (PG::write_if_dirty
    / read_info seam)."""

    def _next_version(self, st: PGState) -> pglog.Eversion:
        """eversion for the next mutation: (map epoch, next seq)."""
        return (self.osdmap.epoch if self.osdmap else 0, st.last_update[1] + 1)

    @staticmethod
    def _meta_key(version: pglog.Eversion) -> str:
        return f"{version[0]:010d}.{version[1]:012d}"

    def _log_mutation(self, st: PGState, op: str, oid: str,
                      version: pglog.Eversion,
                      entry: Optional[LogEntry] = None):
        """Append a log entry + persist it INCREMENTALLY to the pgmeta
        object (one omap key per entry + a head attr), so a restarted OSD
        peers from its on-store log instead of backfilling and the hot
        write path never re-serializes the whole log (reference: log
        entries ride the op's own transaction, PG::write_if_dirty).
        Replicas pass the primary's ``entry`` through verbatim so every
        member's log (incl. prior_version chains) stays byte-identical.
        Returns the appended LogEntry, or None for a replayed duplicate."""
        if version <= st.last_update:
            return None  # replayed/duplicate entry
        if entry is None:
            entry = LogEntry(op=op, oid=oid, version=version,
                             prior_version=st.last_update,
                             committed=st.last_complete,
                             client_reqid=CURRENT_CLIENT_REQID.get())
        st.log.append(entry)
        st.last_update = version
        if racecheck.TRACKER:  # graft-race: the log head advanced —
            # any other task still resting on a round-start self-info
            # snapshot (recovery's roll-forward floor) is now stale
            racecheck.TRACKER.note_write(
                ("pg", getattr(self, "osd_id", -1), str(st.pgid)),
                "self_info")
        dropped = st.log.trim()
        coll = _coll(st.pgid)
        txn = (Transaction()
               .omap_set(coll, PGMETA,
                         {self._meta_key(version): pickle.dumps(entry)})
               .setattr(coll, PGMETA, "last_update", pickle.dumps(version))
               .setattr(coll, PGMETA, "log_tail", pickle.dumps(st.log.tail)))
        if dropped:
            txn.omap_rmkeys(coll, PGMETA,
                            [self._meta_key(e.version) for e in dropped])
        # learn the primary's commit watermark from the entry stream and
        # drop rollback records for entries that can no longer rewind.
        # Routed through _frontier_learn: the primary's word resolves
        # any boot-reconstructed open entries at/below it (a replica's
        # own frontier must never wedge on entries the primary already
        # committed cluster-wide)
        committed = getattr(entry, "committed", pglog.ZERO)
        if committed > st.last_complete:
            self._frontier_learn(st, committed, txn)
        self.store.queue_transaction(txn)
        return entry

    def _frontier_rebuild(self, st: PGState) -> None:
        """Crash-restart frontier reconstruction: the
        frontier was purely in-memory, so a restarted daemon
        forgot which logged entries were still awaiting their fan-out
        acks — and a post-restart write that fully acked would advance
        ``last_complete`` PAST them, blessing writes whose acks died
        with the process (peering might still rewind them: broken
        read-your-ack by construction).  Re-register every logged entry
        above the persisted watermark as an OPEN frontier entry;
        peering resolves each by verifying every acting member holds it
        (roll forward, reference PG::activate) or rewinding it."""
        for e in st.log.entries:
            if e.version > st.last_complete:
                st.pipeline_pending[e.version] = False
                st.frontier_recovering.add(e.version)
        if st.frontier_recovering:
            self.perf.inc("osd_frontier_rebuilt",
                          len(st.frontier_recovering))

    def _frontier_learn(self, st: PGState, version: pglog.Eversion,
                        txn=None) -> None:
        """An AUTHORITATIVE commit watermark arrived — the primary's
        entry stream, or a peering round that verified every acting
        member holds every entry up to ``version``.  Resolve open
        frontier entries at/below it (their durability is now
        established by authority, not by our own ack bookkeeping),
        sweep any contiguous resolved prefix beyond, and advance."""
        fl = st.pipeline_pending
        for v in [v for v in fl if v <= version]:
            del fl[v]
            st.frontier_recovering.discard(v)
        new = version
        while fl:
            v = next(iter(fl))
            if not fl[v]:
                break
            new = v
            del fl[v]
            st.frontier_recovering.discard(v)
        self._advance_last_complete(st, new, txn)

    @contextlib.asynccontextmanager
    async def _obj_write_lock(self, st: PGState, oid: str):
        """Per-object write serialization for the pipelined mutation
        path: an RMW holds this across its read-merge-encode
        window and commit start, and every other pipelined write to the
        SAME object takes it around its commit start — so no write can
        commit inside an RMW's read window (the lost-update race the
        full PG lock used to exclude), while writes to different
        objects of the PG proceed concurrently.  Always acquired BEFORE
        st.lock (the lockdep order pg.objlock -> pg.lock)."""
        lock = st.obj_locks.get(oid)
        if lock is None:
            lock = st.obj_locks[oid] = DepLock("pg.objlock")
        st.obj_lock_refs[oid] = st.obj_lock_refs.get(oid, 0) + 1
        try:
            async with lock:
                yield
        finally:
            n = st.obj_lock_refs.get(oid, 1) - 1
            if n <= 0:
                st.obj_lock_refs.pop(oid, None)
                st.obj_locks.pop(oid, None)
            else:
                st.obj_lock_refs[oid] = n

    def _entry_still_logged(self, st: PGState, entry) -> bool:
        """Is THIS LogEntry object still part of the PG's history?  The
        commit finishes use it to detect a concurrent peering rewind:
        comparing the version against the log head is foolable — new
        post-rewind writes re-advance ``last_update`` past (or a retry
        round at the same epoch re-MINTS) the rewound eversion, and a
        rolled-back write would ack as success.  Object identity cannot
        be re-minted.  A log ADOPTION (peering replaced the entries
        with auth copies) also fails the check — conservatively
        un-acked, and the client's retry dup-resolves against the log.
        Scans newest-first with an ordering early-exit: an in-flight
        commit's entry sits at/near the head."""
        if entry is None:
            return True
        for e in reversed(st.log.entries):
            if e is entry:
                return True
            if e.version < entry.version:
                return False
        return False

    def _frontier_open(self, st: PGState, version: pglog.Eversion) -> None:
        """Register an in-flight client mutation (called under the PG
        lock, immediately after version assignment, so insertion order
        is version order): the commit watermark may not advance past a
        PENDING entry — an out-of-order later ack blessing bytes that
        can still fail and roll back would break read-your-ack."""
        st.pipeline_pending[version] = False
        if racecheck.TRACKER:  # graft-race: the commit's registry
            # snapshot window OPENS here — `st` will outlive the PG
            # lock through the ack wait
            racecheck.TRACKER.note_read(
                ("pgs", getattr(self, "osd_id", -1), str(st.pgid)),
                "registry")

    def _frontier_done(self, st: PGState, version: pglog.Eversion,
                       ok: bool) -> None:
        """Resolve one in-flight mutation and advance the watermark over
        the contiguous RESOLVED prefix.  A failed (un-acked) entry is
        removed without blocking later acked entries — the pre-pipeline
        semantics, where a later fully-acked op advanced past an earlier
        failed one and peering owns the failed entry's fate."""
        if racecheck.TRACKER:  # graft-race: the snapshot window
            # CLOSES — resolution re-consults the registry downstream
            # (_advance_last_complete's identity re-check is the guard
            # this attests), so a registry swap during the ack wait is
            # revalidated, not acted on blind.  A commit task that
            # finishes without ever resolving its frontier entry keeps
            # the window open and convicts under the race smoke.
            racecheck.TRACKER.note_read(
                ("pgs", getattr(self, "osd_id", -1), str(st.pgid)),
                "registry")
        fl = st.pipeline_pending
        if version not in fl:
            # unregistered caller (recovery / roll-forward, or a commit
            # whose entry a concurrent peering round REWOUND out from
            # under its ack wait — version > last_update): direct
            # advance, still clamped below any pending entry and never
            # past the log head (blessing a rewound version would put
            # the watermark over history that no longer exists)
            if ok and version <= st.last_update:
                self._advance_last_complete(st, version)
            return
        if ok:
            fl[version] = True
        else:
            del fl[version]
            st.frontier_recovering.discard(version)
        new = None
        while fl:
            v = next(iter(fl))
            if not fl[v]:
                break
            new = v
            del fl[v]
            st.frontier_recovering.discard(v)
        if new is not None:
            self._advance_last_complete(st, new)
        self._frontier_rearm_if_short(st)

    def _frontier_rearm_if_short(self, st: PGState) -> None:
        """A DRAINED frontier with the watermark still short of the log
        head means some resolution failed (sub-write acks lost to a
        drop or a mid-fanout crash): no later ack will ever arrive for
        those entries and no map change is due, so without a kick the
        primary stays incomplete until an unrelated epoch — permanently
        on an idle pool (graft-race: batch-smoke at small scale wedges
        exactly here once the last round's acks are gone).  Peering's
        roll-forward owns the failed entries' fate — arm the
        capped-backoff recovery retry and let it rule on each."""
        if st.pipeline_pending or st.last_complete >= st.last_update:
            return
        if st.primary != getattr(self, "osd_id", -1):
            return
        retry = getattr(self, "_queue_recovery_retry", None)
        if retry is not None:
            retry(st)

    def _advance_last_complete(self, st: PGState, version: pglog.Eversion,
                               txn: Optional[Transaction] = None) -> None:
        """Raise the never-roll-back watermark and prune the rollback
        journal up to it (rollback info exists only to undo UN-acked
        entries, ecbackend.rst:10-27).  Never past a pending pipelined
        write: entries awaiting their fan-out acks are not durable."""
        if version <= st.last_complete:
            return
        if version > st.last_update:
            # never past the log head: a watermark over rewound (or
            # never-logged) history is unresolvable — peering elections
            # would find NO member whose log covers it
            return
        if st.pipeline_pending and \
                version >= next(iter(st.pipeline_pending)):
            return
        pgs = getattr(self, "pgs", None)
        if pgs is not None and pgs.get(st.pgid) is not st:
            # superseded PGState (the PG left and rejoined this OSD
            # while an op's ack-wait half was still in flight): its
            # watermark no longer owns the store attr — persisting it
            # here would race the LIVE state's view (surfaced by the
            # frontier invariant as persisted != in-memory).
            # The live state recomputes via peering / the entry stream.
            return
        st.last_complete = version
        coll = _coll(st.pgid)
        own = txn is None
        if own:
            txn = Transaction()
        txn.setattr(coll, PGMETA, "last_complete", pickle.dumps(version))
        dead = [k for k in self.store.omap_get(coll, PGRB)
                if int(k) <= version[1]]
        if dead:
            txn.omap_rmkeys(coll, PGRB, dead)
        if own:
            self.store.queue_transaction(txn)

    @staticmethod
    def _rb_key(seq: int) -> str:
        return f"{seq:012d}"

    def rewind_divergent_log(self, st: PGState,
                             auth_head: pglog.Eversion) -> List[str]:
        """Roll this member's log back to ``auth_head`` (reference
        PGLog::rewind_divergent_log, PGLog.cc:287): undo each divergent
        entry from its rollback record — restoring the EXACT pre-write
        shard bytes/attrs — newest first.  Entries without a record
        (replicated pools, lost records) fall back to removing the
        object; the returned oid list names those, for the caller to
        re-pull/push from the authoritative copy."""
        coll = _coll(st.pgid)
        rb = self.store.omap_get(coll, PGRB)
        need_copy: List[str] = []
        txn = Transaction()
        divergent = [e for e in st.log.entries if e.version > auth_head]
        for e in reversed(divergent):
            rec_blob = rb.get(self._rb_key(e.version[1]))
            if e.op == "trim":
                # snap-trim rollback is a no-op: removed_snaps come from
                # the osdmap, so the authoritative primary re-trims (the
                # operation is idempotent) and snap_sync reconciles
                pass
            elif rec_blob is None:
                txn.remove(coll, e.oid)
                need_copy.append(e.oid)
            else:
                rec = pickle.loads(rec_blob)
                if not rec["existed"]:
                    txn.remove(coll, rec["oid"])
                else:
                    if rec.get("layout") == "planar8":
                        # planar-at-rest object: old_range IS the
                        # captured plane blob — restore it AS planes (a
                        # byte write would land the blob as logical
                        # bytes and drop the layout); capture is
                        # whole-object (chunk_off 0)
                        txn.write_planar(coll, rec["oid"],
                                         rec["chunk_off"] // 8,
                                         rec["old_range"],
                                         rec["old_total"] // 8)
                    else:
                        txn.write(coll, rec["oid"], rec["chunk_off"],
                                  rec["old_range"])
                        txn.truncate(coll, rec["oid"], rec["old_total"])
                    # attrs + version roll back WITH the bytes on BOTH
                    # layouts: restoring planes while the divergent
                    # write's size/hinfo_crc/version attrs stay stamped
                    # leaves old data under a new crc, and the member
                    # fails verify-on-read forever after — an
                    # unrepairable-object wedge when it strikes more
                    # members than the code can spare (graft-race:
                    # batch-smoke seed 2, mid-fanout crash rewind on
                    # two of k+m=3 members)
                    for name, val in rec["old_attrs"].items():
                        if val is None:
                            txn.rmattr(coll, rec["oid"], name)
                        else:
                            txn.setattr(coll, rec["oid"], name, val)
                    txn.set_version(coll, rec["oid"], rec["old_version"])
                txn.omap_rmkeys(coll, PGRB, [self._rb_key(e.version[1])])
            txn.omap_rmkeys(coll, PGMETA, [self._meta_key(e.version)])
            self.perf.inc("osd_log_rewinds")
        st.log.entries = [e for e in st.log.entries
                          if e.version <= auth_head]
        # rolled-back entries leave the commit frontier too: a rewound
        # version can never ack, and a reconstructed open entry for it
        # would wedge the watermark forever
        for v in [v for v in st.pipeline_pending if v > auth_head]:
            del st.pipeline_pending[v]
            st.frontier_recovering.discard(v)
        # in-place entries rewrite: the lazy reqid dup index must rebuild,
        # or has_reqid would ack ops whose effects were just rolled back
        st.log._reqids = None
        st.last_update = auth_head
        txn.setattr(coll, PGMETA, "last_update", pickle.dumps(auth_head))
        self.store.queue_transaction(txn)
        return need_copy

    # ------------------------------------------------------- PG splitting

    def _split_pg(self, pool, st: "PGState") -> List[PGid]:
        """Split this parent PG's objects/log into child collections by
        stable_mod under the pool's CURRENT pg_num (reference
        PG::split_colls / split_into, PG.h:416-422,1436).

        Runs on every OSD holding the parent when pg_num grows; because
        pgp_num is unchanged at that moment, children place onto the SAME
        acting set as the parent (raw_pg_to_pps folds child seeds back to
        the parent's placement seed), so every member splits identically
        and the children activate with their data in place.  A later
        pgp_num increase migrates children via the normal remap+recovery
        path.  Returns the child pgids that received objects."""
        from ceph_tpu_torch.cluster import snaps as snapmod
        from ceph_tpu_torch.ops.jenkins import str_hash_rjenkins

        coll = _coll(st.pgid)
        new_num, mask = pool.pg_num, pool.pg_num_mask

        def child_seed(head: str) -> int:
            return ceph_stable_mod(
                str_hash_rjenkins(head.encode()), new_num, mask)

        from ceph_tpu_torch.cluster.tiering import HITSET_PREFIX

        moves: Dict[int, List[str]] = {}
        for name in self.store.list_objects(coll):
            if name in (PGMETA, PGRB) or name.startswith(HITSET_PREFIX):
                continue  # pg-internal bookkeeping objects stay put
            seed = child_seed(snapmod.head_of(name))
            if seed != st.pgid.seed:
                moves.setdefault(seed, []).append(name)
        # the LOG splits by oid hash independently of surviving store
        # objects: entries for deleted objects must migrate too, or their
        # dup protection dies with the split
        log_moves: Dict[int, List[LogEntry]] = {}
        for e in st.log.entries:
            seed = child_seed(snapmod.head_of(e.oid))
            if seed != st.pgid.seed:
                log_moves.setdefault(seed, []).append(e)
        children: List[PGid] = []
        for seed in sorted(set(moves) | set(log_moves)):
            names = moves.get(seed, [])
            child = PGid(st.pgid.pool, seed)
            children.append(child)
            dst = _coll(child)
            txn = Transaction()
            if dst not in self.store.list_collections():
                txn.create_collection(dst)
            for name in names:
                data = self.store.read(coll, name)
                txn.write(dst, name, 0, data if data else b"")
                for k, v in self.store.get_xattrs(coll, name).items():
                    txn.setattr(dst, name, k, v)
                om = self.store.omap_get(coll, name)
                if om:
                    txn.omap_set(dst, name, om)
                txn.set_version(dst, name, self.store.get_version(coll, name))
                txn.remove(coll, name)
            # child log: the parent's entries for the child's objects,
            # with the parent's watermarks so peering among the child's
            # members (== the parent's members) agrees
            entries = log_moves.get(seed, [])
            txn.omap_set(dst, PGMETA,
                         {self._meta_key(e.version): pickle.dumps(e)
                          for e in entries})
            txn.setattr(dst, PGMETA, "last_update",
                        pickle.dumps(st.last_update))
            txn.setattr(dst, PGMETA, "log_tail", pickle.dumps(st.log.tail))
            txn.setattr(dst, PGMETA, "last_complete",
                        pickle.dumps(st.last_complete))
            txn.setattr(dst, PGMETA, "split_pgnum", pickle.dumps(new_num))
            self.store.queue_transaction(txn)
            self.perf.inc("osd_pg_splits")
        # stamp the parent: this collection is now consistent with new_num
        self.store.queue_transaction(Transaction().setattr(
            coll, PGMETA, "split_pgnum", pickle.dumps(new_num)))
        if children and hasattr(self, "clog"):
            self.clog("INF", f"pg {st.pgid} split into "
                             f"{[str(c) for c in children]} "
                             f"(pg_num {new_num})")
        return children

    def _maybe_split(self, pool, st: "PGState") -> bool:
        """Split this PG if its on-store split watermark is behind the
        pool's pg_num.  The watermark persists with the PG (setattr on
        PGMETA), so an OSD that was down or restarted across the pg_num
        bump still splits on resume — an in-memory tracker would not
        survive (reference: split is driven from the persisted map epoch).
        NOTE: children assume the parent's placement (pgp_num unchanged);
        bump pgp_num only after the cluster has advanced past the split.
        """
        coll = _coll(st.pgid)
        blob = self.store.getattr(coll, PGMETA, "split_pgnum")
        stored = pickle.loads(blob) if blob else -1
        # stored == -1: unstamped collection (predates the watermark, or
        # the OSD was down across the bump before creation stamping) —
        # scan once; _split_pg stamps even when nothing moves
        if 0 < pool.pg_num <= stored:
            return False
        self._split_pg(pool, st)
        return True

    def _save_pg_meta(self, st: PGState) -> None:
        """Full rewrite of the persisted log (recovery-time adoption of an
        authoritative log; NOT on the per-op path)."""
        coll = _coll(st.pgid)
        old = list(self.store.omap_get(coll, PGMETA))
        txn = Transaction()
        if old:
            txn.omap_rmkeys(coll, PGMETA, old)
        txn.omap_set(coll, PGMETA,
                     {self._meta_key(e.version): pickle.dumps(e)
                      for e in st.log.entries})
        txn.setattr(coll, PGMETA, "last_update", pickle.dumps(st.last_update))
        txn.setattr(coll, PGMETA, "log_tail", pickle.dumps(st.log.tail))
        self.store.queue_transaction(txn)

    def _load_pg_meta(self, pgid: PGid) -> Tuple[pglog.Eversion, PGLog]:
        coll = _coll(pgid)
        lu = self.store.getattr(coll, PGMETA, "last_update")
        if lu is None:
            return pglog.ZERO, PGLog()
        last_update = pickle.loads(lu)
        tail_blob = self.store.getattr(coll, PGMETA, "log_tail")
        tail = pickle.loads(tail_blob) if tail_blob else pglog.ZERO
        entries = [pickle.loads(v) for _, v in
                   sorted(self.store.omap_get(coll, PGMETA).items())]
        entries = [e for e in entries if e.version > tail]
        return last_update, PGLog(tail=tail, entries=entries)

    def _load_last_complete(self, pgid: PGid) -> pglog.Eversion:
        blob = self.store.getattr(_coll(pgid), PGMETA, "last_complete")
        return pickle.loads(blob) if blob else pglog.ZERO

    def _list_pg_objects(self, pgid: PGid) -> List[str]:
        # PGMETA, the rollback journal, and archived hit sets are PG
        # bookkeeping; the journal and hit sets are member-LOCAL (each
        # shard/primary records its own) — none may ever be listed,
        # scrubbed, or backfilled as data
        from ceph_tpu_torch.cluster.tiering import HITSET_PREFIX

        return [o for o in self.store.list_objects(_coll(pgid))
                if o not in (PGMETA, PGRB)
                and not o.startswith(HITSET_PREFIX)]

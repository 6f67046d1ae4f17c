"""ReplicatedBackend: local txn + MOSDRepOp fan-out, pull/push
(reference src/osd/ReplicatedBackend.cc via the PGBackend seam).

Counterpart of ``ceph_tpu/cluster/backend_replicated.py``."""

from __future__ import annotations

import asyncio
import pickle
from typing import Optional

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster import pglog
from ceph_tpu_torch.cluster.pglog import LogEntry
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.cluster.pg import PGMETA, PGState, _coll
from ceph_tpu_torch.cluster.store import Transaction
from ceph_tpu_torch.osdmap.osdmap import PGPool


class ReplicatedBackendMixin:

    # --- replicated txn shapes (ONE builder per verb): the
    # serial _op_* methods and the pipelined client_ops routing both
    # build through these, so the two paths are txn-identical by
    # construction (the replicated analog of _ec_prepare_write).

    def _txn_write_full(self, st: PGState, oid: str, data: bytes,
                        snapc, version) -> Transaction:
        return (self._snap_pre_txn(st, oid, snapc)
                .remove(_coll(st.pgid), oid)
                .write(_coll(st.pgid), oid, 0, data)
                .set_version(_coll(st.pgid), oid, version[1]))

    def _txn_write(self, st: PGState, oid: str, offset: int,
                   data: bytes, snapc, version) -> Transaction:
        return (self._snap_pre_txn(st, oid, snapc)
                .write(_coll(st.pgid), oid, offset, data)
                .set_version(_coll(st.pgid), oid, version[1]))

    def _txn_truncate(self, st: PGState, oid: str, size: int,
                      snapc, version) -> Transaction:
        return (self._snap_pre_txn(st, oid, snapc)
                .truncate(_coll(st.pgid), oid, size)
                .set_version(_coll(st.pgid), oid, version[1]))

    # replicated write: local txn + MOSDRepOp fan-out (ReplicatedBackend)
    async def _op_write_full(self, pool: PGPool, st: PGState, oid: str,
                             data: bytes, snapc=None) -> int:
        if pool.is_erasure():
            return await self._ec_write(pool, st, oid, data, offset=None,
                                        snapc=snapc)
        version = self._next_version(st)
        txn = self._txn_write_full(st, oid, data, snapc, version)
        return await self._replicate_txn(st, txn, "modify", oid, version)

    async def _op_write(self, pool: PGPool, st: PGState, oid: str,
                        offset: int, data: bytes, snapc=None) -> int:
        """Partial write at (offset, len) — the RMW path for EC pools
        (reference ECBackend::start_rmw, ECBackend.cc:1785)."""
        if pool.is_erasure():
            return await self._ec_write(pool, st, oid, data, offset=offset,
                                        snapc=snapc)
        version = self._next_version(st)
        txn = self._txn_write(st, oid, offset, data, snapc, version)
        return await self._replicate_txn(st, txn, "modify", oid, version)

    def _head_size(self, pool: PGPool, st: PGState, oid: str,
                   missing=0):
        """Logical object size (EC pools: the 'size' xattr, the shard
        stat would be 1/k of it); ``missing`` for absent objects."""
        coll = _coll(st.pgid)
        if pool.is_erasure():
            sa = self.store.getattr(coll, oid, "size")
            if sa is not None:
                return int(sa)
            return missing if self.store.stat(coll, oid) is None else 0
        s = self.store.stat(coll, oid)
        return missing if s is None else s

    async def _op_truncate(self, pool: PGPool, st: PGState, oid: str,
                           size: int, snapc=None) -> int:
        """CEPH_OSD_OP_TRUNCATE.  Replicated: a store truncate in the
        replicated txn.  EC: re-encode the surviving prefix (the
        reference routes EC truncates through the RMW machinery too)."""
        if pool.is_erasure():
            cur = self._head_size(pool, st, oid)
            if size == cur:
                return 0
            if size < cur:
                head = await self._op_read(pool, st, oid, 0, size)
                head = head.ljust(size, b"\0")
            else:
                head = (await self._op_read(pool, st, oid, 0, cur)
                        ).ljust(size, b"\0")
            return await self._ec_write(pool, st, oid, head, offset=None,
                                        snapc=snapc)
        version = self._next_version(st)
        txn = self._txn_truncate(st, oid, size, snapc, version)
        return await self._replicate_txn(st, txn, "modify", oid, version)

    async def _op_delete_pipelined(self, pool: PGPool, st: PGState,
                                   oid: str, snapc=None) -> int:
        """Pipelined delete: same txn shape as ``_op_delete`` (COW
        pre-ops + EC rollback capture + remove), built under the PG
        lock inside the commit section, acks awaited outside.  On EC
        pools the commit additionally holds the OBJECT write lock: a
        delete slipping inside an in-flight RMW's read-merge window
        would be resurrected by the RMW's merged full-stripe commit —
        the lost-update race the object lock exists to exclude."""
        coll = _coll(st.pgid)

        def _build(version):
            txn = Transaction()
            txn.ops.extend(self._cow_pre_ops(st, oid, snapc,
                                             erasure=pool.is_erasure()))
            if pool.is_erasure():
                from ceph_tpu_torch.cluster.pg import PGRB

                txn.rb_capture(coll, oid, PGRB,
                               self._rb_key(version[1]))
            txn.remove(coll, oid)
            return txn

        if pool.is_erasure():
            async with self._obj_write_lock(st, oid):
                return await self._rep_mutate_pipelined(st, oid, _build,
                                                        op="delete")
        return await self._rep_mutate_pipelined(st, oid, _build,
                                                op="delete")

    def _cow_pre_ops(self, st: PGState, oid: str, snapc,
                     erasure: bool) -> list:
        """Clone-on-write pre-ops for a mutation (make_writeable,
        PrimaryLogPG.cc:7019) — the ONE seam both backends and delete go
        through.  The returned ops must ride the same transaction /
        sub-write as the mutation so clone + snapset apply atomically."""
        from ceph_tpu_torch.cluster import snaps as snapmod

        if snapc is None:
            return []
        coll = _coll(st.pgid)
        if erasure:
            sa = self.store.getattr(coll, oid, "size")
            size = int(sa) if sa else 0
        else:
            size = self.store.stat(coll, oid) or 0
        ops, cloned = snapmod.make_writeable_ops(
            self.store, coll, oid, snapc, size)
        if cloned:
            self.perf.inc("osd_snap_clones")
        return ops

    def _snap_pre_txn(self, st: PGState, oid: str, snapc) -> Transaction:
        txn = Transaction()
        txn.ops.extend(self._cow_pre_ops(st, oid, snapc, erasure=False))
        return txn

    async def _replicate_txn(self, st: PGState, txn: Transaction,
                             op: str, oid: str,
                             version: pglog.Eversion) -> int:
        """Apply locally + fan out with the log entry; commit when all
        acting replicas ack (reference PrimaryLogPG::issue_repop,
        PrimaryLogPG.cc:9173).  Serial shape — the caller holds st.lock
        across the whole call (compound/meta/trim mutations and the
        ``osd_pipeline_writes=0`` fallback).  The hot data path uses
        the start/finish split so the ack wait runs with the PG lock
        released."""
        token = await self._replicate_txn_start(st, txn, op, oid, version)
        return await self._replicate_txn_finish(st, token)

    async def _replicate_txn_start(self, st: PGState, txn: Transaction,
                                   op: str, oid: str,
                                   version: pglog.Eversion):
        """Ordered commit section of a replicated mutation (runs under
        st.lock): local txn apply, log append, commit-frontier
        registration, and the MOSDRepOp fan-out SENDS.  Returns the
        token ``_replicate_txn_finish`` resolves — with the lock
        RELEASED on the pipelined path."""
        from ceph_tpu_torch.cluster.optracker import mark_current
        from ceph_tpu_torch.cluster.pg import CURRENT_OP_DEADLINE

        self.store.queue_transaction(txn)
        mark_current("store:journal_queued")
        entry = self._log_mutation(st, op, oid, version)
        # commit-frontier registration: replicated mutations
        # share the PG's watermark with pipelined EC writes, so every
        # advance routes through the contiguous-prefix frontier
        self._frontier_open(st, version)
        peers = [o for o in st.acting
                 if o != self.osd_id and o != CRUSH_ITEM_NONE]
        fut = None
        reqid = None
        try:
            self._chaos_point("commit_pre_fanout")
            if peers:
                reqid = self._next_reqid()
                fut = self._make_waiter(reqid, len(peers))
                # span propagation: replicas' apply spans join this op's
                # tree.  Message built PER PEER: send_message stamps hop
                # events into msg.trace, so a shared dict would leak one
                # replica's send stamp into the next replica's header
                subctx = self.tracer.context()
                txn_blob = txn.encode()
                # sub-writes inherit the client op's deadline (None for
                # recovery/trim traffic): replicas shed the dead legs
                sub_deadline = CURRENT_OP_DEADLINE.get()
                for o in peers:
                    rep = M.MOSDRepOp(reqid=reqid, pgid=st.pgid,
                                      txn_blob=txn_blob,
                                      entry=entry,
                                      epoch=self.osdmap.epoch,
                                      deadline=sub_deadline)
                    if subctx is not None:
                        rep.trace = dict(subctx)
                    try:
                        await self._send_osd(o, rep)
                    except (ConnectionError, OSError, RuntimeError):
                        # peer unreachable (map lag around a failure):
                        # the op proceeds on the reachable set; the
                        # logged entry delta-recovers the peer at rejoin
                        # (reference: acting shrinks, missing grows)
                        self._waiter_dec(reqid)
                mark_current("sub_op_sent")
        except BaseException:
            if reqid is not None:
                self._pending.pop(reqid, None)
            self._frontier_done(st, version, ok=False)
            raise
        return (reqid, version, fut, entry)

    async def _replicate_txn_finish(self, st: PGState, token) -> int:
        """Ack-wait half of a replicated mutation; resolves the commit
        frontier however it exits."""
        from ceph_tpu_torch.cluster.optracker import mark_current

        reqid, version, fut, entry = token
        try:
            if fut is not None:
                try:
                    if not fut.done():
                        await asyncio.wait_for(
                            fut, timeout=self._ack_wait_timeout())
                    mark_current("sub_op_acked")
                except asyncio.TimeoutError:
                    self._frontier_done(st, version, ok=False)
                    return -110
                finally:
                    self._pending.pop(reqid, None)
        except BaseException:
            self._frontier_done(st, version, ok=False)
            raise
        if not self._entry_still_logged(st, entry):
            # entry rewound/replaced by a concurrent peering round
            # mid-ack-wait: no longer part of the PG's history — stay
            # un-acked (see the EC finish; same race, same
            # identity-based rule)
            self._frontier_done(st, version, ok=False)
            return -110
        # all acting members acked: advance the never-roll-back watermark
        # (through the frontier, clamped below any pending pipelined op)
        self._chaos_point("frontier_pre_done")
        self._frontier_done(st, version, ok=True)
        mark_current("commit")
        return 0

    async def _rep_mutate_pipelined(self, st: PGState, oid: str,
                                    build, op: str = "modify") -> int:
        """Pipelined replicated mutation: take the PG lock
        only for version assignment + txn build + the commit-start
        section, await the fan-out acks with it released.
        ``build(version) -> Transaction`` runs UNDER the lock, so
        reads it does (snap COW state, current size) are consistent
        with the version order exactly as in the serial path."""
        async with st.lock:
            version = self._next_version(st)
            txn = build(version)
            token = await self._replicate_txn_start(
                st, txn, op, oid, version)
        self.perf.inc("osd_rep_pipelined")
        return await self._replicate_txn_finish(st, token)

    async def _op_delete(self, pool: PGPool, st: PGState, oid: str,
                         snapc=None) -> int:
        """Delete is ack-gated exactly like writes — fire-and-forget
        MOSDRepOps let a slow replica resurrect the object.  Under a
        SnapContext the pre-delete head is cloned first (whiteout
        semantics: snaps keep seeing the object; for EC pools the clone
        op copies each member's SHARD object in place)."""
        coll = _coll(st.pgid)
        version = self._next_version(st)
        txn = Transaction()
        txn.ops.extend(self._cow_pre_ops(st, oid, snapc,
                                         erasure=pool.is_erasure()))
        if pool.is_erasure():
            # rollback record for the delete, captured MEMBER-LOCALLY by
            # the store op (each member journals its own shard bytes) so
            # an un-acked delete can rewind during peering
            from ceph_tpu_torch.cluster.pg import PGRB

            txn.rb_capture(coll, oid, PGRB, self._rb_key(version[1]))
        txn.remove(coll, oid)
        return await self._replicate_txn(st, txn, "delete", oid, version)

    async def _op_read(self, pool: PGPool, st: PGState, oid: str,
                       offset: int = 0, length: Optional[int] = None) -> bytes:
        if pool.is_erasure():
            return await self._ec_read(pool, st, oid, offset, length)
        return self.store.read(_coll(st.pgid), oid, offset, length)

    async def _pull_rep_object(self, st: PGState, source: int,
                               oid: str) -> bool:
        """Fetch a full replicated object from a member (pull recovery,
        reference ReplicatedBackend::prepare_pull).  Returns success: the
        caller must NOT claim the authoritative version for objects it
        failed to pull."""
        return await self._pull_rep_object_st(st, source, oid) == "ok"

    async def _pull_rep_object_st(self, st: PGState, source: int,
                                  oid: str) -> str:
        """Pull with outcome: "ok" | "enoent" (source lacks the object —
        definitive, not a failure) | "fail" (unreachable/timeout)."""
        reqid = self._next_reqid()
        fut = self._make_waiter(reqid, 1)
        try:
            await self._send_osd(source, M.MOSDECSubOpRead(
                reqid=reqid, pgid=st.pgid, oid=oid, shard=-1))
            acc = await asyncio.wait_for(fut, timeout=2.0)
            result, reply = acc[0]
            if result == -2:
                return "enoent"
            if result == 0 and reply is not None:
                txn = (Transaction()
                       .remove(_coll(st.pgid), oid)
                       .write(_coll(st.pgid), oid, 0, reply.data)
                       .set_version(_coll(st.pgid), oid,
                                    reply.hinfo.get("version", 0)))
                for k, v in reply.hinfo.get("xattrs", {}).items():
                    txn.setattr(_coll(st.pgid), oid, k, v)
                self.store.queue_transaction(txn)
                return "ok"
        except (asyncio.TimeoutError, ConnectionError):
            pass
        finally:
            self._pending.pop(reqid, None)
        return "fail"

    async def _push_object(self, pool: PGPool, st: PGState, osd: int,
                           oid: str, entry: LogEntry) -> bool:
        """Replay one log entry onto a stale member (delta recovery).
        Returns False when the push failed (the member stays stale and
        the recovery round must be retried)."""
        if entry.op == "delete":
            try:
                await self._send_osd(osd, M.MOSDPGPush(
                    pgid=st.pgid, oid=oid, op="delete",
                    version=entry.version[1], entry=entry))
                self.perf.inc("osd_pushes_sent")
                return True
            except ConnectionError:
                return False
        ok = True
        if entry.op == "trim" or self._has_snap_state(st, oid):
            # snapshot-bearing object: the logged head mutation implies
            # clone/snapset changes that must travel with it
            ok = await self._push_snap_state(pool, st, osd, oid)
        if entry.op == "trim":
            return ok
        if pool.is_erasure():
            return ok & await self._recover_ec_object(
                pool, st, oid, targets=[osd], entry=entry)
        coll = _coll(st.pgid)
        if self.store.stat(coll, oid) is None:
            return ok  # deleted since: a later entry carries the delete
        data = self.store.read(coll, oid)
        try:
            await self._send_osd(osd, M.MOSDPGPush(
                pgid=st.pgid, oid=oid, data=data,
                xattrs=self.store.get_xattrs(coll, oid),
                version=entry.version[1], entry=entry))
            self.perf.inc("osd_pushes_sent")
        except ConnectionError:
            ok = False
        return ok

    async def _repull_after_rewind(self, st: PGState, oids) -> None:
        """Re-fetch objects a record-less rewind had to remove, from the
        acting primary (the instruction sender).  Failed pulls retry
        under capped seeded backoff: this runs on a NON-primary, so the
        primary-side incomplete-round re-arm (recovery.py
        _queue_recovery_retry) never covers it — dropping a failure here
        would leave the shard missing until an unrelated map change."""
        pool = self.osdmap.pools.get(st.pgid.pool)
        if pool is None:
            return
        from ceph_tpu_torch.chaos.rng import stream
        from ceph_tpu_torch.utils.backoff import ExpBackoff

        rng = stream(self.config.chaos_seed,
                     f"repull:osd.{self.osd_id}:{st.pgid}") \
            if self.config.chaos_seed else None
        bo = ExpBackoff(base=0.25, cap=3.0, rng=rng)
        pending = list(oids)
        for _ in range(6):
            failed = []
            for oid in pending:
                try:
                    if pool.is_erasure():
                        ok = await self._recover_ec_object(
                            pool, st, oid, targets=[self.osd_id])
                    elif st.primary >= 0 and st.primary != self.osd_id:
                        ok = await self._pull_rep_object(st, st.primary,
                                                         oid)
                    else:
                        ok = True
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    ok = False
                if not ok:
                    failed.append(oid)
                    self.perf.inc("osd_recovery_incomplete")
            if not failed:
                return
            pending = failed
            if self._stopped or self.pgs.get(st.pgid) is not st:
                return
            await asyncio.sleep(bo.next())

    def _has_snap_state(self, st: PGState, oid: str) -> bool:
        from ceph_tpu_torch.cluster import snaps as snapmod

        return self.store.getattr(_coll(st.pgid),
                                  snapmod.snapdir_oid(oid), "ss") is not None

    async def _push_snap_state(self, pool: PGPool, st: PGState, osd: int,
                               head: str) -> bool:
        """Sync one head's snapshot state to a member: the authoritative
        SnapSet (as a snap_sync push — the receiver also deletes clones
        the set no longer lists, covering missed trims) plus every live
        clone object.  Returns False when any push failed."""
        from ceph_tpu_torch.cluster import snaps as snapmod

        coll = _coll(st.pgid)
        blob = self.store.getattr(coll, snapmod.snapdir_oid(head), "ss")
        if blob is None:
            return True
        try:
            await self._send_osd(osd, M.MOSDPGPush(
                pgid=st.pgid, oid=head, op="snap_sync", data=blob))
        except ConnectionError:
            return False
        ss = snapmod.SnapSet.decode(blob)
        ok = True
        for c in ss.clones:
            cname = snapmod.clone_oid(head, c)
            if self.store.stat(coll, cname) is None:
                continue
            if pool.is_erasure():
                ok &= await self._recover_ec_object(pool, st, cname,
                                                    targets=[osd])
            else:
                try:
                    await self._send_osd(osd, M.MOSDPGPush(
                        pgid=st.pgid, oid=cname,
                        data=self.store.read(coll, cname),
                        xattrs=self.store.get_xattrs(coll, cname),
                        version=self.store.get_version(coll, cname)))
                    self.perf.inc("osd_pushes_sent")
                except ConnectionError:
                    ok = False
        return ok


    def _handle_push(self, msg: M.MOSDPGPush) -> None:
        coll = _coll(msg.pgid)
        st = self.pgs.get(msg.pgid)
        if msg.op == "log_sync":
            if st is not None:
                st.last_update, st.log = pickle.loads(msg.data)
                self._save_pg_meta(st)
            else:
                # backfill target OUTSIDE acting (pg_temp handoff): we
                # hold the pushed data but not the PGState yet — it
                # materializes when the temp entry clears and the map
                # puts us in acting.  Persist the shipped meta now, and
                # stamp last_complete at the shipped head so the resume
                # path (_frontier_rebuild) doesn't treat every adopted
                # entry as an open frontier needing re-verification.
                tmp = PGState(msg.pgid, [], [], -1)
                tmp.last_update, tmp.log = pickle.loads(msg.data)
                self._save_pg_meta(tmp)
                txn = Transaction()
                txn.setattr(coll, PGMETA, "last_complete",
                            pickle.dumps(tmp.last_update))
                self.store.queue_transaction(txn)
            self.perf.inc("osd_pushes_applied")
            return
        if msg.op == "rewind":
            # primary-instructed divergent-log rewind (PGLog.cc:287):
            # undo our entries beyond the authoritative head from the
            # local rollback journal.  Self-protection: never rewind
            # below our own commit watermark — entries acked to clients
            # are not rollbackable, whatever a (possibly stale) primary
            # says
            if st is not None and (msg.interval is None
                                   or msg.interval >= st.peer_interval):
                # ...nor for a primary of an interval older than the one
                # whose peering query this member answered last (a
                # revived daemon peering on its pre-crash map)
                target = pickle.loads(msg.data)
                if st.last_update > target >= st.last_complete:
                    need = self.rewind_divergent_log(st, target)
                    if need:
                        # fallback removals (lost records): re-pull the
                        # authoritative copies off the dispatch path,
                        # tracked so the task self-discards (task-spawn
                        # lint: a bare spawn here leaked one dead Task
                        # per rewind for the daemon's life)
                        import asyncio as _aio

                        self._track(_aio.get_event_loop().create_task(
                            self._repull_after_rewind(st, list(need))))
            self.perf.inc("osd_pushes_applied")
            return
        if msg.op == "snap_sync":
            # adopt the authoritative SnapSet; clones it no longer lists
            # were trimmed while we were away.  Version-guarded like data
            # pushes: an old primary still draining its push queue must
            # never overwrite a newer snapset (and destroy its clones)
            from ceph_tpu_torch.cluster import snaps as snapmod

            ss = snapmod.SnapSet.decode(msg.data)
            local = snapmod.load_snapset(self.store, coll, msg.oid)
            if local.version >= ss.version:
                return
            txn = Transaction()
            txn.ops.extend(snapmod.snapset_ops(coll, msg.oid, ss))
            txn.ops.extend(snapmod.prune_clone_ops(
                self.store, coll, msg.oid, ss))
            self.store.queue_transaction(txn)
            self.perf.inc("osd_pushes_applied")
            return
        if msg.op == "delete":
            # version-guarded like pushes: a stale delete (old primary's
            # backfill racing a newer primary's push) must not remove a
            # newer object
            cur = self.store.get_version(coll, msg.oid)
            if cur <= msg.version:
                self.store.queue_transaction(
                    Transaction().remove(coll, msg.oid))
        else:
            cur = self.store.get_version(coll, msg.oid)
            exists = self.store.stat(coll, msg.oid) is not None
            # op == "repair": scrub found silent corruption (same version,
            # wrong bytes) — apply unconditionally
            if msg.op == "repair" or not (exists and cur >= msg.version):
                txn = (Transaction()
                       .remove(coll, msg.oid)
                       .write(coll, msg.oid, 0, msg.data)
                       .set_version(coll, msg.oid, msg.version))
                for k, v in msg.xattrs.items():
                    txn.setattr(coll, msg.oid, k, v)
                self.store.queue_transaction(txn)
        if st is not None and msg.entry is not None:
            self._log_mutation(st, msg.entry.op, msg.entry.oid,
                               msg.entry.version, entry=msg.entry)
        self.perf.inc("osd_pushes_applied")

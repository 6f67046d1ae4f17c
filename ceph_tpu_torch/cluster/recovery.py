"""Peering-driven recovery + backfill (reference PG::start_peering_
interval -> PrimaryLogPG::start_recovery_ops seam): authoritative-log
selection, delta recovery, whole-PG backfill.

Counterpart of ``ceph_tpu/cluster/recovery.py``."""

from __future__ import annotations

import asyncio
import pickle
from typing import Dict

from ceph_tpu_torch.analysis import racecheck
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster import pglog
from ceph_tpu_torch.cluster.pglog import PGInfo, PGLog
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.cluster.pg import MOSDPGQuery, MOSDPGQueryReply, PGState, _coll
from ceph_tpu_torch.cluster.store import Transaction
from ceph_tpu_torch.osdmap.osdmap import PGid, PGPool


class RecoveryMixin:

    # ------------------------------------------------------------- recovery

    def _kick_peering(self) -> None:
        """Start (or let run) the single peering drain task: concurrent
        map changes collapse into the live pass instead of stacking one
        _recover_all per epoch — under a churn burst the pending set
        absorbs every epoch's re-peer fan-out."""
        t = self._peering_task
        if t is not None and not t.done():
            return  # the running pass re-checks the pending set
        self._peering_task = self._track(
            asyncio.get_event_loop().create_task(self._recover_all()))

    async def _recover_all(self) -> None:
        """Drain the pending-peering queue in bounded waves: each PG's
        round runs as its own task behind the per-OSD concurrency
        throttle (_recover_pg's semaphore); waves larger than
        osd_peering_stagger_after desynchronize their starts with
        capped seeded jitter so hundreds of simultaneously-bouncing
        OSDs do not stampede each other with peer queries."""
        await asyncio.sleep(self.config.osd_recovery_delay_start)
        while not self._stopped:
            # snapshot-and-clear is atomic (no await between): a map
            # change landing mid-wave re-adds to the live set and the
            # next while pass picks it up
            pending = sorted(self._peering_pending)
            self._peering_pending.difference_update(pending)
            if not pending:
                return
            stagger_after = self.config.osd_peering_stagger_after
            stagger = bool(stagger_after) and len(pending) > stagger_after
            from ceph_tpu_torch.utils.tasks import track_task

            waves: set = set()
            for pgid in pending:
                st = self.pgs.get(pgid)
                if st is None or st.primary != self.osd_id:
                    # no longer ours to recover: the new primary's
                    # beacon carries the unclean claim now
                    self._unclean_pgs.discard(pgid)
                    continue
                track_task(waves, asyncio.get_event_loop().create_task(
                    self._peer_one(st, stagger)))
            if waves:
                # _peer_one contains its own error accounting; the
                # gather only orders the wave against the next pass
                await asyncio.gather(*list(waves))

    async def _peer_one(self, st: PGState, stagger: bool) -> None:
        try:
            if stagger:
                cap = self.config.osd_peering_stagger_max
                if cap > 0:
                    import random as _random

                    r = self._peering_rng.random() \
                        if self._peering_rng is not None \
                        else _random.random()
                    await asyncio.sleep(r * cap)
            # background class yields to client admission pressure
            # (mclock demotion analog): recovery pulls wait for the op
            # budget to drain below 3/4
            await self._yield_under_pressure()
            await self._recover_pg(st)
        except asyncio.CancelledError:
            raise
        except Exception:
            # count AND surface: a silently-failing recovery loop
            # means a pool that never re-protects itself
            self.perf.inc("osd_recovery_errors")
            import logging
            logging.getLogger("ceph_tpu_torch.osd").exception(
                "osd.%d: recovery of pg %s failed", self.osd_id, st.pgid)

    async def _query_pg(self, osd: int, pgid: PGid):
        """GetInfo/GetLog exchange with one member (reference peering
        Query/Notify, PG.h RecoveryMachine GetInfo)."""
        key = ("pgq", str(pgid), osd)
        fut = self._make_waiter(key, 1)
        st = self.pgs.get(pgid)
        try:
            await self._send_osd(osd, MOSDPGQuery(
                pgid=pgid, interval=st.interval_epoch if st else 0))
            acc = await asyncio.wait_for(fut, timeout=2.0)
            return acc[0][1]
        except (asyncio.TimeoutError, ConnectionError):
            return None
        finally:
            self._pending.pop(key, None)

    async def _recover_pg(self, st: PGState) -> None:
        """Primary-driven peering + recovery (flattened RecoveryMachine,
        reference src/osd/PG.h:1994-2498):

        1. GetInfo: collect (last_update, log) from every acting member.
        2. GetLog: the max last_update owns the authoritative log; if that
           is not us, bring ourselves up first (delta when our
           last_update is inside the auth log window, backfill otherwise).
        3. Active/Recovering: push ONLY the log delta to each stale
           member; full-inventory backfill when a member is behind the
           log tail.

        Runs under the PG lock: peering mutates st.log/st.last_update, and
        a client write interleaving with log adoption could regress
        last_update and reuse an eversion (the reference blocks ops during
        peering for the same reason).

        An INCOMPLETE round (unreachable member, failed pull/push) arms a
        capped-backoff retry (_queue_recovery_retry): peering re-runs on
        map changes, but a pull that fails AFTER the last map change of an
        outage would otherwise never retry — the primary stays stale
        forever, serving old-generation state (surfaced by graft-chaos as
        persistent torn EC reads).

        Rounds run behind the per-OSD concurrency throttle
        (osd_peering_max_concurrent): a mass bounce produces a
        bounded wave of simultaneous rounds, and every entry path — map
        advance, incomplete-round retry, frontier reconstruction —
        shares the one gate.  Round duration rides the
        osd_peering_lat_hist histogram on the perf/Prometheus path."""
        sem = self._peering_sem
        if sem.locked():
            self.perf.inc("osd_peering_throttled")
        async with sem:
            self.perf.inc("osd_peering_rounds")
            t0 = self.clock.monotonic()
            try:
                async with st.lock:
                    complete = await self._recover_pg_locked(st)
            except asyncio.CancelledError:
                raise
            except Exception:
                # a round that RAISES must still re-arm: infos
                # racing in-flight commits can be transiently inconsistent,
                # and a wedged retry chain leaves reconstructed frontier
                # entries unresolved forever
                self.perf.inc("osd_recovery_errors")
                import logging

                logging.getLogger("ceph_tpu_torch.osd").exception(
                    "osd.%d: peering round for pg %s errored",
                    self.osd_id, st.pgid)
                complete = False
            finally:
                self.perf.hinc("osd_peering_lat_hist",
                               self.clock.monotonic() - t0)
        if complete:
            self._recovery_backoffs.pop(st.pgid, None)
            self._unclean_pgs.discard(st.pgid)
        else:
            self._queue_recovery_retry(st)
            self._unclean_pgs.add(st.pgid)

    async def _recover_pg_locked(self, st: PGState) -> bool:
        m = self.osdmap
        # the interval this round's queries announce: a round that
        # outlives it (a map lands while the members answer) rewinds
        # nobody, since its rule was made for an older interval
        interval, booted = st.interval_epoch, self._up_epoch is not None
        pool = m.pools[st.pgid.pool]
        members = [o for o in st.acting
                   if o not in (self.osd_id, CRUSH_ITEM_NONE)]
        infos: Dict[int, PGInfo] = {self.osd_id: st.info()}
        if racecheck.TRACKER:  # graft-race: round-start self-info
            # snapshot — the roll-forward floor must NOT rest on it
            # after the member awaits below (the stale self-info bug class)
            racecheck.TRACKER.note_read(
                ("pg", self.osd_id, str(st.pgid)), "self_info")
        logs: Dict[int, PGLog] = {self.osd_id: st.log}
        inventories: Dict[int, Dict[str, int]] = {}
        complete = True
        for osd in members:
            reply = await self._query_pg(osd, st.pgid)
            if reply is None:
                complete = False  # unreachable member: retry later
                continue
            infos[osd] = reply.info or PGInfo()
            logs[osd] = reply.log or PGLog()
            inventories[osd] = reply.objects or {}

        auth = pglog.choose_authoritative(
            infos, require_rollback=pool.is_erasure())
        auth_head = infos[auth].last_update
        if auth_head < st.last_complete:
            # STALE ROUND: in-flight ack waits advanced our
            # watermark while we were collecting infos — rewinding (or
            # syncing) toward a head below it would roll back ACKED
            # writes.  Drop this round; the retry collects fresh infos.
            return False
        if pool.is_erasure() and st.last_update > auth_head:
            # we hold entries the authoritative log rolls back: an
            # un-acked partial-stripe write that not every shard applied
            # (reference PGLog::rewind_divergent_log, PGLog.cc:287 +
            # ecbackend.rst rollback).  Undo from our rollback journal.
            need = self.rewind_divergent_log(st, auth_head)
            for oid in need:  # record lost: re-pull the auth copy
                complete &= await self._recover_ec_object(
                    pool, st, oid, targets=[self.osd_id])
        if pool.is_erasure() and auth != self.osd_id and \
                infos[auth].last_update > st.last_update:
            # a stale primary syncs from the authoritative log, decoding
            # each object from the members' shards: a member past the
            # authoritative head holds un-acked generations there, so it
            # rewinds first, or the decode mixes generations and the
            # primary never syncs (the rewind further down waits for
            # the primary to hold the head).  The reference skips this.
            # Only a daemon whose map shows its own boot does it: one
            # still on its pre-crash map may not lead the PG at all.
            ahead = [o for o in members if o in infos
                     and infos[o].last_update > auth_head] if booted else []
            if ahead and (st.interval_epoch != interval or
                          not await self._rewind_members(
                              st, ahead, auth_head, infos, logs,
                              inventories)):
                return False
        if auth != self.osd_id and \
                infos[auth].last_update > st.last_update:
            complete &= await self._sync_self_from(
                pool, st, auth, logs[auth], inventories.get(auth, {}))

        # backfillfull gate: with the map flag set, FULL-
        # INVENTORY backfill is deferred — bulk-copying a whole PG into
        # stores past the backfillfull ratio would drive them straight
        # to FULL.  The round stays incomplete, so the capped-backoff
        # retry re-runs it after the flag clears.  Log-DELTA recovery
        # still proceeds (reference semantics: backfillfull gates
        # backfill, not recovery — the delta pushes mostly overwrite
        # existing shards, and blocking them would pin reduced
        # redundancy on every bounce while merely nearfull-ish).
        backfill_gated = "backfillfull" in getattr(m, "flags", set())
        for osd in members:
            if osd not in infos:
                continue
            peer_lu = infos[osd].last_update
            if pool.is_erasure() and peer_lu > st.last_update and \
                    st.last_update >= auth_head:
                if st.interval_epoch != interval:
                    complete = False
                    continue
                # divergent member: instruct it to rewind to our head
                # (it holds a superset of our log, so after the rewind
                # it is exactly current — nothing to push).  Guarded on
                # US holding the authoritative head: a stale primary
                # that failed to self-sync must never roll healthy
                # replicas back to its own stale state
                try:
                    await self._send_osd(osd, M.MOSDPGPush(
                        pgid=st.pgid, op="rewind",
                        data=pickle.dumps(st.last_update),
                        interval=st.interval_epoch))
                except ConnectionError:
                    complete = False
                continue
            if peer_lu >= st.last_update:
                continue
            to_sync = st.log.objects_to_sync(peer_lu)
            if to_sync is None:
                if backfill_gated:
                    self.perf.inc("osd_backfill_blocked_full")
                    complete = False
                    continue
                complete &= await self._backfill_member(
                    pool, st, osd, inventories.get(osd, {}))
            else:
                # replay in VERSION order so the member's log advances
                # monotonically (out-of-order pushes would hit the
                # duplicate guard and leave silent log holes), and stop
                # at the first failed push: a later one would move the
                # member's head past the object it still lacks, and the
                # next round, which compares heads, would never push it
                for oid, entry in sorted(to_sync.items(),
                                         key=lambda kv: kv[1].version):
                    if not await self._push_object(pool, st, osd, oid,
                                                   entry):
                        complete = False
                        break

        # roll-forward (reference PG::activate: last_complete =
        # last_update once missing is empty): every acting member
        # REPORTED last_update >= V, so every entry up to V exists on
        # every shard and can never rewind — advance the watermark.
        # Without this, a write whose sub-writes all landed but whose
        # ack was lost (bounce mid-commit) leaves last_complete behind
        # forever: no rewind fires (nothing is divergent) and no later
        # ack arrives (surfaced by graft-chaos as a stuck-incomplete PG)
        # the sync/push phase above may have advanced OUR OWN log past
        # the info snapshotted at round start (_sync_self_from pulls,
        # racing pipelined commits): the floor must rest on the CURRENT
        # self state, or a stale self-info pins the watermark below
        # entries every member verifiably holds — the round then ends
        # complete=True with last_complete wedged behind last_update
        # and nothing ever re-arms it
        infos[self.osd_id] = st.info()
        if racecheck.TRACKER:  # graft-race: the self-info fix — the
            # re-read revalidates the round-start snapshot; reverting
            # it re-convicts under the race smoke
            racecheck.TRACKER.note_read(
                ("pg", self.osd_id, str(st.pgid)), "self_info")
        live = [o for o in st.acting if o != CRUSH_ITEM_NONE]
        # EC undersized guard: with fewer than min_size live
        # members, "every member holds it" is vacuous — rolling the
        # watermark forward over entries only a sub-k shard subset
        # holds commits a generation nothing can ever decode (the same
        # bug class _ec_acting_writeable blocks at admission)
        undersized = pool.is_erasure() and not self._ec_acting_writeable(
            pool, self._codec(pool), st)
        if all(o in infos for o in live) and not undersized:
            floor = min(i.last_update for i in infos.values())
            if complete and floor < st.last_update and members:
                # this round PUSHED the delta above the floor: re-query
                # the members' heads before rolling the watermark over
                # the pushed entries — roll-forward must rest on a
                # REPORT that every member holds them, never on a send
                # having been queued
                for osd in members:
                    reply = await self._query_pg(osd, st.pgid)
                    if reply is None:
                        complete = False
                        infos.pop(osd, None)
                        continue
                    infos[osd] = reply.info or PGInfo()
                # the re-query AWAITED: acting can have changed while
                # the replies trickled in, and a member that joined
                # mid-round has no info row — re-read it so the
                # every-live-member-reported gate judges the membership
                # the roll-forward will actually cover (graft-race:
                # stale-snapshot-across-await on the round-start `live`)
                live = [o for o in st.acting if o != CRUSH_ITEM_NONE]
                if all(o in infos for o in live):
                    floor = min(i.last_update for i in infos.values())
            floor = min(floor, st.last_update)
            # routed through the frontier: entries at/below
            # the verified floor resolve — including crash-restart
            # reconstructions (_frontier_rebuild) whose acks died with
            # the previous process life
            if floor > st.last_complete or st.pipeline_pending:
                self._frontier_learn(st, floor)
        if st.frontier_recovering:
            # open boot entries above what this round could verify:
            # the PG is not crash-consistent yet — retry (the members
            # behind them are still syncing, or unreachable)
            complete = False
        # pg_temp handoff: this PG runs on a mon-minted temp
        # acting set (the pre-reshape donors) while its REAL owners are
        # the up-members outside acting.  Backfill them current, then
        # ask the mon to clear the temp entry — the clear commits a new
        # epoch that re-peers the PG onto its up set.  Returning
        # incomplete keeps the capped-backoff retry armed until that
        # map lands (a lost clear message just re-sends; the backfill
        # pushes are idempotent via version guards).
        if complete and st.pgid in m.pg_temp:
            handoff = [o for o in st.up
                       if o != CRUSH_ITEM_NONE and o not in st.acting]
            for osd in handoff:
                if backfill_gated:
                    self.perf.inc("osd_backfill_blocked_full")
                    complete = False
                    break
                reply = await self._query_pg(osd, st.pgid)
                if reply is None:
                    complete = False
                    continue
                complete &= await self._backfill_member(
                    pool, st, osd, reply.objects or {})
            if complete:
                await self._mon_send(M.MOSDPGTemp(
                    pgid=st.pgid, osds=(), epoch=m.epoch,
                    osd_id=self.osd_id))
                self.perf.inc("osd_pg_temp_clear_requested")
                complete = False
        self.perf.inc("osd_pg_recoveries")
        return complete

    async def _rewind_members(self, st: PGState, members, head,
                              infos: Dict[int, PGInfo],
                              logs: Dict[int, PGLog],
                              inventories: Dict[int, Dict[str, int]]
                              ) -> bool:
        """Tell each of ``members`` to rewind its log to ``head``, then
        re-query them into ``infos``/``logs``/``inventories``.  True when
        every one now reports ``head`` or less; a member whose commit
        watermark is past ``head`` refuses (its entries were acked)."""
        for osd in members:
            try:
                await self._send_osd(osd, M.MOSDPGPush(
                    pgid=st.pgid, op="rewind", data=pickle.dumps(head),
                    interval=st.interval_epoch))
            except ConnectionError:
                return False
        for osd in members:
            reply = await self._query_pg(osd, st.pgid)
            if reply is None:
                return False
            infos[osd] = reply.info or PGInfo()
            logs[osd] = reply.log or PGLog()
            inventories[osd] = reply.objects or {}
            if infos[osd].last_update > head:
                return False
        return True

    def _queue_recovery_retry(self, st: PGState) -> None:
        """Arm ONE delayed re-peering attempt for this PG (capped
        exponential backoff, seeded jitter when the chaos seed is set, so
        scenario retry timing replays).  Collapses with in-flight
        retries; the backoff resets when a round completes."""
        if self._stopped or st.primary != self.osd_id:
            return
        if st.pgid in self._recovery_retry_tasks:
            return
        bo = self._recovery_backoffs.get(st.pgid)
        if bo is None:
            from ceph_tpu_torch.chaos.rng import stream
            from ceph_tpu_torch.utils.backoff import ExpBackoff

            rng = stream(self.config.chaos_seed,
                         f"recovery:osd.{self.osd_id}:{st.pgid}") \
                if self.config.chaos_seed else None
            bo = ExpBackoff(base=0.25, cap=3.0, rng=rng)
            self._recovery_backoffs[st.pgid] = bo
        delay = bo.next()
        self.perf.inc("osd_recovery_retries")

        async def _retry() -> None:
            try:
                await asyncio.sleep(delay)
                self._recovery_retry_tasks.pop(st.pgid, None)
                if not self._stopped and st.primary == self.osd_id and \
                        self.pgs.get(st.pgid) is st:
                    await self._recover_pg(st)
            except asyncio.CancelledError:
                raise
            except Exception:
                self.perf.inc("osd_recovery_errors")

        task = asyncio.get_event_loop().create_task(_retry())
        self._recovery_retry_tasks[st.pgid] = task
        # track in the self-discarding set (not _tasks: a long-lived OSD
        # would keep one dead Task per retry for its lifetime)
        self._opq_running.add(task)
        task.add_done_callback(self._opq_running.discard)

    async def _sync_self_from(self, pool: PGPool, st: PGState, auth: int,
                              auth_log: PGLog,
                              auth_inventory: Dict[str, int]) -> bool:
        """Bring the primary up to the authoritative member's state.
        Returns False when a pull failed (the auth log was NOT adopted
        and the caller must retry)."""
        coll = _coll(st.pgid)
        to_sync = auth_log.objects_to_sync(st.last_update)
        if to_sync is None:
            # behind the log window: full backfill from auth's inventory
            mine = {oid: self.store.get_version(coll, oid)
                    for oid in self._list_pg_objects(st.pgid)}
            to_pull = [oid for oid, ver in auth_inventory.items()
                       if mine.get(oid, -1) < ver]
            # objects we hold that the authoritative member does not =
            # deletes we missed (possibly trimmed past the log tail);
            # without this, a rejoining primary resurrects deleted objects
            for oid in mine:
                if oid not in auth_inventory:
                    self.store.queue_transaction(
                        Transaction().remove(coll, oid))
        else:
            to_pull = []
            for oid, entry in to_sync.items():
                if entry.op == "delete":
                    self.store.queue_transaction(
                        Transaction().remove(coll, oid))
                else:
                    to_pull.append(oid)
        from ceph_tpu_torch.cluster import snaps as snapmod

        ok = True
        for oid in to_pull:
            if pool.is_erasure() and not oid.endswith(snapmod._SNAPDIR):
                ok &= await self._recover_ec_object(
                    pool, st, oid, targets=[self.osd_id])
            else:
                # snapdir metadata objects pull as plain copies even on
                # EC pools (identical on every member)
                ok &= await self._pull_rep_object(st, auth, oid)
            if not snapmod.is_snap_key(oid):
                # a delta-synced head may imply clone/snapset changes that
                # have no log entries of their own (COW writes, trims);
                # a FAILED snap pull must block adoption of the
                # authoritative log exactly like a failed head pull
                ok &= await self._pull_snap_state(pool, st, auth, oid)
        if not ok:
            # a pull failed (auth unreachable mid-recovery): do NOT claim
            # the authoritative version — stay stale so the retry/next
            # peering round re-pulls instead of serving stale bytes as new
            self.perf.inc("osd_recovery_incomplete")
            return False
        # adopt the authoritative log
        st.log = PGLog(tail=auth_log.tail,
                       entries=list(auth_log.entries),
                       max_entries=auth_log.max_entries)
        st.last_update = auth_log.head if auth_log.entries else \
            max(st.last_update, auth_log.tail)
        self._save_pg_meta(st)
        return True

    async def _pull_snap_state(self, pool: PGPool, st: PGState, auth: int,
                               head: str) -> bool:
        """Pull one head's snapshot state from the authoritative member:
        its snapdir SnapSet, any clone objects we lack, and prune clones
        the set no longer lists (missed trims).  Returns False on a pull
        FAILURE (auth unreachable) — the caller must then refuse to adopt
        the authoritative log; "auth has no snap state" is success."""
        from ceph_tpu_torch.cluster import snaps as snapmod

        coll = _coll(st.pgid)
        sd = snapmod.snapdir_oid(head)
        status = await self._pull_rep_object_st(st, auth, sd)
        if status == "enoent":
            return True  # no snap state upstream (the common case)
        if status != "ok":
            return False
        blob = self.store.getattr(coll, sd, "ss")
        if blob is None:
            return True
        ss = snapmod.SnapSet.decode(blob)
        ok = True
        for c in ss.clones:
            cname = snapmod.clone_oid(head, c)
            if self.store.stat(coll, cname) is not None:
                continue
            if pool.is_erasure():
                ok &= await self._recover_ec_object(pool, st, cname,
                                                    targets=[self.osd_id])
            else:
                ok &= await self._pull_rep_object(st, auth, cname)
        txn = Transaction()
        txn.ops.extend(snapmod.prune_clone_ops(self.store, coll, head, ss))
        if txn.ops:
            self.store.queue_transaction(txn)
        return ok

    async def _backfill_member(self, pool: PGPool, st: PGState, osd: int,
                               inventory: Dict[str, int]) -> bool:
        """Full-inventory resync for a member behind the log tail
        (reference Backfilling state).  Returns False when any push
        failed (the member is still stale; the caller must retry)."""
        from ceph_tpu_torch.cluster import snaps as snapmod

        ok = True
        for oid in self._list_pg_objects(st.pgid):
            ver = self.store.get_version(_coll(st.pgid), oid)
            if inventory.get(oid, -1) >= ver:
                continue
            # snapdir objects are pure metadata (identical on every
            # member, EC pools included): push data+xattrs directly;
            # everything else on an EC pool (clones included) is a real
            # EC object whose member shard gets reconstructed
            if pool.is_erasure() and not oid.endswith(snapmod._SNAPDIR):
                ok &= await self._recover_ec_object(pool, st, oid,
                                                    targets=[osd])
            else:
                data = self.store.read(_coll(st.pgid), oid)
                try:
                    await self._send_osd(osd, M.MOSDPGPush(
                        pgid=st.pgid, oid=oid, data=data,
                        xattrs=self.store.get_xattrs(_coll(st.pgid), oid),
                        version=ver))
                    self.perf.inc("osd_pushes_sent")
                except ConnectionError:
                    ok = False
        # stale objects the member has but we (authoritative) don't
        mine = set(self._list_pg_objects(st.pgid))
        for oid in inventory:
            if oid not in mine:
                try:
                    await self._send_osd(osd, M.MOSDPGPush(
                        pgid=st.pgid, oid=oid, op="delete",
                        version=st.last_update[1]))
                    self.perf.inc("osd_pushes_sent")
                except ConnectionError:
                    ok = False
        # hand the member our log state so the next peering round sees it
        # as current instead of re-backfilling — only when every push
        # landed: a log_sync over missed pushes would mark a still-stale
        # member current and silently skip the missing objects
        if ok:
            blob = pickle.dumps((st.last_update, st.log))
            try:
                await self._send_osd(osd, M.MOSDPGPush(
                    pgid=st.pgid, op="log_sync", data=blob))
            except ConnectionError:
                ok = False
        return ok

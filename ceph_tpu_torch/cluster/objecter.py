"""Objecter + librados-style client surface.

Counterpart of ``ceph_tpu/cluster/objecter.py``.

Mirrors the reference client op engine (src/osdc/Objecter.cc): ops are
targeted client-side — object name -> ps (ceph_str_hash_rjenkins) ->
PG -> acting primary against the cached OSDMap (_calc_target,
Objecter.cc:2749) — sent as MOSDOp, and resent with a refreshed map on
misdirect or connection failure (:1272-1329 resend semantics).  The
RadosClient/IoCtx pair mirrors librados (src/librados/IoCtxImpl.cc).
"""

from __future__ import annotations

import asyncio
import pickle
import time
from typing import Any, Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.messenger import (
    Addr,
    Connection,
    Dispatcher,
    EntityName,
    Messenger,
)
from ceph_tpu_torch.ops.jenkins import str_hash_rjenkins
from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGid, ceph_stable_mod
from ceph_tpu_torch.utils import Config
from ceph_tpu_torch.utils.backoff import AIMDWindow, ExpBackoff
from ceph_tpu_torch.utils.device import resolve_device_index
from ceph_tpu_torch.utils.tasks import track_task


class Objecter(Dispatcher):
    def __init__(self, name: str, mon_addr,
                 config: Optional[Config] = None, device=None):
        """``device``: where the client's map lives (CUDA unless the
        caller names the CPU; raises without a card).  Its per-op
        targeting is the scalar CRUSH chain on the host, whatever the
        device: ``target_seconds`` sums the time it takes and
        ``targets`` counts the walks (cache misses)."""
        import secrets as _secrets

        self.device = resolve_device_index(device)
        self.target_seconds = 0.0
        self.targets = 0

        # reqid identity carries a per-incarnation nonce (reference
        # osd_reqid_t: client gid + incarnation): a restarted client
        # reusing a name must never collide with the OSDs' reqid dup
        # cache from its previous life — tids restart at 1
        self.client_name = f"{name}#{_secrets.token_hex(4)}"
        self.display_name = name
        # per-client config copy (daemons copy theirs the same way):
        # chaos injectargs against one client must not leak into the
        # cluster-wide template config
        self.config = Config(**config.show()) if config else Config()
        self.messenger = Messenger(
            EntityName("client", abs(hash(name)) % 10000),
            secret=self.config.auth_secret(),
            auth=self.config.cephx_context(f"client.{name}"),
            config=self.config)
        self.messenger.add_dispatcher(self)
        # graft-trace: the client mints the root span of every op's
        # cross-daemon tree (NULL_SPAN factory when trace_enabled=0)
        from ceph_tpu_torch.trace import Tracer

        self.tracer = Tracer(f"client.{name}",
                             enabled=bool(self.config.trace_enabled),
                             keep=self.config.trace_keep)
        from ceph_tpu_torch.cluster.monclient import MonTargeter

        self.monc = MonTargeter(
            self.messenger, mon_addr,
            subscribe_since=lambda: self.osdmap.epoch if self.osdmap else 0)
        self.osdmap: Optional[OSDMap] = None
        self._map_event = asyncio.Event()
        # _refresh_map's subscribes: the last one sent, and the newest
        # one whose answer has been applied
        self._sub_tid = 0
        self._sub_acked = 0
        self._tid = 0
        self._trace_seq = 0
        self._inflight: Dict[Tuple[str, int], asyncio.Future] = {}
        self._mon_tid = 0
        self._mon_inflight: Dict[int, asyncio.Future] = {}
        self._cmd_inflight: Dict[int, asyncio.Future] = {}
        self._mds_inflight: Dict[int, asyncio.Future] = {}
        # linger ops (watches) re-registered on every map change
        # (reference Objecter::linger_register, Objecter.cc:778)
        self._cookie = 0
        self._watches: Dict[Tuple[int, str, int], object] = {}
        self._relinger_task = None
        # client-side flow control against OSD admission throttles: an
        # AIMD congestion window on inflight ops, driven by explicit
        # THROTTLED (-EBUSY) pushback — the primary flow-control signal,
        # replacing blind wait_for timeouts.  Wide open until the first
        # pushback, so with throttles off (default) it never constrains.
        self._primary_cache: Tuple[Optional[int], Dict] = (None, {})
        # reply-leg tail timelines: the OSD's terminal reply
        # carries a trace whose hop stamps + our completion stamp cover
        # the previously-untraced reply flight + client wakeup; bench
        # --attribute merges these so wall_coverage holds on short ops
        from collections import deque as _deque

        self._op_tails: "_deque" = _deque(maxlen=4096)
        self.cwnd = AIMDWindow(self.config.objecter_inflight_max)
        self._cwnd_inflight = 0
        self._cwnd_event = asyncio.Event()
        self._pushback_backoff = ExpBackoff(
            base=0.02, cap=1.0, rng=self._backoff_rng("pushback"))
        self._ops_acked = 0
        # graft-blackbox flight ring (NULL_FLIGHT when disabled):
        # clients have no ChaosClock — wall time, zero recorded skew
        from ceph_tpu_torch.trace import FlightRecorder

        self.flight = FlightRecorder.from_config(
            f"client.{self.display_name}", self.config)
        # client-edge op coalescer: the objecter twin of the
        # OSD's SubWriteBatcher.  Built unconditionally — the gate is
        # consulted PER SEND (objecter_batch_tick_ops, injectargs-able),
        # so 0 keeps the legacy one-frame-per-op anchor byte-for-byte.
        from ceph_tpu_torch.cluster.batcher import OpBatcher

        self._tasks: Set[asyncio.Task] = set()
        self._stopped = False
        self._op_batcher = OpBatcher(self)
        self._batch_ticks = 0
        self._batch_tick_ops = 0
        self._batch_reply_frames = 0
        self._batch_reply_items = 0

    def _track(self, task: asyncio.Task) -> None:
        track_task(self._tasks, task)

    # -- client telemetry on the mgr Prometheus path ------------

    def flow_counters(self) -> Dict[str, int]:
        """Client-side flow-control telemetry: the AIMD congestion
        window state the graft-load SLO judge grades ("converged, not
        collapsed") — exported through the mgr so it rides the SAME
        Prometheus scrape as the daemon counters."""
        return {
            "client_cwnd": self.cwnd.limit,
            "client_cwnd_pushbacks": self.cwnd.pushbacks,
            "client_inflight_ops": self._cwnd_inflight,
            "client_ops_acked": self._ops_acked,
            "client_batch_ticks": self._batch_ticks,
            "client_batch_ops": self._batch_tick_ops,
            "client_batch_reply_frames": self._batch_reply_frames,
            "client_batch_reply_items": self._batch_reply_items,
        }

    async def mgr_report(self) -> bool:
        """Push this client's counters to the active mgr (the client
        half of MgrClient::send_report; daemons stream theirs from the
        heartbeat loop).  Clients have no beacon loop, so consumers —
        the load generator's telemetry loop, tests — call this at their
        own cadence.  False when no mgr is published in the map."""
        import time as _time

        m = self.osdmap
        addr = getattr(m, "mgr_addr", None) if m is not None else None
        if not addr:
            return False
        try:
            await self.messenger.send_message(M.MMgrReport(
                daemon=f"client.{self.display_name}",
                counters=self.flow_counters(),
                stamp=_time.monotonic()), tuple(addr))
            if self.flight:
                self.flight.record("cwnd", **self.flow_counters())
            return True
        except (ConnectionError, OSError, RuntimeError):
            return False

    def _backoff_rng(self, tag: str):
        """Seeded jitter stream when the client carries a chaos seed
        (deterministic scenario replay — the messenger/monclient
        contract); fresh entropy otherwise.  Keyed by the STABLE display
        name: the reqid nonce must not perturb replay."""
        if self.config.chaos_seed:
            from ceph_tpu_torch.chaos.rng import stream

            return stream(self.config.chaos_seed,
                          f"objecter:{self.display_name}:{tag}")
        return None

    @property
    def mon_addr(self) -> Addr:
        return self.monc.current

    def _hunt(self) -> None:
        self.monc.hunt()

    async def _mon_send(self, msg) -> None:
        await self.monc.send(msg, raise_on_fail=True)

    async def start(self) -> None:
        addr = await self.messenger.bind()
        auth_ctx = self.messenger.auth
        if auth_ctx is not None and auth_ctx.master is None:
            # cephx client: bootstrap a ticket from the mon before any
            # session traffic (reference MonClient authenticate())
            await self.messenger.cephx_bootstrap(self.monc.current)
        await self._mon_send(M.MMonSubscribe(what="osdmap", addr=addr))
        await asyncio.wait_for(self._map_event.wait(), timeout=10)

    async def stop(self) -> None:
        self._stopped = True
        for t in list(self._tasks):
            t.cancel()
        if self._tasks:
            # teardown barrier: cancelled batcher ticks fail their
            # parked ops via the batcher's own finally (ConnectionError)
            await asyncio.gather(*self._tasks, return_exceptions=True)
        await self.messenger.shutdown()

    async def ms_handle_reset(self, conn: Connection) -> None:
        """A connection died: our watches ride accepted server-side conns
        that a transparent session reconnect does NOT restore — re-register
        them (reference: watch reconnect on session reset)."""
        self._schedule_relinger()

    async def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, M.MOSDMapMsg):
            newmap = pickle.loads(msg.osdmap_blob).set_device(self.device)
            if self.osdmap is None or newmap.epoch >= self.osdmap.epoch:
                self.osdmap = newmap
                self._schedule_relinger()
            self._sub_acked = max(self._sub_acked, msg.sub_tid)
            self._map_event.set()
            return True
        if isinstance(msg, M.MWatchNotify):
            await self._handle_watch_notify(msg)
            return True
        if isinstance(msg, M.MOSDIncMapMsg):
            m = self.osdmap
            if m is not None and msg.prev_epoch == m.epoch:
                for blob in msg.inc_blobs:
                    m.apply_incremental(pickle.loads(blob))
                if msg.inc_blobs:
                    self._schedule_relinger()
                self._sub_acked = max(self._sub_acked, msg.sub_tid)
                self._map_event.set()
            elif m is not None and msg.epoch <= m.epoch:
                self._sub_acked = max(self._sub_acked, msg.sub_tid)
                self._map_event.set()  # already current
            else:
                # gap: resync from our epoch (a refresh's answer stays
                # owed: the resync carries its number)
                await self._mon_send(
                    M.MMonSubscribe(what="osdmap",
                                    addr=self.messenger.my_addr,
                                    since=m.epoch if m else 0,
                                    tid=msg.sub_tid))
            return True
        if isinstance(msg, M.MOSDOpReplyBatch):
            # scatter a reply tick per item: each MOSDOpReply inside
            # resolves only ITS op's future — a reqid the OSD shed
            # (expired deadline) is simply absent, so its future stays
            # pending and the op's own timeout/resend covers it.  The
            # SubWriteBatcher per-item rule, applied at the client edge;
            # per-item `throttled` flags reach _op_submit_attempts
            # unchanged, so AIMD pushback/ack stays per-op (one
            # throttled item never collapses its tick-mates' window).
            self._batch_reply_frames += 1
            self._batch_reply_items += len(msg.items)
            for item in msg.items:
                fut = self._inflight.pop(tuple(item.reqid), None)
                if fut and not fut.done():
                    fut.set_result(item)
            return True
        if isinstance(msg, M.MOSDOpReply):
            fut = self._inflight.pop(tuple(msg.reqid), None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, M.MMonCommandReply):
            fut = self._mon_inflight.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, M.MCommandReply):
            fut = self._cmd_inflight.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        tname = type(msg).__name__
        if tname == "MClientReply":   # MDS replies (cluster/mds.py)
            fut = self._mds_inflight.pop(msg.tid, None)
            if fut and not fut.done():
                fut.set_result(msg)
            return True
        return False

    # -- targeting (reference _calc_target) --------------------------------

    def object_pgid(self, pool_id: int, oid: str) -> PGid:
        pool = self.osdmap.pools[pool_id]
        ps = str_hash_rjenkins(oid.encode())
        seed = ceph_stable_mod(ps, pool.pg_num, pool.pg_num_mask)
        return PGid(pool_id, seed)

    def _target_osd(self, pgid: PGid) -> int:
        # per-epoch primary cache: the scalar CRUSH walk per op was a
        # measurable slice of the t16 hot path; any map change bumps the
        # epoch and drops the whole cache (pg_temp/primary_temp ride
        # epochs too, so staleness is impossible by construction)
        m = self.osdmap
        epoch, cache = self._primary_cache
        if epoch != m.epoch:
            cache = {}
            self._primary_cache = (m.epoch, cache)
        primary = cache.get(pgid)
        if primary is None:
            t0 = time.perf_counter()
            _, _, _, primary = m.pg_to_up_acting_osds(pgid)
            self.target_seconds += time.perf_counter() - t0
            self.targets += 1
            cache[pgid] = primary
        return primary

    def _record_reply_tail(self, reply) -> None:
        """Keep the reply's hop timeline + our wakeup stamp (no-op for
        untraced replies)."""
        tr = getattr(reply, "trace", None)
        if tr is None:
            return
        import time as _time

        # header events are (name, wall_ts); attribution timelines are
        # (time, name) pairs
        evs = [(ts, name) for name, ts in tr.get("events", ())]
        evs.append((_time.time(), "objecter:complete"))
        self._op_tails.append(evs)

    def drain_op_tails(self):
        """Return and clear the recorded reply tails (bench --attribute
        drains once after warm-up, once after the timing window)."""
        out = [list(e) for e in self._op_tails]
        self._op_tails.clear()
        return out

    async def _refresh_map(self) -> None:
        # A subscribe that lands in a DYING mon's socket gets no push
        # back — the send itself "succeeds" into a half-dead session.
        # One silent window must not fail the caller (a pool_create
        # racing a leader failover saw exactly this): hunt to the next
        # mon and re-subscribe before giving up.
        # Returns once the mon's answer to THIS subscribe is applied, so
        # the map is at least the mon's epoch when it answered: a push
        # already in flight (an older epoch) does not end the wait.
        # (The reference returns on any map message.)
        loop = asyncio.get_event_loop()
        for attempt in range(3):
            self._sub_tid += 1
            tid = self._sub_tid
            self._map_event.clear()
            await self._mon_send(
                M.MMonSubscribe(what="osdmap",
                                addr=self.messenger.my_addr,
                                since=self.osdmap.epoch
                                if self.osdmap else 0, tid=tid))
            deadline = loop.time() + 4
            try:
                while self._sub_acked < tid:
                    self._map_event.clear()
                    await asyncio.wait_for(
                        self._map_event.wait(),
                        timeout=max(0.0, deadline - loop.time()))
                return
            except asyncio.TimeoutError:
                self._hunt()
                if attempt == 2:
                    raise

    # -- op submission with resend-on-map-change ---------------------------

    # write verbs for overlay targeting (shared with the OSD's dedup set)
    _WRITE_OPS = M.MUTATING_OPS

    def _overlay_pool(self, pool_id: int, ops) -> int:
        """Cache-tier overlay redirect (reference Objecter::_calc_target,
        src/osdc/Objecter.cc: target_oloc.pool = read_tier/write_tier):
        ops against a base pool with an overlay go to the cache pool."""
        pool = self.osdmap.pools.get(pool_id)
        if pool is None:
            return pool_id
        writes = any(o[0] in self._WRITE_OPS for o in ops)
        if writes and pool.has_write_tier():
            return pool.write_tier
        if not writes and pool.has_read_tier():
            return pool.read_tier
        return pool_id

    async def op_submit(self, pool_id: int, oid: str,
                        ops: List[Tuple[str, Dict[str, Any]]],
                        timeout: Optional[float] = None,
                        pgid=None, snapc=None,
                        snapid=None) -> M.MOSDOpReply:
        if timeout is None:
            timeout = self.config.rados_osd_op_timeout
        deadline = asyncio.get_event_loop().time() + timeout
        explicit_pgid = pgid
        # op-lifecycle trace header: one id for the op across resends;
        # the events ride the MOSDOp into the OSD's TrackedOp so
        # dump_historic_ops shows the client-side timeline too
        import time as _time

        self._trace_seq += 1
        trace_id = f"{self.client_name}:op{self._trace_seq}"
        trace_events = [("objecter:submit", _time.time())]
        # wall-clock deadline rides the message header: OSDs and their
        # sub-ops shed this op at dequeue once it passes (nobody awaits)
        wall_deadline = _time.time() + timeout
        # congestion-window gate BEFORE targeting: inflight ops beyond
        # the AIMD window wait here, and an op whose deadline passes
        # while waiting is shed client-side (never sent at all)
        waited = await self._cwnd_acquire(deadline, oid)
        if waited:
            trace_events.append(("objecter:throttle_wait", _time.time()))
        try:
            # root span of the op's cross-daemon tree: lives for the
            # whole submit incl. resends, so its duration IS the
            # client-observed wall time stage attribution is judged by
            with self.tracer.start("op_submit", trace_id=trace_id) as root:
                root.annotate(oid=oid, ops=[o[0] for o in ops])
                return await self._op_submit_attempts(
                    pool_id, oid, ops, deadline, wall_deadline,
                    explicit_pgid, trace_id, trace_events, root,
                    snapc, snapid)
        finally:
            self._cwnd_release()

    async def _cwnd_acquire(self, deadline: float, oid: str) -> bool:
        waited = False
        loop = asyncio.get_event_loop()
        while self._cwnd_inflight >= self.cwnd.limit:
            waited = True
            remaining = deadline - loop.time()
            if remaining <= 0:
                # client-side dead-work shed: the op expired before it
                # ever left this host — don't add it to the pile
                raise TimeoutError(
                    f"op on {oid} expired waiting for congestion window")
            self._cwnd_event.clear()
            try:
                await asyncio.wait_for(self._cwnd_event.wait(),
                                       timeout=remaining)
            except asyncio.TimeoutError:
                pass
        self._cwnd_inflight += 1
        return waited

    def _cwnd_release(self) -> None:
        self._cwnd_inflight = max(0, self._cwnd_inflight - 1)
        self._cwnd_event.set()

    async def _send_op(self, msg: M.MOSDOp, addr: Tuple) -> None:
        """Route one op frame out: through the per-(session, OSD) tick
        coalescer when client batching is on, else the legacy per-op
        frame.  Gated per SEND so objecter_batch_tick_ops=0 is a live
        anchor (injectargs mid-run flips the path for the next op)."""
        if self.config.objecter_batch_tick_ops > 0:
            await self._op_batcher.send(addr, msg)
        else:
            await self.messenger.send_message(msg, addr)

    async def _op_submit_attempts(self, pool_id, oid, ops, deadline,
                                  wall_deadline, explicit_pgid, trace_id,
                                  trace_events, root, snapc, snapid):
        import time as _time

        loop = asyncio.get_event_loop()
        # capped full-jitter backoff between retargeting attempts (was a
        # blind doubling sleep); a separate stream paces throttle
        # pushback retries so congestion retries and map-refresh retries
        # never share an attempt counter
        retarget_backoff = ExpBackoff(base=0.05, cap=1.0,
                                      rng=self._backoff_rng("retarget"))
        while True:
            # re-resolve the overlay every attempt: a tier/overlay change
            # mid-retry must re-target (the redirect is map state)
            target_pool = self._overlay_pool(pool_id, ops)
            pgid = explicit_pgid if explicit_pgid is not None \
                else self.object_pgid(target_pool, oid)
            primary = self._target_osd(pgid)
            addr = self.osdmap.osd_addrs.get(primary) if primary >= 0 else None
            if addr is not None:
                self._tid += 1
                reqid = (self.client_name, self._tid)
                fut = loop.create_future()
                self._inflight[reqid] = fut
                msg = M.MOSDOp(reqid=reqid, pgid=pgid, oid=oid, ops=ops,
                               epoch=self.osdmap.epoch,
                               snapc=snapc, snapid=snapid,
                               deadline=wall_deadline)
                msg.trace = {"id": trace_id,
                             "events": trace_events +
                             [("objecter:send", _time.time())]}
                if root.span_id is not None:
                    # span propagation: the OSD's dispatch span parents
                    # under this client root
                    msg.trace["span"] = root.span_id
                try:
                    await self._send_op(msg, tuple(addr))
                    # outwait the OSD's own replica-ack timeout (abandoning
                    # in parallel just queues a duplicate op behind the PG
                    # lock), but never past the op deadline — an ack past
                    # the deadline must not reach the caller as success
                    attempt = min(self.config.osd_client_op_timeout + 2.0,
                                  max(0.05, deadline - loop.time()))
                    reply = await asyncio.wait_for(fut, timeout=attempt)
                    if getattr(reply, "throttled", False):
                        # explicit admission pushback: shrink the window
                        # (multiplicative decrease), pause a jittered
                        # beat, resend — WITHOUT a map refresh (the
                        # target is right, the daemon is full)
                        self.cwnd.on_pushback()
                        if self.flight:
                            self.flight.record(
                                "cwnd", event="pushback",
                                limit=self.cwnd.limit)
                        if loop.time() > deadline:
                            raise TimeoutError(
                                f"op on {oid} throttled past deadline")
                        await asyncio.sleep(self._pushback_backoff.next())
                        continue
                    if reply.result != -11:  # not misdirected
                        self.cwnd.on_ack()
                        self._ops_acked += 1
                        self._pushback_backoff.reset()
                        self._record_reply_tail(reply)
                        return reply
                except (ConnectionError, OSError, asyncio.TimeoutError):
                    self._inflight.pop(reqid, None)
            if loop.time() > deadline:
                raise TimeoutError(f"op on {oid} timed out")
            await asyncio.sleep(retarget_backoff.next())
            try:
                await self._refresh_map()
            except asyncio.TimeoutError:
                pass

    # -- watch/notify (linger ops) -----------------------------------------

    def _schedule_relinger(self) -> None:
        """Re-register every watch after a map change: the PG's primary
        may have moved (reference linger resend on map change)."""
        if not self._watches:
            return
        if self._relinger_task is None or self._relinger_task.done():
            self._relinger_task = asyncio.get_event_loop().create_task(
                self._relinger())

    async def _relinger(self) -> None:
        for (pool_id, oid, cookie) in list(self._watches):
            try:
                await self.op_submit(pool_id, oid,
                                     [("watch", {"cookie": cookie})],
                                     timeout=10.0)
            except (IOError, OSError, TimeoutError):
                pass  # rewatch is best-effort; next reset retries

    async def _handle_watch_notify(self, msg: M.MWatchNotify) -> None:
        cb = self._watches.get((msg.pool, msg.oid, msg.cookie))
        if cb is not None:
            try:
                res = cb(msg.payload)
                if asyncio.iscoroutine(res):
                    await res
            except Exception:
                pass
        # ack one-way: this runs INSIDE our read loop, so a waiting
        # op_submit could never see its reply (self-deadlock until timeout)
        try:
            pgid = self.object_pgid(msg.pool, msg.oid)
            primary = self._target_osd(pgid)
            addr = self.osdmap.osd_addrs.get(primary)
            if addr is not None:
                self._tid += 1
                await self.messenger.send_message(
                    M.MOSDOp(reqid=(self.client_name, self._tid),
                             pgid=pgid, oid=msg.oid,
                             ops=[("notify_ack",
                                   {"notify_id": msg.notify_id})],
                             epoch=self.osdmap.epoch), tuple(addr))
        except (ConnectionError, OSError, RuntimeError, KeyError):
            pass  # unacked notify: the notifier's timeout covers it

    async def watch(self, pool_id: int, oid: str, callback) -> int:
        self._cookie += 1
        cookie = self._cookie
        self._watches[(pool_id, oid, cookie)] = callback
        reply = await self.op_submit(pool_id, oid,
                                     [("watch", {"cookie": cookie})])
        if reply.result != 0:
            del self._watches[(pool_id, oid, cookie)]
            raise IOError(f"watch({oid}) -> {reply.result}")
        return cookie

    async def unwatch(self, pool_id: int, oid: str, cookie: int) -> None:
        self._watches.pop((pool_id, oid, cookie), None)
        await self.op_submit(pool_id, oid, [("unwatch", {"cookie": cookie})])

    async def daemon_command(self, addr, cmd: Dict[str, Any],
                             timeout: float = 10.0):
        """Admin command straight to a daemon ('ceph tell' / admin-socket
        analog): osd perf dump, dump_historic_ops, mgr status, ..."""
        self._mon_tid += 1
        tid = self._mon_tid
        fut = asyncio.get_event_loop().create_future()
        self._cmd_inflight[tid] = fut
        try:
            await self.messenger.send_message(
                M.MCommand(cmd=cmd, tid=tid), tuple(addr))
            reply = await asyncio.wait_for(fut, timeout=timeout)
        finally:
            self._cmd_inflight.pop(tid, None)
        if reply.result != 0:
            raise RuntimeError(f"daemon command failed: {reply.data}")
        return reply.data

    async def mon_command(self, cmd: Dict[str, Any], timeout: float = 10.0):
        """Command with failover: retries against the other monitors when
        the current one dies or has no leader (commands are idempotent at
        the mon: pool create returns the existing pool on a retry)."""
        deadline = asyncio.get_event_loop().time() + timeout * 3
        last_err = None
        # capped jittered backoff between retries: a mon that answers -11
        # INSTANTLY (leaderless quorum) must not be hammered at loop
        # speed — fixed sleeps made every leaderless client resonate
        backoff = ExpBackoff(base=0.05, cap=1.0,
                             rng=self._backoff_rng("mon_command"))
        while asyncio.get_event_loop().time() < deadline:
            self._mon_tid += 1
            tid = self._mon_tid
            fut = asyncio.get_event_loop().create_future()
            self._mon_inflight[tid] = fut
            try:
                await self._mon_send(M.MMonCommand(cmd=cmd, tid=tid))
                reply = await asyncio.wait_for(fut, timeout=timeout)
            except (asyncio.TimeoutError, ConnectionError, OSError) as e:
                self._mon_inflight.pop(tid, None)
                last_err = e
                self._hunt()
                await asyncio.sleep(backoff.next())
                continue
            if reply.result == -11:   # no leader yet: retry
                last_err = RuntimeError(str(reply.data))
                await asyncio.sleep(backoff.next())
                continue
            if reply.result != 0:
                raise RuntimeError(f"mon command failed: {reply.data}")
            return reply.data
        raise TimeoutError(f"mon command never succeeded: {last_err}")


class IoCtx:
    """Pool I/O context (librados IoCtx analog).

    Snapshot surface (librados snap API): pool snaps attach their
    SnapContext to writes automatically (from the osdmap's pg_pool_t);
    ``set_snap_context`` installs an explicit selfmanaged context (RBD's
    mode); ``set_snap_read``/per-call ``snapid`` select the snap reads
    observe (reference rados_ioctx_snap_set_read)."""

    def __init__(self, objecter: Objecter, pool_id: int):
        self.objecter = objecter
        self.pool_id = pool_id
        self._snapc: Optional[Tuple[int, Tuple[int, ...]]] = None
        self._snap_read: Optional[int] = None

    # -- snapshot controls -------------------------------------------------

    def set_snap_context(self, seq: int, snaps) -> None:
        """Selfmanaged SnapContext for subsequent writes (descending)."""
        self._snapc = (seq, tuple(snaps))

    def set_snap_read(self, snapid: Optional[int]) -> None:
        """Snap observed by subsequent reads (None = HEAD)."""
        self._snap_read = snapid

    def _write_snapc(self):
        if self._snapc is not None:
            return self._snapc
        pool = self.objecter.osdmap.pools.get(self.pool_id) \
            if self.objecter.osdmap else None
        if pool is not None and pool.snaps:
            return pool.snap_context()
        return None

    async def snap_create(self, name: str) -> int:
        """Pool snapshot (reference rados_ioctx_snap_create)."""
        sid = await self.objecter.mon_command({
            "prefix": "osd pool mksnap", "pool": self.pool_id, "snap": name})
        await self.objecter._refresh_map()
        return sid

    async def snap_remove(self, name: str) -> int:
        sid = await self.objecter.mon_command({
            "prefix": "osd pool rmsnap", "pool": self.pool_id, "snap": name})
        await self.objecter._refresh_map()
        return sid

    def snap_list(self) -> Dict[int, str]:
        pool = self.objecter.osdmap.pools[self.pool_id]
        return dict(pool.snaps)

    def snap_lookup(self, name: str) -> int:
        for sid, n in self.snap_list().items():
            if n == name:
                return sid
        raise FileNotFoundError(name)

    async def selfmanaged_snap_create(self) -> int:
        """Allocate a snap id the CLIENT manages (reference
        rados_ioctx_selfmanaged_snap_create — RBD's snapshot mode)."""
        sid = await self.objecter.mon_command({
            "prefix": "osd pool selfmanaged_snap_create",
            "pool": self.pool_id})
        await self.objecter._refresh_map()
        return sid

    async def selfmanaged_snap_remove(self, snapid: int) -> None:
        await self.objecter.mon_command({
            "prefix": "osd pool selfmanaged_snap_remove",
            "pool": self.pool_id, "snapid": snapid})
        await self.objecter._refresh_map()

    # -- data ops ----------------------------------------------------------

    @staticmethod
    def _raise_write_error(verb: str, oid: str, reply) -> None:
        """Map a mutation's failed result to the exception the caller
        can act on: -28 becomes a REAL OSError(ENOSPC) — the cluster is
        full, not broken, and the remedy is deleting data,
        not retrying or refreshing maps."""
        if reply.result == -28:
            raise OSError(
                28, f"{verb}({oid}): cluster full (ENOSPC); deletes "
                    f"still admitted")
        raise IOError(f"{verb}({oid}) -> {reply.result}: {reply.data}")

    async def write_full(self, oid: str, data: bytes,
                         timeout: float = None) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("write_full", {"data": data})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            self._raise_write_error("write_full", oid, reply)

    async def write(self, oid: str, data: bytes, offset: int = 0,
                    timeout: float = None) -> None:
        """Partial write at an offset — the EC read-modify-write path
        (reference IoCtxImpl::write -> ECBackend::start_rmw)."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("write", {"offset": offset, "data": data})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            self._raise_write_error("write", oid, reply)

    async def read(self, oid: str, offset: int = 0,
                   length: int = None, timeout: float = None,
                   snapid: int = None) -> bytes:
        args = {}
        if offset:
            args["offset"] = offset
        if length is not None:
            args["length"] = length
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("read", args)], timeout=timeout,
            snapid=snapid if snapid is not None else self._snap_read)
        if reply.result == -2:
            raise FileNotFoundError(oid)
        if reply.result != 0:
            raise IOError(f"read({oid}) -> {reply.result}: {reply.data}")
        return reply.data

    async def remove(self, oid: str, timeout: float = None) -> None:
        reply = await self.objecter.op_submit(self.pool_id, oid,
                                              [("delete", {})],
                                              timeout=timeout,
                                              snapc=self._write_snapc())
        if reply.result == -2:
            # -ENOENT maps like read/stat: callers that tolerate a
            # missing object catch FileNotFoundError, not a generic
            # IOError (rbd.remove's journal cleanup relies on this)
            raise FileNotFoundError(oid)
        if reply.result != 0:
            raise IOError(f"remove({oid}) -> {reply.result}")

    async def append(self, oid: str, data: bytes,
                     timeout: float = None) -> int:
        """Atomic append; returns the offset the data landed at
        (reference rados_append)."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("append", {"data": bytes(data)})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            self._raise_write_error("append", oid, reply)
        return reply.data

    async def truncate(self, oid: str, size: int) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("truncate", {"size": size})],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"truncate({oid}) -> {reply.result}")

    async def zero(self, oid: str, offset: int, length: int) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid,
            [("zero", {"offset": offset, "length": length})],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"zero({oid}) -> {reply.result}")

    async def copy_from(self, dst_oid: str, src_oid: str,
                        src_pool: Optional[int] = None,
                        src_snapid: Optional[int] = None) -> int:
        """Server-side object copy (reference rados_copy /
        CEPH_OSD_OP_COPY_FROM): the destination primary pulls data,
        user xattrs, and omap from the source — cross-pool and across
        pool types — without routing bytes through this client.
        Returns the copied byte count."""
        args = {"src_oid": src_oid}
        if src_pool is not None:
            args["src_pool"] = src_pool
        if src_snapid is not None:
            args["src_snapid"] = src_snapid
        reply = await self.objecter.op_submit(
            self.pool_id, dst_oid, [("copy_from", args)],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"copy_from({dst_oid} <- {src_oid}) -> "
                          f"{reply.result}")
        return reply.data

    async def rollback(self, oid: str, snapid: int) -> None:
        """Roll the head back to its state at ``snapid`` (reference
        rados_ioctx_snap_rollback -> _rollback_to); the current head
        still COWs into its own clone first."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("rollback", {"snapid": snapid})],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"rollback({oid}@{snapid}) -> {reply.result}")

    async def create(self, oid: str, exclusive: bool = True) -> None:
        """Exclusive object create (rados_write_op create + EXCL)."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("create", {})],
            snapc=self._write_snapc())
        if reply.result == -17:
            raise FileExistsError(oid)
        if reply.result != 0:
            raise IOError(f"create({oid}) -> {reply.result}")

    async def cmpxattr(self, oid: str, name: str, value: bytes) -> bool:
        """Equality xattr guard; False on mismatch (-ECANCELED)."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid,
            [("cmpxattr", {"name": name, "value": bytes(value)})])
        if reply.result == -125:
            return False
        if reply.result != 0:
            raise IOError(f"cmpxattr({oid}) -> {reply.result}")
        return True

    async def stat(self, oid: str, snapid: int = None,
                   timeout: float = None) -> int:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("stat", {})], timeout=timeout,
            snapid=snapid if snapid is not None else self._snap_read)
        if reply.result != 0:
            raise FileNotFoundError(oid)
        return reply.data

    async def list_objects(self) -> List[str]:
        """Pool-wide object listing: one list op per PG against its
        primary (librados NObjectIterator analog)."""
        from ceph_tpu_torch.osdmap.osdmap import PGid

        pool = self.objecter.osdmap.pools[self.pool_id]
        replies = await asyncio.gather(*[
            self.objecter.op_submit(self.pool_id, "", [("list", {})],
                                    pgid=PGid(self.pool_id, seed))
            for seed in range(pool.pg_num)])
        names: List[str] = []
        for reply in replies:
            names.extend(reply.data or [])
        return sorted(names)

    # -- xattrs (librados rados_getxattr/setxattr family) -------------------

    async def getxattr(self, oid: str, name: str,
                       snapid: Optional[int] = None) -> bytes:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("getxattr", {"name": name})],
            snapid=snapid if snapid is not None else self._snap_read)
        if reply.result == -61:
            raise KeyError(name)
        if reply.result != 0:
            raise IOError(f"getxattr({oid}, {name}) -> {reply.result}")
        return reply.data

    async def setxattr(self, oid: str, name: str, value: bytes) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("setxattr", {"name": name,
                                              "value": bytes(value)})],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"setxattr({oid}, {name}) -> {reply.result}")

    async def rmxattr(self, oid: str, name: str) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("rmxattr", {"name": name})],
            snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"rmxattr({oid}, {name}) -> {reply.result}")

    async def getxattrs(self, oid: str) -> Dict[str, bytes]:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("getxattrs", {})])
        if reply.result != 0:
            raise IOError(f"getxattrs({oid}) -> {reply.result}")
        return reply.data

    # -- omap ---------------------------------------------------------------

    async def omap_set(self, oid: str, kv: Dict[str, bytes],
                       timeout: float = None) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("omap_set", {"kv": dict(kv)})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"omap_set({oid}) -> {reply.result}")

    async def omap_get(self, oid: str,
                       snapid: Optional[int] = None,
                       timeout: float = None) -> Dict[str, bytes]:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("omap_get", {})], timeout=timeout,
            snapid=snapid if snapid is not None else self._snap_read)
        if reply.result != 0:
            raise IOError(f"omap_get({oid}) -> {reply.result}")
        return reply.data

    async def omap_rmkeys(self, oid: str, keys,
                          timeout: float = None) -> None:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("omap_rmkeys", {"keys": list(keys)})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(f"omap_rmkeys({oid}) -> {reply.result}")

    # -- object classes (rados_exec) ----------------------------------------

    async def execute(self, oid: str, cls: str, method: str,
                      indata: bytes = b"",
                      timeout: float = None) -> bytes:
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("exec", {"cls": cls, "method": method,
                                          "indata": bytes(indata)})],
            timeout=timeout, snapc=self._write_snapc())
        if reply.result != 0:
            raise IOError(
                f"exec({oid}, {cls}.{method}) -> {reply.result}: "
                f"{reply.data}")
        return reply.data

    # -- watch/notify -------------------------------------------------------

    async def watch(self, oid: str, callback) -> int:
        """Register a watch; callback(payload) fires on every notify
        (re-registered across map changes — a linger op)."""
        return await self.objecter.watch(self.pool_id, oid, callback)

    async def unwatch(self, oid: str, cookie: int) -> None:
        await self.objecter.unwatch(self.pool_id, oid, cookie)

    async def notify(self, oid: str, payload: bytes = b"",
                     timeout: float = 5.0):
        """Notify all watchers; returns the list of ackers."""
        reply = await self.objecter.op_submit(
            self.pool_id, oid, [("notify", {"payload": bytes(payload),
                                            "timeout": timeout})])
        if reply.result != 0:
            raise IOError(f"notify({oid}) -> {reply.result}")
        return reply.data


class RadosClient:
    """librados rados_t analog: connect, pools, ioctx."""

    def __init__(self, mon_addr: Addr, name: str = "admin",
                 config: Optional[Config] = None, device=None):
        self.objecter = Objecter(name, mon_addr, config, device=device)

    async def connect(self) -> None:
        await self.objecter.start()

    async def shutdown(self) -> None:
        await self.objecter.stop()

    async def pool_create(self, name: str, pool_type: str = "replicated",
                          pg_num: int = 16, size: int = 3,
                          ec_profile: Optional[Dict[str, str]] = None) -> int:
        pool_id = await self.objecter.mon_command({
            "prefix": "osd pool create", "pool": name,
            "pool_type": pool_type, "pg_num": pg_num, "size": size,
            "ec_profile": ec_profile})
        await self.objecter._refresh_map()
        return pool_id

    async def status(self):
        return await self.objecter.mon_command({"prefix": "status"})

    async def tier_add(self, base: str, cache: str) -> None:
        """'osd tier add <base> <cache>' (reference OSDMonitor)."""
        await self.objecter.mon_command({
            "prefix": "osd tier add", "pool": base, "tierpool": cache})
        await self.objecter._refresh_map()

    async def tier_remove(self, base: str, cache: str) -> None:
        await self.objecter.mon_command({
            "prefix": "osd tier remove", "pool": base, "tierpool": cache})
        await self.objecter._refresh_map()

    async def tier_cache_mode(self, cache: str, mode: str) -> None:
        """'osd tier cache-mode <cache> writeback|readproxy|forward|none'."""
        await self.objecter.mon_command({
            "prefix": "osd tier cache-mode", "pool": cache, "mode": mode})
        await self.objecter._refresh_map()

    async def tier_set_overlay(self, base: str, cache: str) -> None:
        await self.objecter.mon_command({
            "prefix": "osd tier set-overlay", "pool": base,
            "overlaypool": cache})
        await self.objecter._refresh_map()

    async def tier_remove_overlay(self, base: str) -> None:
        await self.objecter.mon_command({
            "prefix": "osd tier remove-overlay", "pool": base})
        await self.objecter._refresh_map()

    async def pool_delete(self, name: str, sure: bool = False) -> None:
        """Irreversible; mirrors the reference's name-twice + sure gate."""
        await self.objecter.mon_command({
            "prefix": "osd pool delete", "pool": name, "pool2": name,
            "sure": sure})
        await self.objecter._refresh_map()

    async def pool_rename(self, src: str, dst: str) -> None:
        await self.objecter.mon_command({
            "prefix": "osd pool rename", "srcpool": src, "destpool": dst})
        await self.objecter._refresh_map()

    async def pool_set(self, name: str, var: str, val) -> None:
        await self.objecter.mon_command({
            "prefix": "osd pool set", "pool": name, "var": var,
            "val": val})
        await self.objecter._refresh_map()

    def pool_list(self):
        m = self.objecter.osdmap
        return {p.name or pid: pid for pid, p in m.pools.items()}

    def ioctx(self, pool_id: int) -> IoCtx:
        return IoCtx(self.objecter, pool_id)

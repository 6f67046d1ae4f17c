"""OSD daemon: PGs, replicated and erasure-coded backends, recovery.

Counterpart of ``ceph_tpu/cluster/osd.py``.

Structural mirror of the reference OSD (src/osd/OSD.cc dispatch ->
PrimaryLogPG op execution; ReplicatedBackend transaction fan-out;
ECBackend shard writes/reads, src/osd/ECBackend.cc:921,986,1141), with the
dense compute — erasure encode/decode, chunk crc32c — running through the
device codec engine.  Heartbeats/failure reports mirror OSD::heartbeat_check
(OSD.cc:4763) -> MOSDFailure -> monitor.  Recovery re-synchronizes PG
contents on map change (push recovery; EC shards reconstructed by decode,
ECBackend::run_recovery_op analog).
"""

from __future__ import annotations

import asyncio
import pickle
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from ceph_tpu_torch.analysis import racecheck
from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster import pglog
from ceph_tpu_torch.cluster.messenger import (
    Addr,
    Connection,
    Dispatcher,
    EntityName,
    Messenger,
)
from ceph_tpu_torch.cluster.pglog import LogEntry, PGInfo, PGLog
from ceph_tpu_torch.cluster.store import MemStore, ObjectStore, Transaction
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.ops import crc32c as crcmod
from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGid, PGPool
from ceph_tpu_torch.utils import Config, PerfCounters
from ceph_tpu_torch.utils.device import resolve_device_index, run_on
from ceph_tpu_torch.cluster.backend_ec import ECBackendMixin
from ceph_tpu_torch.cluster.tiering import TieringMixin
from ceph_tpu_torch.cluster.backend_replicated import ReplicatedBackendMixin
from ceph_tpu_torch.cluster.client_ops import ClientOpsMixin
from ceph_tpu_torch.cluster.pg import (  # noqa: F401  (re-exported: tools/tests)
    MOSDPGQuery,
    MOSDPGQueryReply,
    PGMETA,
    PGState,
    PGLogMixin,
    _coll,
)
from ceph_tpu_torch.cluster.recovery import RecoveryMixin
from ceph_tpu_torch.cluster.scrub import ScrubMixin

# the daemon-level metadata collection: superblock with the current osdmap
# (reference OSDSuperblock, read at OSD::init, src/osd/OSD.cc:2556)
METACOLL = "meta"


class OSDDaemon(PGLogMixin, ClientOpsMixin, ReplicatedBackendMixin,
                ECBackendMixin, RecoveryMixin, ScrubMixin, TieringMixin,
                Dispatcher):
    def __init__(self, osd_id: int, mon_addr,
                 config: Optional[Config] = None,
                 store: Optional[ObjectStore] = None, device=None,
                 placements=None):
        """``device``: where this OSD's codec, checksum and placement work
        runs (CUDA unless the caller names the CPU; raises without a
        card).  ``placements``: a raw-placement cache every map this OSD
        takes in shares with the other daemons of an in-process cluster
        (``vstart.PlacementCache``), or None."""
        self.device = resolve_device_index(device)
        self.placements = placements
        self.osd_id = osd_id
        # per-daemon config copy: injectargs on one daemon must never
        # leak into another (each reference daemon owns its md_config_t)
        self.config = Config(**config.show()) if config else Config()
        # the default store advertises (and ENFORCES) the
        # configured capacity — the memstore_device_bytes analog the
        # cluster-full protection and the disk-fill scenarios size
        self.store = store or MemStore(self.config.memstore_device_bytes)
        self.messenger = Messenger(
            EntityName("osd", osd_id),
            secret=self.config.auth_secret(),
            auth=self.config.cephx_context(f"osd.{osd_id}"),
            config=self.config)
        self.messenger.add_dispatcher(self)
        # chaos seams (ceph_tpu_torch/chaos/): per-daemon skewable clock (our
        # heartbeat/failure timings read THIS, so a scenario can skew one
        # daemon's view of time) + config-driven disk injector on the
        # store; both stay provable no-ops at default config
        from ceph_tpu_torch.chaos.clock import ChaosClock
        from ceph_tpu_torch.chaos.disk import DiskInjector

        self.clock = ChaosClock.from_config(self.config)
        self.store.chaos = DiskInjector.from_config(
            self.config, f"osd.{osd_id}")
        self.config.add_observer(self._chaos_disk_observer)
        # reference ceph_osd.cc:511-525 policy binding: clients are lossy
        # (replies are connection-scoped; the client re-requests) with a
        # byte throttle so a fast client backpressures instead of burying
        # the daemon; osd/mon peers stay lossless (session replay)
        from ceph_tpu_torch.cluster.messenger import Policy, Throttle

        self.messenger.set_policy("client", Policy(
            lossy=True,
            throttle=Throttle(self.config.osd_client_message_size_cap)))
        self.messenger.set_policy("osd", Policy(lossy=False))
        self.messenger.set_policy("mon", Policy(lossy=False))
        # monmap failover (shared MonClient hunting, cluster/monclient.py)
        from ceph_tpu_torch.cluster.monclient import MonTargeter

        from ceph_tpu_torch.chaos.rng import stream as _chaos_stream

        self.monc = MonTargeter(
            self.messenger, mon_addr,
            subscribe_since=lambda: self.osdmap.epoch if self.osdmap else 0,
            rng=_chaos_stream(self.config.chaos_seed,
                              f"monc:osd.{osd_id}")
            if self.config.chaos_seed else None)
        self.osdmap: Optional[OSDMap] = None
        self.pgs: Dict[PGid, PGState] = {}
        self.map_advance_seconds = 0.0
        self.map_advances = 0
        # per-daemon counter registry: own counters + the process-wide
        # device-kernel counters, all served by one 'perf dump'
        from ceph_tpu_torch.utils import KERNELS, PerfCountersCollection

        self.perfcoll = PerfCountersCollection()
        self.perf = self.perfcoll.create(f"osd.{osd_id}")
        self.perfcoll.register(KERNELS)
        self._declare_perf_schema()
        from ceph_tpu_torch.cluster.optracker import OpTracker

        self.tracker = OpTracker(
            history_size=self.config.osd_op_history_size,
            slow_size=self.config.osd_op_history_slow_op_size,
            slow_threshold=self.config.osd_op_complaint_time,
            clock=self.clock)
        # graft-trace seams (ceph_tpu_torch/trace/): per-daemon span tracer +
        # event-loop profiler, both provable no-ops at default config
        from ceph_tpu_torch.trace import LoopProfiler, Tracer

        self.tracer = Tracer(f"osd.{osd_id}",
                             enabled=bool(self.config.trace_enabled),
                             keep=self.config.trace_keep)
        self.loopmon = LoopProfiler(
            self.perf, self.config.loop_profile_interval,
            prefix="osd_loop")
        # graft-blackbox flight ring (NULL_FLIGHT when disabled):
        # stamped on this daemon's possibly-skewed chaos clock
        from ceph_tpu_torch.trace import FlightRecorder

        self.flight = FlightRecorder.from_config(
            f"osd.{osd_id}", self.config, clock=self.clock)
        # live depth of the ordered dispatch queues (ShardedOpWQ-depth
        # analog) — maintained by client_ops, exported as a perf gauge
        self._queued_depth = 0
        # admission budgets in use (client_ops._admit_op): ops + payload
        # bytes concurrently queued/executing against osd_op_throttle_*
        self._admit_ops = 0
        self._admit_bytes = 0
        # recent EC sub-read gather latencies (seconds): the quantile
        # the hedge delay for degraded k-of-n reads is derived from
        from collections import deque as _deque

        self._subread_lats = _deque(maxlen=64)
        # ONE shared jitter stream for internal-op pushback backoff:
        # concurrent internal ops interleave draws from it, so their
        # retries desynchronize (per-call streams with one name would
        # retry in lockstep); seeded for chaos replay, else None
        self._internal_backoff_rng = _chaos_stream(
            self.config.chaos_seed, f"internal:osd.{osd_id}") \
            if self.config.chaos_seed else None
        # last slow-op count surfaced to the cluster log (warn on rise,
        # log clearance on drain — the mon health check itself keys off
        # the beacon stream)
        self._slow_warned = 0
        self.asok = self._build_admin_socket()
        self._codecs: Dict[int, object] = {}
        self._pending: Dict[Tuple, Tuple[asyncio.Future, List]] = {}
        self._tid = 0
        # waiters for this OSD's own internal client ops (copy-from, tier
        # promote/flush): reqid -> future resolved by MOSDOpReply
        self._internal_inflight: Dict[Tuple, asyncio.Future] = {}
        self._internal_tid = 0
        # background tasks: a SELF-DISCARDING set (the messenger._track
        # pattern) — per-op and per-map-change spawns must not
        # accumulate one dead Task each for the daemon's life (the bug
        # class a task-spawn lint rule polices)
        self._tasks: Set[asyncio.Task] = set()
        # incomplete-recovery retry state (recovery.py
        # _queue_recovery_retry): per-PG capped backoff + the armed
        # retry task, so failed pulls/pushes re-run without needing
        # another map change to trigger peering
        self._recovery_backoffs: Dict[PGid, object] = {}
        self._recovery_retry_tasks: Dict[PGid, asyncio.Task] = {}
        # control plane at scale: per-pool resolved-placement
        # snapshots diffed across epochs (osdmap.placement_delta), the
        # pending-peering queue those diffs feed, ONE collapsing drain
        # task, a per-OSD concurrency throttle on simultaneous peering
        # rounds, and the seeded stream big waves stagger from
        self._placement_cache: Dict[int, object] = {}
        self._peering_pending: Set[PGid] = set()
        self._peering_task: Optional[asyncio.Task] = None
        # primary PGs owing a peering/recovery round: added
        # when an epoch queues them to re-peer, cleared when a round
        # completes clean (or the PG leaves this OSD).  The beacon
        # reports the count — the mon's PG_RECOVERING feed that gates
        # the balancer's next round and the reshaper's wait-clean.
        self._unclean_pgs: Set[PGid] = set()
        # a COUNTED throttle, not a mutual-exclusion lock: DepLock has
        # no semaphore mode, and ordering is safe by construction — the
        # semaphore is only ever acquired BEFORE (never while holding)
        # a PG lock (recovery._recover_pg)
        self._peering_sem = asyncio.Semaphore(  # graftlint: ignore[asyncio-blocking]
            max(1, self.config.osd_peering_max_concurrent))
        self._peering_rng = _chaos_stream(
            self.config.chaos_seed, f"peering:osd.{osd_id}") \
            if self.config.chaos_seed else None
        self._hb_last: Dict[int, float] = {}
        # the address each heartbeat peer's stamp belongs to
        self._hb_addr: Dict[int, Tuple] = {}
        self._reported: Set[int] = set()
        # dmClock op scheduling (reference mClockClientQueue plugged into
        # ShardedOpWQ): enabled by osd_op_queue=mclock; ops enqueue per
        # client and a drain task serves them by reservation/weight/limit
        self._opq = None
        self._opq_event = asyncio.Event()
        self._opq_running: Set[asyncio.Task] = set()
        # default (non-mclock) dispatch: per-(connection, PG) FIFO
        # queues drained off the messenger read loop — the reference
        # orders a client session's ops per PG (ShardedOpWQ pg queues)
        self._ordered_q: Dict[Tuple[int, PGid], object] = {}
        self._ordered_active: Set[Tuple[int, PGid]] = set()
        self._opq_default = None
        if self.config.osd_op_queue == "mclock":
            from ceph_tpu_torch.cluster.dmclock import DmClockQueue, QoSSpec

            self._opq_default = QoSSpec(
                reservation=self.config.osd_mclock_default_reservation,
                weight=self.config.osd_mclock_default_weight,
                limit=self.config.osd_mclock_default_limit)
            if self.config.osd_op_shards == 0:
                # legacy global queue; with shards on, each shard owns
                # its own DmClockQueue (mClockClientQueue-per-shard)
                self._opq = DmClockQueue()
        # sharded dispatch: PG-affine
        # shards with tick-bounded drain; 0 = the legacy path above
        self._shardedq = None
        if self.config.osd_op_shards > 0:
            from ceph_tpu_torch.cluster.sharded_wq import ShardedOpWQ

            self._shardedq = ShardedOpWQ(self,
                                         self.config.osd_op_shards)
        # per-tick stripe-batch coalescer + per-peer sub-write frame
        # batcher (cluster/batcher.py): EC writes ride both when
        # osd_batch_tick_ops > 0
        from ceph_tpu_torch.cluster.batcher import (ClientReplyBatcher,
                                              EncodeBatcher,
                                              ReadBatcher,
                                              SubWriteBatcher)

        self._ec_batcher = EncodeBatcher(self)
        self._sub_batcher = SubWriteBatcher(self)
        # read-side coalescer: per-tick decode / recovery
        # reencode / shard-crc verification batches — the decode twin
        self._read_batcher = ReadBatcher(self)
        # client-edge reply coalescer: acks for ops that
        # arrived inside an MOSDOpBatch leave as MOSDOpReplyBatch ticks;
        # per-conn wrapper identity must be STABLE — the ordered-FIFO
        # keys are (id(conn), pgid) — so batch conns are cached here
        self._reply_batcher = ClientReplyBatcher(self)
        self._batch_conns: Dict[int, object] = {}
        # (pgid, oid) pairs with an in-flight async read-repair, so a
        # storm of reads against one corrupt object arms ONE rebuild
        self._read_repairs_inflight: Set[Tuple] = set()
        # boot instance nonce: lets the mon fence a fast rebounce even if
        # the new daemon lands on the identical address
        import itertools as _it
        import secrets as _secrets

        self.boot_instance = _secrets.randbits(63)
        # the epoch of the first map that shows this daemon up at its own
        # address: until it lands, the map this daemon peers with is one
        # from before its boot (a superblock resume), and a PG it thinks
        # it leads may have passed through intervals it never saw
        self._up_epoch: Optional[int] = None
        # watch/notify state: (pgid, oid) -> {(watcher, cookie): conn}
        # (reference Watch/Notify on PrimaryLogPG)
        self._watchers: Dict[Tuple, Dict[Tuple[str, int], Connection]] = {}
        self._notifies: Dict[int, Tuple[asyncio.Future, Set[str]]] = {}
        self._notify_id = 0
        # removed snaps already trimmed per PG (purged_snaps analog;
        # in-memory — a restart re-runs one idempotent trim pass)
        self._purged_snaps: Dict[Tuple, set] = {}
        # chaos crash points: remaining traversals of the
        # armed point before it fires; the launcher (vstart Cluster)
        # installs _chaos_crash_cb so a self-crash keeps the cluster's
        # revive bookkeeping coherent
        self._crash_skip = self.config.chaos_crash_point_skip
        self._crash_fired = False
        self._chaos_crash_cb = None
        self.config.add_observer(self._chaos_crash_observer)
        self._stopped = False

    def _chaos_crash_observer(self, name: str, value) -> None:
        if name == "chaos_crash_point_skip":
            self._crash_skip = int(value)
        elif name == "chaos_crash_point":
            self._crash_fired = False

    def _chaos_point(self, name: str) -> None:
        """Named crash seam: when the armed chaos_crash_point
        matches, power-cut this daemon AT THIS INSTANT — _stopped flips
        before anything else runs, the actual store-crash/teardown is
        handed to the launcher's callback, and ChaosCrash (a
        CancelledError) unwinds the current path exactly like a task
        dying mid-await.  One falsy test when unarmed (no-op contract).
        """
        cp = self.config.chaos_crash_point
        if not cp or cp != name or self._stopped or self._crash_fired:
            return
        if self._crash_skip > 0:
            self._crash_skip -= 1
            return
        from ceph_tpu_torch.chaos import ChaosCrash
        from ceph_tpu_torch.chaos.counters import CHAOS

        self._crash_fired = True
        self._stopped = True
        CHAOS.inc("crash_points_fired")
        if self.flight:
            self.flight.record("crash_point", point=name)
        if hasattr(self.store, "crash"):
            # freeze the disk AT the instant: nothing the unwinding
            # coroutines do past this point may persist (a real power
            # cut doesn't run except-handlers against the platter)
            self.store.crash()
        cb = self._chaos_crash_cb
        if cb is not None:
            # the callback task is OWNED BY THE LAUNCHER (it outlives
            # this daemon's stop(); tracking it here would cancel the
            # crash mid-flight)
            cb(name)
        raise ChaosCrash(f"chaos crash point {name!r} fired")

    # ------------------------------------------------------------ lifecycle

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        self.store.mount()
        since = self._load_superblock()
        addr = await self.messenger.bind(host, port)
        # boot must surface unreachable monitors, not run unregistered
        await self._mon_send(M.MOSDBoot(osd_id=self.osd_id, addr=addr,
                                        instance=self.boot_instance),
                             raise_on_fail=True)
        await self._mon_send(
            M.MMonSubscribe(what="osdmap", addr=addr, since=since))
        loop = asyncio.get_event_loop()
        self._track(loop.create_task(self._heartbeat_loop()))
        self._track(loop.create_task(self._scrub_loop()))
        self._track(loop.create_task(self._tier_agent_loop()))
        if self._opq is not None:
            self._track(loop.create_task(self._opq_drain()))
        if self._shardedq is not None:
            self._shardedq.start()
        if self.loopmon.enabled:
            self._track(loop.create_task(self.loopmon.sample()))
        if self._peering_pending:
            # superblock resume queued our primary PGs before the loop
            # tasks existed; if the subscribed map matches the persisted
            # one no _post_map_update ever fires changed=True, and the
            # boot-time queue (plus its unclean-beacon claim) would sit
            # forever — the restarted primary owes these PGs a round
            self._kick_peering()
        return addr

    def _track(self, task: asyncio.Task) -> asyncio.Task:
        """Register a background task; it discards itself on completion
        and stop() cancels whatever is still live."""
        from ceph_tpu_torch.utils.tasks import track_task

        return track_task(self._tasks, task)

    def _load_superblock(self) -> int:
        """Resume from the persisted osdmap + PG logs (reference
        read_superblock + load_pgs, OSD.cc:2556,2572).  Returns the epoch
        to subscribe from (0 = never booted)."""
        blob = self.store.getattr(METACOLL, "superblock", "osdmap")
        if blob is None:
            return 0
        self.osdmap = pickle.loads(blob).set_device(self.device,
                                                    self.placements)
        self.perf.set("osd_map_epoch", self.osdmap.epoch)
        self._advance_pgs()  # reloads per-PG logs from their pgmeta objects
        return self.osdmap.epoch

    def _save_superblock(self) -> None:
        self.store.queue_transaction(
            Transaction()
            .create_collection(METACOLL)
            .setattr(METACOLL, "superblock", "osdmap",
                     pickle.dumps(self.osdmap)))

    async def stop(self, crash: bool = False, torn_tail: bool = False,
                   lose_frames: int = 0) -> None:
        """Clean shutdown, or (``crash=True``) a power-cut stop: the
        store skips its clean-shutdown checkpoint — FileStore/BlueStore
        may tear or lose the journal tail; a MemStore's contents are
        simply what a dead host's RAM is."""
        self._stopped = True
        # deregister config observers: the per-daemon config OUTLIVES
        # this incarnation (restart/revive reuse it), and stale
        # observers would pin every dead daemon and mutate its state
        # on later injectargs
        self.config.remove_observer(self._chaos_disk_observer)
        self.config.remove_observer(self._chaos_crash_observer)
        for t in list(self._tasks) + list(self._opq_running):
            t.cancel()
        if self._opq_running:
            # teardown drain of already-cancelled op tasks; their
            # results are void by definition
            await asyncio.gather(*self._opq_running,  # graftlint: ignore[swallowed-async-error]
                                 return_exceptions=True)
        await self.messenger.shutdown()
        if crash:
            if hasattr(self.store, "crash"):
                self.store.crash(torn_tail=torn_tail,
                                 lose_frames=lose_frames)
        else:
            self.store.umount()
        # deregister our counters (the shared KERNELS registry stays)
        self.perfcoll.remove(self.perf.name)

    def _chaos_disk_observer(self, name: str, value) -> None:
        if name.startswith("chaos_disk") or name == "chaos_seed":
            from ceph_tpu_torch.chaos.disk import DiskInjector

            self.store.chaos = DiskInjector.from_config(
                self.config, f"osd.{self.osd_id}")

    def _next_reqid(self) -> Tuple[str, int]:
        self._tid += 1
        return (f"osd.{self.osd_id}", self._tid)

    @property
    def _mclock_dispatch(self) -> bool:
        """Is client-op dispatch QoS-queued (global legacy queue or
        per-shard mclock)?  Governs the internal-op loopback choice:
        under FIFO-ordered dispatch a self-targeted nested op must run
        direct (same-(conn,PG) group serialization would deadlock);
        under mclock each dequeue is a free task, so self-messaging is
        safe and required."""
        return self._opq is not None or (
            self._shardedq is not None and self._shardedq.use_mclock)

    @property
    def mon_addr(self) -> Addr:
        return self.monc.current

    async def _mon_send(self, msg, raise_on_fail: bool = False) -> bool:
        return await self.monc.send(msg, raise_on_fail=raise_on_fail)

    async def internal_op(self, pool_id: int, oid: str, ops,
                          snapid=None, snapc=None,
                          timeout: Optional[float] = None,
                          reqid_override: Optional[Tuple] = None):
        """This OSD acting as a rados client (the reference OSD's own
        Objecter, used by copy-from and cache tiering): target the
        object's primary in ``pool_id`` and run an op vector.  Returns
        the terminal MOSDOpReply."""
        from ceph_tpu_torch.ops.jenkins import str_hash_rjenkins
        from ceph_tpu_torch.osdmap.osdmap import ceph_stable_mod

        if timeout is None:
            timeout = self.config.osd_client_op_timeout + 2.0
        deadline = asyncio.get_event_loop().time() + timeout
        # background class: when the target pushes back THROTTLED under
        # admission pressure (or evicts us for a client op), retry under
        # capped jittered backoff — yielding, not hammering.  The rng
        # is the daemon-wide seeded stream (chaos replay) shared by all
        # internal ops, so concurrent retries interleave draws instead
        # of sleeping identical sequences in lockstep.
        from ceph_tpu_torch.utils.backoff import ExpBackoff

        pushback = ExpBackoff(base=0.05, cap=1.0,
                              rng=self._internal_backoff_rng)
        wall_deadline = time.time() + timeout
        while True:
            m = self.osdmap
            pool = m.pools.get(pool_id)
            if pool is None:
                raise IOError(f"pool {pool_id} gone")
            seed = ceph_stable_mod(str_hash_rjenkins(oid.encode()),
                                   pool.pg_num, pool.pg_num_mask)
            pgid = PGid(pool_id, seed)
            _, _, _, primary = m.pg_to_up_acting_osds(pgid)
            addr = m.osd_addrs.get(primary) if primary >= 0 else None
            if addr is None:
                if asyncio.get_event_loop().time() > deadline:
                    raise IOError(f"no primary for {pool_id}:{oid}")
                await asyncio.sleep(0.1)
                continue
            if reqid_override is not None:
                reqid = reqid_override
            else:
                self._internal_tid += 1
                # nonce'd per incarnation like client reqids: a restarted
                # OSD's counter resets, and a stale reqid colliding with
                # the target's dup detection would silently skip the op
                reqid = (f"osd.{self.osd_id}.int#{self.boot_instance}",
                         self._internal_tid)
            msg = M.MOSDOp(reqid=reqid, pgid=pgid, oid=oid, ops=ops,
                           epoch=m.epoch, snapc=snapc, snapid=snapid,
                           deadline=wall_deadline)
            if primary == self.osd_id and not self._mclock_dispatch:
                # self-targeted: dispatch DIRECTLY instead of messaging
                # ourselves — a nested internal op would share the outer
                # op's self-connection, whose read loop is blocked in the
                # outer dispatch (same-conn serialization deadlock when
                # e.g. the base and cache primaries coincide).  Under
                # mclock (queued dispatch) the read loop never blocks, so
                # normal self-messaging is both safe and required (the
                # loopback would return before the queued op runs).
                replies: List = []

                class _LoopConn:
                    peer = self.messenger.name
                    peer_caps = None

                    async def send(self, reply):
                        replies.append(reply)

                msg.src = self.messenger.name
                # dispatch inline (NOT via _handle_client_op, which
                # detaches execution as a task and would return before
                # any reply lands in `replies`): the loopback caller is
                # an ordinary task, never the messenger read loop, so
                # executing here cannot head-of-line block a connection
                await self._serve_queued_op(_LoopConn(), msg)
                reply = next((r for r in reversed(replies)
                              if isinstance(r, M.MOSDOpReply)), None)
                if reply is None:
                    raise IOError(f"internal loopback op on {oid}: "
                                  "no reply")
                if reply.result == -11:
                    if asyncio.get_event_loop().time() > deadline:
                        raise IOError(
                            f"internal op to {pool_id}:{oid} kept "
                            "misdirecting past the deadline")
                    await asyncio.sleep(0.1)
                    continue
                return reply
            fut = asyncio.get_event_loop().create_future()
            self._internal_inflight[reqid] = fut
            try:
                await self.messenger.send_message(msg, tuple(addr))
                reply = await asyncio.wait_for(
                    fut, timeout=max(0.1, deadline -
                                     asyncio.get_event_loop().time()))
                if reply.result == -11:  # misdirected: map moved, retry
                    if asyncio.get_event_loop().time() > deadline:
                        raise IOError(
                            f"internal op to {pool_id}:{oid} kept "
                            "misdirecting past the deadline")
                    await asyncio.sleep(0.1)
                    continue
                if getattr(reply, "throttled", False):
                    # admission pushback / QoS eviction: back off and
                    # retry until our own deadline
                    if asyncio.get_event_loop().time() > deadline:
                        raise IOError(
                            f"internal op to {pool_id}:{oid} throttled "
                            "past the deadline")
                    await asyncio.sleep(pushback.next())
                    continue
                return reply
            except asyncio.TimeoutError:
                raise IOError(f"internal op to {pool_id}:{oid} timed out")
            finally:
                self._internal_inflight.pop(reqid, None)

    def clog(self, prio: str, text: str) -> None:
        """Fire-and-forget cluster-log event to the mon (reference clog /
        MLog; the mon's log service Paxos-replicates it)."""
        import time as _time

        entry = (f"osd.{self.osd_id}", _time.time(), prio, text)

        async def _send():
            try:
                await self._mon_send(M.MLog(entries=(entry,)))
            except Exception:
                # fire-and-forget by contract, but observable: a clog
                # line lost to transport is counted, never silent
                self.perf.inc("osd_clog_send_errors")

        try:
            self._track(asyncio.get_event_loop().create_task(_send()))
        except RuntimeError:
            pass  # no running loop (teardown)


    # ------------------------------------------------------------- dispatch

    async def ms_dispatch(self, conn: Connection, msg) -> bool:
        if self._stopped:
            # a stopped (or chaos-crashed) daemon serves nothing: its
            # store is frozen, so handling a frame here could neither
            # apply nor ack — exactly a dead process on the wire
            return True
        try:
            return await self._dispatch(conn, msg)
        except Exception as e:
            # store-capacity ENOSPC on a CLIENT op surfaces as the
            # real -28 (the backstop beneath the mon's full flag), not
            # a bare EIO.  On sub-op paths (replica/shard applies) the
            # exception propagates like any replica failure — no reply,
            # the primary stays un-acked and peering owns the divergent
            # entry — so only the delivered client reject counts as one
            enospc = isinstance(msg, M.MOSDOp) and \
                isinstance(e, OSError) and getattr(e, "errno", 0) == 28
            self.perf.inc("osd_full_rejects" if enospc
                          else "osd_dispatch_errors")
            if isinstance(msg, M.MOSDOp):
                await conn.send(M.MOSDOpReply(
                    reqid=msg.reqid, result=-28 if enospc else -5,
                    data=repr(e)))
                return True
            raise

    async def _dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, M.MOSDMapMsg):
            await self._handle_map(msg)
            return True
        if isinstance(msg, M.MOSDOpReply):
            # reply to one of OUR internal client ops (copy-from /
            # tier traffic): resolve the waiter
            fut = self._internal_inflight.pop(tuple(msg.reqid), None)
            if fut is not None and not fut.done():
                fut.set_result(msg)
            return True
        if isinstance(msg, M.MOSDIncMapMsg):
            await self._handle_inc_map(msg)
            return True
        if isinstance(msg, M.MOSDOp):
            await self._handle_client_op(conn, msg)
            return True
        if isinstance(msg, M.MOSDOpBatch):
            await self._handle_client_op_batch(conn, msg)
            return True
        if isinstance(msg, M.MOSDRepOp):
            if self._sub_op_expired(msg):
                # parent op's client deadline passed: the primary's
                # waiter is (or will be) gone — applying + replying is
                # dead work.  No reply: the primary times out -110 and
                # the op stays un-acked, so durability is never claimed
                # for a stripe some member shed.
                return True
            # replica-side span: joins the primary's op tree via the
            # sub-op trace header (absent/None when untraced)
            tr = getattr(msg, "trace", None)
            span = self.tracer.start(
                "rep_op", trace_id=tr.get("id"),
                parent_id=tr.get("span")) if tr else None
            try:
                txn = Transaction.decode(msg.txn_blob)
                self.store.queue_transaction(txn)
                st = self.pgs.get(msg.pgid)
                if st is not None and msg.entry is not None:
                    self._log_mutation(st, msg.entry.op, msg.entry.oid,
                                       msg.entry.version, entry=msg.entry)
                self.perf.inc("osd_rep_ops")
                await self._reply_osd(conn, msg, M.MOSDRepOpReply(
                    reqid=msg.reqid, result=0))
            finally:
                # the failed/retried replica legs are exactly the spans
                # the assembled tree must not lose
                if span is not None:
                    span.finish()
            return True
        if isinstance(msg, M.MOSDRepOpReply) or \
                isinstance(msg, M.MOSDECSubOpWriteReply):
            self._ack(msg.reqid, msg.result, msg)
            return True
        if isinstance(msg, M.MOSDECSubOpWrite):
            await self._handle_ec_write(conn, msg)
            return True
        if isinstance(msg, M.MOSDECSubOpWriteBatch):
            await self._handle_ec_write_batch(conn, msg)
            return True
        if isinstance(msg, M.MOSDECSubOpWriteBatchReply):
            # scatter the batched acks to each op's waiter; the shim
            # carries src+shard so the per-responder ack dedup holds
            from types import SimpleNamespace

            for reqid, result, shard in msg.results:
                self._ack(reqid, result,
                          SimpleNamespace(src=msg.src, shard=shard))
            return True
        if isinstance(msg, M.MOSDECSubOpRead):
            await self._handle_ec_read(conn, msg)
            return True
        if isinstance(msg, M.MOSDECSubOpReadReply):
            self._ack(msg.reqid, msg.result, msg)
            return True
        if isinstance(msg, M.MOSDScrub):
            await self._reply_osd(conn, msg, M.MOSDScrubMap(
                reqid=msg.reqid, pgid=msg.pgid,
                objects=self._build_scrub_map(msg.pgid)))
            return True
        if isinstance(msg, M.MOSDScrubMap):
            self._ack(msg.reqid, 0, msg)
            return True
        if isinstance(msg, M.MOSDPGPush):
            self._handle_push(msg)
            await self._reply_osd(conn, msg, M.MOSDPGPushReply(
                pgid=msg.pgid, oid=msg.oid, result=0))
            return True
        if isinstance(msg, M.MOSDPGPushReply):
            return True
        if isinstance(msg, MOSDPGQuery):
            objects = {
                oid: self.store.get_version(_coll(msg.pgid), oid)
                for oid in self._list_pg_objects(msg.pgid)
            }
            st = self.pgs.get(msg.pgid)
            if st is not None and msg.interval > st.peer_interval:
                st.peer_interval = msg.interval
            await self._reply_osd(conn, msg, MOSDPGQueryReply(
                pgid=msg.pgid, objects=objects,
                info=st.info() if st else None,
                log=st.log if st else None))
            return True
        if isinstance(msg, MOSDPGQueryReply):
            self._ack(("pgq", str(msg.pgid), msg.src.num), 0, msg)
            return True
        if isinstance(msg, M.MCommand):
            await self._handle_admin_command(conn, msg)
            return True
        if isinstance(msg, M.MPing):
            if msg.reply:
                if msg.src is not None:
                    self._hb_last[msg.src.num] = self.clock.monotonic()
            else:
                await conn.send(M.MPing(stamp=msg.stamp, reply=True))
            return True
        return False

    def _scrub_stats(self) -> Tuple[int, int]:
        """(unrepaired inconsistent objects, PGs holding any) across
        this OSD's primary PGs — the beacon feed for the mon's
        PG_INCONSISTENT / OSD_SCRUB_ERRORS health checks (raised while
        nonzero, cleared by the next clean beacon, like SLOW_OPS)."""
        objs = pgs = 0
        for st in self.pgs.values():
            if st.primary == self.osd_id and st.inconsistent:
                pgs += 1
                objs += len(st.inconsistent)
        return (objs, pgs)

    def _sub_op_expired(self, msg) -> bool:
        """Dead-work shedding on the replica/shard side: a sub-op whose
        inherited client deadline passed is dropped at dispatch (counted;
        None deadline — recovery traffic — always executes).  Reads the
        daemon's skewable clock, so chaos clock-skew scenarios exercise
        the cross-daemon wall-clock protocol this design rides on."""
        dl = getattr(msg, "deadline", None)
        if dl is None or self.clock.time() <= dl:
            return False
        self.perf.inc("osd_sub_ops_shed_expired")
        return True

    def _ack_wait_timeout(self) -> float:
        """Sub-op ack wait budget: the usual op timeout, clamped to the
        current client op's remaining deadline — replicas SHED expired
        sub-ops without replying, so waiting past the deadline would
        pin the primary (and its ordered FIFO) on work nobody awaits."""
        from ceph_tpu_torch.cluster.pg import CURRENT_OP_DEADLINE

        t = self.config.osd_client_op_timeout
        dl = CURRENT_OP_DEADLINE.get()
        if dl is not None:
            t = min(t, max(0.05, dl - self.clock.time()))
        return t

    async def _yield_under_pressure(self) -> None:
        """Background work (recovery rounds, scrub passes) yields while
        client admission pressure is high — the QoS demotion the
        reference gets from mclock op classes.  No-op with budgets off."""
        budget = self.config.osd_op_throttle_ops
        if not budget:
            return
        yielded = False
        for _ in range(100):
            if self._stopped or \
                    self._admit_ops < max(1, (3 * budget) // 4):
                break
            if not yielded:
                yielded = True
                self.perf.inc("osd_recovery_yields")
            await asyncio.sleep(0.05)

    def _declare_perf_schema(self) -> None:
        """Typed schemas + histograms for the op path (reference
        OSD::create_logger, src/osd/osd_perf_counters.cc)."""
        from ceph_tpu_torch.utils import perf as perfmod

        self.perf.add_u64("osd_client_ops", prio=perfmod.PRIO_CRITICAL,
                          desc="client ops served")
        self.perf.add_u64("osd_rep_ops", desc="replica sub-ops applied")
        self.perf.add_u64("osd_ec_sub_writes",
                          desc="EC shard sub-writes applied")
        self.perf.add_u64("osd_ec_sub_reads",
                          desc="EC shard sub-reads served")
        self.perf.add_time("osd_op_lat", prio=perfmod.PRIO_CRITICAL,
                           desc="client op latency (arrival to reply)")
        # microsecond-bucketed latency + byte-bucketed payload size
        # (reference perf histogram axes on osd_op_*_latency)
        self.perf.add_histogram(
            "osd_op_lat_hist", scale=1e6, unit=perfmod.UNIT_SECONDS,
            prio=perfmod.PRIO_INTERESTING,
            desc="client op latency, log2 microsecond buckets")
        self.perf.add_histogram(
            "osd_op_in_bytes_hist", unit=perfmod.UNIT_BYTES,
            prio=perfmod.PRIO_INTERESTING,
            desc="mutation payload size, log2 byte buckets")
        self.perf.add_u64(
            "osd_dispatch_queue_depth", prio=perfmod.PRIO_INTERESTING,
            desc="client ops waiting in the ordered dispatch queues")
        # overload/degradation telemetry: admission budgets,
        # deadline shedding, QoS conformance, hedged EC reads — all ride
        # the existing perf/Prometheus export
        self.perf.add_u64("osd_throttle_rejects",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="client ops pushed back THROTTLED at "
                               "admission (budget full)")
        self.perf.add_u64("osd_ops_shed_expired",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="client ops dropped at dequeue past "
                               "their deadline (dead work)")
        self.perf.add_u64("osd_sub_ops_shed_expired",
                          desc="replica/shard sub-ops dropped past the "
                               "inherited parent deadline")
        self.perf.add_u64("osd_qos_preempted",
                          desc="queued background-class ops evicted to "
                               "admit client ops under pressure")
        self.perf.add_u64("osd_qos_served_reservation",
                          desc="dmclock dequeues served by reservation "
                               "tag (conformance)")
        self.perf.add_u64("osd_qos_served_spare",
                          desc="dmclock dequeues served from spare "
                               "capacity by weight tag")
        self.perf.add_u64("osd_qos_evicted",
                          desc="queued requests shed by dmclock "
                               "eviction (raw queue stat, "
                               "mirrored to the perf/Prometheus path "
                               "so the graft-load SLO judge sees it "
                               "on the scrape)")
        self.perf.add_u64("osd_admit_ops_in_use",
                          desc="admission op budget currently in use")
        self.perf.add_u64("osd_admit_bytes_in_use",
                          unit=perfmod.UNIT_BYTES,
                          desc="admission byte budget currently in use")
        self.perf.add_u64("osd_ec_hedged_reads",
                          desc="EC gathers that hedged straggler "
                               "sub-reads after the quantile delay")
        self.perf.add_u64("osd_ec_hedge_promotions",
                          desc="EC gathers that promoted a spare shard "
                               "after a failed sub-read send")
        self.perf.add_u64("osd_ec_fastk_reads",
                          desc="EC reads that resolved from the first "
                               "k clean shards")
        self.perf.add_u64("osd_recovery_yields",
                          desc="background recovery/scrub rounds "
                               "delayed under client admission pressure")
        # batched data plane: coalesced dispatch telemetry —
        # coalesced_ops / ticks is the realized batch factor
        self.perf.add_u64("osd_batch_ticks",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="coalesced EC encode ticks dispatched")
        self.perf.add_u64("osd_batch_coalesced_ops",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="EC writes encoded through coalesced "
                               "ticks (ops/ticks = batch factor)")
        self.perf.add_u64("osd_subwrite_batches",
                          desc="multi-item sub-write frames sent "
                               "(per peer per tick)")
        self.perf.add_u64("osd_subwrite_batched_items",
                          desc="shard sub-writes that rode a "
                               "multi-item frame")
        # client-edge batching: MOSDOpBatch ingest +
        # MOSDOpReplyBatch egress — items/frames is the realized client
        # batch factor, the edge twin of osd_batch_coalesced_ops
        self.perf.add_u64("osd_client_batch_frames",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="MOSDOpBatch frames received from "
                               "client tick coalescers")
        self.perf.add_u64("osd_client_batch_items",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="client ops that arrived inside an "
                               "MOSDOpBatch frame (items/frames = "
                               "client batch factor)")
        self.perf.add_u64("osd_client_batch_item_errors",
                          desc="batch items that failed dispatch and "
                               "were answered per item (-5/-28); their "
                               "tick-mates were unaffected")
        self.perf.add_u64("osd_client_batch_reply_frames",
                          desc="MOSDOpReplyBatch frames sent (one per "
                               "reply tick per client conn)")
        self.perf.add_u64("osd_client_batch_reply_items",
                          desc="client acks that rode a batched reply "
                               "frame")
        self.perf.add_u64("osd_client_batch_reply_drops",
                          desc="batched reply items lost to a dead "
                               "client conn (clients resend on "
                               "timeout)")
        # crash-safe batched plane: frontier recovery +
        # batched-ack dedup telemetry
        self.perf.add_u64("osd_frontier_rebuilt",
                          desc="open commit-frontier entries "
                               "reconstructed from the pg log at boot "
                               "(resolved by peering roll-forward or "
                               "rewind)")
        self.perf.add_u64("osd_dup_acks_ignored",
                          desc="duplicate sub-op acks absorbed by the "
                               "per-responder dedup (session replay, "
                               "chaos dup/batch-ack faults)")
        self.perf.add_u64("osd_rmw_pipelined",
                          desc="EC RMW writes committed through the "
                               "pipelined frontier path (PG lock held "
                               "only for the commit section)")
        self.perf.add_u64("osd_rep_pipelined",
                          desc="replicated-pool mutations committed "
                               "through the pipelined frontier path")
        self.perf.add_u64("osd_ec_undersized_blocks",
                          desc="EC writes/roll-forwards refused because "
                               "the live acting set was below the "
                               "pool's min_size floor (acked-but-"
                               "unreconstructable guard)")
        # control plane at scale: vectorized epoch deltas +
        # peering storm control, all on the perf/Prometheus path so the
        # graft-load SLO judge can gate on them from the mgr scrape
        self.perf.add_u64("osd_map_epochs_applied",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="osdmap epochs applied (incremental and "
                               "full) — the churn keep-up signal")
        self.perf.add_u64("osd_map_affected_pgs",
                          desc="PGs the vectorized epoch delta selected "
                               "(placement actually moved this epoch)")
        self.perf.add_u64("osd_pgs_repeered",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="primary PGs queued for peering by map "
                               "advances (per-epoch re-peer fan-out)")
        self.perf.add_u64("osd_map_skip_to_full",
                          desc="incremental chains abandoned for a "
                               "full-map request (chain longer than "
                               "osd_map_max_inc_chain under churn)")
        self.perf.add_u64("osd_peering_rounds",
                          desc="peering rounds started")
        self.perf.add_u64("osd_peering_throttled",
                          desc="peering rounds that waited on the "
                               "per-OSD concurrency throttle "
                               "(osd_peering_max_concurrent)")
        # verified reads + self-healing + cluster-full: all
        # on the perf/Prometheus path so the graft-load SLO judge can
        # gate on their presence from the mgr scrape
        self.perf.add_u64("osd_read_batch_ticks",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="coalesced read-side ticks dispatched "
                               "(decode / recovery reencode / crc "
                               "verification batches)")
        self.perf.add_u64("osd_read_batch_coalesced",
                          desc="requests that rode a coalesced "
                               "read-side tick")
        self.perf.add_u64("osd_read_shard_crc_errors",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="shard crc mismatches caught by "
                               "verify-on-read before the bytes could "
                               "feed a decode")
        self.perf.add_u64("osd_read_shard_errors",
                          desc="shard media errors (EIO) surfaced to a "
                               "read gather")
        self.perf.add_u64("osd_read_repairs",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="objects rebuilt in place by automatic "
                               "read-repair (crc/EIO/stale shard "
                               "detected during a gather)")
        self.perf.add_u64("osd_read_repair_errors",
                          desc="read-repair attempts that failed "
                               "(object stays inconsistent; scrub "
                               "retries)")
        self.perf.add_u64("osd_scrub_errors_repaired",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="scrub-detected inconsistencies "
                               "repaired (crc rot + stale "
                               "generations)")
        self.perf.add_u64("osd_scrubs_scheduled",
                          desc="background scrubs started by the "
                               "seeded per-PG jittered scheduler")
        self.perf.add_u64("osd_full_rejects",
                          prio=perfmod.PRIO_INTERESTING,
                          desc="client writes rejected ENOSPC while "
                               "the OSDMap carried the full flag "
                               "(deletes stay admitted)")
        self.perf.add_u64("osd_backfill_blocked_full",
                          desc="backfill data movement deferred while "
                               "the map carried the backfillfull flag")
        self.perf.add_histogram(
            "osd_peering_lat_hist", scale=1e6, unit=perfmod.UNIT_SECONDS,
            prio=perfmod.PRIO_INTERESTING,
            desc="peering round duration, log2 microsecond buckets")

    def _build_admin_socket(self):
        """Register this daemon's command table (reference OSD::asok_
        command registration, src/osd/OSD.cc admin_socket hooks)."""
        from ceph_tpu_torch.utils import AdminSocket

        asok = AdminSocket()
        asok.register_common(self.perfcoll, self.config,
                             flight=self.flight)

        def _inject(cmd):
            args = cmd.get("args", {})
            self.config.injectargs(args)
            self.perf.inc("osd_injectargs")
            if self.flight and any(k.startswith("chaos_") for k in args):
                self.flight.record("chaos", args=dict(args))
            # complaint-time/history knobs apply to the live tracker
            self.tracker.slow_threshold = \
                self.config.osd_op_complaint_time
            self.tracker.resize(
                history_size=self.config.osd_op_history_size,
                slow_size=self.config.osd_op_history_slow_op_size)

        asok.register("injectargs", _inject, "runtime config mutation")
        asok.register("dump_ops_in_flight",
                      lambda cmd: self.tracker.dump_ops_in_flight(),
                      "ops currently being served")
        asok.register("dump_historic_ops",
                      lambda cmd: self.tracker.dump_historic_ops(),
                      "recently completed ops with event timelines")
        asok.register("dump_historic_slow_ops",
                      lambda cmd: self.tracker.dump_historic_slow_ops(),
                      "slowest completed ops past the complaint time")

        def _attribution(cmd):
            from ceph_tpu_torch.trace.attribution import aggregate_tracker

            a = {**cmd, **cmd.get("args", {})}
            return aggregate_tracker(
                self.tracker, match=a.get("match"),
                measured_wall_s=a.get("measured_wall_s"))

        asok.register("dump_op_attribution", _attribution,
                      "per-stage wall-time breakdown over completed ops "
                      "(args: match=<desc substring>, measured_wall_s)")

        def _trace_dump(cmd):
            a = {**cmd, **cmd.get("args", {})}
            tid = a.get("trace_id")
            if tid is not None:
                return self.tracer.dump_trace(tid)
            return self.tracer.dump_recent(int(a.get("n", 20)))

        asok.register("trace dump", _trace_dump,
                      "completed graft-trace spans (args: trace_id | n)")

        def _dmclock(cmd):
            if self._opq is not None:
                return {"enabled": True, **self._opq.dump()}
            if self._shardedq is not None and self._shardedq.use_mclock:
                return {"enabled": True, **self._shardedq.dump()}
            return {"enabled": False}

        asok.register("dump_dmclock", _dmclock,
                      "dmclock conformance counters + per-client queue "
                      "depths (QoS shedding telemetry)")

        async def _scrub(cmd):
            reports = {}
            for pgid, st in list(self.pgs.items()):
                if st.primary == self.osd_id:
                    reports[str(pgid)] = await self.scrub_pg(st)
            return reports

        asok.register("scrub", _scrub, "scrub every primary PG")

        def _list_inconsistent(cmd):
            # reference 'rados list-inconsistent-obj' analog: objects a
            # scrub or verifying read flagged and repair has not healed
            a = {**cmd, **cmd.get("args", {})}
            want = a.get("pgid")
            out = {}
            for pgid, st in list(self.pgs.items()):
                if st.primary != self.osd_id:
                    continue
                if want is not None and str(pgid) != str(want):
                    continue
                if st.inconsistent or want is not None:
                    out[str(pgid)] = sorted(st.inconsistent)
            return out

        asok.register("list-inconsistent", _list_inconsistent,
                      "unrepaired inconsistent objects per primary PG "
                      "(args: pgid)")

        async def _repair(cmd):
            # 'ceph pg repair' analog: a scrub pass repairs as it goes
            a = {**cmd, **cmd.get("args", {})}
            want = a.get("pgid")
            reports = {}
            for pgid, st in list(self.pgs.items()):
                if st.primary != self.osd_id:
                    continue
                if want is not None and str(pgid) != str(want):
                    continue
                reports[str(pgid)] = await self.scrub_pg(st)
            return reports

        asok.register("repair", _repair,
                      "scrub-and-repair primary PGs (args: pgid)")
        return asok

    async def _handle_admin_command(self, conn: Connection,
                                    msg: M.MCommand) -> None:
        """Admin-socket surface (reference AdminSocket commands: perf
        dump, dump_historic_ops, config show, injectargs, scrub),
        routed through the per-daemon command table."""
        result, data = await self.asok.dispatch(msg.cmd)
        if msg.tid or msg.cmd.get("prefix") != "injectargs":
            try:
                await conn.send(M.MCommandReply(
                    tid=msg.tid, result=result, data=data))
            except (ConnectionError, OSError):
                pass

    # -------------------------------------------------------------- helpers

    async def _compute(self, fn, *args):
        """Run codec compute (encode/decode, possibly a first-call kernel
        build) off the event loop, in an executor thread whose current
        CUDA device is this OSD's.  Blocking the loop here starves
        heartbeat replies and triggers false failure reports — the reference
        isolates heartbeats on dedicated messengers for the same reason
        (src/ceph_osd.cc:459-486 creates 4 hb messengers)."""
        return await asyncio.get_event_loop().run_in_executor(
            None, run_on, self.device, fn, *args)

    def _ack(self, key, result, payload=None) -> None:
        entry = self._pending.get(tuple(key) if isinstance(key, tuple) else key)
        if entry is None:
            return
        fut, acc = entry
        src = getattr(payload, "src", None)
        if src is not None:
            # lossless-session replay and chaos net dup can deliver the
            # same reply twice: one responder contributes ONE ack, or a
            # duplicated sub-write ack would satisfy the durability
            # threshold in place of a shard that never committed
            sk = (src.type, src.num, getattr(payload, "shard", None))
            seen = getattr(fut, "ackers", None)
            if seen is None:
                seen = set()
                fut.ackers = seen  # type: ignore[attr-defined]
            if sk in seen:
                # counted so batch-chaos runs can PROVE the dedup path
                # absorbed their injected duplicate acks
                self.perf.inc("osd_dup_acks_ignored")
                return
            seen.add(sk)
        acc.append((result, payload))
        if fut.done():
            return
        # early-resolve hook (degraded EC reads): a waiter may install
        # ``check(acc) -> bool`` to resolve as soon as the accumulated
        # replies SUFFICE (e.g. k same-generation shards), without
        # waiting for every contacted responder
        chk = getattr(fut, "check", None)
        if chk is not None and chk(acc):
            fut.set_result(acc)
            return
        if len(acc) >= fut.needed:  # type: ignore[attr-defined]
            fut.set_result(acc)

    def _make_waiter(self, key, needed: int) -> asyncio.Future:
        fut = asyncio.get_event_loop().create_future()
        fut.needed = needed  # type: ignore[attr-defined]
        self._pending[key] = (fut, [])
        return fut

    def _waiter_dec(self, key) -> None:
        """A planned responder became unreachable: lower the threshold AND
        re-check completion — acks that already arrived must be able to
        satisfy the waiter, or a durably-committed op reports failure."""
        entry = self._pending.get(key)
        if entry is None:
            return
        fut, acc = entry
        fut.needed -= 1  # type: ignore[attr-defined]
        if len(acc) >= fut.needed and not fut.done():  # type: ignore[attr-defined]
            fut.set_result(acc)

    async def _send_osd(self, osd: int, msg) -> None:
        addr = self.osdmap.osd_addrs.get(osd)
        if addr is None:
            raise ConnectionError(f"no address for osd.{osd}")
        await self.messenger.send_message(msg, addr)

    async def _reply_osd(self, conn: Connection, msg, reply) -> None:
        """Ack an osd peer over the LOSSLESS session instead of the raw
        accepted connection: a sub-op ack lost to a connection reset
        must be replayed, or the primary stalls its full op timeout on a
        write that IS durable everywhere (the reference's osd-osd policy
        is lossless in both directions for the same reason; surfaced by
        chaos net injection).  Falls back to the raw conn when the peer
        isn't in our map yet."""
        src = msg.src
        if src is not None and src.type == "osd" and \
                self.osdmap is not None:
            addr = self.osdmap.osd_addrs.get(src.num)
            if addr is not None:
                try:
                    await self.messenger.send_message(reply, tuple(addr))
                    return
                except (ConnectionError, OSError, RuntimeError):
                    pass
        await conn.send(reply)

    # ------------------------------------------------------------ map flow

    async def _handle_inc_map(self, msg: M.MOSDIncMapMsg) -> None:
        """Apply a delta chain (reference handle_osd_map incremental path).
        On an epoch gap, re-subscribe from our epoch to resync; a chain
        past osd_map_max_inc_chain skips to a full-map request instead
        of unpickling an unbounded churn burst on the dispatch loop."""
        m = self.osdmap
        if m is None or msg.prev_epoch != m.epoch:
            if m is not None and msg.epoch <= m.epoch:
                return  # stale or duplicate
            await self._mon_send(
                M.MMonSubscribe(what="osdmap", addr=self.messenger.my_addr,
                                since=m.epoch if m else 0))
            return
        if len(msg.inc_blobs) > self.config.osd_map_max_inc_chain:
            self.perf.inc("osd_map_skip_to_full")
            await self._mon_send(
                M.MMonSubscribe(what="osdmap",
                                addr=self.messenger.my_addr, since=0))
            return
        for blob in msg.inc_blobs:
            m.apply_incremental(pickle.loads(blob))
        if msg.inc_blobs:
            self.perf.inc("osd_map_epochs_applied", len(msg.inc_blobs))
        self.perf.set("osd_map_epoch", m.epoch)
        if self.flight:
            self.flight.record("map", epoch=m.epoch,
                               incs=len(msg.inc_blobs))
        await self._post_map_update()

    async def _handle_map(self, msg: M.MOSDMapMsg) -> None:
        newmap: OSDMap = pickle.loads(msg.osdmap_blob).set_device(
            self.device, self.placements)
        old = self.osdmap
        if old is not None and newmap.epoch < old.epoch:
            return  # stale full map
        self.osdmap = newmap
        self.perf.inc("osd_map_epochs_applied",
                      max(1, newmap.epoch - old.epoch) if old is not None
                      else 1)
        self.perf.set("osd_map_epoch", newmap.epoch)
        if self.flight:
            self.flight.record("map", epoch=newmap.epoch, full=True)
        await self._post_map_update()

    async def _post_map_update(self) -> None:
        newmap = self.osdmap
        self._save_superblock()
        if not self._stopped and self.osd_id < newmap.max_osd and \
                not newmap.osd_up[self.osd_id]:
            # the map says we are down but we are alive: re-boot (reference
            # OSD::start_boot after _committed_osd_maps notices the same)
            self.perf.inc("osd_re_boots")
            await self._mon_send(M.MOSDBoot(osd_id=self.osd_id,
                                            addr=self.messenger.my_addr,
                                            instance=self.boot_instance))
        if self._up_epoch is None and self.osd_id < newmap.max_osd and \
                newmap.osd_up[self.osd_id] and \
                newmap.osd_addrs.get(self.osd_id) == \
                tuple(self.messenger.my_addr or ()):
            # going down and up is an interval change for every PG this
            # daemon holds, whatever acting sets the maps it skipped had
            self._up_epoch = newmap.epoch
            for st in self.pgs.values():
                st.interval_epoch = max(st.interval_epoch, newmap.epoch)
        changed = self._advance_pgs()
        if changed and not self._stopped:
            if self.flight:
                self.flight.record("peering", epoch=newmap.epoch)
            self._kick_peering()
        if not self._stopped and any(
                set(newmap.pools[st.pgid.pool].removed_snaps)
                - self._purged_snaps.get(st.pgid, set())
                for st in self.pgs.values()
                if st.pgid.pool in newmap.pools
                and newmap.pools[st.pgid.pool].removed_snaps):
            self._track(asyncio.get_event_loop().create_task(
                self._snap_trim_all()))

    async def _snap_trim_all(self) -> None:
        """Snap trimming (reference PrimaryLogPG::SnapTrimmer): for every
        primary PG whose pool has removed snaps, drop them from object
        snapsets and delete fully-trimmed clone objects.  Idempotent —
        re-running over an already-trimmed snapset is a no-op — and
        _purged_snaps (the reference purged_snaps analog, in-memory) keeps
        later map epochs from rescanning stores for long-gone snaps."""
        from ceph_tpu_torch.cluster import snaps as snapmod

        purged_now: Dict[object, set] = {}
        for st in list(self.pgs.values()):
            if self._stopped or st.primary != self.osd_id:
                continue
            pool = self.osdmap.pools.get(st.pgid.pool)
            if pool is None or not pool.removed_snaps:
                continue
            removed = set(pool.removed_snaps)
            if removed <= self._purged_snaps.get(st.pgid, set()):
                continue
            purged_now.setdefault(st.pgid, set()).update(removed)
            coll = _coll(st.pgid)
            for name in self.store.list_objects(coll):
                if not name.endswith(snapmod._SNAPDIR):
                    continue
                async with st.lock:
                    ops = snapmod.trim_ops(self.store, coll, name, removed)
                    if not ops:
                        continue
                    txn = Transaction()
                    txn.ops.extend(ops)
                    version = self._next_version(st)
                    await self._replicate_txn(
                        st, txn, "trim", snapmod.head_of(name), version)
                    self.perf.inc("osd_snaps_trimmed")
        if not self._stopped:
            for pgid, snaps in purged_now.items():
                self._purged_snaps.setdefault(pgid, set()).update(snaps)

    def _advance_pgs(self) -> bool:
        """``_advance_pgs_once``, timed: ``map_advance_seconds`` sums the
        host time this daemon's map advances took (the whole-pool
        placements on its device included), ``map_advances`` counts
        them."""
        t0 = time.perf_counter()
        try:
            return self._advance_pgs_once()
        finally:
            self.map_advance_seconds += time.perf_counter() - t0
            self.map_advances += 1

    def _advance_pgs_once(self) -> bool:
        """Recompute PG membership and queue peering for the PGs an
        epoch actually moved; returns True when peering has work.

        with osd_map_vectorized_delta (default) each pool's
        resolved placement is snapshotted after every advance and
        DIFFED against the previous one (osdmap.placement_delta) — one
        batched dispatch plus whole-pool array compares per epoch, zero
        per-PG Python for unaffected PGs, and only primaries whose
        up/acting moved re-peer.  With it off, every PG rescans and any
        change re-peers every primary PG — the per-PG-scan bit-exactness
        anchor (the per-PG-scan behavior).  PG log/last_update are
        preserved across map changes (and reloaded from the pgmeta
        object when the collection already exists on store — the
        load_pgs resume path, reference OSD.cc:2572)."""
        from ceph_tpu_torch.osdmap.osdmap import placement_delta, \
            placement_snapshot

        m = self.osdmap
        use_vec = bool(self.config.osd_map_vectorized_delta)
        if not use_vec:
            # a stale cache from a past vectorized phase must not feed
            # diffs after the option is toggled back on
            self._placement_cache.clear()
        changed = False
        to_peer: Set[PGid] = set()
        batch_min = self.config.osd_map_batch_min_pgs
        # pg_num growth: split local PGs whose persisted split watermark
        # trails the pool's pg_num, BEFORE recomputing membership, so
        # child PGStates load the split-out meta/objects (reference
        # PG::split_colls on map advance).  The watermark rides the
        # PGMETA object, so an OSD that was down across the bump splits
        # on resume.  Skipped per pool when the cached snapshot proves
        # pg_num did not move.
        for pool_id, pool in m.pools.items():
            if pool.is_erasure():
                continue
            cached = self._placement_cache.get(pool_id)
            if cached is not None and cached.pg_num == pool.pg_num:
                continue
            for pgid, st in list(self.pgs.items()):
                if pgid.pool == pool_id and self._maybe_split(pool, st):
                    changed = True
        for pool_id, pool in m.pools.items():
            old_snap = self._placement_cache.get(pool_id)
            snap = placement_snapshot(m, pool_id, batch_min)
            if use_vec:
                self._placement_cache[pool_id] = snap
            seeds = None
            if old_snap is not None:
                seeds = placement_delta(old_snap, snap)
                if seeds is not None:
                    self.perf.inc("osd_map_affected_pgs", len(seeds))
            it = range(pool.pg_num) if seeds is None else sorted(seeds)
            for seed in it:
                pgid = PGid(pool_id, seed)
                up, upp, acting, actp = snap.resolve(seed)
                up, acting = list(up), list(acting)
                mine = self.osd_id in [o for o in acting
                                       if o != CRUSH_ITEM_NONE]
                old = self.pgs.get(pgid)
                if mine:
                    if old is None:
                        changed = True
                        self.store.queue_transaction(
                            Transaction().create_collection(_coll(pgid)))
                        st = PGState(pgid, up, acting, actp,
                                     interval_epoch=m.epoch)
                        # resumed parent collections split BEFORE their
                        # children (lower seeds iterate first) load meta
                        if not pool.is_erasure():
                            self._maybe_split(pool, st)
                        st.last_update, st.log = self._load_pg_meta(pgid)
                        st.last_complete = self._load_last_complete(pgid)
                        # logged entries above the persisted
                        # watermark are OPEN frontier entries — their
                        # acks died with the previous process life, so
                        # last_complete must not bless them until
                        # peering rules on each (roll forward / rewind)
                        self._frontier_rebuild(st)
                        self.pgs[pgid] = st
                        if racecheck.TRACKER:  # graft-race: registry
                            # entry REPLACED — in-flight ack waits
                            # holding the old PGState are now stale
                            racecheck.TRACKER.note_write(
                                ("pgs", self.osd_id, str(pgid)),
                                "registry")
                        if actp == self.osd_id:
                            to_peer.add(pgid)
                    else:
                        # up-only changes re-peer too: a
                        # drain with a minted pg_temp leaves acting
                        # untouched while up moves to the incoming set —
                        # the primary must notice, backfill the up
                        # members, and request the temp clear, and
                        # nothing but this diff tells it to.
                        if old.acting != acting or old.up != up or (
                                old.primary != actp
                                and actp == self.osd_id):
                            changed = True
                            if actp == self.osd_id:
                                to_peer.add(pgid)
                        if old.acting != acting or old.primary != actp:
                            old.interval_epoch = m.epoch
                        old.up, old.acting, old.primary = up, acting, actp
                elif old is not None:
                    del self.pgs[pgid]
                    self._unclean_pgs.discard(pgid)
                    changed = True
                    if racecheck.TRACKER:  # graft-race: the PG left
                        # this OSD — snapshots of its state went stale
                        racecheck.TRACKER.note_write(
                            ("pgs", self.osd_id, str(pgid)), "registry")
        # pools deleted from the map: drop their PGs AND their data
        # (reference: pool deletion queues PG removal + collection nuke).
        # Sweep by STORE collection, not just live PGState — collections
        # from past intervals must die too.
        for pgid in [p for p in self.pgs if p.pool not in m.pools]:
            del self.pgs[pgid]
            self._unclean_pgs.discard(pgid)
            changed = True
        for pool_id in [p for p in self._placement_cache
                        if p not in m.pools]:
            del self._placement_cache[pool_id]
        for coll in self.store.list_collections():
            if not coll.startswith("pg_"):
                continue
            try:
                pool_id = int(coll.split("_")[1])
            except (IndexError, ValueError):
                continue
            if pool_id not in m.pools:
                self.store.queue_transaction(
                    Transaction().remove_collection(coll))
                self.perf.inc("osd_pgs_removed")
        # a crash-restarted primary whose acting set came back
        # IDENTICAL still owes peering a round — its reconstructed open
        # frontier entries resolve only by verified presence/rewind, and
        # nothing else would ever trigger it
        for st in self.pgs.values():
            if st.frontier_recovering and st.primary == self.osd_id:
                to_peer.add(st.pgid)
        if not use_vec and (changed or to_peer):
            # anchor mode: any change re-peers every primary PG (the
            # per-PG stampede, kept for bisection)
            to_peer.update(pgid for pgid, st in self.pgs.items()
                           if st.primary == self.osd_id)
        if to_peer:
            self.perf.inc("osd_pgs_repeered", len(to_peer))
            self._peering_pending.update(to_peer)
            self._unclean_pgs.update(to_peer)
        return bool(to_peer)

    # ------------------------------------------------------------ heartbeat

    async def _heartbeat_loop(self) -> None:
        while not self._stopped:
            await asyncio.sleep(self.config.osd_heartbeat_interval)
            m = self.osdmap
            if m is None:
                continue
            # the chaos-skewable per-daemon clock: a skewed OSD judges
            # peer heartbeat staleness from ITS OWN view of time
            now = self.clock.monotonic()
            # beacon to the mon (reference MOSDBeacon): lets the mon mark
            # us down even when no peer reporters survive; never let a
            # transport hiccup kill the heartbeat task.  The beacon also
            # carries blocked-op telemetry: the mon raises/clears the
            # SLOW_OPS health warning from this stream, so clearance on
            # drain needs no extra message.
            slow_n, slow_oldest = self.tracker.slow_in_flight()
            if slow_n and slow_n != self._slow_warned:
                self.clog("WRN", f"{slow_n} slow ops, oldest age "
                                 f"{slow_oldest:.2f}s "
                                 f"(complaint time "
                                 f"{self.tracker.slow_threshold}s)")
            elif not slow_n and self._slow_warned:
                self.clog("INF", "slow ops cleared")
            self._slow_warned = slow_n
            if self.flight:
                # queue/admission/slow-op sample each beacon window, a
                # LOOP_LAG spike event when the window crossed the
                # warning bound, and scrub detections when any fired
                self.flight.record(
                    "queue", depth=self._queued_depth,
                    admit_ops=self._admit_ops,
                    admit_bytes=self._admit_bytes, slow=slow_n)
                lag = self.loopmon.lag_report()
                if lag is not None and \
                        lag[1] >= self.config.loop_lag_warn > 0:
                    self.flight.record("loop_lag",
                                       window_max=round(lag[1], 6))
                bad_objs, bad_pgs = self._scrub_stats()
                if bad_objs:
                    self.flight.record("scrub", inconsistent=bad_objs,
                                       pgs=bad_pgs)
            try:
                # only PGs we still PRIMARY count as unclean — a PG
                # that moved away (or whose primaryship did) is the new
                # primary's to report; keeping it here pins the mon's
                # PG_RECOVERING check on an OSD that will never run the
                # recovery that clears it
                self._unclean_pgs = {
                    p for p in self._unclean_pgs
                    if p in self.pgs
                    and self.pgs[p].primary == self.osd_id}
                await self._mon_send(M.MOSDAlive(
                    osd_id=self.osd_id, statfs=self.store.statfs(),
                    slow_ops=(slow_n, slow_oldest),
                    loop_lag=self.loopmon.lag_report(),
                    scrub_stats=self._scrub_stats(),
                    unclean_pgs=len(self._unclean_pgs),
                    map_epoch=m.epoch))
                # the beacon delivered this window's max: start the next
                # window, so a drained stall clears LOOP_LAG like a
                # drained op queue clears SLOW_OPS
                self.loopmon.reset_window()
            except Exception:
                # the heartbeat loop must survive any transport hiccup,
                # but a dropped beacon is counted, never silent
                self.perf.inc("osd_beacon_send_errors")
            # perf-counter stream to the active mgr (MgrClient::send_report)
            mgr_addr = getattr(m, "mgr_addr", None)
            if mgr_addr:
                try:
                    counters = dict(
                        self.perf.dump()[f"osd.{self.osd_id}"])
                    # load observation for graft-balance: statfs + this
                    # OSD's per-pool PRIMARY object counts ride the
                    # report (primaries only, so summing across daemons
                    # counts each object once — the autoscaler's and
                    # balancer's byte/object feed)
                    total_b, used_b = self.store.statfs()
                    counters["osd_stat_bytes_total"] = total_b
                    counters["osd_stat_bytes_used"] = used_b
                    for pgid, st in self.pgs.items():
                        if st.primary != self.osd_id:
                            continue
                        key = f"osd_pool_{pgid.pool}_objects"
                        n = sum(1 for o in self.store.list_objects(
                            _coll(pgid)) if o != PGMETA)
                        counters[key] = counters.get(key, 0) + n
                    await self.messenger.send_message(M.MMgrReport(
                        daemon=f"osd.{self.osd_id}",
                        counters=counters, stamp=now), tuple(mgr_addr))
                except (ConnectionError, OSError, RuntimeError):
                    pass
            for osd, addr in list(m.osd_addrs.items()):
                if osd == self.osd_id:
                    continue
                if not m.osd_up[osd]:
                    # a down peer leaves the heartbeat set, whoever
                    # reported it: the stamp of its last reply would
                    # otherwise outlive it and accuse its next life the
                    # moment it is up (reference heartbeat_peers is
                    # rebuilt from each map)
                    self._hb_last.pop(osd, None)
                    self._hb_addr.pop(osd, None)
                    continue
                if self._hb_addr.get(osd) != tuple(addr):
                    # a peer new to the set, or a new life at another
                    # address: tracked afresh from now
                    self._hb_addr[osd] = tuple(addr)
                    self._hb_last[osd] = now
                    self._reported.discard(osd)
                try:
                    await self.messenger.send_message(
                        M.MPing(stamp=now), addr)
                except (ConnectionError, OSError):
                    pass
                last = self._hb_last.get(osd, now)
                if now - last > self.config.osd_heartbeat_grace and \
                        osd not in self._reported:
                    self._reported.add(osd)
                    if await self._mon_send(M.MOSDFailure(
                            failed_osd=osd, reporter=self.osd_id)):
                        self.perf.inc("osd_failure_reports")
            # once the monitor marks a reported peer down, forget it so a
            # future reboot is tracked afresh
            for osd in list(self._reported):
                if not m.osd_up[osd]:
                    self._reported.discard(osd)
                    self._hb_last.pop(osd, None)

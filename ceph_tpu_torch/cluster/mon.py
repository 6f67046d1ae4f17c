"""Monitor: the cluster-map authority (single mon or Paxos quorum).

Counterpart of ``ceph_tpu/cluster/mon.py``.

Mirrors the reference monitor's OSD-map service (src/mon/OSDMonitor.cc):
boot/failure handling with reporter thresholds (can_mark_down,
OSDMonitor.cc:1761), beacon-staleness + down-out ticks, map-epoch
broadcast to subscribers (MonClient subscription model,
src/mon/MonClient.cc:354), and pool-create commands that build CRUSH
rules through the EC-profile seam (ErasureCode::create_rule analog).

Multi-mon mode replicates every map delta through the Paxos machinery in
cluster/paxos.py (reference src/mon/Paxos.cc + Elector.cc): the elected
leader proposes, peons accept/commit and forward client commands to the
leader, leases detect leader death, and any quorum member serves map
subscriptions from its replicated state.

The port's monitor keeps its placement work on a device: ``device``
(CUDA unless the caller names the CPU) is set on every map it takes in,
whether from its caller, its store, a peer's full-map push or a commit,
so a map never carries its sender's device into this daemon.  The
pg_temp mint at commit time reads whole pools through
``OSDMap.pool_raw_up`` (one batched placement per pool on the old map
and one on the new) and runs in an executor thread, off the event loop
that serves elections and leases.
"""

from __future__ import annotations

import asyncio
import copy
import pickle
import time
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from ceph_tpu_torch.cluster import messages as M
from ceph_tpu_torch.cluster.messenger import Addr, Connection, Dispatcher, EntityName, Messenger
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_TAKE,
    Rule,
)
from ceph_tpu_torch.osdmap.osdmap import (
    Incremental,
    OSDMap,
    PGid,
    PGPool,
    POOL_TYPE_ERASURE,
    POOL_TYPE_REPLICATED,
)
from ceph_tpu_torch.utils import Config, DepLock, PerfCounters
from ceph_tpu_torch.utils.device import resolve_device_index, run_on


class Monitor(Dispatcher):
    def __init__(self, osdmap: OSDMap, config: Optional[Config] = None,
                 rank: int = 0, n_mons: int = 1, store=None, device=None,
                 placements=None):
        """``store``: an ObjectStore backing the MonitorDBStore analog
        (reference src/mon/MonitorDBStore.h: mon state as a kv database);
        committed map state persists and start() resumes from it.
        ``device``: where this monitor's placement work runs (CUDA unless
        the caller names the CPU; raises without a card).
        ``placements``: a raw-placement cache this monitor's maps share
        with the other daemons of an in-process cluster
        (``vstart.PlacementCache``), or None."""
        self.device = resolve_device_index(device)
        self.placements = placements
        self.rank = rank
        self.n_mons = n_mons
        self.store = store
        self.db = None
        # per-daemon config copy: injectargs on one daemon must never
        # leak into another (each reference daemon owns its md_config_t)
        self.config = Config(**config.show()) if config else Config()
        self.osdmap = osdmap.set_device(self.device, placements)
        self.messenger = Messenger(
            EntityName("mon", rank),
            secret=self.config.auth_secret(),
            auth=self.config.cephx_context(f"mon.{rank}"),
            config=self.config)
        self.messenger.add_dispatcher(self)
        # cephx ticket service (reference CephxServiceHandler): clients
        # prove their entity key, the mon issues time-limited tickets;
        # revoked entities are refused renewal
        self._revoked_entities: Set[str] = set()
        if self.messenger.auth is not None:
            self.messenger.auth_server = self._handle_auth_request
        self.subscribers: Set[Addr] = set()
        # subscriber bind-addr -> the connection its subscribe rode in on
        self._sub_conns: Dict[Tuple, Connection] = {}
        # per-subscriber map-push state (backpressure): pushes
        # are serialized per subscriber by ONE pusher task each, and a
        # churn burst coalesces into "send (last, current]" instead of
        # queuing one delta message per epoch behind a slow peer
        self._push_state: Dict[Tuple, Dict] = {}
        # self-discarding background tasks (map pushers, failure flush)
        self._mon_tasks: Set[asyncio.Task] = set()
        self.failure_reports: Dict[int, Set[int]] = {}
        # markdowns past the reporter threshold awaiting the coalesce
        # window: N simultaneous failures -> ONE epoch
        self._pending_failed: Set[int] = set()
        self._failure_flush_task: Optional[asyncio.Task] = None
        self.down_since: Dict[int, float] = {}
        # last beacon per osd (reference MOSDBeacon/last_osd_report): lets
        # the tick mark OSDs down even when no reporters remain (e.g. the
        # whole cluster stopped at once)
        self.last_beacon: Dict[int, float] = {}
        # per-osd (total, used) bytes from beacons ('ceph df' feed)
        self.osd_statfs: Dict[int, Tuple[int, int]] = {}
        # per-osd blocked-op telemetry from beacons: feeds the SLOW_OPS
        # health warning and clears as soon as beacons report drain
        self.osd_slow_ops: Dict[int, Tuple[int, float]] = {}
        # per-osd event-loop lag from beacons (graft-trace loop
        # profiler): feeds the LOOP_LAG health warning the same way
        self.osd_loop_lag: Dict[int, Tuple[float, float]] = {}
        # per-osd (unrepaired inconsistent objects, pgs) from beacons
        # feeds PG_INCONSISTENT / OSD_SCRUB_ERRORS, raised
        # while any primary holds unrepaired damage, cleared by the
        # next clean beacon — the SLOW_OPS raise/clear shape
        self.osd_scrub_stats: Dict[int, Tuple[int, int]] = {}
        # per-osd (unclean primary pgs, beacon map epoch) — the
        # PG_RECOVERING feed: a PG is unclean while its primary still
        # owes it a peering/backfill round, and a beacon OLDER than the
        # last placement-changing epoch cannot yet vouch for that
        # epoch's reshuffle (pessimistic-until-reported, the misplaced-
        # ratio gate the balancer/reshaper throttle on)
        self.osd_unclean: Dict[int, Tuple[int, int]] = {}
        self._placement_epoch = 0
        self.perf = PerfCounters("mon")
        # erasure profile -> k, for the pg_temp mint (_ec_data_chunks)
        self._ec_k: Dict[Tuple, int] = {}
        # chaos-skewable per-daemon time source: lease staleness, beacon
        # grace, and the down-out tick all judge from THIS clock, so a
        # skewed monitor really does fire early elections / false downs
        from ceph_tpu_torch.chaos.clock import ChaosClock

        self.clock = ChaosClock.from_config(self.config)
        # graft-blackbox: flight ring + the bounded health-transition
        # history (the postmortem timeline's health spine) — raise and
        # clear records diffed from _health_data() each tick
        from collections import deque as _deque

        from ceph_tpu_torch.trace import FlightRecorder

        self.flight = FlightRecorder.from_config(
            f"mon.{rank}", self.config, clock=self.clock)
        self.health_history: _deque = _deque(
            maxlen=max(1, int(getattr(self.config,
                                      "mon_health_history", 128))))
        self._last_health_checks: Dict[str, str] = {}
        self._last_health_status = "HEALTH_OK"
        # vstart arms this: fired once per edge INTO HEALTH_ERR with the
        # active checks (the postmortem trigger seam)
        self._blackbox_health_cb = None
        self.asok = self._build_admin_socket()
        self._tick_task: Optional[asyncio.Task] = None
        self._log: List[Tuple[str, object]] = []  # committed proposal log
        # cluster log (reference LogMonitor, src/mon/LogMonitor.h:39): a
        # Paxos-replicated event log every quorum member applies in order;
        # daemons feed it with MLog, the mon's own state changes append
        # directly, and 'log last' reads it back
        self.cluster_log: List[Tuple[str, float, str, str]] = []
        self._pending_clog: List[Tuple[str, float, str, str]] = []
        self.CLUSTER_LOG_MAX = 10_000
        # recent incrementals by resulting epoch (reference: mon keeps a
        # window of full+inc maps; subscribers behind the window get a full
        # map).  Size mirrors osd_map_cache_size.
        self._inc_log: Dict[int, Incremental] = {}
        # -- quorum state (multi-mon) --
        self.mon_addrs: List[Addr] = []
        self.elector = None
        self.paxos = None
        self.is_leader = n_mons == 1
        self.leader_rank: Optional[int] = 0 if n_mons == 1 else None
        self._map_mutex = DepLock("mon.map_mutex")
        self._lease_task: Optional[asyncio.Task] = None
        self._last_lease = 0.0
        self._fwd: Dict[int, Tuple[Connection, int]] = {}
        self._fwd_tid = 0
        self._boot_instances: Dict[int, int] = {}
        self.stopped = False

    async def start(self, host: str = "127.0.0.1", port: int = 0) -> Addr:
        if self.store is not None:
            from ceph_tpu_torch.cluster.kv import StoreDB

            self.store.mount()
            self.db = StoreDB(self.store)
            blob = self.db.get("osdmap", "latest")
            if blob is not None:
                # resume the committed map (MonitorDBStore refresh)
                self.osdmap = pickle.loads(blob).set_device(
                    self.device, self.placements)
                self.perf.inc("mon_store_resumes")
            clog_blob = self.db.get("clog", "recent")
            if clog_blob is not None:
                self.cluster_log = pickle.loads(clog_blob)
        addr = await self.messenger.bind(host, port)
        if self.n_mons == 1:
            self._tick_task = asyncio.get_event_loop().create_task(
                self._tick())
        return addr

    def set_monmap(self, addrs: List[Addr]) -> None:
        """Install the monmap + consensus machinery (multi-mon vstart
        calls this once every monitor is bound)."""
        from ceph_tpu_torch.cluster.paxos import Elector, Paxos

        self.mon_addrs = [tuple(a) for a in addrs]
        self.is_leader = False
        self.leader_rank = None
        self.elector = Elector(
            self.rank, self.n_mons, self._send_mon, self._on_elected,
            timeout=self.config.mon_election_timeout,
            state_version=lambda: self.paxos.last_committed
            if self.paxos else 0)
        self.paxos = Paxos(
            self.rank, self.n_mons, self._send_mon, self._apply_committed,
            timeout=self.config.mon_paxos_timeout)

    async def begin_elections(self) -> None:
        if self.elector:
            await self.elector.start_election()

    async def stop(self) -> None:
        self.is_leader = False
        self.stopped = True
        if self.elector:
            self.elector.stop()
        if self.paxos:
            self.paxos.step_down()
        for t in (self._tick_task, self._lease_task,
                  self._failure_flush_task):
            if t:
                t.cancel()
        for t in list(self._mon_tasks):
            t.cancel()
        await self.messenger.shutdown()
        # umount LAST: an in-flight commit draining above must still be
        # able to persist its delta
        if self.store is not None:
            self.db = None
            self.store.umount()

    def _health_data(self) -> Dict:
        """Reference health checks (OSD_DOWN, OSD_OUT, OSD_FULL,
        SLOW_OPS): the SLOW_OPS warning is fed by the OSD beacon stream
        and clears on drain exactly like the reference's
        'N slow ops, oldest one blocked for X sec' check
        (OSDMap::check_health SLOW_OPS)."""
        m = self.osdmap
        checks = {}
        down = [o for o in range(m.max_osd)
                if m.osd_exists[o] and not m.osd_up[o]]
        out = [o for o in range(m.max_osd)
               if m.osd_exists[o] and m.osd_weight[o] == 0]
        if down:
            checks["OSD_DOWN"] = f"{len(down)} osds down: {down}"
        if out:
            checks["OSD_OUT"] = f"{len(out)} osds out: {out}"
        # utilization tiers against the configured mon_osd_*full_ratio
        # thresholds: nearfull warns, backfillfull blocks
        # backfill, full rejects client writes (HEALTH_ERR).  ONE
        # classifier serves this and the flag-commit tick, so health
        # reporting can never desynchronize from flag enforcement.
        tiers = self._full_tiers()
        nearfull = tiers["nearfull"]
        backfillfull = tiers["backfillfull"]
        full = tiers["full"]
        if full:
            checks["OSD_FULL"] = (
                f"{len(full)} osd(s) full: {full} — client writes "
                f"rejected ENOSPC until space frees")
        if backfillfull:
            checks["OSD_BACKFILLFULL"] = (
                f"{len(backfillfull)} osd(s) backfillfull: "
                f"{backfillfull}")
        if nearfull:
            checks["OSD_NEARFULL"] = \
                f"{len(nearfull)} osd(s) nearfull: {nearfull}"
        inconsistent = {o: s for o, s in self.osd_scrub_stats.items()
                        if o < m.max_osd and m.osd_up[o]}
        if inconsistent:
            objs = sum(n for n, _ in inconsistent.values())
            pgs = sum(p for _, p in inconsistent.values())
            checks["PG_INCONSISTENT"] = (
                f"{pgs} pg(s) inconsistent, {objs} unrepaired "
                f"object(s) (osds: {sorted(inconsistent)})")
            checks["OSD_SCRUB_ERRORS"] = \
                f"{objs} unrepaired scrub/read errors"
        slow = {o: s for o, s in self.osd_slow_ops.items()
                if o < m.max_osd and m.osd_up[o]}
        if slow:
            total = sum(n for n, _ in slow.values())
            oldest = max(age for _, age in slow.values())
            checks["SLOW_OPS"] = (
                f"{total} slow ops, oldest age {oldest:.2f}s "
                f"(osds: {sorted(slow)})")
        # PG_RECOVERING: data is still chasing placement.
        # Three feeds, all pessimistic: live pg_temp entries (a reshape
        # handoff in flight), any up OSD reporting unclean primary PGs,
        # and any up OSD whose last beacon predates the last placement-
        # changing epoch (it hasn't re-peered that reshuffle yet, so
        # its "clean" claim is stale).  The balancer's require_clean
        # gate and the reshaper's wait-clean both key off this check —
        # it is what stops a round-N+1 upmap or a daemon stop from
        # yanking a member that is still the sole holder of acked bytes.
        if m.pools:
            ups = [o for o in range(m.max_osd)
                   if m.osd_exists[o] and m.osd_up[o]]
            unclean = {o: self.osd_unclean[o][0] for o in ups
                       if self.osd_unclean.get(o, (0, 0))[0] > 0}
            behind = [o for o in ups
                      if self.osd_unclean.get(o, (0, -1))[1]
                      < self._placement_epoch]
            parts = []
            if m.pg_temp:
                parts.append(f"{len(m.pg_temp)} pg(s) on temp acting "
                             f"(reshape handoff)")
            if unclean:
                parts.append(f"{sum(unclean.values())} pg(s) "
                             f"recovering (osds: {sorted(unclean)})")
            if behind:
                parts.append(f"{len(behind)} osd(s) not yet reported "
                             f"since epoch {self._placement_epoch}")
            if parts:
                checks["PG_RECOVERING"] = "; ".join(parts)
        lagged = {o: ll for o, ll in self.osd_loop_lag.items()
                  if o < m.max_osd and m.osd_up[o]}
        if lagged:
            worst = max(mx for _, mx in lagged.values())
            checks["LOOP_LAG"] = (
                f"event-loop lag up to {worst * 1e3:.0f}ms "
                f"(osds: {sorted(lagged)}); something is blocking "
                f"the daemon's asyncio loop")
        status = "HEALTH_OK" if not checks else (
            "HEALTH_ERR" if full or len(down) >= m.max_osd
            else "HEALTH_WARN")
        return {"status": status, "checks": checks}

    def _full_tiers(self) -> Dict[str, List[int]]:
        """Classify every up OSD's beacon utilization into EXCLUSIVE
        tiers against the mon_osd_*full_ratio thresholds — the single
        source both the health checks and the flag-commit tick read,
        so the warning an operator sees and the flag the
        OSDs enforce can never drift apart."""
        m = self.osdmap
        out: Dict[str, List[int]] = {"nearfull": [], "backfillfull": [],
                                     "full": []}
        for o, (tot, used) in sorted(self.osd_statfs.items()):
            if not tot or o >= m.max_osd or not m.osd_up[o]:
                continue
            frac = used / tot
            if frac >= self.config.mon_osd_full_ratio > 0:
                out["full"].append(o)
            elif frac >= self.config.mon_osd_backfillfull_ratio > 0:
                out["backfillfull"].append(o)
            elif frac >= self.config.mon_osd_nearfull_ratio > 0:
                out["nearfull"].append(o)
        return out

    def _note_health(self) -> None:
        """Health-transition bookkeeping, run each tick: diff the live
        checks against the last tick's view and append raise/clear
        records to the bounded history ring (satellite: the postmortem
        timeline's health spine).  An edge INTO HEALTH_ERR fires the
        vstart-armed blackbox callback — the fourth trigger kind."""
        data = self._health_data()
        checks, status = data["checks"], data["status"]
        now = round(self.clock.time(), 6)
        epoch = self.osdmap.epoch
        for name, msg in checks.items():
            if name not in self._last_health_checks:
                sev = "ERR" if name == "OSD_FULL" else "WRN"
                rec = {"check": name, "severity": sev, "op": "raise",
                       "epoch": epoch, "time": now, "detail": msg}
                self.health_history.append(rec)
                if self.flight:
                    self.flight.record("health", **rec)
        for name in self._last_health_checks:
            if name not in checks:
                rec = {"check": name, "severity": "INF", "op": "clear",
                       "epoch": epoch, "time": now, "detail": ""}
                self.health_history.append(rec)
                if self.flight:
                    self.flight.record("health", **rec)
        if status != self._last_health_status:
            self.health_history.append(
                {"check": "STATUS", "severity": status, "op": "status",
                 "epoch": epoch, "time": now,
                 "detail": f"{self._last_health_status} -> {status}"})
            if self.flight:
                self.flight.record("health_status",
                                   prev=self._last_health_status,
                                   status=status, epoch=epoch)
            cb = self._blackbox_health_cb
            if status == "HEALTH_ERR" and cb is not None:
                cb(dict(checks))
        self._last_health_checks = dict(checks)
        self._last_health_status = status

    def _build_admin_socket(self):
        """The mon's 'ceph daemon mon.X' command table (reference
        Monitor::_add_bootstrap_peer_hint et al. asok registration)."""
        from ceph_tpu_torch.utils import AdminSocket

        asok = AdminSocket()
        asok.register_common(self.perf, self.config,
                             flight=self.flight)
        asok.register("health", lambda cmd: self._health_data(),
                      "cluster health status + checks")
        asok.register("health history",
                      lambda cmd: list(self.health_history),
                      "bounded ring of health-transition records "
                      "(check, severity, raise/clear epoch + time)")
        asok.register("quorum_status",
                      lambda cmd: {"rank": self.rank,
                                   "leader": self.leader_rank,
                                   "is_leader": self.is_leader,
                                   "n_mons": self.n_mons},
                      "this monitor's view of the quorum")
        return asok

    @staticmethod
    def _placement_path(m) -> str:
        """'batched' when the map's shape runs on the TensorMapper, else
        'scalar_fallback(<why>)' — the operator-visible answer to "is my
        1M-PG map silently a Python loop?".  Uses the cheap shape probe:
        status must never build device tables inside the mon loop."""
        from ceph_tpu_torch.crush.mapper import TensorMapper

        why = TensorMapper.unsupported_reason(m.crush)
        return "batched" if why is None else f"scalar_fallback({why})"

    # -- cephx ticket service ---------------------------------------------

    def _handle_auth_request(self, msg):
        """Verify the entity-key proof and issue a ticket (reference
        CephxServiceHandler::handle_request)."""
        import hashlib as _hl
        import hmac as _hm

        from ceph_tpu_torch.cluster import auth as authmod
        from ceph_tpu_torch.cluster.messenger import SIG_LEN, _MsgAuthReply

        master = self.config.auth_secret()
        if master is None:
            return _MsgAuthReply(result=-22, error="no cluster key")
        if msg.entity in self.osdmap.revoked_entities or \
                msg.entity in self._revoked_entities:
            self.perf.inc("mon_auth_refused")
            return _MsgAuthReply(result=-13, error="entity revoked")
        ek = authmod.entity_key(master, msg.entity)
        want = _hm.new(ek, b"authreq:" + msg.entity.encode() + msg.nonce,
                       _hl.sha256).digest()[:SIG_LEN]
        if not _hm.compare_digest(want, msg.proof):
            self.perf.inc("mon_auth_refused")
            return _MsgAuthReply(result=-13, error="bad key proof")
        ttl = self.config.auth_ticket_ttl
        blob, sealed, _ = authmod.issue_ticket(
            master, msg.entity, authmod.default_caps_for(msg.entity), ttl)
        self.perf.inc("mon_tickets_issued")
        return _MsgAuthReply(result=0, ticket_blob=blob, sealed_key=sealed,
                             ttl=ttl)

    # -- quorum plumbing ---------------------------------------------------

    async def _send_mon(self, rank: int, msg) -> None:
        await self.messenger.send_message(msg, self.mon_addrs[rank])

    async def _on_elected(self, leader: int, quorum: List[int],
                          epoch: int) -> None:
        self.leader_rank = leader
        was_leader = self.is_leader
        self.is_leader = leader == self.rank
        self.perf.inc("mon_elections_won" if self.is_leader
                      else "mon_elections_lost")
        if self.is_leader:
            await self.paxos.leader_init(quorum)
            if self._tick_task is None or self._tick_task.done():
                self._tick_task = asyncio.get_event_loop().create_task(
                    self._tick())
            if self._lease_task is None or self._lease_task.done():
                self._lease_task = asyncio.get_event_loop().create_task(
                    self._lease_loop())
        else:
            if self.paxos:
                self.paxos.step_down()
            if was_leader and self._tick_task:
                self._tick_task.cancel()
                self._tick_task = None
            self._last_lease = self.clock.monotonic()
            if self._lease_task is None or self._lease_task.done():
                self._lease_task = asyncio.get_event_loop().create_task(
                    self._lease_watch())

    async def _lease_loop(self) -> None:
        """Leader: extend the quorum lease (reference Paxos lease)."""
        while self.is_leader:
            for r in range(self.n_mons):
                if r != self.rank:
                    try:
                        await self._send_mon(r, M.MMonPaxos(
                            op="lease", rank=self.rank,
                            epoch=(self.elector.epoch
                                   if self.elector else 0),
                            last_committed=self.paxos.last_committed))
                    except (ConnectionError, OSError):
                        pass
            await asyncio.sleep(self.config.mon_lease_interval)

    async def _lease_watch(self) -> None:
        """Peon: call an election when the leader's lease goes stale."""
        while not self.is_leader and self.elector is not None:
            await asyncio.sleep(self.config.mon_lease_interval)
            if self.is_leader:
                return
            stale = self.clock.monotonic() - self._last_lease
            if stale > self.config.mon_lease_ack_timeout:
                self.perf.inc("mon_lease_timeouts")
                await self.elector.start_election()
                self._last_lease = self.clock.monotonic()

    async def _apply_committed(self, version: int, value: bytes) -> None:
        """Paxos apply callback: every quorum member applies committed
        map deltas in order (the PaxosService refresh).  Restart skew is
        tolerated: deltas already covered by a store-resumed map are
        skipped, and a map GAP (this mon's persisted map older than the
        quorum's) triggers a full-map sync from the leader instead of
        wedging on apply_incremental's contiguity check."""
        inc = pickle.loads(value)
        if inc.epoch <= self.osdmap.epoch:
            return  # resumed store already contains this delta
        if inc.epoch > self.osdmap.epoch + 1:
            await self._request_map_sync()
            return
        await self._apply_inc_local(inc)

    async def _request_map_sync(self) -> None:
        """Ask the leader's map service for our missing epochs (mon-to-mon
        subscription; the reply lands in ms_dispatch below)."""
        if self.leader_rank is None or self.leader_rank == self.rank:
            return
        try:
            await self._send_mon(self.leader_rank, M.MMonSubscribe(
                what="osdmap", addr=self.messenger.my_addr,
                since=self.osdmap.epoch))
        except (ConnectionError, OSError):
            pass

    # -- proposal/commit ---------------------------------------------------

    def _propose(self, what: str, payload) -> None:
        self._log.append((what, payload))
        self.perf.inc("mon_proposals")

    def clog(self, prio: str, msg: str) -> None:
        """Buffer a cluster-log event from this mon (leader side); the
        tick flushes the buffer through a Paxos round."""
        self._pending_clog.append(
            (f"mon.{self.rank}", time.time(), prio, msg))

    def _pool_by_name(self, name):
        return next((p for p, po in self.osdmap.pools.items()
                     if po.name == name or p == name), None)

    async def _handle_tier_command(self, prefix: str, cmd):
        """Cache-tier admin (reference OSDMonitor 'osd tier *' handlers):
        add/remove a cache pool over a base, set the cache mode, and
        point the base's overlay (read/write redirect) at the cache."""
        import dataclasses as _dc

        # snapshot + inc construction INSIDE the map mutex like every
        # other mutation path: two concurrent tier commands must never
        # commit deltas derived from the same stale pool state
        async with self._map_mutex:
            base_id = self._pool_by_name(cmd.get("pool"))
            if base_id is None:
                return -2, f"pool {cmd.get('pool')!r} not found"
            base = self.osdmap.pools[base_id]
            inc = None
            if prefix == "osd tier add":
                tid = self._pool_by_name(cmd.get("tierpool"))
                if tid is None:
                    return -2, f"pool {cmd.get('tierpool')!r} not found"
                if tid == base_id:
                    return -22, "a pool cannot be its own tier"
                tier = self.osdmap.pools[tid]
                if tier.is_tier():
                    return -22, f"{tier.name} is already a tier"
                if tier.tiers or base.is_tier():
                    return -22, "tier chains are not allowed"
                inc = self._new_inc()
                inc.new_pools[base_id] = _dc.replace(
                    base, tiers=tuple(base.tiers) + (tid,))
                inc.new_pools[tid] = _dc.replace(tier, tier_of=base_id)
            elif prefix == "osd tier remove":
                tid = self._pool_by_name(cmd.get("tierpool"))
                if tid is None or tid not in base.tiers:
                    return -2, "no such tier"
                if base.read_tier == tid or base.write_tier == tid:
                    return -16, ("tier is an active overlay; "
                                 "remove-overlay first")
                tier = self.osdmap.pools[tid]
                inc = self._new_inc()
                inc.new_pools[base_id] = _dc.replace(
                    base, tiers=tuple(t for t in base.tiers if t != tid))
                inc.new_pools[tid] = _dc.replace(tier, tier_of=-1,
                                                 cache_mode="none")
            elif prefix == "osd tier cache-mode":
                # here 'pool' names the CACHE pool
                mode = cmd.get("mode")
                if mode not in ("none", "writeback", "readproxy",
                                "forward"):
                    return -22, f"invalid cache mode {mode!r}"
                if not base.is_tier():
                    return -22, f"{base.name} is not a tier"
                inc = self._new_inc()
                inc.new_pools[base_id] = _dc.replace(base,
                                                     cache_mode=mode)
            elif prefix == "osd tier set-overlay":
                tid = self._pool_by_name(cmd.get("overlaypool"))
                if tid is None or tid not in base.tiers:
                    return -2, "overlay pool is not a tier of this pool"
                inc = self._new_inc()
                inc.new_pools[base_id] = _dc.replace(
                    base, read_tier=tid, write_tier=tid)
            elif prefix == "osd tier remove-overlay":
                inc = self._new_inc()
                inc.new_pools[base_id] = _dc.replace(
                    base, read_tier=-1, write_tier=-1)
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        self.clog("INF", f"tier command '{prefix}' on pool "
                         f"'{base.name}' applied")
        return 0, None

    async def _pool_set_pgnum(self, pid: int, var: str, val):
        """'osd pool set pg_num/pgp_num' (reference OSDMonitor pg_num
        checks + PG splitting on the OSDs).  pg_num may only GROW, and
        pgp_num stays put until set separately, so freshly-split children
        place with their parents (osd_types pps folding) and migrate on
        the later pgp_num bump — the reference's split-then-move design."""
        import dataclasses as _dc

        po = self.osdmap.pools[pid]
        try:
            ival = int(val)
        except (TypeError, ValueError):
            return -22, f"invalid {var}={val!r}"
        if var == "pg_num":
            if po.is_erasure():
                return -95, "pg_num change on erasure pools not supported"
            if ival <= po.pg_num:
                return -22, (f"pg_num {ival} must exceed current "
                             f"{po.pg_num} (merging unsupported)")
            new_pool = _dc.replace(po, pg_num=ival)
        else:
            if not (1 <= ival <= po.pg_num):
                return -22, f"need 1 <= pgp_num <= pg_num ({po.pg_num})"
            new_pool = _dc.replace(po, pgp_num=ival)
        async with self._map_mutex:
            inc = self._new_inc()
            inc.new_pools[pid] = new_pool
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        return 0, ival

    def _new_inc(self) -> Incremental:
        return Incremental(epoch=self.osdmap.epoch + 1)

    async def _commit_inc(self, inc: Incremental) -> bool:
        """Commit a map delta: direct in single-mon mode, through a Paxos
        round (begin/accept/commit on the quorum) otherwise.  The mint
        runs in an executor thread (its device calls and deep copies
        would otherwise hold the loop past the election timeout); the
        caller's ``_map_mutex`` keeps the map still meanwhile."""
        await self._off_loop(self._mint_pg_temp, inc)
        if self.paxos is None:
            await self._apply_inc_local(inc)
            return True
        return await self.paxos.propose(pickle.dumps(inc))

    async def _off_loop(self, fn, *args):
        """``fn(*args)`` in an executor thread on this monitor's device:
        the device work of a commit (the mint, an EC pool's codec) would
        otherwise hold the loop that serves elections and leases."""
        return await asyncio.get_running_loop().run_in_executor(
            None, run_on, self.device, fn, *args)

    def _mint_pg_temp(self, inc: Incremental) -> None:
        """Conservative temp mappings for wholesale remaps.

        The reference's primaries request pg_temp themselves when they
        discover a backfill interval; here the leader derives the same
        entries AT COMMIT TIME, before the delta ships: any PG whose
        new up set shares NO member with its current acting set would
        strand its only copies on daemons the new map no longer names —
        an elastic drain (weight->0) or a big upmap batch can replace a
        whole acting set in one epoch.  Such PGs keep serving from the
        old holders (pg_temp = old acting) until the acting primary
        backfills the up members and requests the clear (MOSDPGTemp
        with empty osds).  Minted entries ride IN the same Incremental,
        so every quorum member and subscriber applies one atomic view.

        An erasure PG is minted when the remap leaves fewer than k
        surviving old holders in their own slots (``_ec_handoff_mask``),
        which includes a wholesale remap.

        Also sweeps the opposite edge: a temp entry whose members were
        ALL purged from the map pins the PG to ids that can never come
        back — clear it and let acting fall back to up.  Down-but-
        existing members are NOT grounds to sweep: down is transient
        (a beacon blip marks every OSD down at once), and a swept
        handoff strands the data when the donors return.

        Whole pools at a time: for each pool of both maps, one
        ``pool_raw_up`` on the old map and one on the new, numpy masks
        for the seeds that cannot mint (an explicit request, an armed
        handoff, an empty new set, a surviving donor) and Python only
        for the seeds that do.  A pool the old map lacks has no donors,
        and seeds past the old pg_num have none either.  Entries and
        counters equal the per-PG ``pg_raw_up`` loop's with the erasure
        rule above in it."""
        placement = (inc.new_up or inc.new_weights or inc.new_pools
                     or inc.new_pg_upmap_items or inc.new_crush_hosts
                     or inc.old_osds or inc.new_primary_affinity)
        if not placement and not inc.new_down:
            return
        old = self.osdmap
        new = copy.deepcopy(old).set_device(self.device, self.placements)
        new.apply_incremental(copy.deepcopy(inc))
        # DOWN-BLIND on both sides: the mint reasons about data LOCATION,
        # and a beacon blip marking an OSD down does not move its bytes
        live = np.asarray(new.osd_exists, dtype=bool)

        def survives(ids: np.ndarray) -> np.ndarray:
            ok = (ids >= 0) & (ids < new.max_osd)
            return ok & live[np.where(ok, ids, 0)] if new.max_osd else ok

        if placement:
            for pid, pool in new.pools.items():
                if pid not in old.pools:
                    continue
                n = min(pool.pg_num, old.pools[pid].pg_num)
                old_raw, old_len, _ = old._pool_raw(pid)
                new_raw, new_len, _ = new._pool_raw(pid)
                old_raw, new_raw = old_raw[:n], new_raw[:n]
                donor = survives(old_raw)
                cols = np.arange(new_raw.shape[1])
                nonempty = ((new_raw >= 0)
                            & (cols[None, :] < new_len[:n, None])).any(axis=1)
                if pool.can_shift_osds():
                    shared = (donor[:, :, None] & (
                        old_raw[:, :, None] == new_raw[:, None, :])).any(
                            axis=(1, 2))
                    mint = nonempty & donor.any(axis=1) & ~shared
                else:
                    mint = self._ec_handoff_mask(pool, donor, old_raw,
                                                 new_raw, nonempty)
                # an explicit request wins, and an armed handoff (a live
                # member in the old entry) is never re-derived: a mid-
                # blip re-mint would compute its donors from a DEGRADED
                # acting view and overwrite the real data-bearers
                for pg in inc.new_pg_temp:
                    if pg.pool == pid and pg.seed < n:
                        mint[pg.seed] = False
                for pg, cur in old.pg_temp.items():
                    if pg.pool == pid and pg.seed < n and any(
                            survives(np.asarray(cur, dtype=np.int64))):
                        mint[pg.seed] = False
                for seed in np.nonzero(mint)[0].tolist():
                    old_list = old_raw[seed, : old_len[seed]].tolist()
                    keep = survives(np.asarray(old_list, dtype=np.int64))
                    donors = [o for o, k in zip(old_list, keep) if k]
                    if pool.can_shift_osds():
                        # replicated: acting = donors FIRST (the primary
                        # stays data-bearing) + the incoming up members,
                        # so every write acked during the handoff
                        # replicates to them too
                        entry = donors + [
                            o for o in new_raw[seed, : new_len[seed]].tolist()
                            if o >= 0 and o not in donors]
                    else:
                        # erasure: acting positions are shard slots —
                        # donors only, in place, keep the data reachable
                        entry = [o if k else CRUSH_ITEM_NONE
                                 for o, k in zip(old_list, keep)]
                    inc.new_pg_temp[PGid(pid, seed)] = entry
                    self.perf.inc("mon_pg_temp_minted")
        for pgid, temp in new.pg_temp.items():
            if pgid in inc.new_pg_temp:
                continue
            if not any(o < new.max_osd and new.osd_exists[o]
                       for o in temp if o >= 0):
                inc.new_pg_temp[pgid] = []
                self.perf.inc("mon_pg_temp_swept")

    def _ec_handoff_mask(self, pool, donor, old_raw, new_raw, nonempty):
        """The seeds of an erasure pool to mint: those whose remap leaves
        fewer than k (the profile's data chunks, whatever ``min_size``
        says) surviving old holders in their own slots while others
        survive.  That holds for a wholesale remap (no old holder in the
        new set, none in place) and for an indep retry that moves several
        slots for one out OSD: the new acting set cannot decode the
        PG's objects though it shares members, and recovery gathers from
        acting only, so the old holders stay acting until the new
        members are backfilled.  A deliberate difference from ceph_tpu's
        mint, which needs a wholesale remap; the tests that hold the mint
        to the reference replace this by the wholesale rule."""
        w = min(old_raw.shape[1], new_raw.shape[1])
        in_place = (donor[:, :w] & (
            old_raw[:, :w] == new_raw[:, :w])).sum(axis=1)
        return nonempty & (in_place < self._ec_data_chunks(pool)) & (
            donor.sum(axis=1) > in_place)

    def _ec_data_chunks(self, pool) -> int:
        """k of an erasure pool, from its codec (a profile may leave k to
        the plugin's default), once per profile."""
        key = tuple(sorted(pool.ec_profile.items()))
        k = self._ec_k.get(key)
        if k is None:
            from ceph_tpu_torch.ec import factory

            profile = dict(pool.ec_profile) or {
                "plugin": "jerasure", "technique": "reed_sol_van",
                "k": "2", "m": "1"}
            k = factory(profile, device=self.device).get_data_chunk_count()
            self._ec_k[key] = k
        return k

    async def _apply_inc_local(self, inc: Incremental) -> None:
        """Apply a delta to the replicated map, log it, broadcast it."""
        self.osdmap.apply_incremental(inc)
        if (inc.new_up or inc.new_down or inc.new_weights or inc.new_pools
                or inc.new_pg_temp or getattr(inc, "new_pg_upmap_items", None)
                or getattr(inc, "new_crush_hosts", None)
                or getattr(inc, "old_osds", None)
                or getattr(inc, "new_max_osd", 0)
                or inc.new_primary_affinity):
            # any epoch that can move a PG re-arms the PG_RECOVERING
            # pessimism: beacons older than this can't vouch for it
            self._placement_epoch = self.osdmap.epoch
        # cluster-log events ride the delta stream: every quorum member
        # appends the same entries in the same order (LogMonitor refresh)
        new_clog = getattr(inc, "new_log_entries", ())
        if new_clog:
            self.cluster_log.extend(tuple(e) for e in new_clog)
            del self.cluster_log[:-self.CLUSTER_LOG_MAX]
            self.perf.inc("mon_clog_entries", len(new_clog))
        self._inc_log[inc.epoch] = inc
        cutoff = inc.epoch - self.config.osd_map_cache_size
        for e in [e for e in self._inc_log if e <= cutoff]:
            del self._inc_log[e]
        self.perf.inc("mon_map_epochs")
        if self.db is not None:
            from ceph_tpu_torch.cluster.kv import KVTransaction

            txn = (KVTransaction()
                   .set("osdmap", f"inc_{inc.epoch:010d}", pickle.dumps(inc))
                   .set("osdmap", "latest", pickle.dumps(self.osdmap)))
            # trim the persisted inc window like the in-memory one
            txn.rmkey("osdmap", f"inc_{cutoff:010d}")
            if new_clog:
                txn.set("clog", "recent",
                        pickle.dumps(self.cluster_log[-1000:]))
            self.db.submit_transaction(txn)
        await self._broadcast_map()

    async def _persist_latest(self) -> None:
        if self.db is not None:
            from ceph_tpu_torch.cluster.kv import KVTransaction

            self.db.submit_transaction(KVTransaction().set(
                "osdmap", "latest", pickle.dumps(self.osdmap)))

    # -- dispatch ----------------------------------------------------------

    async def ms_dispatch(self, conn: Connection, msg) -> bool:
        if isinstance(msg, M.MMonElection):
            if self.elector:
                await self.elector.handle(msg)
            return True
        if isinstance(msg, M.MMonPaxos):
            if msg.op == "lease":
                # fence stale ex-leaders: a lease from an older election
                # epoch must not refresh the timeout or flip forwarding
                # (reference Paxos::handle_lease epoch check)
                if self.elector is not None and msg.epoch < self.elector.epoch:
                    return True
                self._last_lease = self.clock.monotonic()
                self.leader_rank = msg.rank
            elif self.paxos:
                await self.paxos.handle(msg)
            return True
        if isinstance(msg, M.MLog):
            if not self.is_leader:
                if self.leader_rank is not None and \
                        self.leader_rank != self.rank:
                    try:
                        await self._send_mon(self.leader_rank, msg)
                    except (ConnectionError, OSError):
                        pass
                return True
            self._pending_clog.extend(tuple(e) for e in msg.entries)
            return True
        if isinstance(msg, (M.MOSDBoot, M.MOSDFailure, M.MOSDAlive,
                            M.MOSDPGTemp)):
            if not self.is_leader:
                # peon: relay to the leader (reference forward_request)
                if self.leader_rank is not None and \
                        self.leader_rank != self.rank:
                    try:
                        await self._send_mon(self.leader_rank, msg)
                    except (ConnectionError, OSError):
                        pass
                return True
            if isinstance(msg, M.MOSDBoot):
                await self._handle_boot(msg)
            elif isinstance(msg, M.MOSDFailure):
                await self._handle_failure(msg)
            elif isinstance(msg, M.MOSDPGTemp):
                await self._handle_pg_temp(msg)
            elif 0 <= msg.osd_id < self.osdmap.max_osd:
                self.last_beacon[msg.osd_id] = self.clock.monotonic()
                if getattr(msg, "statfs", None) is not None:
                    self.osd_statfs[msg.osd_id] = tuple(msg.statfs)
                slow = getattr(msg, "slow_ops", None)
                if slow is not None:
                    if slow[0]:
                        self.osd_slow_ops[msg.osd_id] = tuple(slow)
                    else:
                        # drained: the health warning clears with the
                        # next 'health' evaluation
                        self.osd_slow_ops.pop(msg.osd_id, None)
                ss = getattr(msg, "scrub_stats", None)
                if ss is not None and ss[0]:
                    self.osd_scrub_stats[msg.osd_id] = tuple(ss)
                else:
                    # repaired (or a restarted daemon with nothing
                    # flagged): PG_INCONSISTENT clears like SLOW_OPS
                    self.osd_scrub_stats.pop(msg.osd_id, None)
                uc = getattr(msg, "unclean_pgs", None)
                if uc is not None:
                    self.osd_unclean[msg.osd_id] = (
                        int(uc), int(getattr(msg, "map_epoch", 0)))
                lag = getattr(msg, "loop_lag", None)
                warn_at = self.config.loop_lag_warn
                if lag is not None and warn_at > 0 and lag[1] >= warn_at:
                    self.osd_loop_lag[msg.osd_id] = tuple(lag)
                else:
                    # drained below the threshold — or the daemon's
                    # profiler is off (lag None, e.g. restarted with
                    # the default config): LOOP_LAG clears like
                    # SLOW_OPS; a non-reporting OSD must never hold a
                    # stale warning
                    self.osd_loop_lag.pop(msg.osd_id, None)
            return True
        if isinstance(msg, M.MOSDMapMsg):
            newmap = pickle.loads(msg.osdmap_blob)
            if newmap.epoch > self.osdmap.epoch:
                self.osdmap = newmap.set_device(self.device, self.placements)
                self.perf.inc("mon_map_syncs")
                await self._persist_latest()
            return True
        if isinstance(msg, M.MOSDIncMapMsg):
            if msg.prev_epoch == self.osdmap.epoch:
                for blob in msg.inc_blobs:
                    await self._apply_inc_local(pickle.loads(blob))
            elif msg.epoch > self.osdmap.epoch:
                await self._request_map_sync()
            return True
        if isinstance(msg, M.MMgrBeacon):
            if not self.is_leader:
                if self.leader_rank is not None and \
                        self.leader_rank != self.rank:
                    try:
                        await self._send_mon(self.leader_rank, msg)
                    except (ConnectionError, OSError):
                        pass
                return True
            async with self._map_mutex:
                if self.osdmap.mgr_addr != tuple(msg.addr):
                    inc = self._new_inc()
                    inc.new_mgr_addr = tuple(msg.addr)
                    self.perf.inc("mon_mgr_beacons")
                    await self._commit_inc(inc)
            return True
        if type(msg).__name__ == "MMDSBeacon":
            # active-MDS registration (MDSMap-lite, like the mgr's)
            if not self.is_leader:
                if self.leader_rank is not None and \
                        self.leader_rank != self.rank:
                    try:
                        await self._send_mon(self.leader_rank, msg)
                    except (ConnectionError, OSError):
                        pass
                return True
            async with self._map_mutex:
                rank = getattr(msg, "rank", 0) or 0
                known = getattr(self.osdmap, "mds_addrs", {})
                if known.get(rank) != tuple(msg.addr):
                    inc = self._new_inc()
                    inc.new_mds_addrs = {rank: tuple(msg.addr)}
                    if rank == 0:
                        inc.new_mds_addr = tuple(msg.addr)
                    self.perf.inc("mon_mds_beacons")
                    await self._commit_inc(inc)
            return True
        if isinstance(msg, M.MMonSubscribe):
            self.subscribers.add(tuple(msg.addr))
            # remember the subscriber's OWN connection: cephx clients
            # cannot verify daemon authorizers (they hold no master
            # key), so pushes must ride the session the client opened —
            # exactly the reference model, where clients never accept
            # inbound connections
            self._sub_conns[tuple(msg.addr)] = conn
            covered = await self._send_map(tuple(msg.addr),
                                           since=msg.since,
                                           sub_tid=msg.tid)
            # the direct subscribe reply counts as a push: the pusher
            # must not re-send epochs the refresh just covered
            ps = self._push_state.setdefault(tuple(msg.addr), {})
            ps["last"] = max(ps.get("last", 0), covered)
            ps.setdefault("target", covered)
            return True
        if isinstance(msg, M.MCommand):
            # daemon-directed admin command ('ceph daemon mon.X ...'):
            # served from the local admin socket, never Paxos-forwarded
            result, data = await self.asok.dispatch(msg.cmd)
            try:
                await conn.send(M.MCommandReply(
                    tid=msg.tid, result=result, data=data))
            except (ConnectionError, OSError):
                pass
            return True
        if isinstance(msg, M.MMonCommand):
            await self._handle_command(conn, msg)
            return True
        if isinstance(msg, M.MMonCommandReply):
            # reply for a command we forwarded to the leader: relay it
            entry = self._fwd.pop(msg.tid, None)
            if entry is not None:
                client_conn, client_tid = entry
                try:
                    await client_conn.send(M.MMonCommandReply(
                        tid=client_tid, result=msg.result, data=msg.data))
                except (ConnectionError, OSError):
                    pass
            return True
        return False

    async def _handle_boot(self, msg: M.MOSDBoot) -> None:
        self._propose("boot", (msg.osd_id, msg.addr))
        if msg.osd_id >= self.osdmap.max_osd:
            return
        async with self._map_mutex:
            cur_addr = self.osdmap.osd_addrs.get(msg.osd_id)
            prev_instance = self._boot_instances.get(msg.osd_id)
            new_incarnation = (
                (cur_addr is not None and
                 tuple(cur_addr) != tuple(msg.addr)) or
                (prev_instance is not None and msg.instance and
                 prev_instance != msg.instance))
            self._boot_instances[msg.osd_id] = msg.instance
            if self.osdmap.osd_up[msg.osd_id] and not new_incarnation \
                    and cur_addr is not None:
                # a duplicate boot of the daemon life the map already
                # has up: a daemon marked down sends one on every map
                # that still shows it down, so a markdown of many OSDs
                # over many epochs queues many.  Each committed would
                # be an epoch, a pg_temp mint over every pool and a map
                # advance on every OSD (a boot storm that feeds itself
                # on a loaded loop); reference OSDMonitor::preprocess_boot
                # drops it.  It proves liveness like a beacon.
                self.last_beacon[msg.osd_id] = self.clock.monotonic()
                self.perf.inc("mon_osd_boot_dups")
                return
            if self.osdmap.osd_up[msg.osd_id] and new_incarnation:
                # a NEW incarnation of an osd we still think is up (it
                # bounced faster than failure detection): mark it down
                # first so the acting sets change and primaries run a
                # peering pass — otherwise the rejoiner silently keeps
                # whatever writes it missed (reference preprocess_boot
                # marks a booting-but-up osd down before the new up)
                down = self._new_inc()
                down.new_down.append(msg.osd_id)
                self.perf.inc("mon_osd_boot_fenced")
                await self._commit_inc(down)
            inc = self._new_inc()
            inc.new_up[msg.osd_id] = tuple(msg.addr)
            self.down_since.pop(msg.osd_id, None)
            self.failure_reports.pop(msg.osd_id, None)
            self.last_beacon[msg.osd_id] = self.clock.monotonic()
            self.perf.inc("mon_osd_boot")
            self.clog("INF", f"osd.{msg.osd_id} boot")
            await self._commit_inc(inc)

    async def _handle_pg_temp(self, msg: M.MOSDPGTemp) -> None:
        """Primary-requested temp-mapping change.  Today the only sender
        is a recovered primary asking for a CLEAR (osds=()): every
        up-member is backfilled current, so the conservative mon-minted
        pg_temp entry can drop and the map's real up set take over."""
        pgid = msg.pgid
        if pgid is None:
            return
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None or pgid.seed >= pool.pg_num:
            return
        async with self._map_mutex:
            cur = self.osdmap.pg_temp.get(pgid)
            want = [int(o) for o in msg.osds]
            # idempotent: a clear for an absent entry (or a set request
            # matching the current one) commits nothing
            if cur is None and not want:
                return
            if cur is not None and list(cur) == want:
                return
            # a CLEAR is only honored from a member of the live entry:
            # under a beacon blip an OSD whose degraded map shows every
            # donor down computes itself sole primary of an EMPTY pg,
            # finds nothing to hand off, and asks for the clear — honoring
            # it drops the only pointer to the data-bearing donors
            if cur is not None and not want and \
                    getattr(msg, "osd_id", -1) not in cur:
                self.perf.inc("mon_pg_temp_clear_rejected")
                return
            inc = self._new_inc()
            inc.new_pg_temp[pgid] = want
            self.perf.inc("mon_pg_temp_requests")
            await self._commit_inc(inc)

    async def _handle_failure(self, msg: M.MOSDFailure) -> None:
        m = self.osdmap
        osd = msg.failed_osd
        if osd < 0 or osd >= m.max_osd or not m.osd_up[osd]:
            return
        reporters = self.failure_reports.setdefault(osd, set())
        reporters.add(msg.reporter)
        # can_mark_down analog: enough distinct reporters
        if len(reporters) < self.config.mon_osd_min_down_reporters:
            return
        self._propose("down", osd)
        window = self.config.mon_osd_failure_coalesce
        if window <= 0:
            # immediate per-failure commit (the uncoalesced anchor:
            # one Paxos round per markdown)
            async with self._map_mutex:
                if not self.osdmap.osd_up[osd]:
                    return
                inc = self._new_inc()
                inc.new_down.append(osd)
                self.down_since[osd] = self.clock.monotonic()
                nrep = len(self.failure_reports.pop(osd, ()))
                self.perf.inc("mon_osd_marked_down")
                self.clog("ERR", f"osd.{osd} failed "
                                 f"({nrep} reporters) -> marked down")
                await self._commit_inc(inc)
            return
        # failure-report aggregation — every markdown that
        # crosses the threshold inside one coalesce window rides ONE
        # incremental, so a mass outage costs a handful of epochs (and
        # Paxos rounds), not one per OSD
        self._pending_failed.add(osd)
        t = self._failure_flush_task
        if t is None or t.done():
            from ceph_tpu_torch.utils.tasks import track_task

            self._failure_flush_task = track_task(
                self._mon_tasks, asyncio.get_event_loop().create_task(
                    self._flush_failures(window)))

    async def _flush_failures(self, window: float) -> None:
        """Commit every pending markdown as one map epoch per coalesce
        window, LOOPING until the pending set drains: a report that
        crosses the threshold while a commit is in flight lands in
        _pending_failed with this task still alive (so no new flush
        spawns), and OSD reporters send each failure only once
        (osd._reported) — without the re-check that markdown would
        strand until the beacon-grace backstop."""
        while not self.stopped:
            await asyncio.sleep(window)
            async with self._map_mutex:
                batch = sorted(o for o in self._pending_failed
                               if self.osdmap.osd_up[o])
                self._pending_failed.clear()
                if not batch:
                    return
                inc = self._new_inc()
                now = self.clock.monotonic()
                for osd in batch:
                    inc.new_down.append(osd)
                    self.down_since[osd] = now
                    nrep = len(self.failure_reports.pop(osd, ()))
                    self.perf.inc("mon_osd_marked_down")
                    self.clog("ERR", f"osd.{osd} failed "
                                     f"({nrep} reporters) -> marked down")
                if len(batch) > 1:
                    self.perf.inc("mon_failures_coalesced",
                                  len(batch) - 1)
                if not await self._commit_inc(inc):
                    # quorum lost mid-markdown: drop the batch — the
                    # beacon-grace tick (ours or the next leader's)
                    # redoes the detection from live state
                    for osd in batch:
                        self.down_since.pop(osd, None)

    # commands that mutate cluster state need mon "rw" caps (MonCap)
    _MUTATING_PREFIXES = frozenset({
        "osd pool create", "osd out", "osd in", "injectargs",
        "osd pool mksnap", "osd pool rmsnap",
        "osd pool selfmanaged_snap_create",
        "osd pool selfmanaged_snap_remove", "auth revoke",
        "osd pool delete", "osd pool rename", "osd pool set",
        "osd tier add", "osd tier remove", "osd tier cache-mode",
        "osd tier set-overlay", "osd tier remove-overlay",
        "osd pg-upmap-items", "osd rm-pg-upmap-items",
        "osd grow", "osd purge"})

    async def _handle_command(self, conn: Connection, msg: M.MMonCommand) -> None:
        cmd = msg.cmd
        result, data = 0, None
        prefix = cmd.get("prefix")
        caps = getattr(conn, "peer_caps", None)
        if caps is not None and prefix in self._MUTATING_PREFIXES:
            from ceph_tpu_torch.cluster import auth as authmod

            if not authmod.allows(caps, "mon", "rw"):
                self.perf.inc("mon_eperm")
                await conn.send(M.MMonCommandReply(
                    tid=msg.tid, result=-1,
                    data=f"EPERM: mon rw caps required for {prefix!r}"))
                return
        mutating = prefix in (
            "osd pool create", "osd out", "osd in",
            "osd pool mksnap", "osd pool rmsnap",
            "osd pool selfmanaged_snap_create",
            "osd pool selfmanaged_snap_remove", "auth revoke",
            "osd pool delete", "osd pool rename", "osd pool set",
            "osd tier add", "osd tier remove", "osd tier cache-mode",
            "osd tier set-overlay", "osd tier remove-overlay",
            "osd pg-upmap-items", "osd rm-pg-upmap-items",
            "osd grow", "osd purge")
        if mutating and not self.is_leader:
            # forward to the leader, relay its reply (reference
            # Monitor::forward_request_leader)
            if self.leader_rank is None or self.leader_rank == self.rank:
                await conn.send(M.MMonCommandReply(
                    tid=msg.tid, result=-11, data="no leader"))
                return
            self._fwd_tid += 1
            self._fwd[self._fwd_tid] = (conn, msg.tid)
            await self._send_mon(self.leader_rank, M.MMonCommand(
                cmd=cmd, tid=self._fwd_tid))
            self.perf.inc("mon_commands_forwarded")
            return
        try:
            if prefix == "osd pool create":
                # idempotent by name: a retried create (client failed over
                # mid-commit) returns the existing pool
                existing = next(
                    (pid for pid, p in self.osdmap.pools.items()
                     if p.name == cmd["pool"]), None)
                if existing is not None:
                    data = existing
                else:
                    async with self._map_mutex:
                        data, inc = await self._off_loop(self._create_pool,
                                                         cmd)
                        if not await self._commit_inc(inc):
                            result, data = -11, "quorum lost"
            elif prefix in ("osd pool mksnap", "osd pool rmsnap",
                            "osd pool selfmanaged_snap_create",
                            "osd pool selfmanaged_snap_remove"):
                result, data = await self._handle_snap_command(prefix, cmd)
            elif prefix == "osd pool delete":
                # reference OSDMonitor: name must repeat + the sure flag
                pid = next((p for p, po in self.osdmap.pools.items()
                            if po.name == cmd["pool"] or p == cmd["pool"]),
                           None)
                if pid is None:
                    result, data = -2, f"pool {cmd['pool']!r} not found"
                elif cmd.get("pool2") != cmd["pool"] or \
                        not cmd.get("sure"):
                    result, data = -1, (
                        "EPERM: pass the pool name twice and sure=True "
                        "to really delete (this is irreversible)")
                else:
                    async with self._map_mutex:
                        inc = self._new_inc()
                        inc.old_pools = (pid,)
                        if not await self._commit_inc(inc):
                            result, data = -11, "quorum lost"
                        else:
                            data = pid
            elif prefix == "osd pool rename":
                pid = next((p for p, po in self.osdmap.pools.items()
                            if po.name == cmd["srcpool"]), None)
                if pid is None:
                    result, data = -2, "source pool not found"
                elif any(po.name == cmd["destpool"]
                         for po in self.osdmap.pools.values()):
                    result, data = -17, "destination name exists"
                else:
                    import dataclasses as _dc

                    async with self._map_mutex:
                        inc = self._new_inc()
                        inc.new_pools[pid] = _dc.replace(
                            self.osdmap.pools[pid],
                            name=cmd["destpool"])
                        if not await self._commit_inc(inc):
                            result, data = -11, "quorum lost"
                        else:
                            data = pid
            elif prefix == "osd pool set":
                pid = next((p for p, po in self.osdmap.pools.items()
                            if po.name == cmd["pool"] or p == cmd["pool"]),
                           None)
                var, val = cmd.get("var"), cmd.get("val")
                if pid is None:
                    result, data = -2, f"pool {cmd['pool']!r} not found"
                elif var in ("pg_num", "pgp_num"):
                    result, data = await self._pool_set_pgnum(
                        pid, var, val)
                elif var in ("target_max_objects", "hit_set_count",
                             "hit_set_period"):
                    # cache-tier agent/hit-set knobs (reference
                    # OSDMonitor pool opts)
                    import dataclasses as _dc

                    caster = float if var == "hit_set_period" else int
                    try:
                        tval = caster(val)
                        if tval < 0:
                            raise ValueError
                    except (TypeError, ValueError):
                        result, data = -22, f"invalid {var}={val!r}"
                    else:
                        async with self._map_mutex:
                            inc = self._new_inc()
                            inc.new_pools[pid] = _dc.replace(
                                self.osdmap.pools[pid], **{var: tval})
                            if not await self._commit_inc(inc):
                                result, data = -11, "quorum lost"
                            else:
                                data = tval
                elif var not in ("size", "min_size"):
                    result, data = -22, f"cannot set {var!r}"
                else:
                    import dataclasses as _dc

                    # validate like the reference OSDMonitor: size >= 1
                    # and 1 <= min_size <= size, else committing through
                    # Paxos can wedge every write on the pool
                    po = self.osdmap.pools[pid]
                    try:
                        ival = int(val)
                    except (TypeError, ValueError):
                        ival = -1
                    new_size = ival if var == "size" else po.size
                    new_min = ival if var == "min_size" else po.min_size
                    if ival < 1 or new_min > new_size:
                        result, data = -22, (
                            f"invalid {var}={val!r}: need size >= 1 and "
                            f"1 <= min_size <= size "
                            f"(size={new_size}, min_size={new_min})")
                    else:
                        async with self._map_mutex:
                            inc = self._new_inc()
                            inc.new_pools[pid] = _dc.replace(
                                po, **{var: ival})
                            if not await self._commit_inc(inc):
                                result, data = -11, "quorum lost"
                            else:
                                data = ival
            elif prefix in ("osd tier add", "osd tier remove",
                            "osd tier cache-mode", "osd tier set-overlay",
                            "osd tier remove-overlay"):
                result, data = await self._handle_tier_command(prefix, cmd)
            elif prefix == "auth revoke":
                # refuse future ticket issuance/renewal for the entity
                # (existing tickets die at their TTL); committed through
                # Paxos so every mon enforces it and restarts keep it
                async with self._map_mutex:
                    inc = self._new_inc()
                    inc.new_revoked = (cmd["entity"],)
                    if not await self._commit_inc(inc):
                        result, data = -11, "quorum lost"
                    else:
                        data = sorted(self.osdmap.revoked_entities)
            elif prefix in ("osd out", "osd in"):
                # 'ids' batches the whole set into ONE epoch.  That is
                # load-bearing for drain safety: outing N OSDs as N
                # epochs lets the acting set WALK — each epoch keeps a
                # one-member overlap with the last, but the survivor it
                # keeps may itself be a just-added, not-yet-backfilled
                # member, so N quick epochs can strand every current
                # copy with no pg_temp ever minted.  One epoch makes the
                # wholesale replacement visible to _mint_pg_temp.
                ids = cmd.get("ids")
                ids = [int(i) for i in ids] if ids is not None \
                    else [int(cmd["id"])]
                w = 0 if prefix == "osd out" else 0x10000
                async with self._map_mutex:
                    inc = self._new_inc()
                    for i in ids:
                        inc.new_weights[i] = w
                    if not await self._commit_inc(inc):
                        result, data = -11, "quorum lost"
            elif prefix == "osd pg-upmap-items":
                # the balancer's commit edge: a BATCH of upmap exception
                # pairs as one Incremental (reference OSDMonitor
                # 'osd pg-upmap-items', one pg per command there; batched
                # here so a whole balancer round is one map epoch)
                result, data = await self._handle_upmap_items(cmd)
            elif prefix == "osd rm-pg-upmap-items":
                result, data = await self._handle_rm_upmap_items(cmd)
            elif prefix == "osd grow":
                result, data = await self._handle_grow(cmd)
            elif prefix == "osd purge":
                result, data = await self._handle_purge(cmd)
            elif prefix == "injectargs":
                # fan the config mutation out to the targeted daemons
                # (reference injectargs via mon 'ceph tell')
                who = cmd.get("who", "osd.*")
                args = cmd.get("args", {})
                sent = 0
                for o, addr in list(self.osdmap.osd_addrs.items()):
                    if who not in ("osd.*", f"osd.{o}"):
                        continue
                    if not self.osdmap.osd_up[o]:
                        continue
                    try:
                        await self.messenger.send_message(M.MCommand(
                            cmd={"prefix": "injectargs", "args": args}),
                            tuple(addr))
                        sent += 1
                    except (ConnectionError, OSError):
                        pass
                data = {"notified": sent}
            elif prefix == "status":
                m = self.osdmap
                data = {
                    "epoch": m.epoch,
                    "num_osds": m.max_osd,
                    "num_up": sum(m.osd_up),
                    "num_in": sum(1 for w in m.osd_weight if w > 0),
                    "pools": {p.name or pid: {
                        "id": pid, "size": p.size,
                        "pg_num": p.pg_num, "pgp_num": p.pgp_num,
                        "type": p.type,
                        **({"tier_of": p.tier_of,
                            "cache_mode": p.cache_mode}
                           if p.is_tier() else {}),
                        **({"tiers": list(p.tiers),
                            "read_tier": p.read_tier,
                            "write_tier": p.write_tier}
                           if p.tiers else {}),
                    } for pid, p in m.pools.items()},
                    "mds_ranks": {r: list(a) for r, a in
                                  sorted(getattr(m, "mds_addrs",
                                                 {}).items())},
                    "clog_entries": len(self.cluster_log),
                    # probing the MAP SHAPE tells the truth about the
                    # batched path without building device tables here
                    "placement_path": self._placement_path(m),
                }
            elif prefix == "health":
                data = self._health_data()
            elif prefix == "df":
                # 'ceph df' analog from beacon statfs
                per = {o: {"total": t, "used": u, "avail": t - u}
                       for o, (t, u) in sorted(self.osd_statfs.items())}
                data = {
                    "total_bytes": sum(t for t, _ in
                                       self.osd_statfs.values()),
                    "used_bytes": sum(u for _, u in
                                      self.osd_statfs.values()),
                    "osds": per,
                }
            elif prefix == "perf dump":
                data = self.perf.dump()
            elif prefix == "log last":
                # 'ceph log last [n]' (reference LogMonitor command)
                try:
                    n = int(cmd.get("num", 20))
                except (TypeError, ValueError):
                    n = 20
                tail = self.cluster_log[-n:] if n > 0 else []
                data = [
                    {"who": who, "stamp": stamp, "prio": prio, "msg": m_}
                    for who, stamp, prio, m_ in tail]
            else:
                result = -22  # EINVAL
        except Exception as e:  # surface errors to the caller
            result, data = -22, repr(e)
        reply = M.MMonCommandReply(tid=msg.tid, result=result, data=data)
        await conn.send(reply)

    def _parse_pgid(self, s: str) -> Optional[PGid]:
        try:
            pool_s, seed_s = str(s).split(".", 1)
            pgid = PGid(int(pool_s), int(seed_s))
        except (TypeError, ValueError):
            return None
        pool = self.osdmap.pools.get(pgid.pool)
        if pool is None or not (0 <= pgid.seed < pool.pg_num):
            return None
        return pgid

    async def _handle_upmap_items(self, cmd: Dict):
        """Batched 'osd pg-upmap-items': validate every pair against the
        CURRENT map, commit the whole set as one Incremental.  An empty
        pair list clears the pg's entry."""
        items = cmd.get("items") or {}
        m = self.osdmap
        new_items: Dict[PGid, list] = {}
        for key, pairs in items.items():
            pgid = self._parse_pgid(key)
            if pgid is None:
                return -22, f"bad pgid {key!r}"
            clean = []
            for pair in pairs or []:
                try:
                    src, dst = int(pair[0]), int(pair[1])
                except (TypeError, ValueError, IndexError):
                    return -22, f"bad pair {pair!r} for {key}"
                # destination must be a live, in OSD — committing a map
                # that remaps onto an out/absent OSD would undo the
                # balancer's own safety story
                if not (0 <= dst < m.max_osd and m.osd_exists[dst]
                        and m.osd_weight[dst] > 0):
                    return -22, f"osd.{dst} not usable as upmap target"
                if not (0 <= src < m.max_osd):
                    return -22, f"bad source osd.{src}"
                clean.append((src, dst))
            new_items[pgid] = clean
        if not new_items:
            return -22, "no items"
        async with self._map_mutex:
            inc = self._new_inc()
            inc.new_pg_upmap_items = dict(new_items)
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        self.perf.inc("mon_upmap_commits")
        self.perf.inc("mon_upmap_items", len(new_items))
        return 0, {"applied": len(new_items)}

    async def _handle_rm_upmap_items(self, cmd: Dict):
        pgids = cmd.get("pgids") or []
        clear: Dict[PGid, list] = {}
        for key in pgids:
            pgid = self._parse_pgid(key)
            if pgid is None:
                return -22, f"bad pgid {key!r}"
            clear[pgid] = []
        if not clear:
            return -22, "no pgids"
        async with self._map_mutex:
            inc = self._new_inc()
            inc.new_pg_upmap_items = clear
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        return 0, {"removed": len(clear)}

    async def _handle_grow(self, cmd: Dict):
        """'osd grow': mint count new OSD ids and their CRUSH hosts in
        ONE Incremental (the reference's 'osd crush add-bucket' + 'osd
        crush move' + ids choreography, collapsed).  New ids start
        exists/down/in; daemons boot into them like any revived OSD."""
        try:
            count = int(cmd.get("count", 0))
            per_host = int(cmd.get("osds_per_host", 1) or 1)
        except (TypeError, ValueError):
            return -22, "count/osds_per_host must be ints"
        if count <= 0 or per_host <= 0 or count % per_host:
            return -22, (f"need count > 0 divisible by osds_per_host "
                         f"(got {count}/{per_host})")
        root = cmd.get("root", "default")
        if root not in self.osdmap.crush.item_names.values():
            return -2, f"crush root {root!r} not found"
        async with self._map_mutex:
            m = self.osdmap
            base = m.max_osd
            taken = set(m.crush.item_names.values())
            hosts = []
            hno = sum(1 for b in m.crush.buckets.values() if b.type == 1)
            for i in range(count // per_host):
                name = f"host{hno + i}"
                while name in taken:
                    name += "x"
                taken.add(name)
                ids = tuple(range(base + i * per_host,
                                  base + (i + 1) * per_host))
                hosts.append((name, ids, (0x10000,) * per_host, root))
            inc = self._new_inc()
            inc.new_max_osd = base + count
            inc.new_crush_hosts = tuple(hosts)
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        self.clog("INF", f"osd grow: +{count} osds "
                         f"({base}..{base + count - 1})")
        return 0, {"new_osds": list(range(base, base + count)),
                   "max_osd": base + count,
                   "hosts": [h[0] for h in hosts]}

    async def _handle_purge(self, cmd: Dict):
        """'osd purge': remove a DRAINED osd from existence (reference
        OSDMonitor 'osd purge' = rm + crush remove + auth del).  Refused
        unless the osd is already down AND out — purging a live or
        still-weighted osd silently degrades PGs."""
        try:
            osd = int(cmd["id"])
        except (KeyError, TypeError, ValueError):
            return -22, "need id=<osd>"
        m = self.osdmap
        if not (0 <= osd < m.max_osd) or not m.osd_exists[osd]:
            return -2, f"osd.{osd} does not exist"
        if not cmd.get("sure"):
            return -1, "EPERM: pass sure=True to really purge"
        if m.osd_up[osd] or m.osd_weight[osd] > 0:
            return -16, (f"osd.{osd} must be down+out before purge "
                         f"(up={bool(m.osd_up[osd])}, "
                         f"weight={m.osd_weight[osd]})")
        async with self._map_mutex:
            inc = self._new_inc()
            inc.old_osds = (osd,)
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
        self.down_since.pop(osd, None)
        self.osd_statfs.pop(osd, None)
        self.clog("INF", f"osd.{osd} purged")
        return 0, {"purged": osd}

    def _create_pool(self, cmd: Dict) -> Tuple[int, Incremental]:
        """Build the pool + rule delta (committed by the caller)."""
        name = cmd["pool"]
        pool_type = POOL_TYPE_ERASURE if cmd.get("pool_type") == "erasure" \
            else POOL_TYPE_REPLICATED
        m = self.osdmap
        root = None
        for bid, b in m.crush.buckets.items():
            if b.type == max(bb.type for bb in m.crush.buckets.values()):
                root = bid
                break
        ec_profile = dict(cmd.get("ec_profile") or {})
        ruleno = len(m.crush.rules)  # appended by apply_incremental
        if pool_type == POOL_TYPE_ERASURE:
            from ceph_tpu_torch.ec import factory

            if not ec_profile:
                ec_profile = {"plugin": "jerasure",
                              "technique": "reed_sol_van",
                              "k": "2", "m": "1"}
            codec = factory(ec_profile, device=self.device)
            size = codec.get_chunk_count()
            min_size = codec.get_data_chunk_count()
            # compose the stripe unit with the codec's layout constraints
            # (packet-interleaved codecs need w*packetsize multiples) so
            # default profiles never EINVAL deep in the data path
            ec_profile["stripe_unit"] = str(codec.stripe_unit(
                int(ec_profile.get("stripe_unit",
                                   self.config.osd_ec_stripe_unit))))
            # ErasureCode::create_rule analog: indep chooseleaf rule
            rule = Rule(steps=[
                (RULE_TAKE, root, 0),
                (RULE_CHOOSELEAF_INDEP, size, 1),
                (RULE_EMIT, 0, 0)], type=POOL_TYPE_ERASURE)
        else:
            size = int(cmd.get("size", self.config.osd_pool_default_size))
            min_size = max(1, size - 1)
            rule = Rule(steps=[
                (RULE_TAKE, root, 0),
                (RULE_CHOOSELEAF_FIRSTN, size, 1),
                (RULE_EMIT, 0, 0)])
        pg_num = int(cmd.get("pg_num", self.config.osd_pool_default_pg_num))
        # derive from the REPLICATED map, not local state: a failed-over
        # leader must never reuse an id committed by its predecessor
        pool_id = max(self.osdmap.pools, default=0) + 1
        inc = self._new_inc()
        inc.new_rules.append(rule)
        inc.new_pools[pool_id] = PGPool(
            pool_id=pool_id, type=pool_type, size=size, min_size=min_size,
            pg_num=pg_num, pgp_num=pg_num, crush_rule=ruleno,
            ec_profile=ec_profile, name=name)
        self._propose("pool_create", (pool_id, name))
        self.clog("INF", f"pool '{name}' created (id {pool_id})")
        self.perf.inc("mon_pool_create")
        return pool_id, inc

    async def _handle_snap_command(self, prefix: str, cmd):
        """Pool/selfmanaged snapshot lifecycle (reference
        OSDMonitor::prepare_pool_op on POOL_OP_CREATE_SNAP /
        POOL_OP_CREATE_UNMANAGED_SNAP / the delete twins): every variant
        commits an updated pg_pool_t through Paxos so OSDs learn snap ids
        and removed_snaps from the map."""
        import dataclasses as _dc

        ref = cmd.get("pool")
        pool_id = next((pid for pid, p in self.osdmap.pools.items()
                        if p.name == ref or pid == ref), None)
        if pool_id is None:
            return -2, f"pool {ref!r} not found"
        async with self._map_mutex:
            pool = self.osdmap.pools[pool_id]
            newp = _dc.replace(pool, snaps=dict(pool.snaps),
                               removed_snaps=tuple(pool.removed_snaps))
            data = None
            if prefix == "osd pool mksnap":
                name = cmd["snap"]
                if name in newp.snaps.values():
                    return 0, next(i for i, n in newp.snaps.items()
                                   if n == name)  # idempotent retry
                newp.snap_seq += 1
                newp.snaps[newp.snap_seq] = name
                data = newp.snap_seq
            elif prefix == "osd pool rmsnap":
                name = cmd["snap"]
                sid = next((i for i, n in newp.snaps.items() if n == name),
                           None)
                if sid is None:
                    return -2, f"snap {name!r} not found"
                del newp.snaps[sid]
                newp.removed_snaps = tuple(newp.removed_snaps) + (sid,)
                data = sid
            elif prefix == "osd pool selfmanaged_snap_create":
                newp.snap_seq += 1
                data = newp.snap_seq
            else:  # selfmanaged_snap_remove
                sid = int(cmd["snapid"])
                if sid in newp.removed_snaps:
                    return 0, sid  # idempotent retry
                newp.removed_snaps = tuple(newp.removed_snaps) + (sid,)
                data = sid
            inc = self._new_inc()
            inc.new_pools[pool_id] = newp
            if not await self._commit_inc(inc):
                return -11, "quorum lost"
            self.perf.inc("mon_snap_commands")
            return 0, data

    # -- map distribution --------------------------------------------------

    async def _broadcast_map(self) -> None:
        """Mark every subscriber dirty; their pusher tasks deliver.

        Round 14 backpressure: one serialized pusher per subscriber —
        while a push awaits a slow peer's socket, further commits only
        advance that subscriber's target epoch, so a churn burst
        coalesces into one (last, current] chain per subscriber instead
        of queueing a delta message per epoch (unbounded on a slow OSD),
        and a slow subscriber no longer head-of-line blocks the commit
        path for everyone else."""
        for addr in list(self.subscribers):
            self._kick_map_pusher(addr)

    def _kick_map_pusher(self, addr: Addr) -> None:
        key = tuple(addr)
        st = self._push_state.get(key)
        if st is None:
            st = self._push_state[key] = {"last": self.osdmap.epoch - 1}
        st["target"] = self.osdmap.epoch
        task = st.get("task")
        if task is None or task.done():
            from ceph_tpu_torch.utils.tasks import track_task

            st["task"] = track_task(
                self._mon_tasks, asyncio.get_event_loop().create_task(
                    self._push_maps(key, st)))

    async def _push_maps(self, key: Tuple, st: Dict) -> None:
        while not self.stopped:
            target = st["target"]
            since = st["last"]
            if since >= target:
                return
            if target - since > 1:
                # epochs delivered in one chain that the per-commit
                # broadcast would have sent as separate messages
                self.perf.inc("mon_map_pushes_coalesced",
                              target - since - 1)
            try:
                covered = await self._send_map(key, since=since)
            except (ConnectionError, OSError):
                self.subscribers.discard(key)
                self._push_state.pop(key, None)
                return
            # against the LIVE watermark, not the loop-local `since`: a
            # subscribe-refresh reply racing this push may have already
            # advanced it past what this chain covered
            st["last"] = max(st["last"], covered)

    async def _map_push(self, msg, addr: Addr) -> None:
        """Deliver a map message: over the subscriber's own connection
        when one is alive (required for cephx clients), else by dialing
        the addr (daemon peers)."""
        conn = self._sub_conns.get(tuple(addr))
        if conn is not None and not conn.closed:
            try:
                await conn.send(msg)
                return
            except (ConnectionError, OSError, RuntimeError):
                self._sub_conns.pop(tuple(addr), None)
        await self.messenger.send_message(msg, addr)

    async def _send_map(self, addr: Addr, since: int = 0,
                        sub_tid: int = 0) -> int:
        """Send incrementals covering (since, current] when the window
        has them AND the chain stays under mon_osd_map_max_incs, else
        the full map (reference OSDMonitor send_incremental; skipping
        to a full map bounds both ends of a churn burst).  Returns the
        epoch the message covered.  ``sub_tid`` names the subscribe
        this answers."""
        epoch = self.osdmap.epoch
        if 0 < since <= epoch:
            chain = []
            e = since + 1
            limit = self.config.mon_osd_map_max_incs
            while e <= epoch and e in self._inc_log and \
                    len(chain) < limit:
                chain.append(pickle.dumps(self._inc_log[e]))
                e += 1
            if e > epoch:
                # complete chain (possibly empty when already current; the
                # empty message still acks the subscriber's refresh)
                self.perf.inc("mon_inc_maps_sent")
                await self._map_push(
                    M.MOSDIncMapMsg(prev_epoch=since, epoch=epoch,
                                    inc_blobs=chain, sub_tid=sub_tid),
                    addr)
                return epoch
            if len(chain) >= limit:
                # the subscriber fell outside the bounded delta window
                # under churn: skip to the full map
                self.perf.inc("mon_skip_to_full_sends")
        self.perf.inc("mon_full_maps_sent")
        blob = pickle.dumps(self.osdmap)
        await self._map_push(
            M.MOSDMapMsg(epoch=epoch, osdmap_blob=blob, sub_tid=sub_tid),
            addr)
        return epoch

    async def _tick(self) -> None:
        """Down-out + beacon-staleness tick (reference OSDMonitor tick:
        auto-out and mark-down of osds whose beacons went silent)."""
        while True:
            await asyncio.sleep(self.config.mon_tick_interval)
            now = self.clock.monotonic()
            self._note_health()
            async with self._map_mutex:
                inc = self._new_inc()
                out_restore: Dict[int, float] = {}
                for osd, since in list(self.down_since.items()):
                    if now - since > self.config.mon_osd_down_out_interval \
                            and self.osdmap.osd_weight[osd] > 0:
                        inc.new_weights[osd] = 0
                        out_restore[osd] = self.down_since.pop(osd)
                down_restore: Dict[int, float] = {}
                for osd, last in list(self.last_beacon.items()):
                    if self.osdmap.osd_up[osd] and \
                            now - last > self.config.mon_osd_beacon_grace:
                        inc.new_down.append(osd)
                        self.down_since[osd] = now
                        down_restore[osd] = self.last_beacon.pop(osd)
                        self.perf.inc("mon_osd_marked_down")
                for osd in inc.new_down:
                    self.clog("WRN", f"osd.{osd} marked down "
                                     "(beacon grace expired)")
                for osd in inc.new_weights:
                    self.clog("WRN", f"osd.{osd} marked out "
                                     "(down past the out interval)")
                # full-ratio protection: judge per-OSD
                # utilization from beacon statfs against the configured
                # ratios and commit flag transitions into the map —
                # OSDs enforce from their own copy (ENOSPC on client
                # writes under "full", backfill deferred under
                # "backfillfull"); flags CLEAR here too as deletes
                # drain space and beacons report it
                tiers = self._full_tiers()   # shared with health
                want = set()
                if tiers["full"]:
                    want |= {"full", "backfillfull", "nearfull"}
                if tiers["backfillfull"]:
                    want |= {"backfillfull", "nearfull"}
                if tiers["nearfull"]:
                    want.add("nearfull")
                for flag in ("nearfull", "backfillfull", "full"):
                    have = flag in self.osdmap.flags
                    if (flag in want) == have:
                        continue
                    inc.new_flags[flag] = flag in want
                    if flag in want:
                        self.clog("ERR" if flag == "full" else "WRN",
                                  f"cluster is {flag} "
                                  f"(mon_osd_{flag}_ratio)")
                    else:
                        self.clog("INF", f"{flag} flag cleared")
                # flush buffered cluster-log events through Paxos so the
                # whole quorum (and the persisted store) agree on the log
                if self._pending_clog:
                    inc.new_log_entries = tuple(self._pending_clog)
                    self._pending_clog = []
                if inc.new_weights or inc.new_down or \
                        inc.new_log_entries or inc.new_flags:
                    if not await self._commit_inc(inc):
                        # quorum lost mid-tick (leader killed under
                        # churn): the detection state must survive the
                        # failed commit, or an up-but-dead OSD whose
                        # beacon entry was already popped would never
                        # be marked down by anyone
                        self.down_since.update(out_restore)
                        for osd, last in down_restore.items():
                            self.last_beacon[osd] = last
                            self.down_since.pop(osd, None)
                        self._pending_clog = \
                            list(inc.new_log_entries) + self._pending_clog

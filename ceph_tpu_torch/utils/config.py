"""Typed option schema + runtime-mutable config.

Mirrors the shape of the reference's md_config_t / Option machinery
(src/common/options.cc ~1,338 entries; src/common/config.cc): each option
has a type, default, and optional bounds; values can be set from kwargs,
dicts, or at runtime ("injectargs"), and observers are notified on change
(md_config_obs_t semantics).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional


@dataclass(frozen=True)
class Option:
    name: str
    type: type
    default: Any
    desc: str = ""
    min: Optional[float] = None
    max: Optional[float] = None


OPTIONS: List[Option] = [
    # messenger
    Option("ms_type", str, "async", "messenger transport"),
    Option("ms_bind_host", str, "127.0.0.1"),
    Option("ms_connect_timeout", float, 5.0),
    # osd
    Option("osd_heartbeat_interval", float, 0.5, "peer ping period (s)"),
    Option("osd_heartbeat_grace", float, 2.0, "grace before failure report"),
    Option("osd_pool_default_size", int, 3, min=1, max=16),
    Option("osd_pool_default_min_size", int, 2, min=1),
    Option("osd_pool_default_pg_num", int, 32, min=1),
    Option("osd_recovery_delay_start", float, 0.0),
    Option("osd_client_op_timeout", float, 10.0),
    Option("osd_tier_agent_interval", float, 1.0,
           "cache-tier agent flush/evict period (s)"),
    Option("osd_client_message_size_cap", int, 500 * 1024 * 1024,
           "byte budget concurrently in dispatch from clients "
           "(reference osd_client_message_size_cap throttle)"),
    Option("rados_osd_op_timeout", float, 30.0,
           "client-side total op budget incl. resends"),
    # overload / graceful degradation: layered admission
    # control ahead of dispatch (reference osd_op_throttle feeding
    # ShardedOpWQ) + client congestion window + deadline shedding +
    # degraded EC reads.  Zero budgets = unlimited (provable no-op).
    Option("osd_op_throttle_ops", int, 0,
           "admission budget: client ops concurrently queued+executing; "
           "beyond it the op is pushed back -EBUSY (0 = unlimited)",
           min=0),
    Option("osd_op_throttle_bytes", int, 0,
           "admission budget: mutation payload bytes concurrently "
           "queued+executing (0 = unlimited)", min=0),
    Option("objecter_inflight_max", int, 256,
           "client congestion-window ceiling (AIMD shrinks from here on "
           "throttle pushback, recovers additively on acks)", min=1),
    Option("osd_ec_hedge_reads", int, 1,
           "EC reads gather only the first k clean shards and hedge "
           "stragglers after a quantile-derived delay (0 = full gather)",
           min=0, max=1),
    Option("osd_ec_hedge_delay_floor", float, 0.05,
           "minimum hedge delay before contacting spare EC shards (s)",
           min=0),
    Option("osd_mclock_background_weight", float, 0.25,
           "dmClock weight for background (osd-internal) op classes; "
           "under admission pressure these are shed first"),
    Option("osd_mclock_background_limit", float, 0.0,
           "ops/s cap for the background class (0 = unlimited, like "
           "every dmclock limit)"),
    Option("osd_map_cache_size", int, 50),
    Option("osd_map_batch_min_pgs", int, 256,
           "pools with at least this many PGs use batched placement"),
    # control plane at scale: vectorized epoch deltas,
    # bounded delta chains, and peering storm control.  The vectorized
    # path defaults ON; 0 restores the per-PG rescan + full re-peer —
    # the bit-exactness/bisection anchor.
    Option("osd_map_vectorized_delta", int, 1,
           "compute per-epoch affected-PG sets by diffing whole-pool "
           "batched placements (osdmap.placement_delta) so epoch "
           "application peers only PGs whose up/acting moved.  0 = "
           "per-PG rescan and full re-peer on any change (the anchor)",
           min=0, max=1),
    Option("osd_map_max_inc_chain", int, 64,
           "longest incremental chain an OSD applies from one map "
           "message; beyond it the daemon requests a full map instead "
           "of unpickling the chain on the dispatch loop", min=1),
    Option("osd_peering_max_concurrent", int, 4,
           "simultaneous peering rounds per OSD (reservation-style "
           "throttle: a mass bounce produces a bounded wave, not a "
           "stampede)", min=1),
    Option("osd_peering_stagger_after", int, 8,
           "peering waves larger than this stagger their round starts "
           "with capped seeded jitter so hundreds of OSDs bouncing at "
           "once desynchronize their peer queries (0 = never stagger)",
           min=0),
    Option("osd_peering_stagger_max", float, 0.25,
           "cap on the per-round seeded stagger delay (s)", min=0),
    Option("osd_scrub_interval", float, 0.0,
           "background deep-scrub period per primary PG (0 disables); "
           "the scheduler is per-PG and seeded-jittered so "
           "a daemon's PGs never scrub in lockstep"),
    Option("osd_scrub_jitter", float, 0.5,
           "fraction of osd_scrub_interval used as the per-PG seeded "
           "jitter band (first scrub spreads across it; later scrubs "
           "wobble +/- half of it)", min=0, max=1),
    # verified reads + read-repair: every EC shard's crc is
    # checked by its holder before the bytes may feed a decode, and a
    # shard that fails crc / returns EIO / proves generation-stale is
    # rebuilt in place asynchronously.  Both default ON; 0 restores the
    # opportunistic-verify / fail-the-read behavior (the
    # verify-on-read A/B lever).
    Option("osd_ec_verify_reads", int, 1,
           "verify every EC shard crc at read time (local shard "
           "batched through the read coalescer's crc tick, peers in "
           "their sub-read handlers).  0 = serve unverified bytes",
           min=0, max=1),
    Option("osd_read_repair", int, 1,
           "automatically rebuild shards a read gather found bad "
           "(crc/EIO/stale) from the surviving shards, off the client "
           "path.  0 = detect only", min=0, max=1),
    Option("osd_op_queue", str, "fifo",
           "client op scheduling: fifo | mclock (dmClock QoS)"),
    # sharded dispatch + per-tick stripe-batch coalescing:
    # the ShardedOpWQ analog.  Zero defaults preserve the
    # per-op dispatch/encode path exactly — the bisection anchor; vstart
    # _fast_config (tests + bench) turns both on.
    Option("osd_op_shards", int, 0,
           "client-op dispatch shards (PG-affine hashing; each shard "
           "drains on a bounded dispatch tick and owns its own "
           "mclock/FIFO queue + shedding).  0 = the per-(conn,PG) "
           "FIFO / global-mclock legacy path", min=0),
    Option("osd_batch_tick_ops", int, 0,
           "max EC stripe-batch encodes coalesced into ONE device "
           "dispatch per tick (one to_planar, one fused encode, one "
           "crc32c batch).  0 = per-op encode (legacy)", min=0),
    Option("osd_batch_tick_window", float, 0.0,
           "extra accumulation window (s) after a tick's first encode "
           "request; 0 = pure group-commit self-clocking (a lone op "
           "never waits)", min=0),
    # client-edge op coalescing: the objecter twin of the
    # OSD tick batchers.  Ops targeting the same OSD park in a
    # per-(session, OSD) coalescer and ship as ONE MOSDOpBatch frame
    # per tick; replies coalesce back as ONE MOSDOpReplyBatch per reply
    # tick.  Per-item semantics are preserved end to end: a THROTTLED
    # or shed item un-acks only itself and AIMD pushback/ack accounting
    # stays per item.  0 = one MOSDOp frame + one reply per op — the
    # legacy bit-exactness / same-host A/B anchor; vstart _fast_config
    # turns it on.
    Option("objecter_batch_tick_ops", int, 0,
           "max client ops coalesced into ONE MOSDOpBatch frame per "
           "(session, OSD) tick; a 1-op tick ships the plain legacy "
           "MOSDOp frame.  0 = per-op frames (the anchor)", min=0),
    Option("objecter_batch_tick_window", float, 0.0,
           "extra accumulation window (s) after a client tick's first "
           "parked op; 0 = pure group-commit self-clocking (a lone op "
           "never waits)", min=0),
    # unified pipelined commit frontier: EC RMW and
    # replicated-pool mutations commit through the same split
    # commit-start (under the PG lock) / ack-wait (lock released)
    # path as the pipelined EC full writes, all registered with
    # the PG's commit frontier.  0 = the full-PG-lock commit
    # for EVERY mutation — the serial bit-exactness anchor.
    Option("osd_pipeline_writes", int, 1,
           "pipeline mutation commits: hold the PG lock only for the "
           "ordered commit section, await fan-out acks with it "
           "released (EC full/RMW + replicated unified).  0 = legacy "
           "full-lock serial commits (bisection anchor)",
           min=0, max=1),
    Option("osd_op_complaint_time", float, 30.0,
           "ops blocked this long raise 'slow ops' warnings "
           "(reference osd_op_complaint_time; 0 disables)", min=0),
    Option("osd_op_history_size", int, 20,
           "completed ops kept for dump_historic_ops", min=0),
    Option("osd_op_history_slow_op_size", int, 20,
           "slowest completed ops kept for dump_historic_slow_ops",
           min=0),
    Option("osd_mclock_default_reservation", float, 0.0),
    Option("osd_mclock_default_weight", float, 1.0),
    Option("osd_mclock_default_limit", float, 0.0),
    # graft-trace (ceph_tpu_torch/trace/): span tracing + event-loop profiling.
    # All-off defaults keep both provable no-ops (the chaos-injector
    # contract): Tracer.start returns the NULL_SPAN singleton and the
    # LoopProfiler declares/samples nothing.
    Option("trace_enabled", int, 0,
           "graft-trace span tracing (0 = off: provable no-op)",
           min=0, max=1),
    Option("trace_keep", int, 256,
           "completed traces retained per daemon tracer", min=1),
    Option("loop_profile_interval", float, 0.0,
           "event-loop lag sampler period (s); 0 disables", min=0),
    Option("loop_lag_warn", float, 0.5,
           "sampled loop lag at/above this raises the LOOP_LAG health "
           "warning (needs the sampler on)", min=0),
    # graft-blackbox (ceph_tpu_torch/trace/flight.py + postmortem.py): the
    # per-daemon flight-recorder ring and triggered postmortem bundles.
    # Default-off keeps the provable-no-op contract: every daemon's
    # recorder is the shared NULL_FLIGHT singleton and the trigger path
    # in vstart/load/chaos is one falsy test.
    Option("blackbox_enabled", int, 0,
           "per-daemon flight recorder + triggered postmortem bundles "
           "(0 = off: provable no-op, the graft-trace contract)",
           min=0, max=1),
    Option("blackbox_ring", int, 512,
           "flight-recorder ring capacity per daemon (hard memory "
           "bound; overflow drops oldest and counts)", min=1),
    Option("blackbox_sample", int, 8,
           "record every Nth completed op in the flight ring (slow "
           "ops always recorded)", min=1),
    Option("blackbox_dir", str, "",
           "directory for triggered POSTMORTEM_*.json bundles; empty "
           "keeps bundles in-memory only (cluster.postmortems)"),
    Option("mon_health_history", int, 128,
           "health-transition records kept in the mon's bounded "
           "history ring (served by 'health history')", min=1),
    # graft-balance (ceph_tpu_torch/balance/): the elastic-cluster policy
    # subsystem — device-batched upmap balancer, pg_num autoscaler and
    # grow/drain reshape ops, all mgr-hosted.  Default-off keeps the
    # provable-no-op contract: no loops start, no mon commands are
    # issued, and the mgr_balancer_*/mgr_autoscale_* counter families
    # stay declared-but-zero on the Prometheus scrape.
    Option("mgr_balancer_enabled", int, 0,
           "mgr upmap balancer loop (0 = off: provable no-op, counters "
           "declared but zero)", min=0, max=1),
    Option("mgr_balancer_vectorized", int, 1,
           "1 = device-batched candidate scorer (balance/scorer.py); "
           "0 = the greedy scalar anchor (osdmap/balancer.py) — the "
           "bisection anchor for the bit-exactness gate", min=0, max=1),
    Option("mgr_balancer_interval", float, 5.0,
           "seconds between balancer optimization rounds", min=0.05),
    Option("mgr_balancer_max_moves", int, 16,
           "pg_upmap_items moves committed per round (caps per-round "
           "backfill churn, reference upmap_max_optimizations)", min=1),
    Option("mgr_balancer_max_deviation_ratio", float, 0.05,
           "per-OSD fill deviation ratio the balancer tolerates before "
           "moving PGs (calc_pg_upmaps threshold)", min=0),
    Option("mgr_balancer_primary_weight", float, 0.0,
           "secondary objective weight on primary-count balance "
           "(0 keeps the objective identical to the scalar anchor's "
           "fill-variance energy)", min=0),
    Option("mgr_balancer_move_cost", float, 0.0,
           "projected-move-bytes penalty per candidate (0 = pure "
           "balance objective)", min=0),
    Option("mgr_balancer_require_clean", int, 1,
           "pause optimization while PG_DEGRADED/OSD_DOWN health "
           "checks fire (backfill pressure throttle)", min=0, max=1),
    Option("mgr_autoscale_enabled", int, 0,
           "mgr pg_num autoscaler loop (0 = off: provable no-op)",
           min=0, max=1),
    Option("mgr_autoscale_interval", float, 5.0,
           "seconds between autoscaler rounds", min=0.05),
    Option("mgr_autoscale_objects_per_pg", int, 64,
           "grow a pool's pg_num once its PGs average this many "
           "objects (load-derived target)", min=1),
    Option("mgr_autoscale_pgs_per_osd", int, 100,
           "cluster PG budget: pool pg_num*size summed must stay under "
           "this per in-OSD (mon_max_pg_per_osd analog)", min=1),
    # graft-race (ceph_tpu_torch/analysis/racecheck.py + utils/schedfuzz.py):
    # the seeded schedule-perturbation sanitizer.  Default-off keeps the
    # provable-no-op contract: the module-global probe target stays the
    # falsy NULL_RACE singleton and every cluster probe site is one
    # truthiness test (pinned by tests/test_racecheck.py).
    Option("race_check_enabled", int, 0,
           "arm the cross-task write-after-read tracker at the cluster "
           "probe seams (0 = off: provable no-op; 1 = vstart boot arms "
           "the process-global tracker, served by 'race report'; race "
           "runs install their own tracker + the SchedFuzzLoop shim)",
           min=0, max=1),
    Option("race_check_seed", int, 0,
           "seed for the schedule-perturbation rng stream and the "
           "tracker it reports under (chaos-rng derived: replays "
           "bit-identically)", min=0),
    # mon
    Option("mon_osd_down_out_interval", float, 30.0,
           "auto-out after down this long"),
    # cluster-full protection (reference mon_osd_*_ratio):
    # the mon judges per-OSD utilization from beacon statfs and commits
    # nearfull/backfillfull/full flags into the OSDMap; full pools
    # reject client writes with ENOSPC (deletes still admitted so the
    # cluster can dig itself out), backfillfull gates backfill data
    # movement, and the flags clear as space frees.
    Option("mon_osd_nearfull_ratio", float, 0.85,
           "per-OSD used/total at/above this raises OSD_NEARFULL and "
           "sets the map's nearfull flag", min=0, max=1),
    Option("mon_osd_backfillfull_ratio", float, 0.90,
           "at/above this, backfill data movement is refused "
           "(OSD_BACKFILLFULL + the map's backfillfull flag)",
           min=0, max=1),
    Option("mon_osd_full_ratio", float, 0.95,
           "at/above this the cluster is FULL: client writes are "
           "rejected with ENOSPC until space frees (OSD_FULL, "
           "HEALTH_ERR, the map's full flag)", min=0, max=1),
    Option("mon_osd_min_down_reporters", int, 1),
    Option("mon_osd_failure_coalesce", float, 0.05,
           "window (s) to aggregate concurrent failure reports into "
           "ONE map epoch — N simultaneous markdowns coalesce into one "
           "incremental instead of N Paxos rounds (0 = commit each "
           "markdown immediately)", min=0),
    Option("mon_osd_map_max_incs", int, 32,
           "longest incremental chain the mon sends one subscriber; "
           "beyond it the mon skips to a full map (cheaper than a long "
           "per-epoch pickle chain on both ends)", min=1),
    Option("mon_osd_beacon_grace", float, 6.0,
           "mark an osd down when its beacons go stale this long "
           "(reference osd_beacon_report_interval + mon grace)"),
    Option("mon_tick_interval", float, 0.5),
    Option("mon_election_timeout", float, 0.3,
           "elector victory-check window"),
    Option("mon_paxos_timeout", float, 1.0,
           "collect/accept round timeout"),
    Option("mon_lease_interval", float, 0.25,
           "leader lease extension period"),
    Option("mon_lease_ack_timeout", float, 1.2,
           "peon lease staleness before calling an election"),
    # auth (reference auth_supported / cephx)
    Option("auth_shared_secret", str, "",
           "cluster HMAC signing key; empty = auth none"),
    # "none" | "shared" (static HMAC signing) | "cephx" (mon-issued
    # tickets, per-session keys, caps — cluster/auth.py)
    Option("auth_supported", str, "shared"),
    Option("auth_ticket_ttl", float, 3600.0),
    # client-side: hex per-entity key (provisioned keyring analog);
    # empty + cephx -> derive from auth_shared_secret when present
    Option("auth_entity_key", str, ""),
    # mds (MDSMap-lite + Locker caps-lite)
    Option("mds_lease_ttl", float, 2.0),
    Option("mds_beacon_interval", float, 1.0),
    # ec
    Option("osd_ec_batch_size", int, 64, "stripes per device dispatch"),
    Option("osd_ec_stripe_unit", int, 4096),
    # bit-planar AT-REST shards: EC shard objects are stored,
    # shipped (sub-writes/sub-reads/recovery push), and verified as
    # packed bit-plane matrices — zero layout conversions on the
    # steady-state write/read/RMW/recovery/scrub paths (pinned by the
    # ec_planar_unseamed counter).  0 = byte-at-rest, the
    # bisection/bit-exactness anchor; requires w=8 matrix codecs and
    # stripe_unit % 8 == 0 (else the OSD quietly stays on bytes).
    Option("osd_ec_planar_at_rest", int, 0, min=0, max=1),
    # route EC pool batch encode/decode through the sharded mesh engine
    # (parallel/engine.py): "on" = use a device mesh, "off" = the
    # single-device codec engines.  (\"on\" spreads the batch over the visible CUDA devices; the mesh
    # is the EC data plane the way NCCL fan-out is the reference's.)
    Option("osd_ec_mesh", str, "off"),
    Option("osd_ec_mesh_devices", int, 0),  # 0 = all visible devices
    # store
    Option("memstore_device_bytes", int, 1 << 30),
    Option("bluestore_csum_type", str, "crc32c"),
    # debug
    Option("debug_ms", int, 0, min=0, max=20),
    Option("debug_osd", int, 0, min=0, max=20),
    Option("debug_mon", int, 0, min=0, max=20),
    # chaos (deterministic fault injection, chaos/): the
    # injectargs-able analog of the reference's ms_inject_socket_failures
    # / filestore_debug_inject_read_err debug seams.  All-zero defaults
    # keep every injector a provable no-op (messenger.chaos is None,
    # store.chaos is None, clock skew a plain passthrough).
    Option("chaos_seed", int, 0, "root seed for per-injector rng streams"),
    Option("chaos_net_drop", float, 0.0, "frame drop probability",
           min=0, max=1),
    Option("chaos_net_dup", float, 0.0, "frame duplication probability",
           min=0, max=1),
    Option("chaos_net_delay", float, 0.0,
           "max injected frame delay (s)", min=0),
    Option("chaos_net_delay_prob", float, 0.0,
           "frame delay probability", min=0, max=1),
    Option("chaos_net_reorder", float, 0.0,
           "frame reorder (deferral) probability", min=0, max=1),
    Option("chaos_net_reset", float, 0.0,
           "post-send session reset probability", min=0, max=1),
    Option("chaos_net_partition", str, "",
           "comma-separated host:port peers unreachable FROM this "
           "daemon (asymmetric partition side)"),
    Option("chaos_disk_read_err", float, 0.0,
           "injected EIO probability per store read", min=0, max=1),
    Option("chaos_disk_enospc", float, 0.0,
           "injected ENOSPC probability per transaction", min=0, max=1),
    Option("chaos_disk_bitrot", float, 0.0,
           "silent bit-flip probability per committed write txn",
           min=0, max=1),
    Option("chaos_clock_skew", float, 0.0,
           "seconds added to this daemon's time source"),
    # batch-aware fault injection: per-item faults INSIDE a
    # coalesced tick's frames, and named crash points at the
    # tick/commit seams.  All-zero/empty defaults keep the no-op
    # contract (mutate_batch is never consulted, _chaos_point is one
    # falsy test).
    Option("chaos_net_batch_item_drop", float, 0.0,
           "per-item drop probability INSIDE a MOSDECSubOpWriteBatch "
           "frame (the rest of the frame still delivers — a partial "
           "tick on the wire)", min=0, max=1),
    Option("chaos_net_batch_ack_dup", float, 0.0,
           "per-entry duplication probability in a batched sub-write "
           "ack (exercises per-responder ack dedup)", min=0, max=1),
    Option("chaos_net_batch_ack_reorder", float, 0.0,
           "probability of shuffling a batched ack's result order "
           "(acks must be order-independent)", min=0, max=1),
    Option("chaos_crash_point", str, "",
           "named crash seam: the daemon power-cuts itself the next "
           "time its write path passes this point (tick_mid_encode, "
           "tick_post_encode, commit_pre_fanout, commit_mid_fanout, "
           "frontier_open, frontier_pre_done, batch_apply_mid); "
           "one-shot, '' = off.  Front-door seams: on "
           "an MDS config, mds_journal_mid (journalled but unapplied) "
           "and mds_replay_mid (boot replay cut between events) crash "
           "the rank; on a CLIENT config, rbd_snap_pre_header, "
           "rbd_copyup_mid, rbd_clone_mid, rgw_part_mid, "
           "rgw_complete_mid, and rgw_abort_mid interrupt the library "
           "op (ChaosInterrupt) — the 'application' dies "
           "mid-transaction and a retry models its restart"),
    Option("chaos_crash_point_skip", int, 0,
           "traversals of the armed crash point to let pass before "
           "firing (seed-resolved by scenarios for deterministic "
           "crash timing)", min=0),
]

_BY_NAME = {o.name: o for o in OPTIONS}


class Config:
    def __init__(self, **overrides):
        self._values: Dict[str, Any] = {o.name: o.default for o in OPTIONS}
        self._observers: List[Callable[[str, Any], None]] = []
        for k, v in overrides.items():
            self.set(k, v)

    def get(self, name: str):
        return self._values[name]

    def __getattr__(self, name: str):
        values = object.__getattribute__(self, "_values")
        if name in values:
            return values[name]
        raise AttributeError(name)

    def __setattr__(self, name: str, value) -> None:
        # route option assignment through set(): a shadowing instance
        # attribute would be read back by __getattr__ but silently lost
        # by show()-based per-daemon copies
        if name.startswith("_"):
            object.__setattr__(self, name, value)
        else:
            self.set(name, value)

    def set(self, name: str, value) -> None:
        opt = _BY_NAME.get(name)
        if opt is None:
            raise KeyError(f"unknown option {name}")
        value = opt.type(value)
        if opt.min is not None and value < opt.min:
            raise ValueError(f"{name}={value} below min {opt.min}")
        if opt.max is not None and value > opt.max:
            raise ValueError(f"{name}={value} above max {opt.max}")
        self._values[name] = value
        for obs in self._observers:
            obs(name, value)

    def injectargs(self, args: Dict[str, Any]) -> None:
        """Runtime mutation (reference injectargs admin command)."""
        for k, v in args.items():
            self.set(k, v)

    def add_observer(self, fn: Callable[[str, Any], None]) -> None:
        self._observers.append(fn)

    def remove_observer(self, fn: Callable[[str, Any], None]) -> None:
        """Deregister an observer (daemon teardown).  Configs are
        REUSED across daemon incarnations (vstart restart/revive keep
        the per-daemon config so injected options survive bounces), so
        a stop() that leaves its observers behind pins every dead
        incarnation in memory for the config's lifetime."""
        try:
            self._observers.remove(fn)
        except ValueError:
            pass

    def auth_secret(self):
        """Messenger signing key, or None for auth 'none'."""
        s = self._values.get("auth_shared_secret", "")
        return s.encode() if s else None

    def cephx_context(self, entity: str):
        """CephxContext for a daemon/client messenger when
        auth_supported=cephx, else None (legacy shared/none modes)."""
        if self._values.get("auth_supported") != "cephx":
            return None
        from ceph_tpu_torch.cluster import auth as authmod

        master = self.auth_secret()
        ek = self._values.get("auth_entity_key", "")
        entity_secret = bytes.fromhex(ek) if ek else None
        kind = entity.split(".", 1)[0]
        if kind in ("mon", "osd", "mds", "mgr"):
            return authmod.CephxContext(
                entity, master=master,
                ttl=self._values.get("auth_ticket_ttl", 3600.0))
        # clients never hold the master key — only their entity key
        if entity_secret is None and master is not None:
            entity_secret = authmod.entity_key(master, entity)
        return authmod.CephxContext(
            entity, entity_secret=entity_secret,
            ttl=self._values.get("auth_ticket_ttl", 3600.0))

    def show(self) -> Dict[str, Any]:
        return dict(self._values)

"""Declarative chaos scenarios: seeded fault schedules over a workload.

Counterpart of ``ceph_tpu/chaos/scenario.py``.  ``run_scenario`` takes
the ``device`` every daemon and client of its cluster runs on: CUDA
unless the caller names another (``device="cpu"`` for the plain
versions); it raises when CUDA is absent and no device was named.

The teuthology-thrasher analog, made deterministic: a ``Scenario``
declares a cluster shape, a write workload, a list of fault ``Event``s
pinned to workload rounds, and the invariants that must hold after
convergence.  ``build_schedule(scenario, seed)`` resolves every random
choice (victims, partition halves, skew magnitudes) from the seed's
``schedule`` stream — so the same ``--seed`` produces a bit-identical
fault schedule, and a failure run replays exactly.

Run shape::

    for each round:            # rounds interleave workload and faults
        apply this round's events (mid-write events race a write burst)
        write the round's objects, recording acked payload + crc
        snapshot (optional)
    heal everything            # zero rates, drop partitions, revive dead
    wait for convergence       # all OSDs up, epoch settled
    check invariants           # chaos/invariants.py
    -> Verdict

Event actions:

====================  ======================================================
``kill_osd``          hard-stop an OSD (store lost, like a dead host)
``crash_osd``         power-cut stop; FileStore/BlueStore may tear or lose
                      the journal tail (``torn_tail`` / ``lose_frames``)
``revive_osd``        bring a downed OSD back (crash victims keep their
                      store and replay; kill victims boot empty)
``restart_osd``       bounce keeping the store (delta-resync via pg log)
``net``               set chaos_net_* rates on the target daemon(s)
``disk``              set chaos_disk_* rates on the target daemon(s)
``clock_skew``        skew the target daemon's time source (seconds)
``partition``         split the OSDs into two halves (or explicit sides)
``heal_partition``    drop every partition edge
``bitrot``            flip one stored bit of one acked object replica
``kill_mon``          hard-stop a monitor (default target: the current
                      Paxos leader, resolved at apply time)
``revive_mon``        restart a killed monitor rank (rejoins elections,
                      catches up through collect + map subscription)
====================  ======================================================

Targets: ``osd.N`` / ``mon.N`` pin a daemon; ``random_osd`` resolves
from the schedule stream (never dropping live OSDs below the pool
size); ``random_down_osd`` picks a dead one; ``all_osds`` / ``cluster``
fan out.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.chaos import invariants as inv
from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.daemons import (
    DaemonInjector,
    heal_partitions,
    partition,
    zero_rates,
)
from ceph_tpu_torch.chaos.disk import DiskInjector
from ceph_tpu_torch.chaos.rng import stream
from ceph_tpu_torch.ops import crc32c as crcmod


@dataclass(frozen=True)
class Event:
    round: int
    action: str
    target: str = "random_osd"
    args: Tuple[Tuple[str, object], ...] = ()
    during_writes: bool = False
    # apply AFTER the round's writes land (corruption events: a
    # pre-write bitrot on a reused oid would just be overwritten, and
    # the scrub invariant would pass without ever seeing a flipped bit)
    after_writes: bool = False

    def arg(self, key: str, default=None):
        return dict(self.args).get(key, default)


def ev(round: int, action: str, target: str = "random_osd",
       during_writes: bool = False, after_writes: bool = False,
       **args) -> Event:
    """Sugar: ``ev(1, "crash_osd", torn_tail=True)``."""
    return Event(round=round, action=action, target=target,
                 during_writes=during_writes, after_writes=after_writes,
                 args=tuple(sorted(args.items())))


@dataclass(frozen=True)
class Scenario:
    name: str
    osds: int = 3
    pool_kind: str = "replicated"            # "replicated" | "erasure"
    pool_size: int = 3
    pg_num: int = 8
    ec_profile: Optional[Tuple[Tuple[str, str], ...]] = None
    rounds: int = 3
    objects_per_round: int = 6
    payload_repeat: int = 60
    snapshots: bool = False
    events: Tuple[Event, ...] = ()
    invariants: Tuple[str, ...] = ("durability", "acting", "health",
                                   "lockdep")
    durability_mode: str = "acked"           # "acked" | "attempted"
    store: str = "mem"                       # "mem" | "file" | "blue"
    config: Tuple[Tuple[str, object], ...] = ()
    write_timeout: float = 60.0
    converge_timeout: float = 60.0
    # overload workload shape: "zipf" picks oids from a
    # zipfian hot-object distribution (same oid may be written
    # concurrently — use durability_mode="attempted"); burst_concurrency
    # fires every round's writes concurrently (an offered-load burst
    # against the admission budget); op_deadline bounds each write's
    # client budget (> 0 arms the "deadline" invariant's bookkeeping:
    # an ack arriving after its deadline is a failure)
    workload: str = "seq"                    # "seq" | "zipf"
    burst_concurrency: int = 0
    op_deadline: float = 0.0
    # control-plane storm shape: a Paxos mon quorum, rounds
    # driven by the graft-load open-loop driver instead of the put loop
    # (``load`` is a LoadSpec; one drive() window per round, mid-round
    # events race the in-flight traffic), and two judged gates —
    # bounded time-to-HEALTH_OK after heal and a floor on map epochs/s
    # generated while the storm ran (0 = gate off)
    mons: int = 1
    load: Optional[object] = None            # ceph_tpu_torch.load LoadSpec
    health_ok_bound: float = 0.0
    epochs_floor: float = 0.0


@dataclass
class Verdict:
    name: str
    seed: int
    schedule: List[Dict]
    passed: bool
    failures: List[str]
    acked_objects: int = 0
    counters: Dict[str, int] = field(default_factory=dict)
    # artifact traceability: observed-vs-threshold rows for
    # the judged gates and the graft-blackbox bundle path a conviction
    # triggered.  Excluded from replay_key like counters: gate VALUES
    # are wire-level timings, and the bundle path only exists when the
    # recorder is on.
    gates: List[Dict] = field(default_factory=list)
    postmortem: Optional[str] = None

    def replay_key(self) -> Tuple:
        """The parts of a verdict that must be identical across two runs
        of the same seed: the resolved fault schedule and the outcome.
        (Raw counters are wire-level and vary with async timing.)"""
        sched = tuple(tuple(sorted(e.items())) for e in self.schedule)
        return (self.name, self.seed, sched, self.passed,
                tuple(sorted(self.failures)))

    def as_dict(self) -> Dict:
        return {"name": self.name, "seed": self.seed,
                "passed": self.passed, "failures": self.failures,
                "acked_objects": self.acked_objects,
                "schedule": self.schedule, "counters": self.counters,
                "gates": self.gates, "postmortem": self.postmortem}


# --------------------------------------------------------------- schedule


def build_schedule(scenario: Scenario, seed: int) -> List[Dict]:
    """Resolve every event to a concrete, seed-deterministic plan.
    Victim picks track which OSDs the plan has already killed so a
    ``revive_osd`` targets an actually-dead daemon and kills never plan
    to drop live OSDs below the pool size."""
    rng = stream(seed, "schedule")
    alive = set(range(scenario.osds))
    dead: List[int] = []
    plan: List[Dict] = []
    for i, e in enumerate(sorted(scenario.events,
                                 key=lambda e: (e.round,))):
        entry: Dict = {"round": e.round, "action": e.action,
                       "during_writes": e.during_writes,
                       "after_writes": e.after_writes,
                       "args": dict(e.args)}
        target = e.target
        if e.action == "crash_point":
            # arm a named tick/commit crash seam on one daemon: it
            # power-cuts itself when its write path next passes the
            # point.  Planned as a probable kill (floor bookkeeping);
            # the skip count resolves from the seeded stream so WHICH
            # traversal dies replays bit-identically.
            #
            # Round 15: "client" targets arm a LIBRARY interrupt seam
            # (no daemon dies — the front-door op unwinds and the
            # workload's retry models a restarted application) and
            # "mds.N" targets crash that MDS rank (restarted by the
            # front-door babysitter, never an OSD) — neither touches
            # the OSD alive/dead bookkeeping.
            if target == "client" or target.startswith("mds"):
                if entry["args"].get("at") is None:
                    entry["args"]["at"] = rng.randrange(0, 3)
                entry["target"] = target
                entry["seq"] = i
                plan.append(entry)
                continue
            if target == "random_osd":
                pool = sorted(alive)
                if len(pool) <= scenario.pool_size:
                    continue
                target = f"osd.{rng.choice(pool)}"
            if entry["args"].get("at") is None:
                entry["args"]["at"] = rng.randrange(0, 3)
            osd_id = int(target.split(".")[1])
            alive.discard(osd_id)
            dead.append(osd_id)
        elif e.action in ("kill_osd", "crash_osd", "restart_osd"):
            if target == "random_osd":
                floor = scenario.pool_size if e.action != "restart_osd" \
                    else 1
                pool = sorted(alive)
                if e.action != "restart_osd" and len(pool) <= floor:
                    continue            # plan refuses to wedge the pool
                target = f"osd.{rng.choice(pool)}"
            osd_id = int(target.split(".")[1])
            if e.action != "restart_osd":
                alive.discard(osd_id)
                dead.append(osd_id)
        elif e.action == "revive_osd":
            if target in ("random_osd", "random_down_osd"):
                if not dead:
                    continue
                target = f"osd.{rng.choice(sorted(dead))}"
            osd_id = int(target.split(".")[1])
            if osd_id in dead:
                dead.remove(osd_id)
            alive.add(osd_id)
        elif e.action == "partition":
            if not e.arg("a"):
                half = sorted(rng.sample(sorted(alive),
                                         max(1, len(alive) // 2)))
                rest = sorted(alive - set(half))
                entry["args"]["a"] = [f"osd.{o}" for o in half]
                entry["args"]["b"] = [f"osd.{o}" for o in rest]
            target = "cluster"
        elif e.action == "clock_skew":
            if target == "random_osd":
                target = f"osd.{rng.choice(sorted(alive))}"
            if entry["args"].get("skew") is None:
                entry["args"]["skew"] = round(rng.uniform(-2.0, 2.0), 3)
        elif e.action in ("net", "disk"):
            if target == "random_osd":
                target = f"osd.{rng.choice(sorted(alive))}"
        elif e.action == "bitrot":
            # victim object/osd resolve at apply time (needs the live
            # acked set); the pick still comes from the seeded stream
            target = target if target != "random_osd" else "runtime"
        elif e.action == "kill_mon":
            # the victim is WHOEVER leads at apply time (killing a
            # follower proves nothing): symbolic target, runtime
            # resolution — the plan itself stays bit-identical
            if target == "random_osd":
                target = "mon_leader"
        elif e.action == "revive_mon":
            if target == "random_osd":
                target = "mon_down"
        entry["target"] = target
        entry["seq"] = i
        plan.append(entry)
    return plan


# --------------------------------------------------------------- running


def _payload(rng, oid: str, gen: int, repeat: int) -> bytes:
    tag = f"{oid}-g{gen}-{rng.randrange(1 << 30)}-"
    return tag.encode() * repeat


# the one seeded zipfian sampler lives in load/dist.py;
# same stream consumption (one rng.random() per pick), so seeded
# scenarios recorded before the move replay bit-identically
from ceph_tpu_torch.load.dist import zipf_pick as _zipf_pick  # noqa: E402


def _store_factory(scenario: Scenario, tmpdir: Optional[str]):
    if scenario.store == "mem":
        return None
    import os

    from ceph_tpu_torch.cluster.bluestore import BlueStore
    from ceph_tpu_torch.cluster.filestore import FileStore

    # honor a scenario-configured capacity on file stores too, so the
    # capacity enforcement doesn't silently diverge by store backend
    cap = int(dict(scenario.config).get("memstore_device_bytes",
                                        1 << 30))

    def factory(osd_id: int):
        path = os.path.join(tmpdir, f"osd{osd_id}")
        if scenario.store == "file":
            return FileStore(path, checkpoint_every=64,
                             device_bytes=cap)
        return BlueStore(path, size=64 << 20, checkpoint_every=64)

    return factory


async def heal_cluster(cluster, dmn: DaemonInjector) -> None:
    """Fault-free the cluster before judging: crash-point teardowns
    still in flight must finish first (or the revive sweep races a
    daemon mid-power-cut), every injector rate zeroes, dead monitors
    rejoin the quorum (OSDs must boot against a healthy mon), and the
    dead OSDs revive with whatever durable store survived them.  Shared
    with the graft-load soak runner — one heal sequence, not two."""
    await cluster.drain_chaos()
    zero_rates(cluster)
    if len(cluster.mons) > 1:
        for m_ in list(cluster.mons):
            if m_.stopped:
                await cluster.revive_mon(m_.rank)
        await cluster.wait_for_leader()
    for osd_id in sorted(set(cluster.osd_configs) - set(cluster.osds)):
        await dmn.revive_osd(osd_id,
                             with_store=osd_id in cluster.osd_stores)


async def judge_invariants(cluster, dmn: DaemonInjector, io,
                           invariants, acked: Dict[str, bytes],
                           attempted: Optional[Dict[str, set]] = None,
                           mode: str = "acked", timeout: float = 60.0,
                           acked_crcs: Optional[Dict[str, int]] = None,
                           snaps: Optional[Dict] = None,
                           deadline_misses: Optional[List[str]] = None,
                           frontdoor=None,
                           ) -> List[str]:
    """THE invariant dispatch table, shared by chaos scenarios,
    graft-load soaks, and front-door scenarios (an invariant added here
    is immediately nameable from all three; a run naming one this table
    lacks fails loudly).  ``frontdoor`` is the application-level
    bookkeeping a FrontdoorState carries (chaos/frontdoor.py) — the
    snapshot/multipart/namespace invariants judge against it."""
    failures: List[str] = []
    for name in invariants:
        if name == "durability":
            failures += await inv.check_durability(
                io, acked, attempted=attempted, mode=mode,
                acked_crcs=acked_crcs, timeout=timeout)
        elif name == "health":
            failures += await inv.check_health(cluster, timeout=timeout)
        elif name == "acting":
            failures += await inv.check_acting(cluster, timeout=timeout)
        elif name == "snapshots":
            failures += await inv.check_snapshots(io, snaps or {},
                                                  timeout=timeout)
        elif name == "scrub":
            failures += await inv.check_scrub(cluster,
                                              timeout=timeout * 1.5)
        elif name == "lockdep":
            failures += inv.check_lockdep()
        elif name == "deadline":
            # recorded inline by the workload driver: every ack past
            # its client deadline is one failure line
            failures += list(deadline_misses or ())
        elif name == "shed":
            failures += inv.check_shed(cluster)
        elif name == "repair":
            failures += await inv.check_repair(cluster, timeout=timeout)
        elif name == "frontier":
            failures += await inv.check_frontier(
                cluster, marks=dmn.frontier_marks, timeout=timeout)
        elif name == "batch":
            failures += inv.check_batch(cluster)
        elif name in ("snapshot", "multipart", "namespace"):
            if frontdoor is None:
                failures.append(f"{name}: invariant requires a "
                                f"front-door workload context")
            elif name == "snapshot":
                failures += await inv.check_snapshot(frontdoor,
                                                     timeout=timeout)
            elif name == "multipart":
                failures += await inv.check_multipart(frontdoor,
                                                      timeout=timeout)
            else:
                failures += await inv.check_namespace(frontdoor,
                                                      timeout=timeout)
        else:
            failures.append(f"unknown invariant {name!r}")
    return failures


async def run_scenario(scenario: Scenario, seed: int,
                       tmpdir: Optional[str] = None,
                       device=None) -> Verdict:
    """Boot, thrash, heal, converge, judge.  Pure asyncio — callers
    wrap with ``asyncio.run`` (or the CLI does).  ``device``: the card
    the cluster runs on (CUDA unless named; raises without one)."""
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster
    from ceph_tpu_torch.utils.device import resolve_device_index

    device = resolve_device_index(device)
    schedule = build_schedule(scenario, seed)
    wl = stream(seed, "workload")
    rot = stream(seed, "bitrot")
    cfg = _fast_config()
    cfg.mon_osd_down_out_interval = 120.0    # scenarios bounce, not drain
    cfg.chaos_seed = seed
    for k, v in scenario.config:
        cfg.set(k, v)
    counters0 = dict(CHAOS.dump()["chaos"])
    cluster = await start_cluster(
        scenario.osds, config=cfg, n_mons=scenario.mons,
        with_mgr=scenario.load is not None,
        store_factory=_store_factory(scenario, tmpdir), device=device)
    dmn = DaemonInjector(cluster)
    acked: Dict[str, bytes] = {}
    acked_crcs: Dict[str, int] = {}
    attempted: Dict[str, set] = {}
    snaps: Dict[int, Dict[str, bytes]] = {}
    failures: List[str] = []
    gate_stats: Dict[str, int] = {}
    gate_rows: List[Dict] = []
    postmortem_path: Optional[str] = None
    ctx = None
    try:
        if scenario.load is not None:
            # storm scenarios: traffic comes from the
            # graft-load open-loop driver — one drive() window per
            # round, the soak composition inverted into the chaos
            # runner so scripts/chaos.py owns the storm library
            from ceph_tpu_torch.load.driver import LoadContext

            ctx = await LoadContext.create(scenario.load, seed,
                                           cluster=cluster)
            client = ctx.sessions[0]
            pool = ctx.pool
            io = ctx.io(0)
        else:
            client = await cluster.client()
            if scenario.pool_kind == "erasure":
                pool = await client.pool_create(
                    f"chaos_{scenario.name}"[:24], "erasure",
                    pg_num=scenario.pg_num,
                    ec_profile=dict(scenario.ec_profile or ()))
            else:
                pool = await client.pool_create(
                    f"chaos_{scenario.name}"[:24], "replicated",
                    pg_num=scenario.pg_num, size=scenario.pool_size)
            io = client.ioctx(pool)

        deadline_misses: List[str] = []
        loop = asyncio.get_event_loop()
        storm_t0 = loop.time()
        storm_epoch0 = cluster.mon.osdmap.epoch

        async def put(i: int, gen: int, timeout: float) -> None:
            if scenario.workload == "zipf":
                # zipfian hot objects: concurrent writers may race on
                # one oid — attempted-mode durability judges those
                oid = f"obj{_zipf_pick(wl, scenario.objects_per_round)}"
            else:
                oid = f"obj{i}"
            data = _payload(wl, oid, gen, scenario.payload_repeat)
            attempted.setdefault(oid, set()).add(data)
            t0 = loop.time()
            try:
                await io.write_full(oid, data, timeout=timeout)
            except (IOError, OSError, TimeoutError):
                return
            if scenario.op_deadline:
                elapsed = loop.time() - t0
                if elapsed > timeout + 0.25:
                    # the zero-acked-but-expired acceptance criterion:
                    # an ack arriving after the client's deadline means
                    # deadline shedding failed somewhere in the stack
                    deadline_misses.append(
                        f"deadline: {oid} acked {elapsed:.2f}s after "
                        f"submit, past its {timeout}s deadline")
            acked[oid] = data
            acked_crcs[oid] = crcmod.crc32c(0xFFFFFFFF, data)

        put_timeout = scenario.op_deadline or scenario.write_timeout
        for rnd in range(scenario.rounds):
            evs = [e for e in schedule if e["round"] == rnd]
            for e in [e for e in evs if not e["during_writes"]
                      and not e.get("after_writes")]:
                await _apply_event(cluster, dmn, client, io, e, rot,
                                   acked, pool)
            mid = [e for e in evs if e["during_writes"]]
            if scenario.load is not None:
                from ceph_tpu_torch.load.driver import build_plan, drive

                plan = build_plan(scenario.load, seed + rnd * 1000003)
                window = loop.create_task(
                    drive(ctx, scenario.load, seed, plan=plan,
                          record_acked=True))
                try:
                    if mid:
                        await asyncio.sleep(0.15 + wl.random() * 0.2)
                        for e in mid:
                            await _apply_event(cluster, dmn, client, io,
                                               e, rot, acked, pool)
                            # staggered AND overlapping: a seeded beat
                            # between storm events so each bounce races
                            # the previous one's re-peering, all under
                            # the in-flight load window
                            await asyncio.sleep(wl.random() * 0.25)
                    result = await window
                except BaseException:
                    # a failed mid-round injection must not orphan the
                    # in-flight load window (the soak rule)
                    window.cancel()
                    try:
                        await window
                    except (asyncio.CancelledError, Exception):
                        pass
                    raise
                deadline_misses += result.late_acks
                for oid, data in result.acked.items():
                    acked[oid] = data
                    acked_crcs[oid] = crcmod.crc32c(0xFFFFFFFF, data)
                for oid, tries in result.attempted.items():
                    attempted.setdefault(oid, set()).update(tries)
            elif mid:
                burst = asyncio.gather(
                    *[put(i, rnd,
                          timeout=scenario.op_deadline or 20.0)
                      for i in range(scenario.objects_per_round)],
                    return_exceptions=True)
                await asyncio.sleep(wl.random() * 0.05)
                for e in mid:
                    await _apply_event(cluster, dmn, client, io, e, rot,
                                       acked, pool)
                for r in await burst:
                    # put() absorbs expected I/O failures itself —
                    # anything else escaping a racing write is a
                    # runner bug and must surface, not vanish
                    if isinstance(r, BaseException) and \
                            not isinstance(r, asyncio.CancelledError):
                        raise r
            elif scenario.burst_concurrency:
                # offered-load burst bounded at burst_concurrency
                # in-flight writes — the overload regime the admission
                # budget absorbs
                gate = asyncio.Semaphore(scenario.burst_concurrency)

                async def bounded_put(i, gen):
                    async with gate:
                        await put(i, gen, timeout=put_timeout)

                burst_res = await asyncio.gather(
                    *[bounded_put(i, rnd)
                      for i in range(scenario.objects_per_round)],
                    return_exceptions=True)
                for r in burst_res:
                    # put() absorbs expected I/O failures itself —
                    # anything else is a runner bug and must surface
                    if isinstance(r, BaseException) and \
                            not isinstance(r, asyncio.CancelledError):
                        raise r
            else:
                for i in range(scenario.objects_per_round):
                    await put(i, rnd, timeout=put_timeout)
            for e in [e for e in evs if e.get("after_writes")]:
                await _apply_event(cluster, dmn, client, io, e, rot,
                                   acked, pool)
            if scenario.snapshots:
                sid = await io.snap_create(f"chaos_s{rnd}")
                snaps[sid] = dict(acked)

        # -- storm gates: epochs/s generated while the fault
        #    schedule ran — a churn burst the control plane cannot keep
        #    up with shows as a collapsed rate (coalescing keeps the
        #    COUNT low by design, so the floor judges rate, not count)
        storm_wall = max(1e-6, loop.time() - storm_t0)
        epochs_generated = cluster.mon.osdmap.epoch - storm_epoch0
        gate_stats["epochs_generated"] = epochs_generated
        gate_stats["storm_wall_ms"] = int(storm_wall * 1000)
        if scenario.epochs_floor > 0:
            rate = epochs_generated / storm_wall
            gate_rows.append({"gate": "epochs",
                              "value": round(rate, 3),
                              "threshold": scenario.epochs_floor,
                              "passed": rate >= scenario.epochs_floor})
            if rate < scenario.epochs_floor:
                failures.append(
                    f"epochs: {epochs_generated} epochs in "
                    f"{storm_wall:.1f}s = {rate:.2f}/s < floor "
                    f"{scenario.epochs_floor}/s")

        # -- heal + converge + judge (shared with graft-load soak) ------
        await heal_cluster(cluster, dmn)
        heal_t0 = loop.time()
        await _converge(cluster, scenario.converge_timeout)
        if scenario.health_ok_bound > 0:
            # bounded time-to-HEALTH_OK measured from the heal point:
            # the cluster must not merely converge eventually, it must
            # converge in bounded time after the storm stops
            ok_deadline = heal_t0 + max(scenario.converge_timeout,
                                        scenario.health_ok_bound)
            health_ok_s = None
            while loop.time() < ok_deadline:
                if cluster.mon._health_data()["status"] == "HEALTH_OK":
                    health_ok_s = loop.time() - heal_t0
                    break
                await asyncio.sleep(0.2)
            gate_rows.append(
                {"gate": "health_time",
                 "value": None if health_ok_s is None
                 else round(health_ok_s, 3),
                 "threshold": scenario.health_ok_bound,
                 "passed": health_ok_s is not None
                 and health_ok_s <= scenario.health_ok_bound})
            if health_ok_s is None:
                failures.append(
                    f"health_time: no HEALTH_OK within "
                    f"{ok_deadline - heal_t0:.0f}s of heal")
            else:
                gate_stats["health_ok_ms"] = int(health_ok_s * 1000)
                if health_ok_s > scenario.health_ok_bound:
                    failures.append(
                        f"health_time: HEALTH_OK took "
                        f"{health_ok_s:.1f}s > bound "
                        f"{scenario.health_ok_bound}s")
        inv_failures = await judge_invariants(
            cluster, dmn, io, scenario.invariants, acked,
            attempted=attempted, mode=scenario.durability_mode,
            timeout=scenario.converge_timeout, acked_crcs=acked_crcs,
            snaps=snaps, deadline_misses=deadline_misses)
        failures += inv_failures
        gate_rows.append({"gate": "invariants",
                          "value": len(inv_failures), "threshold": 0,
                          "passed": not inv_failures})
        if failures and getattr(cfg, "blackbox_enabled", 0):
            # graft-blackbox: a convicted scenario triggers a bundle
            # BEFORE teardown, while the breach evidence is still in
            # the daemons' rings.  The reason carries only the failure
            # HEAD (the gate/invariant name): the full failure strings
            # embed wall timings and live in the detail — the reason
            # feeds replay_key, which must be bit-identical across two
            # runs of one seed
            pm_rec = await cluster.blackbox_trigger(
                "chaos_conviction",
                f"scenario {scenario.name} seed={seed} convicted: "
                f"{failures[0].split(':', 1)[0]}",
                detail={"scenario": scenario.name, "seed": seed,
                        "gates": [g for g in gate_rows
                                  if not g["passed"]],
                        "failures": list(failures)},
                clients=(ctx.sessions if ctx is not None else ()))
            postmortem_path = (pm_rec or {}).get("path")
    finally:
        if ctx is not None:
            await ctx.close()  # no-op: the scenario owns the cluster
        await cluster.stop()
    counters1 = CHAOS.dump()["chaos"]
    delta = {k: counters1[k] - counters0.get(k, 0) for k in counters1
             if counters1[k] - counters0.get(k, 0)}
    delta.update(gate_stats)
    return Verdict(name=scenario.name, seed=seed, schedule=schedule,
                   passed=not failures, failures=failures,
                   acked_objects=len(acked), counters=delta,
                   gates=gate_rows, postmortem=postmortem_path)


async def _apply_event(cluster, dmn: DaemonInjector, client, io,
                       e: Dict, rot, acked: Dict[str, bytes],
                       pool: int) -> None:
    action, target, args = e["action"], e["target"], e["args"]
    if action == "kill_osd":
        osd_id = int(target.split(".")[1])
        if osd_id in cluster.osds:
            await dmn.kill_osd(osd_id)
    elif action == "crash_osd":
        osd_id = int(target.split(".")[1])
        if osd_id in cluster.osds:
            await dmn.crash_osd(osd_id,
                                torn_tail=bool(args.get("torn_tail")),
                                lose_frames=int(args.get("lose_frames",
                                                         0)))
    elif action == "revive_osd":
        osd_id = int(target.split(".")[1])
        if osd_id not in cluster.osds:
            await dmn.revive_osd(
                osd_id, with_store=osd_id in cluster.osd_stores)
    elif action == "restart_osd":
        osd_id = int(target.split(".")[1])
        if osd_id in cluster.osds:
            await dmn.restart_osd(osd_id)
    elif action == "crash_point":
        for cfg in _target_configs(cluster, target):
            cfg.injectargs({
                "chaos_crash_point": args["point"],
                "chaos_crash_point_skip": int(args.get("at", 0))})
    elif action in ("net", "disk"):
        for cfg in _target_configs(cluster, target):
            cfg.injectargs({k: v for k, v in args.items()
                            if k.startswith("chaos_")})
    elif action == "clock_skew":
        for cfg in _target_configs(cluster, target):
            cfg.injectargs({"chaos_clock_skew": args["skew"]})
    elif action == "crash_mds":
        # power-cut an MDS rank: its journal + dirfrags live
        # in RADOS; the restarted rank's boot replay is the recovery
        rank = int(target.split(".")[1]) if "." in target else 0
        if (cluster.mdss or {}).get(rank) is not None:
            await cluster.crash_mds(rank)
            CHAOS.inc("daemon_kills")
    elif action == "revive_mds":
        rank = int(target.split(".")[1]) if "." in target else 0
        pools = cluster.mds_pools.get(rank)
        if pools is not None and (cluster.mdss or {}).get(rank) is None:
            await cluster.start_mds(pools[0], pools[1], rank=rank)
            CHAOS.inc("daemon_revives")
    elif action == "kill_mon":
        rank = None
        if target == "mon_leader":
            rank = next((m_.rank for m_ in cluster.mons
                         if m_.is_leader), None)
        else:
            rank = int(target.split(".")[1])
        if rank is not None and not cluster.mons[rank].stopped:
            await dmn.kill_mon(rank)
    elif action == "revive_mon":
        if target == "mon_down":
            rank = next((m_.rank for m_ in cluster.mons
                         if m_.stopped), None)
        else:
            rank = int(target.split(".")[1])
        if rank is not None and cluster.mons[rank].stopped:
            await cluster.revive_mon(rank)
    elif action == "partition":
        partition(cluster, list(args["a"]), list(args["b"]),
                  symmetric=bool(args.get("symmetric", True)))
    elif action == "heal_partition":
        heal_partitions(cluster)
    elif action == "bitrot":
        await _apply_bitrot(cluster, client, e, rot, acked, pool)
    else:
        raise ValueError(f"unknown chaos action {action!r}")


def _target_configs(cluster, target: str):
    if target in ("all_osds", "cluster"):
        for o in cluster.osds.values():
            yield o.config
        if target == "cluster":
            for m in cluster.mons:
                yield m.config
    elif target.startswith("osd."):
        osd = cluster.osds.get(int(target.split(".")[1]))
        if osd is not None:
            yield osd.config
    elif target.startswith("mds"):
        _, _, num = target.partition(".")
        daemon = (cluster.mdss or {}).get(int(num) if num else 0)
        if daemon is not None:
            yield daemon.config
    elif target.startswith("mon"):
        _, _, num = target.partition(".")
        rank = int(num) if num else 0
        if rank < len(cluster.mons):
            yield cluster.mons[rank].config
    elif target == "client":
        for c in cluster.clients:
            yield c.objecter.config


async def _apply_bitrot(cluster, client, e: Dict, rot,
                        acked: Dict[str, bytes], pool: int) -> None:
    """Flip one bit of one acked object on one acting member, straight
    into the store behind the OSD's back — silent corruption that only
    scrub (or a csum-verifying read) can see."""
    if not acked:
        return
    oid = rot.choice(sorted(acked))
    pgid = client.objecter.object_pgid(pool, oid)
    coll = f"pg_{pgid.pool}_{pgid.seed}"
    _, _, acting, _ = client.objecter.osdmap.pg_to_up_acting_osds(pgid)
    live = [o for o in acting if o >= 0 and o in cluster.osds]
    if not live:
        return
    victim = rot.choice(live)
    inj = DiskInjector(rot)
    try:
        inj.flip_bit(cluster.osds[victim].store, coll, oid,
                     bit=e["args"].get("bit"))
    except (FileNotFoundError, ValueError):
        pass


async def _converge(cluster, timeout: float) -> None:
    """All OSDs up in the mon map and every daemon caught up to the
    epoch (best-effort: invariants do the real judging).  An id that a
    drain purged from the map is no OSD to wait for: the reference waits
    for it, and so spends its whole ``timeout`` after every drain."""
    deadline = asyncio.get_event_loop().time() + timeout
    n = cluster.mon.osdmap.max_osd
    while asyncio.get_event_loop().time() < deadline:
        m = cluster.mon.osdmap
        if all(m.osd_up[o] for o in range(n) if m.osd_exists[o]):
            break
        await asyncio.sleep(0.1)
    try:
        await cluster.wait_for_epoch(cluster.mon.osdmap.epoch,
                                     timeout=max(
                                         1.0, deadline -
                                         asyncio.get_event_loop().time()))
    except TimeoutError:
        pass


# public seams for graft-load soak composition: the soak
# runner applies the SAME resolved fault plans through the same
# machinery, so "load + chaos" is composition, not reimplementation
apply_event = _apply_event
wait_converged = _converge
store_factory_for = _store_factory


# --------------------------------------------------------------- builtins


def storm_scenarios(scale: float = 1.0) -> Dict[str, Scenario]:
    """The control-plane storm library, sized by ``scale``.

    1.0 is the full acceptance shape (slow: hundreds of OSD bounces /
    a Paxos leader killed mid-epoch-burst, both under sustained
    graft-load traffic); ``scripts/chaos.py --scale`` and the tier-1
    smoke tests run a small fraction of it on the same code paths.
    Bounces are staggered (seeded beats between events) AND overlapping
    (mid-window, racing the load driver's in-flight traffic and each
    other's re-peering).  The gates: bounded time-to-HEALTH_OK after
    heal, and an epochs/s floor while the storm ran — the full-size
    floor is real; scaled runs keep a token floor (wall time on the
    load-sensitive bench host would make a tight scaled floor flappy,
    BENCH_NOTES round 14)."""
    from ceph_tpu_torch.load.driver import LoadSpec

    s = max(0.03, min(1.0, scale))
    full = s >= 1.0
    bounces = max(4, int(round(100 * s)))
    osds = max(5, min(12, int(round(12 * s))))
    rounds = max(2, min(10, (bounces + 11) // 12))
    per = [bounces // rounds + (1 if r < bounces % rounds else 0)
           for r in range(rounds)]
    rr_events = tuple(
        ev(r, "restart_osd", during_writes=bool(i % 2))
        for r, n in enumerate(per) for i in range(n))
    rr_load = LoadSpec(
        name="rr100", clients=max(8, int(48 * s)), sessions=4,
        rate=1.0, duration=2.0, objects=24, payload=1024,
        op_deadline=20.0, osds=osds, pg_num=16, store="file",
        verbs=(("write", 4.0), ("read", 3.0), ("append", 1.0)))
    mb_rounds = 4 if full else 3
    mb_osds = max(5, min(8, int(round(8 * s))))
    mb_events = tuple(
        ev(r, "restart_osd", during_writes=True)
        for r in range(mb_rounds)
        for _ in range(max(1, int(round(3 * s))))
    ) + (
        # the leader dies MID-epoch-burst (during_writes, while the
        # round's restarts are churning map epochs through Paxos)
        ev(1, "kill_mon", target="mon_leader", during_writes=True),
        ev(min(2, mb_rounds - 1), "revive_mon", target="mon_down"),
    )
    mb_load = LoadSpec(
        name="monbounce", clients=max(8, int(32 * s)), sessions=4,
        rate=1.0, duration=2.0, objects=24, payload=1024,
        op_deadline=20.0, osds=mb_osds, pg_num=16, store="file",
        verbs=(("write", 4.0), ("read", 3.0), ("append", 1.0)))
    common = dict(
        pool_size=3, pg_num=16, store="file",
        durability_mode="attempted",
        invariants=("durability", "frontier", "acting", "health",
                    "lockdep"),
        # storms outlive the default 120s down-out window; a bounced
        # OSD must never be auto-outed before its own revive
        config=(("mon_osd_down_out_interval", 600.0),),
        # the full-size bound sits ABOVE the worst client-budget tail:
        # an op admitted just before heal may legitimately retry to the
        # 90s rados budget, holding SLOW_OPS (and so HEALTH_WARN) that
        # long — 180s = budget tail + markdown/boot margin on the
        # load-sensitive host (measured 112s; BENCH_NOTES round 14)
        health_ok_bound=180.0 if full else 60.0,
        epochs_floor=0.3 if full else 0.02,
        write_timeout=60.0,
        converge_timeout=180.0 if full else 90.0)
    return {
        # hundreds of staggered+overlapping OSD bounces under sustained
        # load-driver traffic (the storm's acceptance shape)
        "rolling-restart-100": Scenario(
            name="rolling-restart-100", osds=osds, rounds=rounds,
            load=rr_load, events=rr_events, **common),
        # Paxos leader killed mid-epoch-burst while OSD churn keeps the
        # map service hot; the quorum must fail over, keep marking
        # downs/ups, and converge in bounded time
        "mon-bounce-under-churn": Scenario(
            name="mon-bounce-under-churn", osds=mb_osds, mons=3,
            rounds=mb_rounds, load=mb_load, events=mb_events, **common),
    }


def builtin_scenarios() -> Dict[str, Scenario]:
    """The shipped scenario library (scripts/chaos.py `list`)."""
    out = storm_scenarios(1.0)
    out.update(_base_scenarios())
    return out


def _base_scenarios() -> Dict[str, Scenario]:
    return {
        # tier-1 smoke: one OSD killed and revived under 10% drop
        "smoke": Scenario(
            name="smoke", osds=4, pool_size=3, pg_num=4, rounds=2,
            objects_per_round=4, payload_repeat=20,
            events=(
                ev(0, "net", target="all_osds", chaos_net_drop=0.10),
                ev(0, "kill_osd"),
                ev(1, "revive_osd"),
            ),
            invariants=("durability", "acting", "health", "lockdep"),
            converge_timeout=45.0),
        # the acceptance gate: partition + kill + torn-write journal
        "partition-kill-torn": Scenario(
            name="partition-kill-torn", osds=5, pool_size=3, pg_num=8,
            rounds=3, objects_per_round=5, store="file",
            events=(
                ev(0, "partition"),
                ev(1, "heal_partition"),
                ev(1, "crash_osd", torn_tail=True),
                ev(2, "revive_osd"),
            ),
            invariants=("durability", "acting", "health", "scrub",
                        "lockdep"),
            converge_timeout=90.0),
        # per-daemon clock skew vs heartbeats/leases
        "clock-skew": Scenario(
            name="clock-skew", osds=3, pool_size=3, pg_num=4, rounds=2,
            objects_per_round=4,
            events=(
                ev(0, "clock_skew"),
                ev(1, "clock_skew", skew=0.0),
            ),
            invariants=("durability", "acting", "health", "lockdep"),
            converge_timeout=45.0),
        # silent bit-rot found and repaired by scrub
        "bitrot-scrub": Scenario(
            name="bitrot-scrub", osds=3, pool_size=3, pg_num=4,
            rounds=2, objects_per_round=4,
            # after_writes: the flip must land on bytes nothing will
            # overwrite again, or scrub has nothing real to find.
            # scrub runs FIRST: it must repair the flip (majority
            # authoritative copy) before durability reads the object —
            # a read routed to the corrupt replica would otherwise fail
            # the run that scrub was about to heal
            events=(ev(1, "bitrot", after_writes=True),),
            invariants=("scrub", "durability", "acting", "health",
                        "lockdep"),
            converge_timeout=60.0),
        # replicated thrash: restart bounces under load, snapshots on
        "thrash-replicated": Scenario(
            name="thrash-replicated", osds=5, pool_size=3, pg_num=8,
            rounds=4, objects_per_round=8, snapshots=True,
            events=(
                ev(0, "restart_osd"),
                ev(1, "restart_osd"),
                ev(2, "restart_osd"),
                ev(3, "restart_osd"),
            ),
            invariants=("durability", "snapshots", "acting", "health",
                        "scrub", "lockdep"),
            converge_timeout=60.0),
        # graceful degradation under overload (the acceptance
        # gate): zipfian write bursts at 4x the admission budget with a
        # shard holder killed mid-run.  Verdict = durability + "no
        # acked op exceeded its deadline" + "shed count > 0" + HEALTH
        # converging clear of a SLOW_OPS storm.  Slow-marked (see
        # overload-smoke for the tier-1 variant).
        "overload-shed": Scenario(
            name="overload-shed", osds=4, pool_kind="erasure",
            pool_size=3, pg_num=4,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            rounds=3, objects_per_round=24, payload_repeat=40,
            durability_mode="attempted", workload="zipf",
            burst_concurrency=24, op_deadline=20.0,
            config=(("osd_op_throttle_ops", 6),),   # 24 offered vs 6
            events=(
                ev(1, "kill_osd"),
                ev(2, "revive_osd"),
            ),
            invariants=("durability", "deadline", "shed", "acting",
                        "health", "lockdep"),
            converge_timeout=90.0),
        # tier-1 smoke variant: one small 4x burst, no faults, purely
        # structural assertions (shed fired, nothing acked late, the
        # cluster converges) — the bench host is load-sensitive, so no
        # timing thresholds here
        "overload-smoke": Scenario(
            name="overload-smoke", osds=3, pool_size=3, pg_num=4,
            rounds=1, objects_per_round=12, payload_repeat=20,
            durability_mode="attempted", workload="zipf",
            burst_concurrency=12, op_deadline=25.0,
            config=(("osd_op_throttle_ops", 3),),   # 12 offered vs 3
            invariants=("durability", "deadline", "shed", "acting",
                        "health", "lockdep"),
            converge_timeout=45.0),
        # tier-1 batch-chaos smoke: seeded per-item frame
        # drops + duplicated/shuffled batched acks on every daemon,
        # plus one tick-boundary crash point, under concurrent EC
        # writes on a durable store.  Verdict: durability + the new
        # frontier invariant (no open entry survives convergence, the
        # persisted watermark matches memory and never regressed) +
        # batch (the coalesced plane actually ran).
        "batch-smoke": Scenario(
            name="batch-smoke", osds=4, pool_kind="erasure",
            pool_size=3, pg_num=8, store="file",
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            rounds=2, objects_per_round=12, payload_repeat=30,
            durability_mode="attempted", burst_concurrency=12,
            events=(
                ev(0, "net", target="all_osds",
                   chaos_net_batch_item_drop=0.15,
                   chaos_net_batch_ack_dup=0.2,
                   chaos_net_batch_ack_reorder=0.2),
                ev(0, "crash_point", point="commit_mid_fanout"),
                ev(1, "revive_osd"),
            ),
            invariants=("durability", "frontier", "batch", "acting",
                        "health", "lockdep"),
            converge_timeout=60.0),
        # tick-boundary crash points across the commit pipeline + a
        # peer killed mid-tick applying a batch frame (slow)
        "batch-kill-midtick": Scenario(
            name="batch-kill-midtick", osds=5, pool_kind="erasure",
            pool_size=3, pg_num=8, store="file",
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            rounds=4, objects_per_round=8, payload_repeat=40,
            durability_mode="attempted", burst_concurrency=8,
            events=(
                ev(0, "net", target="all_osds",
                   chaos_net_batch_item_drop=0.1),
                ev(0, "crash_point", point="batch_apply_mid"),
                ev(1, "revive_osd"),
                ev(1, "crash_point", point="tick_post_encode"),
                ev(2, "revive_osd"),
                ev(2, "crash_point", point="frontier_pre_done"),
                ev(3, "revive_osd"),
            ),
            invariants=("durability", "frontier", "batch", "acting",
                        "health", "scrub", "lockdep"),
            converge_timeout=120.0),
        # rolling restarts (slow): bounce several OSDs under
        # sustained writes on the sharded WQ; time-to-HEALTH_OK is
        # bounded by the health invariant's converge_timeout, with
        # zero durability/frontier violations
        "rolling-restart-sharded": Scenario(
            name="rolling-restart-sharded", osds=6, pool_size=3,
            pg_num=16, rounds=4, objects_per_round=10,
            payload_repeat=40, durability_mode="attempted",
            store="file",
            events=(
                ev(0, "restart_osd", during_writes=True),
                ev(1, "restart_osd", during_writes=True),
                ev(2, "restart_osd", during_writes=True),
                ev(3, "restart_osd", during_writes=True),
            ),
            invariants=("durability", "frontier", "acting", "health",
                        "scrub", "lockdep"),
            converge_timeout=90.0),
        # EC primaries crashed mid-write (the rewind thrasher)
        "thrash-ec-midwrite": Scenario(
            name="thrash-ec-midwrite", osds=4, pool_kind="erasure",
            pg_num=4,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            rounds=3, objects_per_round=4, durability_mode="attempted",
            events=(
                ev(0, "restart_osd", during_writes=True),
                ev(1, "restart_osd", during_writes=True),
                ev(2, "restart_osd", during_writes=True),
            ),
            invariants=("durability", "scrub", "acting", "health",
                        "lockdep"),
            converge_timeout=90.0),
    }

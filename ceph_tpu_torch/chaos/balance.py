"""Elastic-cluster scenarios: live expansion, drain, and balancer
convergence as judged, seeded, replayable runs.

Counterpart of ``ceph_tpu/chaos/balance.py``.  ``run_elastic`` takes the
``device`` every daemon and client of its cluster runs on: CUDA unless
the caller names another (``device="cpu"`` for the plain versions); it
raises when CUDA is absent and no device was named.  The mon's batched
placement (``pool_mapping``) and the mgr's scorer run on that device;
the slot-move ledger below reads their results as numpy arrays.

Three acceptance shapes ride here, all built by
:func:`elastic_scenarios` and run by :func:`run_elastic` over an
:class:`ElasticScenario`:

- ``expand-drain`` — the full reshape choreography under sustained
  graft-load: boot N OSDs, prefill + keep traffic flowing, grow N->2N
  through the mgr's reshape op (``balance grow`` mints ids + CRUSH
  hosts via one mon Incremental, the runner boots the daemons — the
  operator's half of the handshake), run balancer rounds until the
  data spreads, then drain the grown OSDs back out (``balance drain``:
  out -> wait-clean -> stop daemons -> purge).  The verdict: bounded
  time-to-HEALTH_OK after each reshape, rebalance slot-moves within a
  declared factor of the weight-proportional optimal, every SLO gate
  green over the traffic window, and zero acked-then-lost bytes.

- ``balance-convergence`` — the optimizer alone: a pool whose CRUSH
  placement carries natural straw2 variance, balancer rounds under a
  live load window until the committed move stream dries up.  Judged
  on monotone skew (final pg-per-OSD stddev no worse than initial),
  at least ``balance_moves_min`` committed moves on the SLO scrape,
  and — at full scale — >= ``min_candidates`` candidate maps scored
  per the ``mgr_balancer_candidates`` counter (the >=1000/tick
  acceptance line, counter-verified).

- ``expand-drain-smoke`` — the same expand-drain code path at a fixed
  tier-1 size (seconds, not minutes); the chaos CLI
  (``python -m ceph_tpu_torch.tools.chaos``) lists it as a builtin.

Phase plans come from :func:`build_elastic_plan` — a pure function of
(scenario, seed) whose encoding is the replay witness, like chaos
schedules and graft-load plan keys.  Runtime outcomes (move counts,
health wait times) ride the verdict's counters, never the plan.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.daemons import DaemonInjector
from ceph_tpu_torch.chaos.scenario import (
    Verdict,
    heal_cluster,
    judge_invariants,
    wait_converged,
)
from ceph_tpu_torch.load.driver import LoadSpec, build_plan, drive, plan_key


def elastic_scenarios(scale: float = 1.0) -> Dict[str, "ElasticScenario"]:
    """The elastic library, sized by ``scale`` (1.0 = the full
    acceptance shape; small fractions run the same code paths at tier-1
    size).  ``expand-drain-smoke`` is ALWAYS the fixed tier-1 shape,
    independent of scale — the listing's cheap entry point."""
    s = max(0.03, min(1.0, scale))
    full = s >= 1.0
    grow_load = LoadSpec(
        name="elastic-grow", clients=max(8, int(64 * s)), sessions=4,
        rate=1.0, duration=10.0 if full else 3.0,
        objects=32, payload=2048, op_deadline=25.0,
        osds=4, pool_size=2, pg_num=32 if full else 16,
        # reshape churn vs the goodput floor: writes + reads only (the
        # durability namespace), generous deadline
        verbs=(("write", 4.0), ("read", 3.0)),
        gates=(("goodput_min_frac", 0.5), ("p99_ms", 5000.0),
               ("cwnd_floor", 2.0), ("qos_reservation_min", 0.0),
               ("balance_moves_min", 1.0)))
    conv_load = LoadSpec(
        name="balance-conv", clients=max(8, int(48 * s)), sessions=4,
        rate=1.0, duration=6.0 if full else 2.0,
        objects=32, payload=2048, op_deadline=25.0,
        osds=5, pool_size=2, pg_num=64 if full else 16,
        verbs=(("write", 4.0), ("read", 3.0)),
        gates=(("goodput_min_frac", 0.5), ("p99_ms", 5000.0),
               ("cwnd_floor", 2.0), ("qos_reservation_min", 0.0),
               ("balance_moves_min", 0.0)))
    lib = {
        "expand-drain": ElasticScenario(
            name="expand-drain", osds=4, grow=4,
            pg_num=32 if full else 16, load=grow_load,
            health_timeout=60.0 if full else 30.0,
            converge_timeout=90.0 if full else 60.0),
        "balance-convergence": ElasticScenario(
            name="balance-convergence", osds=5, grow=0, drain_back=False,
            pg_num=64 if full else 16, load=conv_load,
            min_candidates=1000 if full else 0,
            health_timeout=60.0 if full else 30.0,
            converge_timeout=90.0 if full else 60.0),
        "expand-drain-smoke": ElasticScenario(
            name="expand-drain-smoke", osds=3, grow=3, pg_num=16,
            load=LoadSpec(
                name="elastic-smoke", clients=8, sessions=2, rate=1.0,
                duration=2.0, objects=16, payload=1024,
                op_deadline=25.0, osds=3, pool_size=2, pg_num=16,
                verbs=(("write", 4.0), ("read", 3.0)),
                gates=(("goodput_min_frac", 0.5), ("p99_ms", 5000.0),
                       ("cwnd_floor", 2.0),
                       ("qos_reservation_min", 0.0),
                       ("balance_moves_min", 1.0))),
            health_timeout=30.0, converge_timeout=60.0),
    }
    return lib


@dataclass(frozen=True)
class ElasticScenario:
    """One elastic-reshape acceptance shape.  ``grow`` new OSDs ride in
    through the mgr reshape op; ``drain_back`` sends them back out
    after the rebalance (the full N->2N->N cycle).  ``move_factor``
    bounds observed slot-moves against the weight-proportional optimal
    (straw2 is consistent but not minimal, and upmap corrections add
    their own moves — 3x is the declared envelope)."""

    name: str
    osds: int = 4
    grow: int = 4
    drain_back: bool = True
    pool_size: int = 2
    pg_num: int = 16
    load: LoadSpec = field(default_factory=lambda: LoadSpec(
        name="elastic", clients=8, sessions=2, duration=2.0))
    balancer_rounds: int = 8         # optimize-tick budget per phase
    move_factor: float = 3.0         # moved slots <= factor * optimal
    min_candidates: int = 0          # mgr_balancer_candidates floor
    health_timeout: float = 30.0     # time-to-HEALTH_OK bound per phase
    converge_timeout: float = 60.0
    invariants: Tuple[str, ...] = ("durability", "acting", "health",
                                   "lockdep")
    config: Tuple[Tuple[str, object], ...] = ()
    store: str = "mem"               # the chaos CLI's tmpdir contract
    rounds: int = 1                  # `list` display only


def build_elastic_plan(sc: ElasticScenario, seed: int) -> List[Dict]:
    """The seed-deterministic phase plan.  The load window's plan_key is
    the graft-load replay witness (pure in (spec, seed)); grow ids are
    symbolic ("the next ``grow`` ids the mon mints") because id minting
    is itself deterministic (base = max_osd).  Runtime outcomes — moves
    committed, health wait — are counters, never plan."""
    phases: List[Dict] = [
        {"phase": "load", "spec": sc.load.name,
         "plan_key": plan_key(build_plan(sc.load, seed))},
    ]
    if sc.grow:
        phases.append({"phase": "grow", "count": sc.grow,
                       "osds_per_host": 1})
    phases.append({"phase": "rebalance", "rounds": sc.balancer_rounds,
                   "move_factor": sc.move_factor})
    if sc.grow and sc.drain_back:
        phases.append({"phase": "drain", "target": "grown"})
    phases.append({"phase": "verify", "invariants": list(sc.invariants)})
    return phases


# ---------------------------------------------------------------- runner


def _mapping_snapshot(m) -> Dict[int, "np.ndarray"]:
    """Per-pool up-mapping arrays — the before/after slot-move ledger."""
    return {pid: np.asarray(m.pool_mapping(pid)[0]).copy()
            for pid in m.pools}


def _moved_slots(before: Dict[int, "np.ndarray"],
                 after: Dict[int, "np.ndarray"]) -> int:
    """PG slots whose placement changed between two snapshots.  Order
    within a PG's up set is placement-relevant (primary), so this is an
    elementwise compare — the same metric placement_delta grades."""
    n = 0
    for pid, b in before.items():
        a = after.get(pid)
        if a is None or a.shape != b.shape:
            # pool reshaped (pg_num change): every slot of the larger
            # shape counts as churn
            n += int(max(a.size if a is not None else 0, b.size))
            continue
        n += int((a != b).any(axis=1).sum())
    return n


async def _wait_health_ok(cluster, timeout: float) -> float:
    """Seconds until the mon reports HEALTH_OK, or -1.0 on timeout."""
    loop = asyncio.get_event_loop()
    t0 = loop.time()
    while loop.time() - t0 < timeout:
        if cluster.mon._health_data()["status"] == "HEALTH_OK":
            return loop.time() - t0
        await asyncio.sleep(0.1)
    return -1.0


async def _optimize_until_dry(cluster, budget: int,
                              timeout: float = 30.0) -> Tuple[int, Dict]:
    """Run balancer rounds until a round commits nothing (or the budget
    runs out).  Throttled rounds — recovery pressure, the cluster still
    digesting the reshape's own backfill — don't consume the round
    budget, only the wall-clock ``timeout``; that throttle-then-proceed
    arc is part of what the scenario exercises.  Returns (total moves
    committed, last round dict)."""
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    moves = 0
    rounds = 0
    last: Dict = {}
    while rounds < max(1, budget) and loop.time() < deadline:
        last = await cluster.daemon_command(
            "mgr", {"prefix": "balance optimize"}, timeout=30.0)
        if last.get("skipped"):
            await asyncio.sleep(0.3)
            continue
        rounds += 1
        if not last.get("committed"):
            break
        moves += int(last.get("moves", 0))
    return moves, last


async def _reshape_wait(cluster, op_id: int, want_phase: str,
                        timeout: float) -> Dict:
    """Poll ``balance status`` (each poll advances open reshape ops —
    the pull-driven contract) until op ``op_id`` reaches ``want_phase``
    or ``done``.  Returns the op's final status dict."""
    loop = asyncio.get_event_loop()
    deadline = loop.time() + timeout
    st: Dict = {}
    while loop.time() < deadline:
        status = await cluster.daemon_command(
            "mgr", {"prefix": "balance status"}, timeout=30.0)
        ops = {o["id"]: o for o in status.get("reshape_ops", [])}
        st = ops.get(op_id, {})
        if st.get("phase") in (want_phase, "done"):
            return st
        await asyncio.sleep(0.1)
    return st


async def run_elastic(sc: ElasticScenario, seed: int,
                      tmpdir: Optional[str] = None,
                      device=None) -> Verdict:
    """Boot, load, grow, rebalance, drain, judge — the elastic
    acceptance runner.  ``device``: the card the cluster runs on (CUDA
    unless named; raises without one)."""
    from ceph_tpu_torch.load import slo
    from ceph_tpu_torch.load.driver import LoadContext

    plan = build_elastic_plan(sc, seed)
    # the load context boots the cluster (with_mgr=True — the balance
    # subsystem needs its host daemon) at the SCENARIO's shape
    spec = replace(sc.load, osds=sc.osds, pool_size=sc.pool_size,
                   pg_num=sc.pg_num,
                   config=tuple(sc.load.config) + tuple(sc.config))
    counters0 = dict(CHAOS.dump()["chaos"])
    stats: Dict[str, int] = {}
    failures: List[str] = []
    ctx = await LoadContext.create(spec, seed, tmpdir=tmpdir,
                                   device=device)
    cluster = ctx.cluster
    dmn = DaemonInjector(cluster)
    load_task = None
    try:
        before = await slo.snapshot(cluster)
        # -- LOAD: one open-loop window spanning the reshape ------------
        load_task = asyncio.get_event_loop().create_task(
            drive(ctx, spec, seed, record_acked=True))
        await asyncio.sleep(0.2)      # let the window open before reshaping

        grown: List[int] = []
        if sc.grow:
            # -- GROW: mgr reshape op mints ids, we boot the daemons ----
            map_before_grow = _mapping_snapshot(cluster.mon.osdmap)
            op = await cluster.daemon_command(
                "mgr", {"prefix": "balance grow", "count": sc.grow},
                timeout=30.0)
            grown = [int(o) for o in op["osds"]]
            await cluster.boot_osds(grown, timeout=sc.health_timeout)
            st = await _reshape_wait(cluster, op["id"], "done",
                                     sc.health_timeout)
            if st.get("phase") != "done":
                failures.append(f"grow: reshape op stuck: {st}")
            # -- REBALANCE: optimize until the move stream dries up -----
            moves, last = await _optimize_until_dry(
                cluster, sc.balancer_rounds, timeout=sc.health_timeout)
            stats["moves_committed"] = moves
            if moves < 1:
                failures.append(
                    f"rebalance: no moves committed onto the grown "
                    f"OSDs (last round: {last})")
            t = await _wait_health_ok(cluster, sc.health_timeout)
            stats["health_ok_after_grow_ms"] = int(max(t, 0) * 1000)
            if t < 0:
                failures.append(
                    f"grow: HEALTH_OK not reached within "
                    f"{sc.health_timeout}s of the reshape")
            # -- MOVE BUDGET: observed churn vs proportional optimal ----
            map_after = _mapping_snapshot(cluster.mon.osdmap)
            moved = _moved_slots(map_before_grow, map_after)
            total_slots = sum(int(a.size) for a in map_after.values())
            frac = sc.grow / (sc.osds + sc.grow)
            optimal = max(1.0, total_slots * frac)
            stats["moved_slots"] = moved
            stats["optimal_slots"] = int(optimal)
            if moved > sc.move_factor * optimal:
                failures.append(
                    f"rebalance: {moved} slots moved for an optimal of "
                    f"~{optimal:.0f} (> declared {sc.move_factor}x "
                    f"envelope)")
        else:
            # -- CONVERGENCE: optimize the natural straw2 variance ------
            skew0 = await cluster.daemon_command(
                "mgr", {"prefix": "balance optimize", "dry_run": True},
                timeout=30.0)
            moves, last = await _optimize_until_dry(
                cluster, sc.balancer_rounds, timeout=sc.health_timeout)
            stats["moves_committed"] = moves
            s_before = float(skew0.get("skew_before", 0.0))
            s_after = float(last.get("skew_after",
                                     last.get("skew_before", 0.0)))
            stats["skew_before_milli"] = int(s_before * 1000)
            stats["skew_after_milli"] = int(s_after * 1000)
            if s_after > s_before + 1e-9:
                failures.append(
                    f"convergence: skew worsened {s_before:.4f} -> "
                    f"{s_after:.4f}")

        result = await load_task
        load_task = None

        if grown and sc.drain_back:
            # -- DRAIN: out -> wait-clean -> stop daemons -> purge ------
            op = await cluster.daemon_command(
                "mgr", {"prefix": "balance drain", "osds": grown},
                timeout=30.0)
            st = await _reshape_wait(cluster, op["id"], "wait-down",
                                     sc.converge_timeout)
            if st.get("phase") not in ("wait-down", "done"):
                failures.append(f"drain: never drained clean: {st}")
            else:
                for o in grown:          # the operator stops the daemons
                    if o in cluster.osds:
                        await cluster.kill_osd(o)
                    cluster.osd_configs.pop(o, None)
                    cluster.osd_stores.pop(o, None)
                st = await _reshape_wait(cluster, op["id"], "done",
                                         sc.converge_timeout)
                if st.get("phase") != "done":
                    failures.append(f"drain: purge never completed: {st}")
                elif any(cluster.mon.osdmap.osd_exists[o] for o in grown):
                    failures.append("drain: purged OSDs still in the map")
            t = await _wait_health_ok(cluster, sc.health_timeout)
            stats["health_ok_after_drain_ms"] = int(max(t, 0) * 1000)
            if t < 0:
                failures.append(
                    f"drain: HEALTH_OK not reached within "
                    f"{sc.health_timeout}s of the drain")

        # -- SLO judge over the whole traffic window --------------------
        after = await slo.snapshot(cluster)
        report = slo.judge(spec, result, before, after)
        gates = report.rows
        if not report.passed:
            failures += [f"slo: {f}" for f in report.failures()]
        if sc.min_candidates:
            scored = slo.counter_sum(after, "ceph_mgr_balancer_candidates",
                                     daemon_prefix="mgr.")
            stats["candidates_scored"] = int(scored)
            if scored < sc.min_candidates:
                failures.append(
                    f"scorer: only {scored:.0f} candidates scored, "
                    f"acceptance floor is {sc.min_candidates}/run")

        # -- heal + converge + judge (the shared seams) ------------------
        await heal_cluster(cluster, dmn)
        await wait_converged(cluster, sc.converge_timeout)
        io = ctx.io(0)
        # attempted-mode durability, like every concurrent-writer chaos
        # scenario: 8 clients race writes to the same oids, and resends
        # under reshape churn ack in dup-protected order — "the last
        # ack the driver SAW" is bookkeeping, not apply order.  Lost
        # data still fails loudly (unreadable / bytes nobody wrote).
        failures += await judge_invariants(
            cluster, dmn, io, sc.invariants, result.acked,
            attempted=result.attempted, mode="attempted",
            timeout=sc.converge_timeout)
        acked_n = len(result.acked)
    finally:
        if load_task is not None and not load_task.done():
            # abnormal exit mid-window: the open-loop ops must not keep
            # firing at a cluster the close below is about to stop
            load_task.cancel()
            try:
                await load_task
            except (asyncio.CancelledError, Exception):
                pass
        await ctx.close()
    counters1 = CHAOS.dump()["chaos"]
    delta = {k: counters1[k] - counters0.get(k, 0) for k in counters1
             if counters1[k] - counters0.get(k, 0)}
    delta.update(stats)
    schedule = [{"round": i, "action": p["phase"],
                 "args": {k: v for k, v in p.items() if k != "phase"}}
                for i, p in enumerate(plan)]
    return Verdict(name=sc.name, seed=seed, schedule=schedule,
                   passed=not failures, failures=failures,
                   acked_objects=acked_n, counters=delta, gates=gates)

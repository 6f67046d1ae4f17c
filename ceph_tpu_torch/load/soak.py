"""Soak runner: sustained graft-load traffic composed with graft-chaos.

Counterpart of ``ceph_tpu/load/soak.py``.  ``run_soak`` boots its
cluster on the ``device`` the caller names: CUDA unless it names another
(``device="cpu"`` for the plain versions); it raises when CUDA is absent
and no device was named.

Rounds of open-loop mixed-verb traffic race a SEEDED fault schedule —
the same ``Event`` vocabulary, schedule resolution, and injector
machinery as chaos scenarios (tick/commit crash points included), with
the durability + frontier invariants as the verdict.  A soak proves
invariants under sustained fire; it never produces a timing headline.

Determinism contract: the fault schedule and the per-round load plans
resolve from the seed exactly like a chaos scenario, and exactly as the
reference's do (``Verdict.replay_key`` is reused verbatim), so a failing
soak replays with ``python -m ceph_tpu_torch.tools.load soak --scenario
<name> --seed <n>``.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.daemons import DaemonInjector
from ceph_tpu_torch.chaos.rng import stream
from ceph_tpu_torch.chaos.scenario import (
    Event,
    Scenario,
    Verdict,
    apply_event,
    build_schedule,
    ev,
    heal_cluster,
    judge_invariants,
    wait_converged,
)
from ceph_tpu_torch.load.driver import LoadContext, LoadSpec, build_plan, drive


@dataclass(frozen=True)
class SoakSpec:
    """Sustained load + a seeded fault schedule + invariant verdict."""

    name: str
    load: LoadSpec
    rounds: int = 3
    events: Tuple[Event, ...] = ()
    # ordering matters on a slow host: acting + frontier RETRY until
    # peering/recovery complete, so durability reads a converged
    # cluster instead of racing a mid-recovery one (a soak's FileStore
    # crash replays can outlast the check window when the host is
    # degraded — observed as "0 of k shard ranges" false failures)
    invariants: Tuple[str, ...] = ("acting", "frontier", "durability",
                                   "deadline", "health", "lockdep")
    converge_timeout: float = 90.0

    def schedule_shell(self) -> Scenario:
        """A chaos Scenario carrying just what ``build_schedule`` needs
        (cluster shape + events), so soak fault plans resolve through
        the SAME seeded resolver as chaos scenarios."""
        return Scenario(
            name=self.name, osds=self.load.osds,
            pool_kind=self.load.pool_kind, pool_size=self.load.pool_size,
            pg_num=self.load.pg_num, ec_profile=self.load.ec_profile,
            rounds=self.rounds, events=self.events, store=self.load.store)


async def run_soak(spec: SoakSpec, seed: int,
                   tmpdir: Optional[str] = None, device=None) -> Verdict:
    """Boot on ``device`` (CUDA unless named; raises without one),
    sustain traffic through the fault schedule, heal, converge, judge
    by invariants.  Returns a chaos ``Verdict`` (same replay-key
    contract)."""
    schedule = build_schedule(spec.schedule_shell(), seed)
    rot = stream(seed, "bitrot")
    counters0 = dict(CHAOS.dump()["chaos"])
    ctx = await LoadContext.create(spec.load, seed, tmpdir=tmpdir,
                                   device=device)
    cluster = ctx.cluster
    dmn = DaemonInjector(cluster)
    acked: Dict[str, bytes] = {}
    attempted: Dict[str, set] = {}
    failures = []
    late_acks = []
    postmortem_path: Optional[str] = None
    try:
        io = ctx.io(0)
        for rnd in range(spec.rounds):
            evs = [e for e in schedule if e["round"] == rnd]
            for e in [e for e in evs if not e["during_writes"]
                      and not e.get("after_writes")]:
                await apply_event(cluster, dmn, ctx.sessions[0], io, e,
                                  rot, acked, ctx.pool)
            mid = [e for e in evs if e["during_writes"]]
            # each round drives one full load window; mid-round events
            # fire a beat into it (racing the in-flight traffic, the
            # chaos during_writes contract)
            plan = build_plan(spec.load, seed + rnd * 1000003)
            window = asyncio.get_event_loop().create_task(
                drive(ctx, spec.load, seed, plan=plan,
                      record_acked=True))
            try:
                if mid:
                    await asyncio.sleep(0.2 + rot.random() * 0.2)
                    for e in mid:
                        await apply_event(cluster, dmn, ctx.sessions[0],
                                          io, e, rot, acked, ctx.pool)
                result = await window
            except BaseException:
                # a failed mid-round injection must not orphan the
                # in-flight window: drain it before teardown so the
                # original failure surfaces clean
                window.cancel()
                try:
                    await window
                except (asyncio.CancelledError, Exception):
                    pass
                raise
            late_acks += result.late_acks
            for oid, data in result.acked.items():
                acked[oid] = data
            for oid, tries in result.attempted.items():
                attempted.setdefault(oid, set()).update(tries)
            for e in [e for e in evs if e.get("after_writes")]:
                await apply_event(cluster, dmn, ctx.sessions[0], io, e,
                                  rot, acked, ctx.pool)

        # -- heal + converge + judge: the chaos seams, verbatim
        #    (durability judges in attempted mode: zipf hot objects
        #    race concurrent writers by design) -----------------------
        await heal_cluster(cluster, dmn)
        await wait_converged(cluster, spec.converge_timeout)
        failures += await judge_invariants(
            cluster, dmn, io, spec.invariants, acked,
            attempted=attempted, mode="attempted",
            timeout=spec.converge_timeout, deadline_misses=late_acks)
        if failures and getattr(cluster.config, "blackbox_enabled", 0):
            # graft-blackbox: a convicted soak triggers a bundle before
            # teardown (same seam as a chaos conviction).  The reason
            # carries only the failure HEAD (invariant name): full
            # strings embed wall timings and ride in the detail — the
            # reason feeds the bundle's deterministic replay_key
            pm_rec = await cluster.blackbox_trigger(
                "chaos_conviction",
                f"soak {spec.name} seed={seed} convicted: "
                f"{failures[0].split(':', 1)[0]}",
                detail={"scenario": spec.name, "seed": seed,
                        "failures": list(failures)},
                clients=ctx.sessions)
            postmortem_path = (pm_rec or {}).get("path")
    finally:
        await ctx.close()
    counters1 = CHAOS.dump()["chaos"]
    delta = {k: counters1[k] - counters0.get(k, 0) for k in counters1
             if counters1[k] - counters0.get(k, 0)}
    return Verdict(name=spec.name, seed=seed, schedule=schedule,
                   passed=not failures, failures=failures,
                   acked_objects=len(acked), counters=delta,
                   gates=[{"gate": "invariants", "value": len(failures),
                           "threshold": 0, "passed": not failures}],
                   postmortem=postmortem_path)


def builtin_soaks() -> Dict[str, SoakSpec]:
    """The shipped soak library (``tools/load.py list``)."""
    return {
        # sustained mixed-verb EC traffic on a durable store racing
        # tick/commit crash points, judged by durability + frontier
        # (slow; never on the bench hot path)
        "soak-mixed-crash": SoakSpec(
            name="soak-mixed-crash",
            load=LoadSpec(
                name="soak-mixed-crash", clients=48, sessions=4,
                rate=1.2, duration=2.5, objects=24, payload=2048,
                osds=5, pool_kind="erasure", pool_size=3, pg_num=8,
                ec_profile=(("plugin", "jerasure"),
                            ("technique", "reed_sol_van"),
                            ("k", "2"), ("m", "1")),
                store="file", op_deadline=12.0,
                verbs=(("write", 4.0), ("read", 3.0), ("rmw", 1.0),
                       ("append", 1.0))),
            rounds=3,
            events=(
                ev(0, "net", target="all_osds",
                   chaos_net_batch_item_drop=0.05),
                ev(0, "crash_point", point="tick_post_encode",
                   during_writes=True),
                ev(1, "revive_osd"),
                ev(1, "crash_point", point="commit_mid_fanout",
                   during_writes=True),
                ev(2, "revive_osd"),
            ),
            invariants=("acting", "frontier", "durability", "deadline",
                        "health", "lockdep"),
            converge_timeout=150.0),
        # replicated bounce soak on durable stores: the rolling-restart
        # shape under sustained mixed traffic
        "soak-rolling-restart": SoakSpec(
            name="soak-rolling-restart",
            load=LoadSpec(
                name="soak-rolling-restart", clients=48, sessions=4,
                rate=1.2, duration=2.5, objects=24, payload=2048,
                osds=5, pg_num=8, store="file", op_deadline=12.0,
                verbs=(("write", 4.0), ("read", 3.0), ("append", 1.0))),
            rounds=3,
            events=(
                ev(0, "restart_osd", during_writes=True),
                ev(1, "restart_osd", during_writes=True),
                ev(2, "restart_osd", during_writes=True),
            ),
            invariants=("acting", "frontier", "durability", "deadline",
                        "health", "lockdep"),
            converge_timeout=120.0),
    }

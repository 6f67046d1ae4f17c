"""Integrity scenarios: verified reads under live corruption
and cluster-full graceful degradation, both seeded and replayable.

Counterpart of ``ceph_tpu/chaos/integrity.py``; ``run_fill_drain``, like
``run_scenario``, runs on the ``device`` it is given (CUDA unless named).

Two acceptance shapes ride here:

- ``bitrot-under-load`` — a plain chaos :class:`Scenario` (built by
  ``integrity_scenarios``) driving a read-heavy graft-load window over
  an EC pool while seeded at-rest bit flips land on acked objects after
  every round's writes, with the scheduled deep scrubber running
  concurrently.  The verdict: zero wrong-bytes acks (``durability``
  reads every acked payload back bit-identical — verify-on-read decodes
  AROUND the corruption), every injected flip detected and healed
  (``repair`` + ``scrub``), and the whole run replays bit-identically
  from its seed.

- ``disk-fill-drain`` — a dedicated phased runner (:func:`run_fill_drain`
  over a :class:`FillScenario`): seeded writes exhaust the stores'
  enforced capacity; the run asserts explicit ENOSPC (never a timeout),
  the mon's full flag + OSD_FULL/HEALTH_ERR raising, deletes STILL
  admitted while full (the dig-yourself-out contract), flags clearing as
  space frees, and service resuming — with zero acked-then-lost writes
  across the whole cycle.  Phases are resolved from the seed, so the
  plan (and the verdict's replay key) is bit-identical across runs.

Like chaos/frontdoor.py, the runner reuses the shared heal/converge/
judge seams from chaos/scenario.py — composition, not reimplementation.
"""

from __future__ import annotations

import asyncio
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

from ceph_tpu_torch.chaos.counters import CHAOS
from ceph_tpu_torch.chaos.daemons import DaemonInjector
from ceph_tpu_torch.chaos.rng import stream
from ceph_tpu_torch.chaos.scenario import (
    Scenario,
    Verdict,
    ev,
    heal_cluster,
    judge_invariants,
    wait_converged,
)
from ceph_tpu_torch.ops import crc32c as crcmod


def integrity_scenarios(scale: float = 1.0) -> Dict[str, object]:
    """The integrity library, sized by ``scale`` (1.0 = the
    full acceptance shape, slow; small fractions run the same code
    paths at tier-1 size — the storm_scenarios convention)."""
    from ceph_tpu_torch.load.driver import LoadSpec

    s = max(0.03, min(1.0, scale))
    full = s >= 1.0
    rounds = 4 if full else 2
    flips_per_round = 2 if full else 1
    load = LoadSpec(
        name="bitrot-read", clients=max(8, int(48 * s)), sessions=4,
        rate=1.2, duration=3.0 if full else 1.5,
        objects=24, payload=4096, op_deadline=25.0,
        osds=4, pool_kind="erasure", pool_size=3, pg_num=8,
        ec_profile=(("plugin", "jerasure"),
                    ("technique", "reed_sol_van"),
                    ("k", "2"), ("m", "1")),
        # read-heavy: the verified-read path IS the thing under test
        verbs=(("write", 2.0), ("read", 6.0), ("append", 0.5)))
    events = tuple(
        ev(r, "bitrot", after_writes=True)
        for r in range(rounds) for _ in range(flips_per_round))
    return {
        # seeded at-rest corruption injected while graft-load reads at
        # rate, the jittered deep scrubber running concurrently: zero
        # wrong-bytes acks, every flip detected + repaired, replayable
        "bitrot-under-load": Scenario(
            name="bitrot-under-load", osds=4, pool_kind="erasure",
            pg_num=8, rounds=rounds,
            ec_profile=(("plugin", "jerasure"),
                        ("technique", "reed_sol_van"),
                        ("k", "2"), ("m", "1")),
            load=load, events=events,
            durability_mode="attempted",
            # the scheduled scrubber runs DURING the load windows (the
            # scrub-concurrent mix) and owns flips the reads miss
            config=(("osd_scrub_interval", 1.0),),
            # scrub BEFORE repair: the scrub invariant's repairing
            # pass owns any flip the run's reads never touched, so the
            # repair invariant judges a fully-swept cluster
            invariants=("durability", "scrub", "repair", "acting",
                        "health", "lockdep"),
            converge_timeout=90.0 if full else 60.0),
        "disk-fill-drain": FillScenario(
            name="disk-fill-drain",
            fill_max_writes=160 if full else 80,
            payload=32768),
    }


# ------------------------------------------------------------ fill-drain


@dataclass(frozen=True)
class FillScenario:
    """Cluster-full acceptance shape: fill to ENOSPC, drain, resume.
    ``device_bytes`` sizes every OSD's enforced MemStore capacity; the
    ratios are the config defaults (full at 95%)."""

    name: str
    osds: int = 3
    pool_size: int = 3
    pg_num: int = 4
    device_bytes: int = 1 << 20
    payload: int = 32768
    fill_max_writes: int = 80
    enospc_needed: int = 3          # distinct ENOSPC rejections to see
    drain_frac: float = 0.75
    post_writes: int = 4
    flag_timeout: float = 20.0
    converge_timeout: float = 60.0
    invariants: Tuple[str, ...] = ("durability", "acting", "health",
                                   "lockdep")
    config: Tuple[Tuple[str, object], ...] = ()
    store: str = "mem"              # scripts/chaos.py tmpdir contract
    rounds: int = 1                 # `list` display only


def build_fill_plan(sc: FillScenario, seed: int) -> List[Dict]:
    """The seed-deterministic phase plan (the replay witness): which
    objects the fill writes, in which order the drain deletes.  Actual
    ack/reject splits are runtime outcomes — counters, not plan."""
    rng = stream(seed, "fill")
    oids = [f"fill{i}" for i in range(sc.fill_max_writes)]
    drain = sorted(oids, key=lambda _o: rng.random())
    return [
        {"phase": "fill", "oids": oids, "payload": sc.payload},
        {"phase": "assert_full"},
        {"phase": "drain", "order": drain, "frac": sc.drain_frac},
        {"phase": "assert_clear"},
        {"phase": "resume",
         "oids": [f"post{i}" for i in range(sc.post_writes)]},
    ]


async def run_fill_drain(sc: FillScenario, seed: int,
                         tmpdir: Optional[str] = None,
                         device=None) -> Verdict:
    """Boot, fill to the enforced capacity, assert the full-flag
    response, drain, assert clearance + resumed service, judge.
    ``device``: the card the cluster runs on (CUDA unless named; raises
    without one)."""
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster
    from ceph_tpu_torch.utils.device import resolve_device_index

    device = resolve_device_index(device)
    plan = build_fill_plan(sc, seed)
    wl = stream(seed, "payload")
    cfg = _fast_config()
    cfg.chaos_seed = seed
    cfg.memstore_device_bytes = sc.device_bytes
    cfg.mon_osd_down_out_interval = 120.0
    for k, v in sc.config:
        cfg.set(k, v)
    counters0 = dict(CHAOS.dump()["chaos"])
    cluster = await start_cluster(sc.osds, config=cfg, device=device)
    dmn = DaemonInjector(cluster)
    failures: List[str] = []
    stats: Dict[str, int] = {}
    acked: Dict[str, bytes] = {}
    acked_crcs: Dict[str, int] = {}
    loop = asyncio.get_event_loop()

    def _payload(oid: str) -> bytes:
        tag = f"{oid}-{wl.randrange(1 << 30)}-".encode()
        return tag * max(1, sc.payload // len(tag))

    async def _flag(on: bool, timeout: float) -> bool:
        deadline = loop.time() + timeout
        while loop.time() < deadline:
            if ("full" in cluster.mon.osdmap.flags) == on:
                return True
            await asyncio.sleep(0.1)
        return False

    try:
        client = await cluster.client()
        pool = await client.pool_create(
            "fill_drain", "replicated", pg_num=sc.pg_num,
            size=sc.pool_size)
        io = client.ioctx(pool)

        # -- FILL: write until the capacity protection pushes back ----
        enospc = 0
        fill = plan[0]
        for oid in fill["oids"]:
            data = _payload(oid)
            try:
                await io.write_full(oid, data, timeout=20)
            except OSError as e:
                if getattr(e, "errno", None) == 28:
                    enospc += 1
                    if enospc >= sc.enospc_needed:
                        break
                    await asyncio.sleep(0.2)
                    continue
                failures.append(
                    f"fill: {oid} failed with a NON-ENOSPC error "
                    f"under capacity pressure: {e!r}")
                break
            acked[oid] = data
            acked_crcs[oid] = crcmod.crc32c(0xFFFFFFFF, data)
        stats["fill_acked"] = len(acked)
        stats["fill_enospc"] = enospc
        if not enospc:
            failures.append("fill: capacity never pushed back ENOSPC")

        # -- ASSERT FULL: flag committed, health ERR, writes rejected -
        if not await _flag(True, sc.flag_timeout):
            failures.append("full: map flag never raised after ENOSPC")
        else:
            health = cluster.mon._health_data()
            if "OSD_FULL" not in health["checks"] or \
                    health["status"] != "HEALTH_ERR":
                failures.append(f"full: health did not reflect the "
                                f"full state: {health}")
            # a write against the committed flag must reject PROMPTLY
            # with explicit ENOSPC (not burn a timeout)
            t0 = loop.time()
            try:
                await io.write_full("flagged", _payload("flagged"),
                                    timeout=20)
                failures.append("full: write admitted under the flag")
            except OSError as e:
                if getattr(e, "errno", None) != 28:
                    failures.append(f"full: flagged write failed with "
                                    f"{e!r}, want ENOSPC")
                elif loop.time() - t0 > 5.0:
                    failures.append("full: ENOSPC took longer than a "
                                    "prompt rejection should")
        stats["full_rejects"] = sum(
            o.perf.get("osd_full_rejects")
            for o in cluster.osds.values())

        # -- DRAIN: deletes admitted WHILE full; flags clear after ----
        drain = plan[2]
        doomed = [o for o in drain["order"] if o in acked]
        doomed = doomed[: max(1, int(len(doomed) * drain["frac"]))]
        for oid in doomed:
            try:
                await io.remove(oid, timeout=20)
                acked.pop(oid, None)
                acked_crcs.pop(oid, None)
            except (IOError, OSError) as e:
                failures.append(f"drain: delete {oid} refused while "
                                f"full: {e!r} — the cluster cannot "
                                f"dig itself out")
        stats["drained"] = len(doomed)
        if not await _flag(False, sc.flag_timeout):
            failures.append("drain: full flag never cleared after "
                            "space freed")

        # -- RESUME: writes flow again ----------------------------------
        await cluster.wait_for_epoch(cluster.mon.osdmap.epoch,
                                     timeout=10)
        for oid in plan[4]["oids"]:
            data = _payload(oid)
            try:
                await io.write_full(oid, data, timeout=30)
            except (IOError, OSError) as e:
                failures.append(
                    f"resume: {oid} still refused after drain: {e!r}")
                continue
            acked[oid] = data
            acked_crcs[oid] = crcmod.crc32c(0xFFFFFFFF, data)

        # -- heal + converge + judge (the shared seams) ----------------
        await heal_cluster(cluster, dmn)
        await wait_converged(cluster, sc.converge_timeout)
        failures += await judge_invariants(
            cluster, dmn, io, sc.invariants, acked,
            mode="acked", timeout=sc.converge_timeout,
            acked_crcs=acked_crcs)
    finally:
        await cluster.stop()
    counters1 = CHAOS.dump()["chaos"]
    delta = {k: counters1[k] - counters0.get(k, 0) for k in counters1
             if counters1[k] - counters0.get(k, 0)}
    delta.update(stats)
    # the replay key hashes the PLAN (seed-pure), never the runtime
    # ack/reject splits (those ride counters, like chaos Verdicts)
    schedule = [{"round": i, "action": p["phase"],
                 "args": {k: v for k, v in p.items() if k != "phase"}}
                for i, p in enumerate(plan)]
    return Verdict(name=sc.name, seed=seed, schedule=schedule,
                   passed=not failures, failures=failures,
                   acked_objects=len(acked), counters=delta)

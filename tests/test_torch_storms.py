"""The control-plane storms' tier-1 smokes on a port cluster, the cases of
``tests/test_control_plane.py``: the rolling-restart storm at scale 0.06
(seed 7), the Paxos leader killed mid-epoch-burst at scale 0.06 (seed 11),
and anchor mode (``osd_map_vectorized_delta=0``) converging a bounce to
the same healthy end state.

Each runs on ``device="cpu"`` under its own deadline and keeps the
reference test's assertions.  What is compared with the reference does not
depend on timing: the scaled storm library entry, its schedule, and each
verdict's replay key, which equals that of a passing reference verdict of
the reference's own schedule.
"""

import asyncio
import dataclasses

import pytest

import ceph_tpu.chaos.scenario as jscenario
import ceph_tpu_torch.chaos.scenario as scenario
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 300.0
SCALE = 0.06


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def _scaled_storms():
    return scenario.storm_scenarios(SCALE)


def ref_replay_key(name: str, seed: int):
    sc = jscenario.storm_scenarios(SCALE)[name]
    return jscenario.Verdict(
        name=name, seed=seed, schedule=jscenario.build_schedule(sc, seed),
        passed=True, failures=[]).replay_key()


@pytest.mark.parametrize("name", ["rolling-restart-100",
                                  "mon-bounce-under-churn"])
def test_scaled_storm_equals_reference(name):
    assert dataclasses.asdict(_scaled_storms()[name]) == \
        dataclasses.asdict(jscenario.storm_scenarios(SCALE)[name])


@pytest.mark.chaos
def test_storm_rolling_restart_scaled(tmp_path):
    """The rolling-restart storm at scale 0.06 (load-driver traffic,
    staggered and overlapping bounces, the HEALTH_OK and epochs/s gates,
    the durability/frontier/acting invariants) passes seeded, its
    schedule is seed-deterministic, and its replay key is the
    reference's."""
    sc = _scaled_storms()["rolling-restart-100"]
    assert scenario.build_schedule(sc, 7) == scenario.build_schedule(sc, 7)
    v = run(scenario.run_scenario(sc, 7, tmpdir=str(tmp_path),
                                  device="cpu"))
    assert v.passed, v.failures
    assert v.counters.get("daemon_restarts", 0) >= 4
    assert v.counters.get("epochs_generated", 0) > 0
    assert v.replay_key() == ref_replay_key("rolling-restart-100", 7)


@pytest.mark.chaos
def test_storm_mon_bounce_scaled(tmp_path):
    """The Paxos leader killed mid-epoch-burst at scale 0.06: the quorum
    fails over, keeps committing markdowns and boots, the killed mon
    revives into the quorum, and every invariant and the HEALTH_OK gate
    hold."""
    sc = _scaled_storms()["mon-bounce-under-churn"]
    v = run(scenario.run_scenario(sc, 11, tmpdir=str(tmp_path),
                                  device="cpu"))
    assert v.passed, v.failures
    assert v.counters.get("daemon_kills", 0) >= 1      # the leader
    assert v.counters.get("daemon_revives", 0) >= 0
    assert v.replay_key() == ref_replay_key("mon-bounce-under-churn", 11)


def test_anchor_mode_converges_identically():
    """``osd_map_vectorized_delta=0`` (the per-PG-scan anchor) still
    converges a bounce to the same healthy end state."""
    from ceph_tpu_torch.chaos.invariants import check_acting, check_health
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    async def scenario_():
        cfg = _fast_config()
        cfg.osd_map_vectorized_delta = 0
        cluster = await start_cluster(4, config=cfg, device="cpu")
        try:
            client = await cluster.client()
            pool = await client.pool_create("anchor", "replicated",
                                            pg_num=8, size=3)
            io = client.ioctx(pool)
            for i in range(6):
                await io.write_full(f"a{i}", b"anchor" * 40)
            await cluster.restart_osd(1)
            fails = await check_acting(cluster, timeout=30)
            fails += await check_health(cluster, timeout=30)
            assert not fails, fails
            for i in range(6):
                assert await io.read(f"a{i}") == b"anchor" * 40
        finally:
            await cluster.stop()

    run(scenario_(), bound=120.0)

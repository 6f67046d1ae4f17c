"""The port's integrity runners (``ceph_tpu_torch/chaos/integrity.py``)
against ``ceph_tpu``'s, on the scenario cases of
``tests/test_integrity.py``.

Host determinism, exact equality with the reference: the integrity
library entry for entry at two scales, ``build_schedule`` of
``bitrot-under-load`` and ``build_fill_plan`` of ``disk-fill-drain`` at
seeds 0-4.  Whole runs on a port cluster (``device="cpu"``, each under
its own deadline): the ``bitrot-under-load`` and ``disk-fill-drain``
smokes as the reference's tests run them, each verdict's replay key equal
to a passing reference run's.  The full-size twins are slow-marked, as
the reference's are.
"""

import asyncio
import dataclasses

import pytest

import ceph_tpu.chaos.integrity as jintegrity
import ceph_tpu.chaos.scenario as jscenario
import ceph_tpu_torch.chaos.integrity as integrity
import ceph_tpu_torch.chaos.scenario as scenario
from tests._flaky import contention_retry
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

BOUND = 120.0
SEEDS = range(5)
SCALES = [0.05, 0.06, 1.0]


def run(coro, bound: float = BOUND):
    return asyncio.run(asyncio.wait_for(coro, timeout=bound))


def ref_key(scale: float, name: str, seed: int):
    """The replay key of a passing reference run: its own plan, passed,
    no failures."""
    sc = jintegrity.integrity_scenarios(scale)[name]
    if isinstance(sc, jintegrity.FillScenario):
        sched = [{"round": i, "action": p["phase"],
                  "args": {k: v for k, v in p.items() if k != "phase"}}
                 for i, p in enumerate(jintegrity.build_fill_plan(sc, seed))]
    else:
        sched = jscenario.build_schedule(sc, seed)
    return jscenario.Verdict(name=name, seed=seed, schedule=sched,
                             passed=True, failures=[]).replay_key()


@pytest.mark.parametrize("scale", SCALES)
@pytest.mark.parametrize("name", ["bitrot-under-load", "disk-fill-drain"])
def test_integrity_library_equals_reference(name, scale):
    got = integrity.integrity_scenarios(scale)
    ref = jintegrity.integrity_scenarios(scale)
    assert sorted(got) == sorted(ref)
    assert dataclasses.asdict(got[name]) == dataclasses.asdict(ref[name])


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", SCALES)
def test_bitrot_schedule_equals_reference(scale, seed):
    got = scenario.build_schedule(
        integrity.integrity_scenarios(scale)["bitrot-under-load"], seed)
    assert got == jscenario.build_schedule(
        jintegrity.integrity_scenarios(scale)["bitrot-under-load"], seed)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("scale", SCALES)
def test_fill_plan_equals_reference(scale, seed):
    got = integrity.build_fill_plan(
        integrity.integrity_scenarios(scale)["disk-fill-drain"], seed)
    assert got == jintegrity.build_fill_plan(
        jintegrity.integrity_scenarios(scale)["disk-fill-drain"], seed)


def test_integrity_plans_are_seed_deterministic():
    lib = integrity.integrity_scenarios(0.06)
    bl = lib["bitrot-under-load"]
    assert scenario.build_schedule(bl, 23) == scenario.build_schedule(bl, 23)
    fd = lib["disk-fill-drain"]
    assert isinstance(fd, integrity.FillScenario)
    assert integrity.build_fill_plan(fd, 23) == \
        integrity.build_fill_plan(fd, 23)
    assert integrity.build_fill_plan(fd, 23) != \
        integrity.build_fill_plan(fd, 24)


@pytest.mark.chaos
@contention_retry()
def test_bitrot_under_load_smoke():
    """``tests/test_integrity.py::test_bitrot_under_load_smoke`` on the
    port: seeded PASS on the reference's schedule, flips injected."""
    sc = integrity.integrity_scenarios(0.06)["bitrot-under-load"]
    verdict = run(scenario.run_scenario(sc, 11, device="cpu"))
    assert verdict.passed, verdict.failures
    assert verdict.counters.get("disk_bitrot_flips", 0) >= 1
    assert verdict.replay_key() == ref_key(0.06, "bitrot-under-load", 11)


@pytest.mark.chaos
@contention_retry()
def test_disk_fill_drain_smoke():
    """``tests/test_integrity.py::test_disk_fill_drain_smoke`` on the
    port: the fill -> flag -> drain -> clear -> resume cycle passes with
    zero acked-then-lost writes, on the reference's plan."""
    sc = integrity.integrity_scenarios(0.06)["disk-fill-drain"]
    verdict = run(integrity.run_fill_drain(sc, 7, device="cpu"))
    assert verdict.passed, verdict.failures
    assert verdict.counters.get("fill_enospc", 0) >= 1
    assert verdict.counters.get("full_rejects", 0) >= 1
    assert verdict.counters.get("drained", 0) >= 1
    assert verdict.replay_key() == ref_key(0.06, "disk-fill-drain", 7)


@pytest.mark.chaos
@pytest.mark.slow
def test_bitrot_under_load_full_replays_bit_identically():
    sc = integrity.integrity_scenarios(1.0)["bitrot-under-load"]
    v1 = run(scenario.run_scenario(sc, 11, device="cpu"), bound=600.0)
    v2 = run(scenario.run_scenario(sc, 11, device="cpu"), bound=600.0)
    assert v1.passed, v1.failures
    assert v1.replay_key() == v2.replay_key() == \
        ref_key(1.0, "bitrot-under-load", 11)


@pytest.mark.chaos
@pytest.mark.slow
def test_disk_fill_drain_full_replays_bit_identically():
    sc = integrity.integrity_scenarios(1.0)["disk-fill-drain"]
    v1 = run(integrity.run_fill_drain(sc, 7, device="cpu"), bound=600.0)
    v2 = run(integrity.run_fill_drain(sc, 7, device="cpu"), bound=600.0)
    assert v1.passed, v1.failures
    assert v1.replay_key() == v2.replay_key() == \
        ref_key(1.0, "disk-fill-drain", 7)

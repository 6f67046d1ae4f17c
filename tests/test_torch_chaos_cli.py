"""The port's chaos CLI (``python -m ceph_tpu_torch.tools.chaos``) against
``scripts/chaos.py``.

``list`` and ``schedule`` print byte for byte what the reference's CLI
prints, for every kind of scenario it names: a builtin, a scaled storm, a
front-door scenario, the fill-drain runner's and the elastic runner's;
one seed gives one plan twice.  The exit codes are the reference's: 0
every invariant holds, 1 a verdict failed, 2 an unknown scenario.  ``run``
drives a port cluster with ``--device cpu``; without ``--device`` the CLI
wants the card, and here, with none, ``run`` exits 2 with a message and
boots nothing.  Every run passes ``--no-postmortem``.
"""

import json
import os
import subprocess
import sys

import pytest
import torch

from ceph_tpu_torch.tools import chaos as cli
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CLI = os.path.join(REPO, "scripts", "chaos.py")
TIMEOUT = 180


def port(*args, env=None):
    env = dict(os.environ, PYTHONPATH=REPO, **(env or {}))
    return subprocess.run([sys.executable, "-m",
                           "ceph_tpu_torch.tools.chaos", *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=TIMEOUT)


def ref(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, REF_CLI, *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=TIMEOUT)


SCHEDULES = {
    "builtin": ("--scenario", "smoke", "--seed", "42"),
    "builtin-ec": ("--scenario", "batch-smoke", "--seed", "31"),
    "storm": ("--scenario", "rolling-restart-100", "--seed", "7",
              "--scale", "0.06"),
    "storm-mon": ("--scenario", "mon-bounce-under-churn", "--seed", "11",
                  "--scale", "0.06"),
    "frontdoor": ("--scenario", "frontdoor-smoke", "--seed", "7"),
    "frontdoor-scaled": ("--scenario", "rbd-snap-midwrite", "--seed", "3",
                         "--scale", "0.06"),
    "fill": ("--scenario", "disk-fill-drain", "--seed", "3"),
    "elastic": ("--scenario", "expand-drain-smoke", "--seed", "7"),
    "elastic-scaled": ("--scenario", "expand-drain", "--seed", "5",
                       "--scale", "0.06"),
}


def test_cli_list_is_byte_equal_to_the_reference():
    got, want = port("list"), ref("list")
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    names = {line.split()[0] for line in got.stdout.splitlines()}
    assert {"smoke", "frontdoor-smoke", "expand-drain-smoke",
            "disk-fill-drain", "rolling-restart-100"} <= names


@pytest.mark.parametrize("kind", sorted(SCHEDULES))
def test_cli_schedule_is_byte_equal_to_the_reference(kind):
    args = ("schedule",) + SCHEDULES[kind]
    got, want = port(*args), ref(*args)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout
    assert json.loads(got.stdout)


def test_cli_schedule_deterministic_and_unknown_scenario(capsys):
    args = ("schedule",) + SCHEDULES["frontdoor"]
    p1, p2 = port(*args), port(*args)
    assert p1.returncode == 0, p1.stderr
    assert p1.stdout == p2.stdout
    plans = set()
    for seed in range(6):
        assert cli.main(["schedule", "--scenario", "smoke", "--seed",
                         str(seed)]) == 0
        plans.add(capsys.readouterr().out)
    assert len(plans) > 1
    for sub in ("schedule", "run"):
        bad, want = port(sub, "--scenario", "nope"), \
            ref(sub, "--scenario", "nope")
        assert bad.returncode == want.returncode == 2
        assert "unknown scenario 'nope'" in bad.stderr
        assert bad.stderr == want.stderr


def test_cli_run_smoke_on_the_cpu_exits_zero():
    res = port("run", "--scenario", "smoke", "--seed", "42", "--device",
               "cpu", "--no-postmortem")
    assert res.returncode == 0, res.stdout + res.stderr
    assert res.stdout.startswith("scenario smoke seed=42: PASS")


def test_cli_run_frontdoor_smoke_json_replays_its_schedule():
    """What the card's check runs: ``frontdoor-smoke`` at seed 7 through
    the CLI in a fresh process, its JSON verdict passed, the seams fired,
    and its schedule the one ``schedule`` prints."""
    res = port("run", "--scenario", "frontdoor-smoke", "--seed", "7",
               "--json", "--no-postmortem", "--device", "cpu")
    assert res.returncode == 0, res.stdout + res.stderr
    verdict = json.loads(res.stdout)
    assert verdict["passed"], verdict["failures"]
    assert verdict["counters"].get("interrupt_points_fired", 0) >= 1
    assert verdict["counters"].get("mds_crash_points_fired", 0) >= 1
    sched = port("schedule", "--scenario", "frontdoor-smoke", "--seed", "7")
    assert verdict["schedule"] == json.loads(sched.stdout)


def test_cli_run_exits_one_on_a_failed_verdict(monkeypatch, capsys):
    from ceph_tpu_torch.chaos import scenario

    seen = []

    async def failed(sc, seed, tmpdir=None, device=None):
        seen.append((sc.name, seed, device))
        return scenario.Verdict(
            name=sc.name, seed=seed,
            schedule=scenario.build_schedule(sc, seed), passed=False,
            failures=["durability: obj3 lost"])

    monkeypatch.setattr(scenario, "run_scenario", failed)
    assert cli.main(["run", "--scenario", "smoke", "--seed", "4",
                     "--device", "cpu", "--no-postmortem"]) == 1
    out = capsys.readouterr().out
    assert "scenario smoke seed=4: FAIL" in out
    assert "  FAIL durability: obj3 lost" in out
    assert seen == [("smoke", 4, torch.device("cpu"))]


@pytest.mark.parametrize("name,runner", [
    ("frontdoor-smoke", "ceph_tpu_torch.chaos.frontdoor.run_frontdoor"),
    ("expand-drain-smoke", "ceph_tpu_torch.chaos.balance.run_elastic"),
    ("disk-fill-drain", "ceph_tpu_torch.chaos.integrity.run_fill_drain"),
    ("smoke", "ceph_tpu_torch.chaos.scenario.run_scenario")])
def test_cli_run_takes_the_runner_of_each_kind(name, runner, monkeypatch):
    import importlib

    from ceph_tpu_torch.chaos.scenario import Verdict

    modname, _, attr = runner.rpartition(".")
    seen = []

    async def fake(sc, seed, tmpdir=None, device=None):
        seen.append((sc.name, device, tmpdir is not None,
                     dict(sc.config).get("blackbox_enabled")))
        return Verdict(name=sc.name, seed=seed, schedule=[], passed=True,
                       failures=[])

    monkeypatch.setattr(importlib.import_module(modname), attr, fake)
    sc = cli.scenario_library()[name]
    assert cli.main(["run", "--scenario", name, "--device", "cpu",
                     "--postmortem", "."]) == 0
    assert seen == [(name, torch.device("cpu"), sc.store != "mem", 1)]


def test_cli_without_a_device_wants_the_card_and_boots_nothing(
        monkeypatch, capsys, tmp_path):
    """No ``--device``: the CLI runs on CUDA; with no card it exits 2
    with a message before any cluster starts, and writes nothing."""
    from ceph_tpu_torch.cluster import vstart

    booted = []

    async def start_cluster(*args, **kwargs):
        booted.append(kwargs)
        raise AssertionError("a cluster was started")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(vstart, "start_cluster", start_cluster)
    monkeypatch.chdir(tmp_path)
    for name in ("smoke", "frontdoor-smoke", "expand-drain-smoke",
                 "disk-fill-drain"):
        assert cli.main(["run", "--scenario", name]) == 2
        assert "CUDA" in capsys.readouterr().err
    assert booted == [] and os.listdir(tmp_path) == []
    # list and schedule need no card
    assert cli.main(["schedule", "--scenario", "smoke", "--seed", "1"]) == 0


def test_cli_run_without_a_device_fails_in_a_process_without_a_card():
    res = port("run", "--scenario", "smoke", "--seed", "42",
               "--no-postmortem", env={"CUDA_VISIBLE_DEVICES": ""})
    assert res.returncode == 2
    assert "CUDA" in res.stderr and "PASS" not in res.stdout

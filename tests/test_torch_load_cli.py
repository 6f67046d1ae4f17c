"""The port's load CLI (``python -m ceph_tpu_torch.tools.load``) against
``scripts/load.py``, on the CLI cases of ``tests/test_load.py``.

``list`` and ``plan`` print byte for byte what the reference's CLI
prints, and ``report`` prints the reference's table for the same
artifact; the exit codes are the reference's (0 gates pass, 1 a gate
fails, 2 an unknown spec, soak or gate, or a missing artifact).  ``run``
drives a port cluster with ``--device cpu``.  Without ``--device`` the
CLI wants the card: here, with none, ``run``, ``ramp`` and ``soak`` exit
2 with a message and boot nothing.  Every run passes ``--no-postmortem``
or a temporary ``--postmortem`` directory.
"""

import json
import os
import re
import subprocess
import sys

import pytest
import torch

from ceph_tpu_torch.tools import load as cli
from tests._torch_chaos import _port_chaos_reset  # noqa: F401  (fixture)
from tests.test_torch_cluster import (  # noqa: F401  (fixtures)
    _one_torch_thread, _port_lockdep_reset)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF_CLI = os.path.join(REPO, "scripts", "load.py")
TIMEOUT = 120


def port(*args):
    env = dict(os.environ, PYTHONPATH=REPO)
    return subprocess.run([sys.executable, "-m", "ceph_tpu_torch.tools.load",
                           *args], capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=TIMEOUT)


def ref(*args):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, REF_CLI, *args],
                          capture_output=True, text=True, cwd=REPO,
                          env=env, timeout=TIMEOUT)


@pytest.mark.parametrize("args", [("list",),
                                  ("plan", "--spec", "smoke", "--seed", "42"),
                                  ("plan", "--spec", "ramp-ec", "--seed", "7",
                                   "--gate", "p99_ms=50")],
                         ids=["list", "plan-smoke", "plan-ramp-ec"])
def test_cli_output_is_byte_equal_to_the_reference(args):
    got, want = port(*args), ref(*args)
    assert got.returncode == want.returncode == 0, got.stderr + want.stderr
    assert got.stdout == want.stdout


def test_cli_plan_deterministic_and_unknown_spec():
    p1 = port("plan", "--spec", "smoke", "--seed", "42")
    p2 = port("plan", "--spec", "smoke", "--seed", "42")
    assert p1.returncode == 0, p1.stderr
    assert p1.stdout == p2.stdout
    doc = json.loads(p1.stdout)
    assert doc["offered_ops"] == 180
    assert re.fullmatch(r"[0-9a-f]{64}", doc["replay_key"])
    bad = port("plan", "--spec", "nope", "--seed", "1")
    assert bad.returncode == 2 and "unknown spec" in bad.stderr
    badsoak = port("soak", "--scenario", "nope")
    assert badsoak.returncode == 2 and "unknown soak" in badsoak.stderr


def test_cli_run_exit_codes_gates_pass_and_fail():
    """gates-pass=0, gate-fail=1, unknown gate=2, on a CPU cluster."""
    ok = port("run", "--spec", "smoke-micro", "--seed", "3", "--device",
              "cpu", "--no-postmortem")
    assert ok.returncode == 0, ok.stdout + ok.stderr
    assert "ALL GATES PASS" in ok.stdout
    fail = port("run", "--spec", "smoke-micro", "--seed", "3", "--device",
                "cpu", "--no-postmortem", "--gate", "p99_ms=0.0001")
    assert fail.returncode == 1, fail.stdout + fail.stderr
    assert "FAIL p99" in fail.stdout
    typo = port("run", "--spec", "smoke-micro", "--seed", "3", "--device",
                "cpu", "--no-postmortem", "--gate", "goodput=1")
    assert typo.returncode == 2, typo.stdout + typo.stderr
    assert "unknown gate" in typo.stderr


def test_cli_report_equals_reference(tmp_path):
    """``tests/test_load.py::test_cli_report_reads_artifact``'s document:
    the port prints the reference's table; a missing file exits 2."""
    doc = {"kind": "graft-load ramp", "spec": "t", "seed": 1,
           "mode": "cluster_vstart", "vs_baseline": None,
           "session_only": True,
           "steps": [{"scale": 1, "offered_ops_s": 10.0,
                      "offered_ops": 10, "acked_ops_scraped": 10.0,
                      "p99_ms": 2.0, "passed": True, "gates": []}],
           "knee": {"scale": 1, "offered_ops_s": 10.0,
                    "acked_ops_scraped": 10.0, "p99_ms": 2.0}}
    path = tmp_path / "LOAD_r99.json"
    path.write_text(json.dumps(doc))
    got, want = port("report", str(path)), ref("report", str(path))
    assert got.returncode == want.returncode == 0, got.stderr
    assert got.stdout == want.stdout
    assert "knee: 10.0 offered ops/s" in got.stdout
    missing = port("report", str(tmp_path / "nope.json"))
    assert missing.returncode == 2


@pytest.mark.parametrize("argv", [
    ["run", "--spec", "smoke-micro", "--seed", "3", "--no-postmortem"],
    ["ramp", "--spec", "smoke-micro", "--scales", "1", "--no-postmortem"],
    ["soak", "--scenario", "soak-mixed-crash", "--no-postmortem"]],
    ids=["run", "ramp", "soak"])
def test_cli_without_a_device_wants_the_card_and_boots_nothing(
        argv, monkeypatch, capsys, tmp_path):
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
    assert cli.main(argv) == 2
    assert "CUDA" in capsys.readouterr().err
    assert booted == [] and os.listdir(tmp_path) == []


def test_cli_run_without_a_device_fails_in_a_process_without_a_card():
    """The same through ``python -m`` in a process that sees no card."""
    env = dict(os.environ, PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run(
        [sys.executable, "-m", "ceph_tpu_torch.tools.load", "run", "--spec",
         "smoke-micro", "--seed", "3", "--no-postmortem"],
        capture_output=True, text=True, cwd=REPO, env=env, timeout=TIMEOUT)
    assert res.returncode == 2
    assert "CUDA" in res.stderr and "ALL GATES" not in res.stdout

"""On the card: each cell's command, as the benchmark is run, gives a
correct result line; each control, and each map fault, at the cells' own
sizes is refused.
Skips without a CUDA card (the ``card`` fixture decides, at run time).

    python3 -m pytest portbench/tests/test_portbench_card.py -m card
"""

import json
import subprocess
import sys

import pytest

from conftest import ROOT, cells

SEED = 2**31 + 99991


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
def test_cell_runs_correct_on_the_card(card, cell):
    p = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", "5", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-2000:]
    line = json.loads(p.stdout.strip().splitlines()[-1])
    assert line["correct"] is True, line["checks"]
    assert line["device"]["platform"] == "gpu"


@pytest.mark.card
@pytest.mark.parametrize("cell", cells())
def test_control_is_refused_on_the_card(card, cell):
    from portbench import controls

    checks = controls.run_control(ROOT, cell, SEED, card)
    assert any(v > lim for v, lim in checks.values()), checks


@pytest.mark.card
@pytest.mark.parametrize("cell", [c for c in cells() if c.endswith("osd_out")])
@pytest.mark.parametrize("fault", ["state_unchanged", "half_pool"])
def test_map_fault_is_refused_on_the_card(card, cell, fault):
    """At the cell's own map and pg_num, an epoch that is not applied, to
    the whole pool or to half of it, fails the check on every seed."""
    from portbench import controls

    checks = controls.run_control(ROOT, cell, SEED, card, fault=fault)
    assert checks["pgs_wrong"][0] > 0, checks

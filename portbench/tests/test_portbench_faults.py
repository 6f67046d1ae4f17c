"""Each fault a cell can have (its driver's ``FAULTS``), planted in the
program under the timed path at toy sizes on the CPU, makes ``correct``
come out false: an answer altered where it is produced, half of a tick's
batch left out, and (for the map) a step that returns its state
unchanged or is applied to half of the pool.  One card, so no exchange
between chips to leave out.  ``portbench/controls.py --fault`` reads the
same faults on the chip at the cells' own sizes."""

import json
import os

import pytest
import torch

from conftest import ROOT, toy_cells
from portbench import controls, harness

SEED = 2**31 + 4242


def _faults(cell):
    """The faults of the cell's driver, found by its traffic mix."""
    traffic = cell.split(".", 1)[1]
    with open(os.path.join(ROOT, "portbench", "traffic",
                           traffic + ".json")) as f:
        driver = json.load(f)["driver"]
    return sorted(harness.load_driver_module(ROOT, driver).FAULTS)


def _cases():
    return [(cell, fault) for cell in toy_cells() for fault in _faults(cell)]


def test_every_cell_plants_its_faults():
    by_driver = {}
    for cell, fault in _cases():
        by_driver.setdefault(cell.split(".")[-1], set()).add(fault)
    assert by_driver["osd_out"] == {"state_unchanged", "half_pool",
                                    "answer_altered"}
    for traffic in ("write_4m", "degraded_read_4m"):
        assert by_driver[traffic] == {"answer_altered", "half_batch"}


@pytest.mark.parametrize("cell,fault", _cases())
def test_planted_fault_is_refused(toy, cell, fault):
    seconds = 4.0 if cell.endswith("osd_out") else 1.0
    with controls.planted(toy, cell, fault):
        result, checks, _stats = harness.run(toy, cell, SEED, seconds, False,
                                             torch.device("cpu"))
    assert result["correct"] is False, checks
    unchecked = [k for k in checks if k.endswith("unchecked")]
    assert all(checks[k][0] == 0 for k in unchecked), checks


@pytest.mark.parametrize("cell,fault", _cases())
def test_fault_at_check_size_is_refused(toy, cell, fault):
    checks = controls.run_control(toy, cell, SEED + 1, torch.device("cpu"),
                                  fault=fault)
    assert any(v > lim for v, lim in checks.values()), checks

"""Every cell's control, the reference in the program's place with one
stated guarantee broken, comes out not correct (at toy sizes on the CPU;
``portbench/controls.py`` reads it on the chip at the cells' sizes)."""

import pytest
import torch

from conftest import toy_cells
from portbench import controls


@pytest.mark.parametrize("cell", toy_cells())
@pytest.mark.parametrize("seed", [2**31 + 1, 7])
def test_control_is_refused(toy, cell, seed):
    checks = controls.run_control(toy, cell, seed, torch.device("cpu"))
    assert any(v > lim for v, lim in checks.values()), checks
    unchecked = [k for k in checks if k.endswith("unchecked")]
    assert all(checks[k][0] == 0 for k in unchecked), checks

#!/usr/bin/env python3
"""The controls of ``correct``, and the faults it has to catch, read at a
cell's own sizes.

A control puts in the program's place what the configuration's
``controls`` key names for the cell's driver: the plain reference, or the
program on another path, with one guarantee that the configuration states
broken in the way a later change would be tempted to break it, to save
the step that costs the most.  A fault is planted in the program itself
(an answer altered where it is produced, half of a tick's batch left out,
a map step that returns its state unchanged).  Each driver brings its
own, as ``CONTROLS`` and ``FAULTS`` in ``portbench/drivers/<driver>.py``;
this file only runs them.

The benchmark's own runs never run a control or a fault.  On the chip:

    python3 portbench/controls.py --workload <cell> --seeds <n> [<n> ...]
        [--fault <name>]

runs set-up, the units the check samples, and the check, one seed after
another in this process, and prints each seed's compared numbers beside
their limits, one JSON line a seed.  ``portbench/tests/`` runs every
control and fault at a size the CPU holds.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@contextlib.contextmanager
def planted(root: str, workload: str, fault: str):
    """The cell's ``fault`` planted in the program while the block runs."""
    from portbench import harness

    cell = harness.load_cell(root, workload)
    mod = harness.load_driver_module(root, cell.traffic["driver"])
    undo = []

    def patch(obj, name, value):
        undo.append((obj, name, getattr(obj, name)))
        setattr(obj, name, value)

    try:
        mod.FAULTS[fault](patch)
        yield
    finally:
        for obj, name, value in reversed(undo):
            setattr(obj, name, value)


def run_control(root: str, workload: str, seed: int, device,
                units: int = 0, fault: str = ""):
    """The check's numbers at the cell's own sizes for the control, or,
    given ``fault``, for the program with that fault planted: set-up,
    ``units`` units of traffic (enough for the check when 0), the check."""
    from portbench import harness

    cell = harness.load_cell(root, workload)
    Driver = harness.load_driver(root, cell.traffic["driver"])
    with planted(root, workload, fault) if fault else \
            contextlib.nullcontext():
        drv = Driver(cell.config, cell.traffic, seed, device,
                     control=not fault)
        drv.setup()
        for _ in range(units or drv.units_to_check()):
            drv.step()
        drv.release()
    return drv.check()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="portbench/controls.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--units", type=int, default=0)
    p.add_argument("--fault", default="")
    args = p.parse_args(argv)
    here = os.path.dirname(os.path.abspath(__file__))
    sys.path[:] = [q for q in sys.path if os.path.abspath(q or ".") != here]
    sys.path.insert(0, ROOT)
    import torch

    device = torch.device("cuda", 0) if torch.cuda.is_available() \
        else torch.device("cpu")
    for seed in args.seeds:
        checks = run_control(ROOT, args.workload, seed, device, args.units,
                             args.fault)
        print(json.dumps({
            "workload": args.workload, "seed": seed,
            "run": args.fault or "control",
            "correct": all(v <= lim for v, lim in checks.values()),
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in checks.items()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

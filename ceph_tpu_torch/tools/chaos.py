"""graft-chaos CLI: run seeded fault-injection scenarios.

Counterpart of ``scripts/chaos.py``.  The cluster of ``run`` runs on CUDA
unless ``--device`` names another device (``--device cpu``); without a
card ``run`` exits 2 before it boots anything.

    python -m ceph_tpu_torch.tools.chaos list
    python -m ceph_tpu_torch.tools.chaos schedule --scenario smoke --seed 42
    python -m ceph_tpu_torch.tools.chaos run --scenario smoke --seed 42 \
        [--json] [--device cpu]

``run`` exits 0 when every invariant holds, 1 otherwise, and 2 for an
unknown scenario or no card; ``schedule`` prints the resolved fault plan
WITHOUT booting a cluster (two invocations with the same seed print
identical plans — the replay contract, cheap to eyeball).  Scenarios
with durable stores get a temporary directory that is removed
afterwards.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import os
import sys
import tempfile


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="chaos", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list built-in scenarios")
    for name in ("schedule", "run"):
        p = sub.add_parser(name)
        p.add_argument("--scenario", required=True)
        p.add_argument("--seed", type=int, default=1)
        p.add_argument("--json", action="store_true")
        p.add_argument("--scale", type=float, default=1.0,
                       help="storm-scenario size factor: 1.0 = the "
                            "full acceptance shape (slow), small "
                            "fractions run the same code paths at "
                            "tier-1 size (e.g. --scale 0.06)")
        if name == "run":
            p.add_argument("--postmortem", default=".", metavar="DIR",
                           help="directory for triggered "
                                "POSTMORTEM_*.json bundles (default .)")
            p.add_argument("--no-postmortem", action="store_true",
                           help="disable the flight recorder / "
                                "postmortem bundles for this run")
            p.add_argument("--device", default=None,
                           help="torch device (default: the current "
                                "CUDA card)")
    return ap.parse_args(argv)


def scenario_library(scale: float = 1.0):
    """Every scenario the CLI names: the builtins, the front-door,
    integrity and elastic libraries, and at a ``scale`` other than 1.0
    the scaled storm, front-door, integrity and elastic shapes over
    them."""
    from ceph_tpu_torch.chaos.balance import elastic_scenarios
    from ceph_tpu_torch.chaos.frontdoor import frontdoor_scenarios
    from ceph_tpu_torch.chaos.integrity import integrity_scenarios
    from ceph_tpu_torch.chaos.scenario import (builtin_scenarios,
                                               storm_scenarios)

    scenarios = builtin_scenarios()
    scenarios.update(frontdoor_scenarios(1.0))
    scenarios.update(integrity_scenarios(1.0))
    scenarios.update(elastic_scenarios(1.0))
    if scale != 1.0:
        scenarios.update(storm_scenarios(scale))
        scenarios.update(frontdoor_scenarios(scale))
        scenarios.update(integrity_scenarios(scale))
        scenarios.update(elastic_scenarios(scale))
    return scenarios


def run_one(sc, seed: int, tmpdir, device):
    """One verdict of ``sc`` at ``seed`` through the runner of its kind,
    on ``device``."""
    from ceph_tpu_torch.chaos.balance import ElasticScenario, run_elastic
    from ceph_tpu_torch.chaos.frontdoor import (FrontdoorScenario,
                                                run_frontdoor)
    from ceph_tpu_torch.chaos.integrity import FillScenario, run_fill_drain
    from ceph_tpu_torch.chaos.scenario import run_scenario

    if isinstance(sc, FrontdoorScenario):
        runner = run_frontdoor
    elif isinstance(sc, FillScenario):
        runner = run_fill_drain
    elif isinstance(sc, ElasticScenario):
        runner = run_elastic
    else:
        runner = run_scenario
    return asyncio.run(runner(sc, seed, tmpdir=tmpdir, device=device))


def main(argv=None) -> int:
    args = parse_args(argv)

    from ceph_tpu_torch.chaos.balance import (ElasticScenario,
                                              build_elastic_plan)
    from ceph_tpu_torch.chaos.integrity import FillScenario, build_fill_plan
    from ceph_tpu_torch.chaos.scenario import build_schedule

    scenarios = scenario_library(getattr(args, "scale", 1.0))
    if args.cmd == "list":
        for name, sc in sorted(scenarios.items()):
            print(f"{name:24s} osds={sc.osds} rounds={sc.rounds} "
                  f"store={sc.store} invariants={','.join(sc.invariants)}")
        return 0
    sc = scenarios.get(args.scenario)
    if sc is None:
        print(f"unknown scenario {args.scenario!r} "
              f"(try: {', '.join(sorted(scenarios))})", file=sys.stderr)
        return 2
    if args.cmd == "schedule":
        if isinstance(sc, FillScenario):
            print(json.dumps(build_fill_plan(sc, args.seed), indent=2))
        elif isinstance(sc, ElasticScenario):
            print(json.dumps(build_elastic_plan(sc, args.seed),
                             indent=2))
        else:
            print(json.dumps(build_schedule(sc, args.seed), indent=2))
        return 0
    from ceph_tpu_torch.utils.device import resolve_device_index

    try:
        device = resolve_device_index(args.device)
    except RuntimeError as e:
        print(f"chaos: {e}", file=sys.stderr)
        return 2
    if not args.no_postmortem:
        # graft-blackbox on by default for CLI runs: a conviction (or a
        # fired crash point / HEALTH_ERR edge) auto-produces a bundle
        from dataclasses import replace

        sc = replace(sc, config=tuple(sc.config) + (
            ("blackbox_enabled", 1),
            ("blackbox_dir", os.path.abspath(args.postmortem))))
    tmpdir = None
    try:
        if sc.store != "mem":
            tmpdir = tempfile.mkdtemp(prefix="graft_chaos_")
        verdict = run_one(sc, args.seed, tmpdir, device)
    finally:
        if tmpdir is not None:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)
    if args.json:
        print(json.dumps(verdict.as_dict(), indent=2))
    else:
        print(f"scenario {verdict.name} seed={verdict.seed}: "
              f"{'PASS' if verdict.passed else 'FAIL'} "
              f"({verdict.acked_objects} acked objects, "
              f"faults={verdict.counters})")
        for f in verdict.failures:
            print(f"  FAIL {f}")
        if getattr(verdict, "postmortem", None):
            print(f"  postmortem: {verdict.postmortem}")
    return 0 if verdict.passed else 1


if __name__ == "__main__":
    sys.exit(main())

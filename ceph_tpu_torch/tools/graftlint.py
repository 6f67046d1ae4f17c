"""graftlint CLI: the port's static-analysis gate.

Counterpart of ``scripts/graftlint.py``.  It lints the port
(``ceph_tpu_torch/``, ``chip_smoke.py`` and the port's tests) against
its own baseline, ``GRAFTLINT_TORCH_BASELINE.json`` at the repo root.

    python -m ceph_tpu_torch.tools.graftlint                 # text report
    python -m ceph_tpu_torch.tools.graftlint --json          # JSON report
    python -m ceph_tpu_torch.tools.graftlint --dot locks.dot # lock graph
    python -m ceph_tpu_torch.tools.graftlint --write-baseline
    python -m ceph_tpu_torch.tools.graftlint --runtime-edges dump.json
        # merge a live cluster's `lockdep dump` edges into the static
        # lock graph
    python -m ceph_tpu_torch.tools.graftlint --race batch-smoke \
        --seeds 1,2,3 [--device cpu]
        # dynamic half: run the scenario under the seeded
        # schedule-perturbation loop with the write-after-read tracker
        # armed, once per seed, its cluster on the card unless --device
        # names another device

Exit status: 0 when every finding is baselined (or none fire), 1
otherwise.  ``--race`` keeps the same contract (0 clean / 1 convictions
or scenario failures) and adds 2 for usage errors (unknown scenario,
unparsable seed list) and for a missing card, so CI can tell "found a
race" from "asked wrong".

The static modes are pure AST analysis: no device, no torch import.
``--race`` boots real (in-process) clusters and takes seconds per seed.
"""

from __future__ import annotations

import argparse
import json
import sys

from ceph_tpu_torch.analysis import baseline as baseline_mod
from ceph_tpu_torch.analysis import engine
from ceph_tpu_torch.analysis import lockgraph


def _race_main(args) -> int:
    """The --race driver: seeds x one scenario through racecheck.race_run.

    2 = usage error (bad seed list, unknown scenario, no card), 1 = any
    seed's verdict failed or the tracker convicted, 0 = all seeds
    clean."""
    from ceph_tpu_torch.analysis import racecheck
    from ceph_tpu_torch.chaos.scenario import builtin_scenarios
    from ceph_tpu_torch.utils.device import resolve_device_index

    try:
        seeds = [int(s) for s in args.seeds.split(",") if s.strip()]
        if not seeds:
            raise ValueError("empty seed list")
    except ValueError as e:
        print(f"graftlint --race: bad --seeds {args.seeds!r}: {e}",
              file=sys.stderr)
        return 2
    if args.race not in builtin_scenarios():
        print(f"graftlint --race: unknown scenario {args.race!r} "
              "(python -m ceph_tpu_torch.tools.chaos list)",
              file=sys.stderr)
        return 2
    try:
        device = resolve_device_index(args.device)
    except RuntimeError as e:
        print(f"graftlint --race: {e}", file=sys.stderr)
        return 2
    runs = []
    for seed in seeds:
        verdict, report, digest = racecheck.race_run(
            args.race, seed, shrink=not args.full_scale, device=device)
        runs.append({"seed": seed, "passed": verdict.passed,
                     "failures": list(verdict.failures),
                     "race": report, "trace_digest": digest})
    bad = sum(1 for r in runs
              if not r["passed"] or r["race"]["findings"])
    if args.as_json:
        print(json.dumps({"scenario": args.race, "runs": runs,
                          "ok": bad == 0}, indent=2, default=str))
    else:
        for r in runs:
            nf = len(r["race"]["findings"])
            status = "ok" if r["passed"] and not nf else "FAIL"
            print(f"{args.race} seed={r['seed']}: {status} "
                  f"(findings={nf}, ticks={r['race']['ticks']}, "
                  f"reads={r['race']['reads']}, "
                  f"writes={r['race']['writes']})")
            for f in r["failures"]:
                print(f"    invariant: {f}")
            for f in r["race"]["findings"]:
                print(f"    race: {f['message']}")
    return 1 if bad else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="graftlint",
                                 description="ceph_tpu_torch static analysis")
    ap.add_argument("paths", nargs="*",
                    help="files to lint (default: the port)")
    ap.add_argument("--json", action="store_true", dest="as_json",
                    help="emit the full report as JSON")
    ap.add_argument("--baseline",
                    default=baseline_mod.default_baseline_path(),
                    help="suppression baseline file (default: "
                         "GRAFTLINT_TORCH_BASELINE.json at the repo root)")
    ap.add_argument("--no-baseline", action="store_true",
                    help="ignore the baseline: report every finding")
    ap.add_argument("--write-baseline", action="store_true",
                    help="accept every current finding into --baseline "
                         "and exit 0")
    ap.add_argument("--runtime-edges", metavar="JSON",
                    help="a `lockdep dump` JSON file (or raw edges "
                         "mapping) to merge into the static lock graph")
    ap.add_argument("--dot", metavar="FILE",
                    help="write the merged lock-order graph as DOT")
    ap.add_argument("--race", metavar="SCENARIO",
                    help="dynamic mode: run SCENARIO under the seeded "
                         "schedule-perturbation loop with the "
                         "write-after-read tracker armed (once per "
                         "--seeds entry); skips the static lint")
    ap.add_argument("--seeds", default="1,2,3",
                    help="comma-separated seeds for --race "
                         "(default: 1,2,3)")
    ap.add_argument("--full-scale", action="store_true",
                    help="--race at the scenario's full workload scale "
                         "(default: the shrunk smoke scale)")
    ap.add_argument("--device", default=None,
                    help="torch device of --race's clusters (default: "
                         "the current CUDA card)")
    args = ap.parse_args(argv)

    if args.race:
        return _race_main(args)

    runtime_edges = None
    if args.runtime_edges:
        with open(args.runtime_edges, encoding="utf-8") as f:
            doc = json.load(f)
        runtime_edges = doc.get("edges", doc)

    baseline = set()
    if not args.no_baseline and not args.write_baseline:
        baseline = baseline_mod.load_baseline(args.baseline)

    report = engine.run_lint(paths=args.paths or None,
                             baseline=baseline,
                             runtime_edges=runtime_edges)

    if args.dot:
        # the lockgraph rule already extracted the edges during run_lint
        static_edges = report.static_edges_raw or {}
        cycle = (report.lock_graph or {}).get("cycle")
        with open(args.dot, "w", encoding="utf-8") as f:
            f.write(lockgraph.to_dot(static_edges, runtime_edges or {},
                                     cycle))
            f.write("\n")
        print(f"lock graph written to {args.dot}", file=sys.stderr)

    if args.write_baseline:
        n = baseline_mod.write_baseline(args.baseline, report.findings)
        print(f"baseline written: {n} suppression(s) -> {args.baseline}")
        return 0

    if args.as_json:
        print(engine.dump_report_json(report))
    else:
        print(report.render_text())
    return 0 if report.ok else 1


if __name__ == "__main__":
    sys.exit(main())

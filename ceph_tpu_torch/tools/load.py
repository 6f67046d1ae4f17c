"""graft-load CLI: seeded traffic windows, saturation ramps, soaks.

Counterpart of ``scripts/load.py``.  The cluster of ``run``, ``ramp``
and ``soak`` runs on CUDA unless ``--device`` names another device
(``--device cpu``); without a card those exit non-zero before they boot
anything.

    python -m ceph_tpu_torch.tools.load list
    python -m ceph_tpu_torch.tools.load plan --spec smoke --seed 42
    python -m ceph_tpu_torch.tools.load run  --spec smoke --seed 42 [--json]
    python -m ceph_tpu_torch.tools.load ramp --spec ramp-ec --seed 42 [--out PATH]
    python -m ceph_tpu_torch.tools.load soak --scenario soak-mixed-crash --seed 42
    python -m ceph_tpu_torch.tools.load report [PATH]

``plan`` prints the resolved per-client op schedule's replay key (and
op counts) WITHOUT booting a cluster — two invocations with one seed
print identical output.  ``run`` drives one judged window: exit 0 when
every SLO gate passes, 1 otherwise.  ``ramp`` sweeps the offered rate,
writes a ``LOAD_torch_r<n>.json`` artifact at the repo root (or
``--out``), and exits 0 iff a knee was found (at least one step passed
every gate).  ``soak`` composes sustained traffic with a seeded chaos
fault schedule: exit 0 iff the durability/frontier invariants hold.
``--gate name=value`` overrides one SLO threshold (e.g. ``--gate
p99_ms=50`` to watch a gate fail).  Exit 2: an unknown spec, soak or
gate, a missing or unreadable artifact, or no card.
"""

from __future__ import annotations

import argparse
import asyncio
import glob
import json
import os
import sys
import tempfile


def _gate_overrides(spec, pairs):
    if not pairs:
        return spec
    from dataclasses import replace

    gates = dict(spec.gates)
    for pair in pairs:
        name, _, value = pair.partition("=")
        if name not in gates:
            # a typo'd gate must not silently judge nothing
            print(f"unknown gate '{name}' "
                  f"(try: {', '.join(sorted(gates))})", file=sys.stderr)
            raise SystemExit(2)
        try:
            gates[name] = float(value)
        except ValueError:
            print(f"gate '{name}' needs a numeric threshold, got "
                  f"{value!r}", file=sys.stderr)
            raise SystemExit(2)
    return replace(spec, gates=tuple(sorted(gates.items())))


def _with_blackbox(spec, args):
    """Arm the flight recorder for a CLI run (on by default: a failed
    judgment produces a POSTMORTEM_*.json bundle in --postmortem DIR;
    --no-postmortem reverts to the library default of
    blackbox_enabled=0)."""
    if getattr(args, "no_postmortem", False):
        return spec
    from dataclasses import replace

    return replace(spec, config=tuple(spec.config) + (
        ("blackbox_enabled", 1),
        ("blackbox_dir", os.path.abspath(args.postmortem))))


def _with_tmpdir(spec_store, fn):
    tmpdir = None
    try:
        if spec_store != "mem":
            tmpdir = tempfile.mkdtemp(prefix="graft_load_")
        return fn(tmpdir)
    finally:
        if tmpdir is not None:
            import shutil

            shutil.rmtree(tmpdir, ignore_errors=True)


def _device(args):
    """The device ``--device`` names (the current CUDA card unless it
    names another), or None after a message when there is no card."""
    from ceph_tpu_torch.utils.device import resolve_device_index

    try:
        return resolve_device_index(args.device)
    except RuntimeError as e:
        print(f"load: {e}", file=sys.stderr)
        return None


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="load", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("list", help="list built-in load specs and soaks")
    for name in ("plan", "run", "ramp"):
        p = sub.add_parser(name)
        p.add_argument("--spec", required=True)
        p.add_argument("--seed", type=int, default=1)
        p.add_argument("--json", action="store_true")
        p.add_argument("--gate", action="append", default=[],
                       metavar="NAME=VALUE",
                       help="override one SLO gate threshold")
        if name in ("run", "ramp"):
            p.add_argument("--postmortem", default=".", metavar="DIR",
                           help="directory for triggered "
                                "POSTMORTEM_*.json bundles (default .)")
            p.add_argument("--no-postmortem", action="store_true",
                           help="disable the flight recorder / "
                                "postmortem bundles for this run")
            p.add_argument("--device", default=None,
                           help="torch device (default: the current "
                                "CUDA card)")
        if name == "ramp":
            p.add_argument("--scales", default=None,
                           help="comma-separated rate multipliers "
                                "(default 1,2,4,8,16,32,64)")
            p.add_argument("--out", default=None,
                           help="artifact path (default "
                                "LOAD_torch_r<n>.json)")
    p = sub.add_parser("soak")
    p.add_argument("--scenario", required=True)
    p.add_argument("--seed", type=int, default=1)
    p.add_argument("--json", action="store_true")
    p.add_argument("--postmortem", default=".", metavar="DIR",
                   help="directory for triggered POSTMORTEM_*.json "
                        "bundles (default .)")
    p.add_argument("--no-postmortem", action="store_true",
                   help="disable the flight recorder / postmortem "
                        "bundles for this run")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card)")
    p = sub.add_parser("report")
    p.add_argument("path", nargs="?", default=None,
                   help="LOAD_torch_r*.json (default: latest)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ceph_tpu_torch.load import ramp as rampmod
    from ceph_tpu_torch.load.driver import (build_plan, builtin_specs,
                                            plan_key, run_load)
    from ceph_tpu_torch.load.soak import builtin_soaks, run_soak

    specs = builtin_specs()
    soaks = builtin_soaks()
    if args.cmd == "list":
        for name, sp in sorted(specs.items()):
            print(f"{name:16s} clients={sp.clients} sessions={sp.sessions} "
                  f"rate={sp.rate}/client x {sp.duration}s "
                  f"pool={sp.pool_kind} verbs="
                  + ",".join(v for v, _ in sp.verbs))
        for name, sk in sorted(soaks.items()):
            print(f"{name:24s} [soak] rounds={sk.rounds} "
                  f"store={sk.load.store} "
                  f"invariants={','.join(sk.invariants)}")
        return 0

    if args.cmd == "soak":
        sk = soaks.get(args.scenario)
        if sk is None:
            print(f"unknown soak {args.scenario!r} "
                  f"(try: {', '.join(sorted(soaks))})", file=sys.stderr)
            return 2
        device = _device(args)
        if device is None:
            return 2
        from dataclasses import replace as _replace

        sk = _replace(sk, load=_with_blackbox(sk.load, args))
        verdict = _with_tmpdir(sk.load.store, lambda tmpdir: asyncio.run(
            run_soak(sk, args.seed, tmpdir=tmpdir, device=device)))
        if args.json:
            print(json.dumps(verdict.as_dict(), indent=2))
        else:
            print(f"soak {verdict.name} seed={verdict.seed}: "
                  f"{'PASS' if verdict.passed else 'FAIL'} "
                  f"({verdict.acked_objects} tracked objects, "
                  f"faults={verdict.counters})")
            for f in verdict.failures:
                print(f"  FAIL {f}")
            if verdict.postmortem:
                print(f"  postmortem: {verdict.postmortem}")
        return 0 if verdict.passed else 1

    if args.cmd == "report":
        path = args.path
        if path is None:
            arts = sorted(glob.glob(os.path.join(
                rampmod._REPO, rampmod.ARTIFACT_PREFIX + "*.json")))
            if not arts:
                print(f"no {rampmod.ARTIFACT_PREFIX}*.json artifacts",
                      file=sys.stderr)
                return 2
            path = arts[-1]
        try:
            with open(path) as f:
                doc = json.load(f)
        except (OSError, ValueError) as e:
            print(f"unreadable artifact {path}: {e}", file=sys.stderr)
            return 2
        print(rampmod.format_table(doc))
        return 0

    spec = specs.get(args.spec)
    if spec is None:
        print(f"unknown spec {args.spec!r} "
              f"(try: {', '.join(sorted(specs))})", file=sys.stderr)
        return 2
    spec = _gate_overrides(spec, args.gate)

    if args.cmd == "plan":
        plan = build_plan(spec, args.seed)
        doc = {"spec": spec.name, "seed": args.seed,
               "replay_key": plan_key(plan),
               "clients": len(plan),
               "offered_ops": sum(len(ops) for ops in plan),
               "verbs": {}}
        for ops in plan:
            for op in ops:
                doc["verbs"][op["verb"]] = \
                    doc["verbs"].get(op["verb"], 0) + 1
        print(json.dumps(doc, indent=2, sort_keys=True))
        return 0

    device = _device(args)
    if device is None:
        return 2
    spec = _with_blackbox(spec, args)
    if args.cmd == "run":
        result, report = _with_tmpdir(
            spec.store, lambda tmpdir: asyncio.run(
                run_load(spec, args.seed, tmpdir=tmpdir, device=device)))
        if args.json:
            print(json.dumps({"result": result.as_dict(),
                              "gates": report.as_rows(),
                              "passed": report.passed,
                              "postmortem": report.postmortem},
                             indent=2))
        else:
            print(f"load {spec.name} seed={args.seed}: "
                  f"{'ALL GATES PASS' if report.passed else 'GATE FAIL'} "
                  f"({result.acked_ops}/{result.offered} acked, "
                  f"plan {result.plan_key[:12]})")
            for r in report.as_rows():
                mark = "PASS" if r["passed"] else "FAIL"
                print(f"  {mark} {r['gate']:8s} value={r['value']} "
                      f"threshold={r['threshold']} [{r['source']}]"
                      + (f" {r['note']}" if r["note"] else ""))
            if report.postmortem:
                print(f"  postmortem: {report.postmortem}")
        return 0 if report.passed else 1

    # ramp
    scales = tuple(float(s) for s in args.scales.split(",")) \
        if args.scales else rampmod.DEFAULT_SCALES
    doc = _with_tmpdir(spec.store, lambda tmpdir: asyncio.run(
        rampmod.ramp(spec, args.seed, scales=scales, tmpdir=tmpdir,
                     device=device)))
    path = rampmod.write_artifact(doc, out=args.out)
    if args.json:
        print(json.dumps(doc, indent=2))
    else:
        print(rampmod.format_table(doc))
    # stderr: --json stdout must stay a parseable document
    print(f"wrote {path}", file=sys.stderr)
    return 0 if doc.get("knee") else 1


if __name__ == "__main__":
    sys.exit(main())

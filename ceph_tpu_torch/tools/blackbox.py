"""graft-blackbox CLI: render postmortem bundles.

Counterpart of ``scripts/blackbox.py``, on the port's
``trace/postmortem.py`` bundles.  It reads files only and does no device
work.

    python -m ceph_tpu_torch.tools.blackbox report   [PATH]
    python -m ceph_tpu_torch.tools.blackbox key      [PATH]
    python -m ceph_tpu_torch.tools.blackbox perfetto [PATH] --out trace.json

``report`` reconstructs the breach window from a POSTMORTEM_*.json
bundle: the trigger + failing gates, the per-stage attribution of the
late/convicted ops (wall_coverage over the breach set), the
top-suspects table (daemon/PG/stage), and the skew-corrected merged
cluster timeline.  ``key`` prints the bundle's deterministic replay
key (bit-identical across two runs of one seed — the seeded-replay
witness).  ``perfetto`` exports the bundle's op timelines + flight
rings as a chrome://tracing / Perfetto JSON document.

PATH defaults to the newest POSTMORTEM_*.json in the current
directory.  Exit codes: 0 success, 1 bundle found but malformed for
the request, 2 usage / no bundle.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys


def _resolve(path) -> str:
    if path:
        return path
    bundles = sorted(glob.glob("POSTMORTEM_*.json"),
                     key=os.path.getmtime)
    if not bundles:
        print("no POSTMORTEM_*.json bundle here (pass a path)",
              file=sys.stderr)
        raise SystemExit(2)
    return bundles[-1]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="blackbox", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("report", "key", "perfetto"):
        p = sub.add_parser(name)
        p.add_argument("path", nargs="?", default=None,
                       help="POSTMORTEM_*.json (default: newest here)")
        if name == "report":
            p.add_argument("--json", action="store_true",
                           help="emit the breach report as JSON")
            p.add_argument("--tail", type=int, default=30,
                           help="timeline events to show (default 30)")
        if name == "perfetto":
            p.add_argument("--out", default=None,
                           help="output path (default <bundle>.trace.json)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    from ceph_tpu_torch.trace import postmortem as pm

    path = _resolve(args.path)
    try:
        bundle = pm.load_bundle(path)
    except (OSError, ValueError) as e:
        print(f"unreadable bundle {path}: {e}", file=sys.stderr)
        return 2

    if args.cmd == "key":
        print(pm.replay_key(bundle))
        return 0

    if args.cmd == "perfetto":
        from ceph_tpu_torch.trace.perfetto import write

        out = args.out or f"{path[:-5]}.trace.json"
        try:
            doc = pm.chrome_trace(bundle)
        except (KeyError, TypeError, ValueError) as e:
            print(f"cannot export {path}: {e}", file=sys.stderr)
            return 1
        write(out, doc)
        print(f"wrote {out} ({len(doc['traceEvents'])} events)")
        return 0

    # report
    try:
        if args.json:
            print(json.dumps(
                {"trigger": bundle.get("trigger"),
                 "replay_key": pm.replay_key(bundle),
                 "breach": bundle.get("breach")
                 or pm.breach_report(bundle)},
                indent=2, sort_keys=True))
        else:
            print(pm.render_report(bundle, timeline_tail=args.tail))
    except (KeyError, TypeError, ValueError) as e:
        print(f"malformed bundle {path}: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())

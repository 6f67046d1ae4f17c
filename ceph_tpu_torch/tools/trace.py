"""graft-trace CLI: inspect, attribute, and export op traces.

Counterpart of ``scripts/trace.py``.  The clusters of ``demo`` and
``attribute`` run on CUDA unless ``--device`` names another device
(``--device cpu``); without a card they exit 2 before they boot
anything.  ``convert`` needs no cluster and no device.

    python -m ceph_tpu_torch.tools.trace convert dump.json -o trace.json
    python -m ceph_tpu_torch.tools.trace demo [--osds 3] [--json] \
        [--perfetto out.json] [--device cpu]
    python -m ceph_tpu_torch.tools.trace attribute [--secs 2.0] [--json] \
        [--device cpu]

``convert`` turns a saved ``dump_historic_ops`` payload (one daemon's
dict, or ``{daemon: payload}``) into Chrome-trace/Perfetto JSON.
``demo`` boots a 3-OSD vstart cluster with tracing enabled, drives one
EC write + read, and prints the op's cross-daemon span tree and stage
attribution.  ``attribute`` runs a short EC write burst and prints the
aggregated per-stage breakdown.

Exit codes: 0 success, 1 bad/missing input or an incomplete trace, 2
usage error (argparse) or no card.
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys


def _render_tree(nodes, indent=0, out=None):
    out = out if out is not None else []
    for n in nodes:
        dur = f"{n['dur'] * 1e3:.2f}ms" if n.get("dur") is not None \
            else "open"
        out.append(f"{'  ' * indent}{n['daemon']} {n['name']} [{dur}]")
        _render_tree(n["children"], indent + 1, out)
    return out


def cmd_convert(args) -> int:
    from ceph_tpu_torch.trace.perfetto import chrome_trace_from_dumps, write

    try:
        with open(args.dump, encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError) as e:
        print(f"cannot read {args.dump}: {e}", file=sys.stderr)
        return 1
    if not isinstance(doc, dict):
        print(f"{args.dump}: expected a dump_historic_ops payload "
              f"(dict), got {type(doc).__name__}", file=sys.stderr)
        return 1
    # accept one daemon's payload or a {daemon: payload} map
    dumps = doc if doc and all(isinstance(v, dict) and "ops" in v
                               for v in doc.values()) \
        else {"daemon": doc}
    if not all(isinstance(d.get("ops"), list) for d in dumps.values()):
        print(f"{args.dump}: no 'ops' list found", file=sys.stderr)
        return 1
    if not any(d.get("ops") for d in dumps.values()):
        print("no ops in dump", file=sys.stderr)
        return 1
    trace = chrome_trace_from_dumps(dumps)
    write(args.out, trace)
    print(f"wrote {len(trace['traceEvents'])} events -> {args.out}")
    return 0


async def _demo_cluster(n_osds: int, device):
    from ceph_tpu_torch.cluster.vstart import _fast_config, start_cluster

    config = _fast_config()
    config.trace_enabled = 1
    config.osd_op_history_size = 200
    cluster = await start_cluster(n_osds, config=config, device=device)
    client = await cluster.client()
    pool = await client.pool_create(
        "trace_ec", "erasure", pg_num=4,
        ec_profile={"plugin": "jerasure", "technique": "reed_sol_van",
                    "k": "2", "m": "1"})
    return cluster, client, pool


async def _demo(args, device) -> int:
    from ceph_tpu_torch.trace.attribution import attribute_events
    from ceph_tpu_torch.trace.perfetto import chrome_trace_from_spans, write
    from ceph_tpu_torch.trace.span import assemble_tree

    cluster, client, pool = await _demo_cluster(args.osds, device)
    try:
        io = client.ioctx(pool)
        await io.write_full("traced", b"\xa5" * 65536)
        assert await io.read("traced") == b"\xa5" * 65536
        # the newest client trace is the read; take the write's id
        tracer = client.objecter.tracer
        tids = list(tracer._traces)
        if not tids:
            print("no client trace recorded", file=sys.stderr)
            return 1
        tid = tids[-2] if len(tids) >= 2 else tids[-1]
        spans = tracer.dump_trace(tid)
        for oid in cluster.osds:
            spans += await cluster.daemon_command(
                f"osd.{oid}", {"prefix": "trace dump",
                               "args": {"trace_id": tid}})
        tree = assemble_tree(spans)
        # the traced op's stage attribution from the primary's tracker
        stages = None
        for oid in cluster.osds:
            hist = await cluster.daemon_command(
                f"osd.{oid}", "dump_historic_ops")
            for op in hist["ops"]:
                if op.get("trace_id") == tid:
                    evs = [(e["time"], e["event"])
                           for e in op["type_data"]["events"]]
                    stages = attribute_events(evs)[0]
        if args.json:
            print(json.dumps({"trace_id": tid, "tree": tree,
                              "stages": stages}, indent=2, default=str))
        else:
            print(f"trace {tid}:")
            print("\n".join(_render_tree(tree)))
            if stages:
                print("stage attribution:")
                for stage, s in sorted(stages.items(),
                                       key=lambda kv: -kv[1]):
                    print(f"  {stage:<24} {s * 1e3:8.3f}ms")
        if args.perfetto:
            write(args.perfetto, chrome_trace_from_spans(spans))
            print(f"perfetto trace -> {args.perfetto}")
        if not tree or not spans:
            print("trace incomplete", file=sys.stderr)
            return 1
        return 0
    finally:
        await cluster.stop()


async def _attribute(args, device) -> int:
    import time

    from ceph_tpu_torch.trace.attribution import flush_op_history, \
        merge_reports

    cluster, client, pool = await _demo_cluster(3, device)
    try:
        io = client.ioctx(pool)
        blob = b"\xa5" * 65536
        await io.write_full("warm", blob)
        await flush_op_history(cluster, 200)
        lats, deadline = [], time.perf_counter() + args.secs
        i = 0
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            await io.write_full(f"attr_{i % 32}", blob)
            lats.append(time.perf_counter() - t0)
            i += 1
        wall = sum(lats) / len(lats)
        reports = []
        for oid in cluster.osds:
            reports.append(await cluster.daemon_command(
                "osd.%d" % oid,
                {"prefix": "dump_op_attribution",
                 "args": {"match": "write_full"}}))
        merged = merge_reports(reports, measured_wall_s=wall)
        if not merged.get("ops"):
            print("no attributed ops", file=sys.stderr)
            return 1
        if args.json:
            print(json.dumps(merged, indent=2))
        else:
            print(f"{merged['ops']} ops, wall_coverage="
                  f"{merged.get('wall_coverage')}")
            for stage, row in merged["stages"].items():
                print(f"  {stage:<24} {row['s'] * 1e3:9.3f}ms "
                      f"{row['frac'] * 100:5.1f}%")
        return 0
    finally:
        await cluster.stop()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="trace", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("convert",
                       help="dump_historic_ops JSON -> chrome trace")
    p.add_argument("dump")
    p.add_argument("-o", "--out", default="trace.json")
    p = sub.add_parser("demo", help="one traced op through vstart")
    p.add_argument("--osds", type=int, default=3)
    p.add_argument("--json", action="store_true")
    p.add_argument("--perfetto", help="write chrome trace JSON here")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card)")
    p = sub.add_parser("attribute", help="stage breakdown of a write burst")
    p.add_argument("--secs", type=float, default=2.0)
    p.add_argument("--json", action="store_true")
    p.add_argument("--device", default=None,
                   help="torch device (default: the current CUDA card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    if args.cmd == "convert":
        return cmd_convert(args)
    from ceph_tpu_torch.utils.device import resolve_device_index

    try:
        device = resolve_device_index(args.device)
    except RuntimeError as e:
        print(f"trace: {e}", file=sys.stderr)
        return 2
    if args.cmd == "demo":
        return asyncio.run(_demo(args, device))
    return asyncio.run(_attribute(args, device))


if __name__ == "__main__":
    sys.exit(main())

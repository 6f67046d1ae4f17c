"""balance: drive the graft-balance mgr subsystem on an ephemeral cluster.

Counterpart of ``scripts/balance.py``.  The cluster runs on CUDA unless
``--device`` names another device (``--device cpu``); without a card a
subcommand exits 2 before it boots anything.

Everything in this repo is in-process: there is no long-lived daemon to
connect to, so each subcommand boots a small vstart cluster with a mgr,
issues the corresponding ``balance *`` admin-socket command, and prints
the result.  The background loops stay OFF (``mgr_balancer_enabled=0``)
— the CLI is the explicit, pull-driven way to exercise the subsystem,
exactly like ``ceph balancer ...`` / ``ceph osd pool autoscale-status``
against a dev cluster.

    python -m ceph_tpu_torch.tools.balance SUBCOMMAND [--device cpu] ...
        status    [--osds N] [--json]
        optimize  [--osds N] [--pg-num N] [--dry-run]
        autoscale [--osds N] [--objects N] [--dry-run]
        grow      --count N [--osds-per-host N]
        drain     --osds 2,3 [--cluster-osds N]

Exit codes: 0 = command succeeded, 1 = operation failed (commit error,
reshape op stuck short of ``done``), 2 = usage error (bad arguments,
draining an OSD the cluster doesn't have, no card).
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys

# how long a grow/drain reshape op may take to reach "done" before the
# CLI calls it stuck (small clusters settle in a few seconds; the
# margin absorbs first kernel builds)
RESHAPE_DEADLINE = 120.0


def _config():
    from ceph_tpu_torch.cluster.vstart import _fast_config

    cfg = _fast_config()
    # loops off: every balancer/autoscaler/reshaper step below happens
    # because WE asked for it, so a run is deterministic and a disabled
    # subsystem provably does nothing in the background
    cfg.mgr_balancer_enabled = 0
    cfg.mgr_autoscale_enabled = 0
    return cfg


async def _boot(n_osds: int, device, osds_per_host: int = 1):
    from ceph_tpu_torch.cluster.vstart import start_cluster

    cluster = await start_cluster(n_osds, osds_per_host=osds_per_host,
                                  config=_config(), with_mgr=True,
                                  device=device)
    client = await cluster.client()
    return cluster, client


async def _seed_pool(cluster, client, pg_num: int, objects: int = 0,
                     size: int = 3):
    pool = await client.pool_create("balance", "replicated",
                                    pg_num=pg_num, size=size)
    io = client.ioctx(pool)
    for i in range(objects):
        await io.write_full(f"obj{i}", f"balance-{i}".encode() * 8)
    # let the fresh pool finish peering: the balancer (correctly)
    # refuses to optimize through PG_RECOVERING, and a just-created
    # pool is briefly exactly that
    loop = asyncio.get_event_loop()
    deadline = loop.time() + 30.0
    while loop.time() < deadline:
        if cluster.mon._health_data()["status"] == "HEALTH_OK":
            break
        await asyncio.sleep(0.1)
    return pool


async def _reshape_done(cluster, op_id: int, on_phase=None) -> dict:
    """Poll ``balance status`` (the pull-driven advance) until the op
    reaches ``done`` or the deadline passes.  ``on_phase(op)`` runs on
    every poll — the drain flow uses it to play the operator's part
    (stopping daemons once the op says ``wait-down``)."""
    loop = asyncio.get_event_loop()
    deadline = loop.time() + RESHAPE_DEADLINE
    last = {}
    while loop.time() < deadline:
        status = await cluster.daemon_command("mgr", "balance status")
        for op in status.get("reshape_ops", []):
            if op.get("id") == op_id:
                last = op
        if last.get("phase") == "done":
            return last
        if on_phase is not None and last:
            await on_phase(last)
        await asyncio.sleep(0.25)
    return last


def _print(doc, as_json: bool) -> None:
    if as_json:
        print(json.dumps(doc, indent=2, sort_keys=True, default=str))
    else:
        for k in sorted(doc):
            print(f"{k:18s} {doc[k]}")


async def _cmd_status(args, device) -> int:
    cluster, client = await _boot(args.osds, device)
    try:
        await _seed_pool(cluster, client, args.pg_num)
        status = await cluster.daemon_command("mgr", "balance status")
        _print(status, args.json)
        return 0
    finally:
        await cluster.stop()


async def _cmd_optimize(args, device) -> int:
    cluster, client = await _boot(args.osds, device)
    try:
        await _seed_pool(cluster, client, args.pg_num)
        result = await cluster.daemon_command(
            "mgr", {"prefix": "balance optimize",
                    "dry_run": bool(args.dry_run)})
        _print(result, args.json)
        if "commit_error" in result:
            print(f"FAIL commit: {result['commit_error']}",
                  file=sys.stderr)
            return 1
        verdict = ("planned" if args.dry_run else "committed",
                   result.get("moves", 0), "moves")
        print("OK", *verdict)
        return 0
    finally:
        await cluster.stop()


async def _cmd_autoscale(args, device) -> int:
    cluster, client = await _boot(args.osds, device)
    try:
        await _seed_pool(cluster, client, args.pg_num,
                         objects=args.objects)
        result = await cluster.daemon_command(
            "mgr", {"prefix": "balance autoscale",
                    "dry_run": bool(args.dry_run)})
        _print(result, args.json)
        print("OK autoscale round complete")
        return 0
    finally:
        await cluster.stop()


async def _cmd_grow(args, device) -> int:
    cluster, client = await _boot(args.osds, device)
    try:
        await _seed_pool(cluster, client, args.pg_num, objects=8)
        op = await cluster.daemon_command(
            "mgr", {"prefix": "balance grow", "count": args.count,
                    "osds_per_host": args.osds_per_host})
        # the mon mints the ids + CRUSH hosts; booting the daemons is
        # the operator's job (vstart analog of racking new drives)
        new_ids = op.get("osds", [])
        await cluster.boot_osds(new_ids)
        final = await _reshape_done(cluster, op["id"])
        _print(final or op, args.json)
        if final.get("phase") != "done":
            print(f"FAIL grow op {op['id']} stuck in phase "
                  f"{final.get('phase')!r}", file=sys.stderr)
            return 1
        print(f"OK grew {args.osds} -> {args.osds + args.count} OSDs "
              f"(ids {new_ids})")
        return 0
    finally:
        await cluster.stop()


async def _cmd_drain(args, device, osd_ids) -> int:
    cluster, client = await _boot(args.cluster_osds, device)
    try:
        await _seed_pool(cluster, client, args.pg_num, objects=8)
        op = await cluster.daemon_command(
            "mgr", {"prefix": "balance drain", "osds": osd_ids})

        async def stop_when_drained(cur):
            # the operator's half of the handshake: once the op says
            # wait-down (data moved off), stop the retiring daemons so
            # the mon can mark them down and the op can purge them
            if cur.get("phase") != "wait-down":
                return
            for o in osd_ids:
                osd = cluster.osds.pop(o, None)
                if osd is not None:
                    await osd.stop()

        final = await _reshape_done(cluster, op["id"],
                                    on_phase=stop_when_drained)
        _print(final or op, args.json)
        if final.get("phase") != "done":
            print(f"FAIL drain op {op['id']} stuck in phase "
                  f"{final.get('phase')!r}", file=sys.stderr)
            return 1
        print(f"OK drained OSDs {osd_ids}")
        return 0
    finally:
        await cluster.stop()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="balance", description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    for name in ("status", "optimize", "autoscale", "grow", "drain"):
        p = sub.add_parser(name)
        p.add_argument("--pg-num", type=int, default=32)
        p.add_argument("--json", action="store_true")
        p.add_argument("--device", default=None,
                       help="torch device (default: the current CUDA "
                            "card)")
        if name == "drain":
            p.add_argument("--cluster-osds", type=int, default=5,
                           help="cluster size to boot (default 5)")
            p.add_argument("--osds", required=True,
                           help="comma-separated OSD ids to drain")
        else:
            p.add_argument("--osds", type=int, default=4,
                           help="cluster size to boot (default 4)")
        if name in ("optimize", "autoscale"):
            p.add_argument("--dry-run", action="store_true")
        if name == "autoscale":
            p.add_argument("--objects", type=int, default=64)
        if name == "grow":
            p.add_argument("--count", type=int, required=True)
            p.add_argument("--osds-per-host", type=int, default=1)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)

    osd_ids = None
    if args.cmd == "grow" and args.count <= 0:
        print(f"grow --count must be positive (got {args.count})",
              file=sys.stderr)
        return 2
    if args.cmd == "drain":
        try:
            osd_ids = [int(o) for o in args.osds.split(",") if o.strip()]
        except ValueError:
            print(f"unparsable --osds {args.osds!r} "
                  "(want e.g. --osds 2,3)", file=sys.stderr)
            return 2
        bad = [o for o in osd_ids if o < 0 or o >= args.cluster_osds]
        if not osd_ids or bad:
            print(f"--osds {args.osds!r} names OSDs outside the "
                  f"{args.cluster_osds}-OSD cluster", file=sys.stderr)
            return 2
        if len(osd_ids) >= args.cluster_osds:
            print("refusing to drain every OSD in the cluster",
                  file=sys.stderr)
            return 2
    from ceph_tpu_torch.utils.device import resolve_device_index

    try:
        device = resolve_device_index(args.device)
    except RuntimeError as e:
        print(f"balance: {e}", file=sys.stderr)
        return 2
    if args.cmd == "drain":
        return asyncio.run(_cmd_drain(args, device, osd_ids))
    handler = {"status": _cmd_status, "optimize": _cmd_optimize,
               "autoscale": _cmd_autoscale, "grow": _cmd_grow}[args.cmd]
    return asyncio.run(handler(args, device))


if __name__ == "__main__":
    sys.exit(main())

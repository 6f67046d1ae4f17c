"""ceph CLI analog: cluster status + per-daemon admin commands.

Reference: src/ceph.in — ``ceph status/health/df``, ``ceph daemon
<name> <cmd>`` (the admin-socket path), and ``ceph daemonperf <name>``
(the rate view over successive perf dumps).  Counterpart of
``ceph_tpu/tools/ceph.py``; the client runs on CUDA unless ``--device``
names another device.

    python -m ceph_tpu_torch.tools.ceph --mon host:port status
    python -m ceph_tpu_torch.tools.ceph --mon host:port daemon osd.0 perf dump
    python -m ceph_tpu_torch.tools.ceph --mon host:port daemonperf osd.0 1 5
"""

from __future__ import annotations

import argparse
import asyncio
import json
import sys
import time
from typing import Dict, Tuple

from ceph_tpu_torch.cluster.objecter import RadosClient
from ceph_tpu_torch.utils import Config


def _parse_addr(s: str) -> Tuple[str, int]:
    host, port = s.rsplit(":", 1)
    return (host, int(port))


def resolve_daemon(objecter, name: str, mon_addrs):
    """Daemon name -> address via the client's cached osdmap (the CLI's
    analog of asok-path resolution: osds/mgr/mds addresses ride the
    map); 'mon' is the mon we are talking to, 'mon.N' indexes the
    --mon list in order."""
    m = objecter.osdmap
    kind, _, num = name.partition(".")
    if kind == "mon":
        if not num:
            return tuple(objecter.mon_addr)
        rank = int(num)
        if rank >= len(mon_addrs):
            raise KeyError(
                f"mon.{rank} not in the --mon list "
                f"({len(mon_addrs)} given; pass every mon to address "
                "one by rank)")
        return tuple(mon_addrs[rank])
    if kind == "osd":
        addr = m.osd_addrs.get(int(num))
        if addr is None:
            raise KeyError(f"{name} has no address in the map")
        return tuple(addr)
    if kind == "mgr":
        if not getattr(m, "mgr_addr", None):
            raise KeyError("no mgr in the map")
        return tuple(m.mgr_addr)
    if kind == "mds":
        addrs = getattr(m, "mds_addrs", {}) or {}
        rank = int(num) if num else 0
        if rank not in addrs:
            raise KeyError(f"{name} has no address in the map")
        return tuple(addrs[rank])
    raise KeyError(f"unknown daemon kind {kind!r}")


def _rate_rows(prev: Dict, cur: Dict, dt: float):
    """Counter deltas/s between two perf dumps (daemonperf's view):
    ints rate; avg dicts rate avgcount and report interval-average
    latency."""
    rows = []
    for section in sorted(cur):
        for name in sorted(cur[section]):
            v1, v0 = cur[section][name], prev.get(section, {}).get(name)
            if isinstance(v1, (int, float)) and \
                    isinstance(v0, (int, float)):
                if v1 != v0:
                    rows.append((f"{section}.{name}",
                                 f"{(v1 - v0) / dt:.1f}/s"))
            elif isinstance(v1, dict) and "avgcount" in v1 and \
                    isinstance(v0, dict):
                dc = v1["avgcount"] - v0.get("avgcount", 0)
                ds = v1["sum"] - v0.get("sum", 0.0)
                if dc:
                    rows.append((f"{section}.{name}",
                                 f"{dc / dt:.1f}/s "
                                 f"avg {ds / dc * 1e3:.2f}ms"))
    return rows


async def daemonperf(objecter, addr, interval: float, count: int) -> None:
    """Poll 'perf dump' and print per-interval rates (reference
    'ceph daemonperf': DaemonWatcher's delta view)."""
    prev = await objecter.daemon_command(addr, {"prefix": "perf dump"})
    t_prev = time.perf_counter()
    for _ in range(count):
        await asyncio.sleep(interval)
        cur = await objecter.daemon_command(addr, {"prefix": "perf dump"})
        now = time.perf_counter()
        rows = _rate_rows(prev, cur, now - t_prev)
        stamp = time.strftime("%H:%M:%S")
        if not rows:
            print(f"{stamp}  (idle)")
        for name, rate in rows:
            print(f"{stamp}  {name:<44} {rate}")
        prev, t_prev = cur, now


async def _run(args) -> int:
    mons = [_parse_addr(a) for a in args.mon.split(",")]
    client = RadosClient(mons if len(mons) > 1 else mons[0],
                         name="cephcli", config=Config(),
                         device=args.device)
    await client.connect()
    obj = client.objecter
    try:
        if args.cmd in ("status", "health", "df"):
            print(json.dumps(
                await obj.mon_command({"prefix": args.cmd}), indent=2,
                default=str))
            return 0
        if args.cmd == "log":
            print(json.dumps(await obj.mon_command(
                {"prefix": "log last", "num": args.num}), indent=2))
            return 0
        if args.cmd == "daemon":
            addr = resolve_daemon(obj, args.name, mons)
            cmd = {"prefix": " ".join(args.command)}
            if args.args:
                cmd["args"] = json.loads(args.args)
            data = await obj.daemon_command(addr, cmd,
                                            timeout=args.timeout)
            print(data if isinstance(data, str)
                  else json.dumps(data, indent=2, default=str))
            return 0
        if args.cmd == "daemonperf":
            addr = resolve_daemon(obj, args.name, mons)
            await daemonperf(obj, addr, args.interval, args.count)
            return 0
        return 2
    finally:
        await client.shutdown()


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="ceph")
    ap.add_argument("--mon", required=True,
                    help="host:port[,host:port..]")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("status")
    sub.add_parser("health")
    sub.add_parser("df")
    p = sub.add_parser("log")
    p.add_argument("num", type=int, nargs="?", default=20)
    p = sub.add_parser("daemon",
                       help="admin-socket command on one daemon")
    p.add_argument("name", help="osd.N | mon[.N] | mgr | mds.N")
    p.add_argument("command", nargs="+",
                   help="command words, e.g. perf dump")
    p.add_argument("--args", help="JSON dict of command arguments")
    p.add_argument("--timeout", type=float, default=30.0)
    p = sub.add_parser("daemonperf", help="perf-counter rate view")
    p.add_argument("name")
    p.add_argument("interval", type=float, nargs="?", default=1.0)
    p.add_argument("count", type=int, nargs="?", default=5)
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return asyncio.run(_run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())

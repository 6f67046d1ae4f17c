"""rados CLI analog: object ops + bench against a live cluster.

Reference: src/tools/rados/rados.cc (put/get/ls/df/bench subcommands).
Counterpart of ``ceph_tpu/tools/rados.py``.  The client runs on CUDA
unless ``--device`` names another device (``--device cpu``).

    python -m ceph_tpu_torch.tools.rados --mon host:port -p pool bench 10
"""

from __future__ import annotations

import argparse
import asyncio
import sys
import time

from ceph_tpu_torch.cluster.objecter import RadosClient
from ceph_tpu_torch.utils import Config


def _parse_addr(s: str):
    host, port = s.rsplit(":", 1)
    return (host, int(port))


async def _run(args) -> int:
    mons = [_parse_addr(a) for a in args.mon.split(",")]
    client = RadosClient(mons if len(mons) > 1 else mons[0],
                         name="radoscli", config=Config(),
                         device=args.device)
    await client.connect()
    try:
        if args.cmd == "lspools":
            status = await client.status()
            for name, info in status["pools"].items():
                print(f"{info['id']} {name}")
            return 0
        pool = int(args.pool) if args.pool and args.pool.isdigit() else None
        if pool is None:
            status = await client.status()
            match = [i["id"] for n, i in status["pools"].items()
                     if n == args.pool]
            if not match:
                print(f"no pool {args.pool}", file=sys.stderr)
                return 1
            pool = match[0]
        io = client.ioctx(pool)
        if args.cmd == "put":
            data = open(args.infile, "rb").read() if args.infile else \
                sys.stdin.buffer.read()
            await io.write_full(args.obj, data)
        elif args.cmd == "get":
            data = await io.read(args.obj)
            if args.outfile:
                open(args.outfile, "wb").write(data)
            else:
                sys.stdout.buffer.write(data)
        elif args.cmd == "rm":
            await io.remove(args.obj)
        elif args.cmd == "ls":
            for oid in await io.list_objects():
                print(oid)
        elif args.cmd == "stat":
            print(args.obj, "size", await io.stat(args.obj))
        elif args.cmd == "bench":
            report = await bench(io, args.seconds, args.mode,
                                 concurrency=args.t,
                                 block_size=args.block_size,
                                 cleanup=not args.no_cleanup)
            print(f"{report['mode']}: {report['ops']} x "
                  f"{report['block_size']} B in {report['seconds']:.2f}s")
            print(f"  bandwidth: {report['mbps']:.1f} MB/s   "
                  f"iops: {report['iops']:.1f}")
            print(f"  latency ms: avg {report['lat_avg_ms']:.2f}  "
                  f"p50 {report['lat_p50_ms']:.2f}  "
                  f"p95 {report['lat_p95_ms']:.2f}  "
                  f"max {report['lat_max_ms']:.2f}")
        else:
            return 2
        return 0
    finally:
        await client.shutdown()


async def bench(io, seconds: float, mode: str = "write",
                concurrency: int = 16, block_size: int = 65536,
                cleanup: bool = True) -> dict:
    """The reference `rados bench` engine (src/tools/rados/rados.cc:103
    obj_bencher write/seq/rand): `concurrency` in-flight ops for
    `seconds`, returning bandwidth + latency percentiles.

    write: distinct objects; seq: read the bench objects in written
    order; rand: uniform random reads over them.  seq/rand write a
    seeding set first when none exists."""
    import random

    blob = b"\xa5" * block_size
    lats: list = []
    counter = {"n": 0}

    existing: list = []
    if mode in ("seq", "rand"):
        existing = [o for o in await io.list_objects()
                    if o.startswith("bench_")]
        if not existing:
            # seed enough objects to read back
            existing = [f"bench_{i}" for i in range(concurrency * 4)]
            await asyncio.gather(*(io.write_full(o, blob)
                                   for o in existing))

    deadline = time.perf_counter() + seconds
    rng = random.Random(0)

    async def worker(wid: int):
        i = wid
        while time.perf_counter() < deadline:
            t0 = time.perf_counter()
            if mode == "write":
                await io.write_full(f"bench_{i}", blob)
            elif mode == "seq":
                await io.read(existing[i % len(existing)])
            else:
                await io.read(existing[rng.randrange(len(existing))])
            lats.append(time.perf_counter() - t0)
            counter["n"] += 1
            i += concurrency

    t0 = time.perf_counter()
    await asyncio.gather(*(worker(w) for w in range(concurrency)))
    dt = max(time.perf_counter() - t0, 1e-9)
    n = counter["n"]
    lats.sort()

    def pct(p):
        return lats[min(len(lats) - 1, int(p * len(lats)))] * 1e3 \
            if lats else 0.0

    report = {
        "mode": mode, "ops": n, "block_size": block_size, "seconds": dt,
        "mbps": n * block_size / dt / 1e6, "iops": n / dt,
        "lat_avg_ms": (sum(lats) / len(lats) * 1e3) if lats else 0.0,
        "lat_p50_ms": pct(0.50), "lat_p95_ms": pct(0.95),
        "lat_max_ms": lats[-1] * 1e3 if lats else 0.0,
    }
    if cleanup and mode == "write":
        names = [o for o in await io.list_objects()
                 if o.startswith("bench_")]
        await asyncio.gather(*(io.remove(o) for o in names))
    return report


def parse_args(argv=None):
    ap = argparse.ArgumentParser(prog="rados")
    ap.add_argument("--mon", required=True, help="host:port[,host:port..]")
    ap.add_argument("-p", "--pool", help="pool name or id")
    ap.add_argument("--device", default=None,
                    help="torch device (default: the current CUDA card)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("lspools")
    p = sub.add_parser("put"); p.add_argument("obj"); p.add_argument("infile", nargs="?")
    p = sub.add_parser("get"); p.add_argument("obj"); p.add_argument("outfile", nargs="?")
    p = sub.add_parser("rm"); p.add_argument("obj")
    sub.add_parser("ls")
    p = sub.add_parser("stat"); p.add_argument("obj")
    p = sub.add_parser("bench")
    p.add_argument("seconds", type=float)
    p.add_argument("mode", nargs="?", default="write",
                   choices=("write", "seq", "rand"))
    p.add_argument("-t", type=int, default=16, help="concurrent ops")
    p.add_argument("--block-size", type=int, default=65536)
    p.add_argument("--no-cleanup", action="store_true")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    return asyncio.run(_run(parse_args(argv)))


if __name__ == "__main__":
    sys.exit(main())

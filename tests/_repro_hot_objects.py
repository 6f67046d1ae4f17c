"""ROADMAP §C3's repro, paced in both packages: the ``read-heavy`` load plan
at 256 PGs on a fresh 4-OSD cluster, every op's verb, object, start, end
and error recorded.

    python -m tests._repro_hot_objects port SEED [TSCALE] [--out PATH]
    python -m tests._repro_hot_objects ref  SEED [TSCALE] [--tick-verify]
    python -m tests._repro_hot_objects port|ref SEED --run-load [--tick-verify]

``TSCALE`` multiplies every planned arrival time (0.25: the same plan in a
quarter of the time, so more ops overlap on each hot object).
``--tick-verify`` runs the reference's ``ReadBatcher.verify`` on its tick,
as the port's always does, instead of its inline host crc (what a host
without ``google_crc32c`` runs).  The port runs on ``device="cpu"``.  It
prints one JSON summary (ops, failed ops, the most ops in flight on one
object, latencies) and a line per failed op; ``--out`` writes every op.
``--run-load`` runs ROADMAP's repro as written instead, one judged
``run_load`` window, and prints its offered and acked ops and errors.
Run it from the repository's root with ``JAX_PLATFORMS=cpu``.
"""

import argparse
import asyncio
import contextvars
import dataclasses
import json
import time
from collections import defaultdict


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("which", choices=("port", "ref"))
    ap.add_argument("seed", type=int)
    ap.add_argument("tscale", type=float, nargs="?", default=1.0)
    ap.add_argument("--tick-verify", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--run-load", action="store_true")
    args = ap.parse_args(argv)
    if args.which == "port":
        import torch

        import ceph_tpu_torch.cluster.objecter as obj
        import ceph_tpu_torch.load.driver as drv

        torch.set_num_threads(1)
        kw = {"device": "cpu"}
    else:
        import ceph_tpu.cluster.objecter as obj
        import ceph_tpu.load.driver as drv

        if args.tick_verify:
            import ceph_tpu.ops.crc32c as jcrc

            jcrc._gcrc = None
        kw = {}

    if args.run_load:
        spec = dataclasses.replace(drv.builtin_specs()["read-heavy"],
                                   pg_num=256)
        t0 = time.time()
        res, report = asyncio.run(drv.run_load(spec, args.seed, **kw))
        print(json.dumps({"which": args.which + (
            "-tick-verify" if args.tick_verify else ""), "run_load": True,
            "s": round(time.time() - t0, 1), "offered": res.offered,
            "acked": res.acked_ops, "errors": res.errors,
            "passed": report.passed}))
        return 0

    current = contextvars.ContextVar("op", default=None)
    recs = []
    real_one = drv._one_op

    async def one_op(ctx, spec, cid, op, result, record_acked):
        loop = asyncio.get_event_loop()
        r = {"cid": cid, "t": op["t"], "verb": op["verb"], "obj": op["obj"],
             "start": loop.time(), "err": None}
        current.set(r)
        await real_one(ctx, spec, cid, op, result, record_acked)
        r["end"] = loop.time()
        recs.append(r)

    def recording(real):
        async def call(self, *a, **k):
            try:
                return await real(self, *a, **k)
            except BaseException as e:
                r = current.get()
                if r is not None and r["err"] is None:
                    r["err"] = f"{type(e).__name__}: {e}"
                raise
        return call

    drv._one_op = one_op
    for name in ("write_full", "read", "append"):
        setattr(obj.IoCtx, name, recording(getattr(obj.IoCtx, name)))

    async def window():
        spec = dataclasses.replace(drv.builtin_specs()["read-heavy"],
                                   pg_num=256)
        plan = [[dict(o, t=round(o["t"] * args.tscale, 6)) for o in ops]
                for ops in drv.build_plan(spec, args.seed)]
        ctx = await drv.LoadContext.create(spec, args.seed, **kw)
        try:
            t0 = time.time()
            res = await drv.drive(ctx, spec, args.seed, plan=plan)
            return res, time.time() - t0
        finally:
            await ctx.close()

    t0 = time.time()
    res, wall = asyncio.run(window())
    by = defaultdict(list)
    for r in recs:
        prefix = "obj" if r["verb"] in ("write", "read") else "mob"
        by[f"{prefix}{r['obj']}"].append(r)
    most = {}
    for key, rs in by.items():
        n = peak = 0
        for _, d in sorted([(r["start"], 1) for r in rs]
                           + [(r["end"], -1) for r in rs]):
            n += d
            peak = max(peak, n)
        most[key] = peak
    lat = sorted(r["end"] - r["start"] for r in recs)
    failed = [r for r in recs if r["err"]
              and not r["err"].startswith("FileNotFound")]
    summary = {"which": args.which + ("-tick-verify" if args.tick_verify
                                      else ""),
               "seed": args.seed, "tscale": args.tscale, "ops": len(recs),
               "failed": len(failed), "window_s": round(wall, 3),
               "total_s": round(time.time() - t0, 1),
               "latency_p50_s": lat[len(lat) // 2], "latency_max_s": lat[-1],
               "most_in_flight": sorted(most.items(),
                                        key=lambda kv: -kv[1])[:6],
               "errors": dict(res.errors)}
    print(json.dumps(summary))
    for r in sorted(failed, key=lambda r: r["start"]):
        print("FAIL", r["verb"], f"obj{r['obj']}", f"client {r['cid']}",
              f"t {r['t']}", f"{r['end'] - r['start']:.3f} s", r["err"])
    if args.out:
        with open(args.out, "w") as f:
            json.dump({"summary": summary, "ops": recs}, f)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

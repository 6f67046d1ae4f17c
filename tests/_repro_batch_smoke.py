"""ROADMAP §C5's repro: ``batch-smoke`` at seed 31 in many processes side
by side, each read-repair logged.

    python -m tests._repro_batch_smoke one port|ref STORE_DIR
    python -m tests._repro_batch_smoke waves port|ref WAVES [--procs 12]

``one`` runs the scenario once (the port on ``device="cpu"``) and prints
one JSON line: the verdict, the objects left in a PG's inconsistent set,
and for each read-repair its PG, object, bad shards, the acting set, each
gather of its rebuild, the rebuild's result and, when it failed, the
OSDs its pushes could not reach and the rise of the primary's
``osd_unrecoverable`` and ``osd_recovery_target_moved``.  ``waves`` runs
``WAVES`` waves of ``--procs`` such processes side by side (a loaded
host) and prints the count of passed runs, of runs that left an object
inconsistent, and of rebuild results.  Run it from the repository's root
with ``JAX_PLATFORMS=cpu``.
"""

import argparse
import asyncio
import collections
import contextvars
import json
import os
import subprocess
import sys
import tempfile
import time

PERF = ("osd_unrecoverable", "osd_recovery_target_moved")


def one(which: str, store_dir: str) -> dict:
    if which == "port":
        import torch

        import ceph_tpu_torch.chaos.scenario as sc_mod
        import ceph_tpu_torch.cluster.backend_ec as be

        torch.set_num_threads(1)
        kw = {"device": "cpu"}
    else:
        import ceph_tpu.chaos.scenario as sc_mod
        import ceph_tpu.cluster.backend_ec as be

        kw = {}
    current = contextvars.ContextVar("repair", default=None)
    repairs = []
    mixin = be.ECBackendMixin
    real_queue = mixin._queue_read_repair
    real_rebuild = mixin._recover_ec_object
    real_gather = mixin._gather_shards

    def queue(self, pool, st, oid, bad):
        r = {"osd": self.osd_id, "pg": str(st.pgid), "oid": oid,
             "bad": {str(k): v for k, v in bad.items()},
             "acting": list(st.acting), "gathers": [], "result": None}
        repairs.append(r)
        token = current.set(r)       # the repair task inherits it
        try:
            return real_queue(self, pool, st, oid, bad)
        finally:
            current.reset(token)

    async def rebuild(self, pool, st, oid, targets=None, entry=None,
                      exclude_sources=None):
        r = current.get()
        if r is not None:
            r["perf0"] = {n: self.perf.get(n) for n in PERF}
            r["at"] = {"acting": list(st.acting), "up": list(st.up),
                       "epoch": self.osdmap.epoch}
        try:
            ok = await real_rebuild(self, pool, st, oid, targets=targets,
                                    entry=entry,
                                    exclude_sources=exclude_sources)
        except BaseException as e:
            if r is not None:
                r["result"] = f"raised {type(e).__name__}: {e}"
            raise
        if r is not None:
            r["result"], r["targets"] = ok, targets
            r["perf1"] = {n: self.perf.get(n) for n in PERF}
        return ok

    async def gather(self, pool, st, oid, *a, **k):
        r = current.get()
        try:
            out = await real_gather(self, pool, st, oid, *a, **k)
        except BaseException as e:
            if r is not None:
                r["gathers"].append(f"raised {type(e).__name__}: {e}")
            raise
        if r is not None:
            r["gathers"].append({"shards": sorted(out[0]), "size": out[1],
                                 "version": out[2]})
        return out

    mixin._queue_read_repair = queue
    mixin._recover_ec_object = rebuild
    mixin._gather_shards = gather
    inconsistent = {}
    real_judge = sc_mod.judge_invariants

    async def judge(cluster, *a, **k):
        failures = await real_judge(cluster, *a, **k)
        for o, d in cluster.osds.items():
            for pgid, st in d.pgs.items():
                if st.inconsistent:
                    inconsistent[f"osd.{o}:{pgid}"] = sorted(st.inconsistent)
        return failures

    sc_mod.judge_invariants = judge
    sc = sc_mod.builtin_scenarios()["batch-smoke"]
    t0 = time.time()
    v = asyncio.run(asyncio.wait_for(
        sc_mod.run_scenario(sc, 31, tmpdir=store_dir, **kw), 600))
    return {"which": which, "s": round(time.time() - t0, 1),
            "passed": v.passed, "failures": v.failures,
            "inconsistent": inconsistent, "repairs": repairs}


def waves(which: str, n: int, procs: int) -> dict:
    counts = collections.Counter()
    bad = []
    for _ in range(n):
        with tempfile.TemporaryDirectory(prefix="repro_batch_smoke_") as d:
            ps = [subprocess.Popen(
                [sys.executable, "-m", "tests._repro_batch_smoke", "one",
                 which, os.path.join(d, f"s{i}")],
                stdout=subprocess.PIPE, stderr=subprocess.DEVNULL,
                text=True) for i in range(procs)]
            for p in ps:
                out, _ = p.communicate(timeout=900)
                lines = out.strip().splitlines()
                if p.returncode or not lines:
                    counts["no verdict"] += 1
                    continue
                doc = json.loads(lines[-1])
                counts["passed" if doc["passed"] else "failed"] += 1
                if doc["inconsistent"]:
                    counts["left inconsistent"] += 1
                    bad.append(doc)
                for r in doc["repairs"]:
                    counts[f"rebuild {r['result']}"] += 1
    return {"which": which, "runs": n * procs, "counts": dict(counts),
            "left_inconsistent": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("one")
    p.add_argument("which", choices=("port", "ref"))
    p.add_argument("store_dir")
    p = sub.add_parser("waves")
    p.add_argument("which", choices=("port", "ref"))
    p.add_argument("waves", type=int)
    p.add_argument("--procs", type=int, default=12)
    args = ap.parse_args(argv)
    if args.cmd == "one":
        print(json.dumps(one(args.which, args.store_dir), default=str))
    else:
        print(json.dumps(waves(args.which, args.waves, args.procs),
                         default=str))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""ROADMAP §C8's repro: ``race_run("batch-smoke", seed, shrink=True)``
with every store write, gather and rebuild logged, and the cluster's
state dumped when an invariant fails.

    python tests/_repro_race_torn.py one port|ref SEED [DEVICE]
    python tests/_repro_race_torn.py runs port|ref SEEDS N [DEVICE] [--procs P]

``one`` runs the scenario once (the port on ``DEVICE``, the CPU unless
named; ``cuda`` on a card) and prints one JSON line: the verdict, and
for a failed invariant, per object it names, every FileStore write of
the object (time, store, shard, version, the first bytes of the shard's
byte view, the calling functions), every shard-group choice and gather
of the run (each shard's version and size, the group chosen, the first
bytes of each chosen shard), every rebuild (its OSD, targets and
result), and each OSD's PGs, logs, stored shards and recovery counters.
``runs`` runs ``N`` times each seed of the comma-separated ``SEEDS``,
``P`` processes side by side (1 by default, as on the card), and prints
the passed and failed runs per seed and each failure's dump.  Run it
from the repository's root with ``JAX_PLATFORMS=cpu``.
"""

import argparse
import json
import os
import subprocess
import sys
import time
import traceback


def dump_state(cluster, objs):
    """Each OSD's PGs (acting, primary, watermarks, the log entries of
    ``objs``), its stored shards of ``objs`` and its recovery counters."""
    out = {}
    for o, d in sorted(cluster.osds.items()):
        row = {"pgs": {}, "objs": {}}
        for pgid, st in d.pgs.items():
            log = [(str(e.version), e.op, e.oid) for e in st.log.entries
                   if e.oid in objs]
            if log:
                row["pgs"][str(pgid)] = {
                    "acting": list(st.acting), "primary": st.primary,
                    "last_update": str(st.last_update),
                    "last_complete": str(st.last_complete), "log": log}
        store = d.store
        for coll in store.list_collections():
            if not coll.startswith("pg_"):
                continue
            for oid in store.list_objects(coll):
                if oid in objs:
                    row["objs"][f"{coll}/{oid}"] = {
                        "shard": str(store.getattr(coll, oid, "shard")),
                        "size": str(store.getattr(coll, oid, "size")),
                        "version": str(store.get_version(coll, oid)),
                        "head": _head(store.read(coll, oid))}
        row["unclean"] = sorted(str(p) for p in d._unclean_pgs)
        row["retries"] = sorted(str(p) for p in d._recovery_retry_tasks)
        row["perf"] = {k: v for k, v in d.perf.dump()[f"osd.{o}"].items()
                       if isinstance(v, (int, float)) and v and
                       any(w in k for w in ("rewind", "recover", "repair",
                                            "peering"))}
        out[f"osd.{o}"] = row
    return out


def _task_stacks():
    """Every pending task of the running loop that is inside the
    cluster's code: its name and its frames there, innermost last."""
    import asyncio

    out = []
    for task in asyncio.all_tasks():
        frames = [f"{os.path.basename(f.f_code.co_filename)}:{f.f_lineno} "
                  f"{f.f_code.co_name}" for f in task.get_stack(limit=30)
                  if "cluster" in f.f_code.co_filename]
        if frames:
            out.append({"task": task.get_name(), "frames": frames})
    return out


def _head(data) -> str:
    return bytes(data)[:20].decode("latin1")


def one(which: str, seed: int, device: str) -> dict:
    root = "ceph_tpu_torch" if which == "port" else "ceph_tpu"
    if which == "port":
        import torch

        torch.set_num_threads(1)
    import importlib

    sc_mod = importlib.import_module(f"{root}.chaos.scenario")
    rc = importlib.import_module(f"{root}.analysis.racecheck")
    fs_mod = importlib.import_module(f"{root}.cluster.filestore")
    be = importlib.import_module(f"{root}.cluster.backend_ec")
    ps = importlib.import_module(f"{root}.ec.planar_store")
    t0 = time.time()
    hist = []

    def now():
        return round(time.time() - t0, 4)

    real_qt = fs_mod.FileStore.queue_transaction

    def queue_transaction(self, txn):
        out = real_qt(self, txn)
        touched = {(op[1], op[2]) for op in txn.ops
                   if len(op) > 2 and isinstance(op[1], str)
                   and op[1].startswith("pg_") and isinstance(op[2], str)}
        stack = [f.name for f in traceback.extract_stack()[:-1]
                 if "cluster" in f.filename][-4:]
        for coll, oid in sorted(touched):
            rec = {"t": now(), "kind": "write", "oid": oid,
                   "store": os.path.basename(self.path), "coll": coll,
                   "stack": stack}
            if self.stat(coll, oid) is not None:
                rec.update(version=str(self.get_version(coll, oid)),
                           shard=str(self.getattr(coll, oid, "shard")),
                           head=_head(self.read(coll, oid)))
            hist.append(rec)
        return out

    def head(blob, layout):
        if layout == ps.LAYOUT_PLANAR:
            blob = ps.planes_to_shard(ps.blob_to_planes(bytes(blob)),
                                      seam="relayout")
        return _head(blob)

    real_choose = be.choose_decode_group

    def choose(got, need_k, committed, committed_before=None):
        out = real_choose(got, need_k, committed,
                          committed_before=committed_before)
        hist.append({"t": now(), "kind": "choose",
                     "got": {s: (v, sz) for s, (_d, v, sz) in got.items()},
                     "chosen": sorted(out[0]), "version": out[2],
                     "size": out[1]})
        return out

    real_gather = be.ECBackendMixin._gather_shards

    async def gather(self, pool, st, oid, need_k, *a, **k):
        out = await real_gather(self, pool, st, oid, need_k, *a, **k)
        hist.append({"t": now(), "kind": "gather", "oid": oid,
                     "osd": self.osd_id, "version": out[2], "size": out[1],
                     "shards": {s: head(d, out[3].get(s))
                                for s, d in out[0].items()}})
        return out

    real_rebuild = be.ECBackendMixin._recover_ec_object

    async def rebuild(self, pool, st, oid, targets=None, entry=None,
                      exclude_sources=None):
        ok = await real_rebuild(self, pool, st, oid, targets=targets,
                                entry=entry, exclude_sources=exclude_sources)
        hist.append({"t": now(), "kind": "rebuild", "oid": oid,
                     "osd": self.osd_id, "targets": targets, "ok": ok})
        return ok

    fs_mod.FileStore.queue_transaction = queue_transaction
    be.choose_decode_group = choose
    be.ECBackendMixin._gather_shards = gather
    be.ECBackendMixin._recover_ec_object = rebuild
    dumps = []
    real_judge = sc_mod.judge_invariants

    async def judge(cluster, *a, **k):
        failures = await real_judge(cluster, *a, **k)
        objs = {f.split()[1] for f in failures if len(f.split()) > 1}
        if failures:
            dumps.append({"tasks": _task_stacks()})
        if objs:
            dumps.append({
                "failures": failures, "state": dump_state(cluster, objs),
                "stores": {os.path.basename(d.store.path): o
                           for o, d in cluster.osds.items()},
                "log": [h for h in hist if h.get("oid", "") in objs
                        or h["kind"] == "choose"]})
        return failures

    sc_mod.judge_invariants = judge
    kw = {"device": device} if which == "port" else {}
    verdict, report, _ = rc.race_run("batch-smoke", seed, shrink=True, **kw)
    return {"which": which, "seed": seed, "device": device,
            "s": round(time.time() - t0, 1), "passed": verdict.passed,
            "failures": verdict.failures, "ticks": report.get("ticks"),
            "dumps": dumps}


def runs(which: str, seeds, n: int, device: str, procs: int) -> dict:
    counts = {s: {"passed": 0, "failed": 0, "no result": 0} for s in seeds}
    bad = []
    order = [s for _ in range(n) for s in seeds]
    while order:
        batch, order = order[:procs], order[procs:]
        ps = [(s, subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "one", which,
             str(s), device], stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL, text=True)) for s in batch]
        for s, p in ps:
            try:
                out, _ = p.communicate(timeout=300)
            except subprocess.TimeoutExpired:
                p.kill()
                out, _ = p.communicate()
            lines = out.strip().splitlines()
            if p.returncode or not lines:
                counts[s]["no result"] += 1
                continue
            doc = json.loads(lines[-1])
            counts[s]["passed" if doc["passed"] else "failed"] += 1
            if not doc["passed"]:
                bad.append(doc)
    return {"which": which, "device": device, "counts": counts,
            "failed": bad}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    sub = ap.add_subparsers(dest="cmd", required=True)
    p = sub.add_parser("one")
    p.add_argument("which", choices=("port", "ref"))
    p.add_argument("seed", type=int)
    p.add_argument("device", nargs="?", default="cpu")
    p = sub.add_parser("runs")
    p.add_argument("which", choices=("port", "ref"))
    p.add_argument("seeds")
    p.add_argument("n", type=int)
    p.add_argument("device", nargs="?", default="cpu")
    p.add_argument("--procs", type=int, default=1)
    args = ap.parse_args(argv)
    if args.cmd == "one":
        doc = one(args.which, args.seed, args.device)
    else:
        doc = runs(args.which, [int(s) for s in args.seeds.split(",")],
                   args.n, args.device, args.procs)
    print(json.dumps(doc, default=str))
    return 0


if __name__ == "__main__":
    # run as a script: the repository's root, not tests/, on the path
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    raise SystemExit(main())

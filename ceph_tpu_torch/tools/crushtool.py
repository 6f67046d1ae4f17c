"""crushtool analog: build, decompile, and test CRUSH maps.

Reference: src/tools/crushtool.cc (--test drives CrushTester::test,
crushtool.cc:1024; --compile/--decompile the text map grammar).  Our map
interchange format is JSON (the text-map analog); --test reports
distribution stats.

Counterpart of ``ceph_tpu/tools/crushtool.py`` on the port's
``crush/compiler.py`` and ``crush/tester.py``: the same flags and the
same printed text.  ``--test`` maps through the batched mapper on the
card; ``main(argv, device="cpu")`` runs it on the CPU instead.
"""

from __future__ import annotations

import argparse
import json
import pickle
import sys

from ceph_tpu_torch.crush.tester import CrushTester
from ceph_tpu_torch.crush.types import (
    Bucket,
    CrushMap,
    Rule,
    Tunables,
)


def map_to_json(cmap: CrushMap) -> dict:
    return {
        "tunables": vars(cmap.tunables),
        "buckets": [
            {"id": b.id, "type": b.type, "alg": b.alg, "items": b.items,
             "weights": b.weights,
             "name": cmap.item_names.get(b.id)}
            for b in cmap.buckets.values()],
        "rules": [{"steps": [list(s) for s in r.steps], "type": r.type}
                  for r in cmap.rules],
        "types": cmap.type_names,
        "device_class": cmap.device_class,
    }


def map_from_json(d: dict) -> CrushMap:
    cmap = CrushMap(Tunables(**d.get("tunables", {})))
    for b in d["buckets"]:
        cmap.add_bucket(Bucket(id=b["id"], type=b["type"],
                               alg=b.get("alg", "straw2"),
                               items=b["items"], weights=b["weights"]),
                        name=b.get("name"))
    for r in d.get("rules", []):
        cmap.add_rule(Rule(steps=[tuple(s) for s in r["steps"]],
                           type=r.get("type", 1)))
    for dev, cls in d.get("device_class", {}).items():
        cmap.set_device_class(int(dev), cls)
    return cmap


def load_map(path: str) -> CrushMap:
    blob = open(path, "rb").read()
    if blob[:1] in (b"{", b"["):
        return map_from_json(json.loads(blob))
    if blob[:1] == b"\x80":
        # pickle protocol 2+ magic: the binary map form
        return pickle.loads(blob)
    # anything else textual is the operator map language
    from ceph_tpu_torch.crush.compiler import compile_text

    return compile_text(blob.decode())


def main(argv=None, device=None) -> int:
    """The command line; ``device`` is where ``--test`` maps (CUDA unless
    the caller names the CPU)."""
    ap = argparse.ArgumentParser(prog="crushtool")
    ap.add_argument("-i", "--infn", help="input map (json or pickled)")
    ap.add_argument("-o", "--outfn", help="output file")
    ap.add_argument("--compile", action="store_true",
                    help="text/json map -> pickled binary map "
                         "(crushtool -c)")
    ap.add_argument("--decompile", action="store_true",
                    help="binary map -> operator TEXT map (crushtool -d; "
                         "--json for the json form)")
    ap.add_argument("--json", action="store_true",
                    help="decompile to json instead of the text language")
    ap.add_argument("--test", action="store_true",
                    help="batch placement test (CrushTester)")
    ap.add_argument("--rule", type=int, default=0)
    ap.add_argument("--num-rep", type=int, default=3)
    ap.add_argument("--min-x", type=int, default=0)
    ap.add_argument("--max-x", type=int, default=1023)
    ap.add_argument("--show-utilization", action="store_true")
    ap.add_argument("--show-mappings", action="store_true")
    args = ap.parse_args(argv)

    if not args.infn:
        ap.error("-i required")
    cmap = load_map(args.infn)

    if args.compile:
        with open(args.outfn or "crush.bin", "wb") as f:
            pickle.dump(cmap, f)
        return 0
    if args.decompile:
        if args.json:
            out = json.dumps(map_to_json(cmap), indent=2)
        else:
            from ceph_tpu_torch.crush.compiler import decompile

            out = decompile(cmap)
        if args.outfn:
            open(args.outfn, "w").write(out)
        else:
            print(out)
        return 0
    if args.test:
        tester = CrushTester(cmap, device=device)
        if args.show_mappings:
            from ceph_tpu_torch.crush.scalar import ScalarMapper

            sm = ScalarMapper(cmap)
            w = [0x10000] * cmap.max_devices
            for x in range(args.min_x, args.max_x + 1):
                out = sm.do_rule(args.rule, x, args.num_rep, w)
                print(f"CRUSH rule {args.rule} x {x} {out}")
        report = tester.test(args.rule, args.num_rep,
                             args.min_x, args.max_x)
        print(report.summary() if args.show_utilization else
              f"tested {report.n_inputs} inputs: "
              f"{len(report.bad_mappings)} bad mappings, "
              f"max deviation {report.max_deviation:.3f}")
        return 1 if report.bad_mappings else 0
    ap.error("one of --compile/--decompile/--test required")
    return 2


if __name__ == "__main__":
    sys.exit(main())

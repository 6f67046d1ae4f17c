"""osdmaptool analog: inspect and simulate OSDMaps.

Reference: src/tools/osdmaptool.cc (--print, --test-map-pgs placement
histograms) and src/tools/psim.cc (whole-cluster placement simulation).
The whole-pool simulation runs through the batched TensorMapper path —
one device dispatch per pool instead of per-PG scalar loops.

Counterpart of ``ceph_tpu/tools/osdmaptool.py``: the same flags and the
same printed text, on pickles of the port's ``OSDMap``, whose own device
the placement runs on; ``main(argv, device="cpu")`` moves it to the CPU.
"""

from __future__ import annotations

import argparse
import pickle
import sys
from collections import Counter


def main(argv=None, device=None) -> int:
    """The command line; ``device``, when given, replaces the loaded
    map's device."""
    ap = argparse.ArgumentParser(prog="osdmaptool")
    ap.add_argument("mapfn", help="pickled OSDMap")
    ap.add_argument("--print", dest="do_print", action="store_true")
    ap.add_argument("--test-map-pgs", action="store_true")
    ap.add_argument("--pool", type=int, default=None)
    ap.add_argument("--upmap", metavar="OUTFN", default=None,
                    help="compute pg_upmap_items balancing PGs/OSD "
                         "(calc_pg_upmaps, OSDMap.cc:3771) and write the "
                         "rebalanced map")
    ap.add_argument("--upmap-deviation", type=float, default=0.05)
    ap.add_argument("--upmap-max", type=int, default=30)
    args = ap.parse_args(argv)

    m = pickle.loads(open(args.mapfn, "rb").read())
    if device is not None:
        m.device = device
    if args.upmap is not None:
        from ceph_tpu_torch.osdmap import balancer

        pools = [args.pool] if args.pool is not None else None
        before = balancer.pg_per_osd_stddev(m, pools)
        changes = balancer.calc_pg_upmaps(
            m, pools, max_deviation_ratio=args.upmap_deviation,
            max_iterations=args.upmap_max)
        after = balancer.pg_per_osd_stddev(m, pools)
        for pgid, items in sorted(changes.items()):
            pairs = " ".join(f"{a}->{b}" for a, b in items)
            print(f"upmap {pgid.pool}.{pgid.seed} items {pairs}")
        print(f"pgs-per-osd stddev {before:.2f} -> {after:.2f} "
              f"({len(changes)} pg_upmap_items)")
        with open(args.upmap, "wb") as f:
            f.write(pickle.dumps(m))
    if args.do_print:
        print(f"epoch {m.epoch}")
        print(f"max_osd {m.max_osd}")
        for pid, p in m.pools.items():
            kind = "erasure" if p.is_erasure() else "replicated"
            print(f"pool {pid} '{p.name}' {kind} size {p.size} "
                  f"pg_num {p.pg_num} crush_rule {p.crush_rule}")
        for o in range(m.max_osd):
            state = "up" if m.osd_up[o] else "down"
            inout = "in" if m.osd_weight[o] > 0 else "out"
            print(f"osd.{o} {state} {inout} weight "
                  f"{m.osd_weight[o] / 0x10000:.4f}")
    if args.test_map_pgs:
        pools = [args.pool] if args.pool is not None else list(m.pools)
        for pid in pools:
            pool = m.pools[pid]
            counts = Counter()
            primaries = Counter()
            from ceph_tpu_torch.osdmap.osdmap import PGid

            try:
                # whole-pool placement in ONE batched device dispatch
                up_arr, upp_arr = m.pool_mapping(pid)
                for seed in range(pool.pg_num):
                    for o in up_arr[seed]:
                        if 0 <= int(o) < m.max_osd:
                            counts[int(o)] += 1
                    if int(upp_arr[seed]) >= 0:
                        primaries[int(upp_arr[seed])] += 1
            except (NotImplementedError, AssertionError):
                for seed in range(pool.pg_num):
                    up, upp, acting, actp = m.pg_to_up_acting_osds(
                        PGid(pid, seed))
                    for o in acting:
                        if o >= 0:
                            counts[o] += 1
                    if actp >= 0:
                        primaries[actp] += 1
            avg = sum(counts.values()) / max(1, len(counts))
            print(f"pool {pid} pg_num {pool.pg_num}")
            for o in sorted(counts):
                print(f"  osd.{o}\t{counts[o]}\tprimary {primaries.get(o, 0)}")
            print(f"  avg {avg:.1f} | max/avg "
                  f"{max(counts.values()) / avg:.2f}" if counts else "  empty")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""A pool's PG placement, for the benchmark's reference.

The OSDMap chain of one PG, as Ceph runs it (OSDMap::_pg_to_up_acting_osds
without temp or upmap entries, every OSD existing and up):

- the placement seed: ``pps = rjenkins(stable_mod(seed, pgp_num), pool)``
  for a ``hashpspool`` pool;
- the raw set: ``crush_do_rule(rule, pps, size, osd_weights)`` on the
  frozen scalar CRUSH copy beside this file;
- the up set: for an erasure pool every slot keeps its position (a hole
  is CRUSH_ITEM_NONE); the primary is the first slot that is not a hole.

The map is built here from the configuration's numbers (racks, hosts,
OSDs, weights, the rule's steps), never taken from the program.
"""

from __future__ import annotations

import multiprocessing
from typing import List, Mapping, Sequence, Tuple

from portbench.reference.crush import jenkins
from portbench.reference.crush.scalar import ScalarMapper
from portbench.reference.crush.types import (
    CRUSH_ITEM_NONE,
    Bucket,
    CrushMap,
    Rule,
)

ITEM_NONE = CRUSH_ITEM_NONE


def stable_mod(x: int, b: int, bmask: int) -> int:
    return x & bmask if (x & bmask) < b else x & (bmask >> 1)


def calc_mask(n: int) -> int:
    return (1 << max(n - 1, 1).bit_length()) - 1


def build_map(cluster: Mapping) -> Tuple[CrushMap, int]:
    """root -> racks -> hosts -> OSDs of straw2 buckets (types 3, 2, 1)
    and the pool's rule; returns the map and the rule's number."""
    cmap = CrushMap()
    w = int(cluster["osd_weight"])
    per_host = int(cluster["osds_per_host"])
    racks, dev = [], 0
    for r in range(int(cluster["racks"])):
        hosts = []
        for h in range(int(cluster["hosts_per_rack"])):
            items = list(range(dev, dev + per_host))
            dev += per_host
            hid = cmap.add_bucket(Bucket(id=0, type=1, alg="straw2",
                                         items=items,
                                         weights=[w] * per_host))
            hosts.append(hid)
        rid = cmap.add_bucket(Bucket(
            id=0, type=2, alg="straw2", items=hosts,
            weights=[w * per_host] * len(hosts)))
        racks.append(rid)
    root = cmap.add_bucket(Bucket(
        id=0, type=3, alg="straw2", items=racks,
        weights=[w * per_host * int(cluster["hosts_per_rack"])] * len(racks)))
    steps = [tuple(root if a == "root" else a for a in s)
             for s in cluster["rule_steps"]]
    ruleno = cmap.add_rule(Rule(steps=steps))
    return cmap, ruleno


class Placement:
    """Up sets and primaries of one erasure pool's PGs."""

    def __init__(self, cluster: Mapping, pool: Mapping):
        self.cmap, self.rule = build_map(cluster)
        self.mapper = ScalarMapper(self.cmap)
        self.n_osds = self.cmap.max_devices
        self.pool_id = int(pool["pool_id"])
        self.size = int(pool["size"])
        self.pgp_num = int(pool["pg_num"])
        self.mask = calc_mask(self.pgp_num)

    def pps(self, seed: int) -> int:
        return jenkins.hash2(stable_mod(seed, self.pgp_num, self.mask),
                             self.pool_id)

    def up(self, seed: int, out: Sequence[int] = ()) -> Tuple[List[int], int]:
        """(up set, primary) of PG ``seed`` with the OSDs ``out`` marked
        out (weight 0) and every other OSD in at full weight."""
        weights = [0x10000] * self.n_osds
        for o in out:
            weights[o] = 0
        raw = self.mapper.do_rule(self.rule, self.pps(seed), self.size,
                                  weights)
        raw = raw + [ITEM_NONE] * (self.size - len(raw))
        primary = next((o for o in raw if o != ITEM_NONE), -1)
        return raw, primary


_WORKER = None


def _worker_init(cluster, pool):
    global _WORKER
    _WORKER = Placement(cluster, pool)


def _worker_pg(task):
    seed, now, before = task
    return _WORKER.up(seed, now), _WORKER.up(seed, before)


def reference_rows(cluster, pool, tasks, workers: int):
    """[((up, primary) now, (up, primary) before), ...] for ``tasks`` of
    (PG seed, OSDs out now, OSDs out before), in ``workers`` spawned
    processes (in this one when ``workers`` is 1), all ended on return."""
    if workers <= 1:
        ref = Placement(cluster, pool)
        return [(ref.up(s, now), ref.up(s, before)) for s, now, before
                in tasks]
    ctx = multiprocessing.get_context("spawn")
    procs = ctx.Pool(workers, initializer=_worker_init,
                     initargs=(cluster, pool))
    try:
        return procs.map(_worker_pg, tasks, chunksize=8)
    finally:
        procs.close()
        procs.join()

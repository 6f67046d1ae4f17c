"""PgAutoscaler: staged pg_num growth from observed per-pool load.

Counterpart of ``ceph_tpu/balance/autoscaler.py``.

Behavioral analog of the reference pg_autoscaler mgr module
(src/pybind/mgr/pg_autoscaler): each pool gets a pg_num TARGET from its
observed object load and the cluster's in-OSD count, and pools whose
target is at least double their current pg_num grow by one doubling per
tick — never more, because each doubling is a real PG split on the OSDs
(``pg.py::_split_pg``) and the staged walk keeps the split+backfill
work bounded.

Load observation rides the existing MMgrReport stream: every OSD's
heartbeat report carries ``osd_pool_<pid>_objects`` (primary PGs only,
so each object is counted once cluster-wide) — the mgr just sums across
daemons.  Targets honor two ceilings:

- ``mgr_autoscale_objects_per_pg``: grow when PGs get fatter than this
  many objects on average (the reference's target_size bias).
- ``mgr_autoscale_pgs_per_osd``: the cluster-wide PG budget — pool
  pg_num * size summed over pools must stay under budget * in-OSDs
  (mon_max_pg_per_osd analog), whatever the load says.

The split-then-move contract is preserved by issuing pg_num first and
pgp_num only on the NEXT tick once the map shows the split landed —
exactly the two-phase order ``mon._pool_set_pgnum`` enforces.
"""

from __future__ import annotations

from typing import Dict

# keep a pool's pg_num a power of two: seed folding (pg_num_mask) then
# splits PGs exactly in half, and the reference autoscaler does the same
def _next_pow2(n: int) -> int:
    p = 1
    while p < n:
        p <<= 1
    return p


def _floor_pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n.bit_length() - 1)


class PgAutoscaler:
    def __init__(self, mgr):
        self.mgr = mgr
        self.last_round: Dict = {}

    def _pool_objects(self, pid: int) -> int:
        total = 0
        for state in self.mgr.daemons.values():
            v = state["counters"].get(f"osd_pool_{pid}_objects", 0)
            if isinstance(v, (int, float)):
                total += int(v)
        return total

    def pool_targets(self) -> Dict[int, Dict]:
        """Per-pool status rows: current pg_num, observed objects, the
        load-derived target, and the pending pgp_num catch-up if any."""
        m = self.mgr.osdmap
        cfg = self.mgr.config
        if m is None:
            return {}
        n_in = sum(1 for o in range(m.max_osd)
                   if m.osd_exists[o] and m.osd_weight[o] > 0)
        per_pg = max(1, int(cfg.mgr_autoscale_objects_per_pg))
        budget = int(cfg.mgr_autoscale_pgs_per_osd) * max(n_in, 1)
        out: Dict[int, Dict] = {}
        for pid, pool in m.pools.items():
            if pool.is_erasure() or pool.tier_of >= 0:
                continue  # erasure pg_num is frozen; tiers follow base
            objects = self._pool_objects(pid)
            want = _next_pow2(max(1, (objects + per_pg - 1) // per_pg))
            # the budget caps TOTAL slots: this pool may use its share
            other_slots = sum(p.pg_num * p.size for q, p in m.pools.items()
                              if q != pid and not p.is_erasure())
            cap = (budget - other_slots) // max(pool.size, 1)
            target = max(pool.pg_num, min(want, _floor_pow2(max(1, cap))))
            out[pid] = {"pool": pool.name, "pg_num": pool.pg_num,
                        "pgp_num": pool.pgp_num, "objects": objects,
                        "target": target,
                        "split_pending": pool.pgp_num < pool.pg_num}
        return out

    async def tick(self, dry_run: bool = False) -> Dict:
        perf = self.mgr.perf
        m = self.mgr.osdmap
        result: Dict = {"epoch": m.epoch if m else 0, "actions": [],
                        "dry_run": dry_run}
        if m is None:
            result["skipped"] = "no osdmap yet"
            self.last_round = result
            return result
        perf.inc("mgr_autoscale_rounds")
        targets = self.pool_targets()
        for pid, row in targets.items():
            if row["split_pending"]:
                # phase 2 of a previous doubling: let the freshly-split
                # children migrate off their parents' placement
                action = {"pool": pid, "set": "pgp_num",
                          "val": row["pg_num"]}
            elif row["target"] >= 2 * row["pg_num"]:
                action = {"pool": pid, "set": "pg_num",
                          "val": row["pg_num"] * 2}
            else:
                continue
            result["actions"].append(action)
            if dry_run:
                continue
            try:
                await self.mgr.mon_command(
                    {"prefix": "osd pool set", "pool": row["pool"],
                     "var": action["set"], "val": action["val"]},
                    timeout=10.0)
                perf.inc("mgr_autoscale_splits"
                         if action["set"] == "pg_num"
                         else "mgr_autoscale_pgp_bumps")
            except (TimeoutError, RuntimeError, ConnectionError,
                    OSError) as e:
                action["error"] = repr(e)
        result["pools"] = targets
        self.last_round = result
        return result

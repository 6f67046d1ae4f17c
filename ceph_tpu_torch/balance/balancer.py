"""UpmapBalancer: the mgr loop that turns scored candidates into commits.

Counterpart of ``ceph_tpu/balance/balancer.py``.

Each tick works on a private deepcopy of the mgr's subscribed osdmap
(the optimizer mutates its scratch map; the authoritative map only
changes when the mon commits the Incremental), runs either the
vectorized scorer (``mgr_balancer_vectorized=1``, the default) or the
scalar anchor (``=0``, the bisection anchor), and commits the chosen
move-set through the ordinary ``osd pg-upmap-items`` mon command — one
Incremental, distributed to subscribers like any other map change.

Safety throttles, checked BEFORE any work:

- ``*full`` flags: a cluster whose OSDs are already backfillfull/full
  must not be asked to move data around (reference balancer module's
  no-op on unhealthy clusters).
- recovery/dmclock pressure: when the summed ``osd_recovery_yields``
  counter moved since the last tick, recovery is actively yielding to
  client QoS — the cluster is busy digesting a previous reshape, so the
  balancer waits (counted as ``mgr_balancer_throttled``).
- degraded health (``mgr_balancer_require_clean``): PG_DEGRADED /
  OSD_DOWN health checks pause optimization.

Every tick updates the ``mgr_balancer_*`` counter family whether or not
it commits, and the whole family is DECLARED at mgr init so a disabled
balancer is visible on the Prometheus scrape as all-zeros — the
provable-no-op contract the SLO balance gate asserts.

The plan (the skews and the optimizer, on the scratch copy) runs in an
executor thread with the mgr's device current: the scorer's device calls
would otherwise hold the mgr's event loop for the whole round.  The copy
is taken on the loop, where map pushes mutate the mgr's map.
"""

from __future__ import annotations

import asyncio
import copy
from typing import Dict, Optional

from ceph_tpu_torch.balance.scorer import calc_pg_upmaps_vectorized
from ceph_tpu_torch.osdmap.balancer import calc_pg_upmaps, pg_per_osd_stddev
from ceph_tpu_torch.utils.device import run_on

# health checks that mean "the cluster is busy recovering": balancing
# on top of an active backfill doubles the data movement for no gain —
# and, worse, can re-move a PG whose previous move is still
# backfilling, walking the acting set away from the only current copy.
# PG_RECOVERING is the live feed: mon-side pg_temp entries
# plus per-OSD unclean-primary-PG beacons, pessimistic until every up
# OSD has reported under the latest placement-changing epoch.
_UNCLEAN_CHECKS = ("PG_RECOVERING", "PG_DEGRADED", "OSD_DOWN",
                   "PG_UNDERSIZED")


class UpmapBalancer:
    def __init__(self, mgr):
        self.mgr = mgr
        self.last_round: Dict = {}
        self._last_recovery_yields: Optional[int] = None

    # -- throttles ----------------------------------------------------------

    def _recovery_pressure(self) -> bool:
        """dmclock/backfill pressure proxy: did any OSD's recovery yield
        to client QoS since our last look?"""
        total = 0
        for state in self.mgr.daemons.values():
            v = state["counters"].get("osd_recovery_yields", 0)
            if isinstance(v, (int, float)):
                total += int(v)
        prev = self._last_recovery_yields
        self._last_recovery_yields = total
        return prev is not None and total > prev

    async def _unclean_health(self) -> Optional[str]:
        if not self.mgr.config.mgr_balancer_require_clean:
            return None
        try:
            health = await self.mgr.mon_command({"prefix": "health"},
                                                timeout=5.0)
        except (TimeoutError, RuntimeError, ConnectionError, OSError):
            return "health unavailable"
        checks = (health or {}).get("checks", {})
        hits = [c for c in _UNCLEAN_CHECKS if c in checks]
        return ",".join(hits) if hits else None

    # -- the optimization round ----------------------------------------------

    async def tick(self, dry_run: bool = False) -> Dict:
        """One balancer round: measure, score, commit.  Returns a status
        dict (also kept as ``last_round`` for the admin command)."""
        cfg = self.mgr.config
        perf = self.mgr.perf
        m = self.mgr.osdmap
        result: Dict = {"epoch": m.epoch if m else 0, "moves": 0,
                        "dry_run": dry_run}
        if m is None:
            result["skipped"] = "no osdmap yet"
            self.last_round = result
            return result
        perf.inc("mgr_balancer_rounds")

        full_flags = m.flags & {"nearfull", "backfillfull", "full"}
        if full_flags:
            perf.inc("mgr_balancer_throttled")
            result["skipped"] = f"cluster flags: {sorted(full_flags)}"
            self.last_round = result
            return result
        if self._recovery_pressure():
            perf.inc("mgr_balancer_throttled")
            result["skipped"] = "recovery yielding to client QoS"
            self.last_round = result
            return result
        unclean = await self._unclean_health()
        if unclean:
            perf.inc("mgr_balancer_throttled")
            result["skipped"] = f"unclean health: {unclean}"
            self.last_round = result
            return result

        changes, scored, skew_before, skew_after = \
            await asyncio.get_running_loop().run_in_executor(
                None, run_on, self.mgr.device, self._plan,
                copy.deepcopy(m))
        if cfg.mgr_balancer_vectorized:
            perf.inc("mgr_balancer_candidates", scored)
        perf.set("mgr_balancer_skew_before_milli", int(skew_before * 1000))
        perf.set("mgr_balancer_skew_after_milli", int(skew_after * 1000))
        perf.inc("mgr_balancer_moves_proposed", len(changes))
        result.update(moves=len(changes),
                      skew_before=round(skew_before, 4),
                      skew_after=round(skew_after, 4))
        if not changes or dry_run:
            self.last_round = result
            return result

        # projected churn: every moved slot rewrites ~one PG's share of
        # the cluster's bytes (uniform estimate; the scenario judge
        # measures the REAL bytes via placement_delta)
        bytes_per_pg = self._bytes_per_pg(m)
        perf.inc("mgr_balancer_bytes_projected",
                 int(len(changes) * bytes_per_pg))

        items = {f"{pg.pool}.{pg.seed}": [list(p) for p in pairs]
                 for pg, pairs in changes.items()}
        try:
            await self.mgr.mon_command(
                {"prefix": "osd pg-upmap-items", "items": items},
                timeout=10.0)
        except (TimeoutError, RuntimeError, ConnectionError, OSError) as e:
            result["commit_error"] = repr(e)
            self.last_round = result
            return result
        perf.inc("mgr_balancer_moves_committed", len(changes))
        result["committed"] = True
        self.last_round = result
        return result

    def _plan(self, scratch):
        """The optimization on ``scratch``, a private copy of the mgr's
        map whose pg_upmap_items it mutates as it plans: (changes,
        candidates scored, skew before, skew after)."""
        cfg = self.mgr.config
        skew_before = pg_per_osd_stddev(scratch)
        max_moves = int(cfg.mgr_balancer_max_moves)
        ratio = float(cfg.mgr_balancer_max_deviation_ratio)
        scored = 0
        if cfg.mgr_balancer_vectorized:
            changes, scored = calc_pg_upmaps_vectorized(
                scratch, max_deviation_ratio=ratio,
                max_moves=max_moves,
                primary_weight=float(cfg.mgr_balancer_primary_weight),
                move_cost=float(cfg.mgr_balancer_move_cost))
        else:
            changes = calc_pg_upmaps(scratch, max_deviation_ratio=ratio)
            if len(changes) > max_moves:
                changes = dict(list(changes.items())[:max_moves])
        return changes, scored, skew_before, pg_per_osd_stddev(scratch)

    def _bytes_per_pg(self, m) -> float:
        """Uniform projected bytes per moved PG slot from the reported
        per-OSD used bytes (osd_statfs flows through MMgrReport)."""
        used = 0
        for state in self.mgr.daemons.values():
            v = state["counters"].get("osd_stat_bytes_used", 0)
            if isinstance(v, (int, float)):
                used += int(v)
        pgs = sum(p.pg_num for p in m.pools.values()) or 1
        return used / pgs

"""Upmap balancer: compute pg_upmap_items that flatten PG-per-OSD skew.

Behavioral analog of OSDMap::calc_pg_upmaps
(reference src/osd/OSDMap.cc:3771): iterate — measure per-OSD
deviation from the weight-proportional target, move PGs off the fullest
OSDs onto the least-full ones, record the moves as pg_upmap_items —
until the worst deviation ratio is under threshold.

A copy of ``ceph_tpu/osdmap/balancer.py`` on the port's OSDMap.  The
expensive part of every iteration is the WHOLE-MAP placement, which here
is the batched `pool_mapping` (one TensorMapper run per pool per
iteration, on the OSDMap's device; the reference walks crush_do_rule per
PG).  Deviation/target math is vectorized numpy.
Candidate validity preserves the rule's failure domain: a replacement
OSD must not share the chooseleaf-domain (e.g. host) with any other
member of the PG — the constraint try_remap_rule enforces via CRUSH
(reference src/osd/OSDMap.cc:3750, try_pg_upmap :3727).

Each iteration moves one PG per overfull OSD (a batched generalization
of the reference's one-change-per-pass restart loop) so large maps
converge in few placement dispatches.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
)
from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGid


def _failure_domains(m: OSDMap, ruleno: int) -> Dict[int, int]:
    """osd -> failure-domain id for the rule's chooseleaf type (osd id
    itself for osd-granularity rules)."""
    rule = m.crush.rules[ruleno]
    dom_type = 0
    for op, _arg1, arg2 in rule.steps:
        if op in (RULE_CHOOSELEAF_FIRSTN, RULE_CHOOSELEAF_INDEP,
                  RULE_CHOOSE_FIRSTN, RULE_CHOOSE_INDEP):
            dom_type = arg2
            break
    parent: Dict[int, int] = {}
    for bid, b in m.crush.buckets.items():
        for item in b.items:
            parent[item] = bid
    out: Dict[int, int] = {}
    for osd in range(m.max_osd):
        node = osd
        dom = osd
        seen = 0
        while node in parent and seen < 64:
            node = parent[node]
            btype = m.crush.buckets[node].type
            if btype == dom_type:
                dom = node
                break
            seen += 1
        out[osd] = dom if dom_type > 0 else osd
    return out


def calc_pg_upmaps(m: OSDMap, pool_ids: Optional[List[int]] = None,
                   max_deviation_ratio: float = 0.05,
                   max_iterations: int = 30,
                   ) -> Dict[PGid, List[Tuple[int, int]]]:
    """Compute new pg_upmap_items (OSDMap.cc:3771).  Mutates ``m``'s
    pg_upmap_items with the chosen moves and also returns them (the
    caller commits them as an Incremental / writes the map back)."""
    pools = pool_ids if pool_ids is not None else list(m.pools)
    changes: Dict[PGid, List[Tuple[int, int]]] = {}
    domains_by_pool = {pid: _failure_domains(m, m.pools[pid].crush_rule)
                       for pid in pools}

    for _ in range(max_iterations):
        # one batched placement per pool: the whole-map dispatch
        placements = {}
        counts = np.zeros(m.max_osd, dtype=np.int64)
        total_slots = 0
        for pid in pools:
            up, _upp = m.pool_mapping(pid)
            placements[pid] = up
            valid = up[(up >= 0) & (up < m.max_osd)]
            counts += np.bincount(valid, minlength=m.max_osd)
            total_slots += int((up != CRUSH_ITEM_NONE).sum())

        weights = np.asarray(m.osd_weight[: m.max_osd], dtype=np.float64)
        weights = weights * np.asarray(m.osd_exists[: m.max_osd],
                                       dtype=np.float64)
        wtotal = weights.sum()
        if wtotal <= 0 or total_slots == 0:
            break
        target = weights / wtotal * total_slots
        in_osds = weights > 0
        deviation = np.where(in_osds, counts - target, 0.0)
        ratio = np.where(target > 0, deviation / np.maximum(target, 1e-9), 0)

        overfull = [int(o) for o in np.argsort(-deviation)
                    if deviation[o] >= 1.0
                    and ratio[o] > max_deviation_ratio]
        underfull = [int(o) for o in np.argsort(deviation)
                     if deviation[o] <= -0.999 and in_osds[o]]
        if not overfull or not underfull:
            break

        moved_any = False
        taken_under: Dict[int, int] = {}
        for osd in overfull:
            move = _move_one_pg(m, pools, placements, osd, underfull,
                                taken_under, deviation, changes,
                                domains_by_pool)
            if move:
                moved_any = True
        if not moved_any:
            break
    return changes


def _move_one_pg(m: OSDMap, pools, placements, src_osd: int,
                 underfull: List[int], taken_under: Dict[int, int],
                 deviation, changes, domains_by_pool) -> bool:
    """Move ONE PG slot off src_osd onto the best valid underfull OSD,
    recording the pg_upmap_items pair (try_pg_upmap analog)."""
    for pid in pools:
        domains = domains_by_pool[pid]
        up = placements[pid]
        rows, cols = np.nonzero(up == src_osd)
        for r, c in zip(rows, cols):
            pgid = PGid(pid, int(r))
            if pgid in m.pg_upmap or pgid in m.pg_upmap_items:
                continue  # already remapped (reference skips these)
            members = [int(v) for v in up[r] if v != CRUSH_ITEM_NONE]
            used_doms = {domains.get(o) for o in members if o != src_osd}
            for dst in underfull:
                # cap how much we pour into one underfull osd this pass
                if taken_under.get(dst, 0) >= max(
                        1, int(-deviation[dst])):
                    continue
                if dst in members:
                    continue
                if domains.get(dst) in used_doms:
                    continue  # would violate the failure domain
                m.pg_upmap_items.setdefault(pgid, []).append(
                    (src_osd, dst))
                changes.setdefault(pgid, []).append((src_osd, dst))
                taken_under[dst] = taken_under.get(dst, 0) + 1
                return True
    return False


def pg_per_osd_stddev(m: OSDMap,
                      pool_ids: Optional[List[int]] = None) -> float:
    """PG-count standard deviation across in OSDs (the balance metric)."""
    pools = pool_ids if pool_ids is not None else list(m.pools)
    counts = np.zeros(m.max_osd, dtype=np.int64)
    for pid in pools:
        up, _ = m.pool_mapping(pid)
        valid = up[(up >= 0) & (up < m.max_osd)]
        counts += np.bincount(valid, minlength=m.max_osd)
    mask = (np.asarray(m.osd_weight[: m.max_osd]) > 0) & \
        np.asarray(m.osd_exists[: m.max_osd], dtype=bool)
    return float(np.std(counts[mask]))

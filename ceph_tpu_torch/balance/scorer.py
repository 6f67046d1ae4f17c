"""Batched upmap scoring: every legal move enumerated and scored at once.

Counterpart of ``ceph_tpu/balance/scorer.py``.  The scalar anchor
(``osdmap/balancer.py::calc_pg_upmaps``) walks overfull OSDs one at a time
and takes the first legal move per pass.  Here the same per-iteration
measurement (``deviation_stats``, bit-exact with the anchor's arrays)
feeds a cross-product candidate generator: every (overfull src, PG slot
on src, underfull dst) triple that the failure-domain rule admits becomes
a row of a flat candidate batch, and the whole batch is scored in one
call.  The objective is the exact change one move makes to
``sum((counts - target)^2)``, ``2 * (dev[dst] - dev[src] + 1)``, plus
two optional terms (primary balance and a per-move byte cost) whose
weights default to 0.

The engine is chosen by the OSDMap's device.  On the card (``"device"``)
the candidates are enumerated as masked tensor ops: for a chunk of
overfull slots, an ``(slots, underfull OSDs)`` mask drops the PG's
members and every OSD whose failure domain another member already uses,
and ``nonzero`` of the flattened mask lists the survivors row-major,
which is the reference's order (slots row-major, destinations in the
underfull list's order).  The scores are float64 torch ops in the
reference's operation order, so they are bit-exact, and the moves are
picked from a stable ``torch.sort`` of which only a prefix is copied to
the host.  ``device="cpu"`` (``"numpy"``) runs the reference's plain
loops.  The overfull and underfull lists are always computed on the host
with the reference's ``np.argsort`` call, whose tie order decides which
moves are picked.  Either engine counts the candidates it scores in
``KERNELS``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.osdmap.balancer import _failure_domains
from ceph_tpu_torch.osdmap.osdmap import OSDMap, PGid
from ceph_tpu_torch.utils.device import resolve_device
from ceph_tpu_torch.utils.perf import KERNELS

# cells of one (slots, underfull) mask chunk: bounds the enumeration's
# temporaries (nonzero's int64 output is 8 bytes per cell at most)
CHUNK_CELLS = 1 << 26
# candidates per chunk of the device scorer's float64 temporaries
SCORE_CHUNK = 1 << 26
# sorted candidates copied to the host for the first walk of _pick_moves;
# each further copy is four times longer
PICK_PREFIX = 4096
# no failure domain has this id (domains are osd or bucket ids)
_NO_DOMAIN = -(1 << 62)


# ---------------------------------------------------------------------------
# Measurement: bit-exact twin of the anchor's per-iteration math
# ---------------------------------------------------------------------------

@dataclass
class DeviationStats:
    """One iteration's balance measurement: ``counts``/``target``/
    ``deviation``/``ratio`` are calc_pg_upmaps' arrays bit for bit;
    ``primary_counts`` extends the measurement to primaries."""

    counts: np.ndarray          # (max_osd,) int64 PG slots per OSD
    primary_counts: np.ndarray  # (max_osd,) int64 primary PGs per OSD
    target: np.ndarray          # (max_osd,) float64
    deviation: np.ndarray       # (max_osd,) float64, 0 outside in-set
    ratio: np.ndarray           # (max_osd,) float64
    in_osds: np.ndarray         # (max_osd,) bool (weight > 0)
    total_slots: int
    placements: Dict[int, np.ndarray] = field(default_factory=dict)

    def overfull(self, max_deviation_ratio: float) -> List[int]:
        """Anchor's overfull set, most-deviant first."""
        return [int(o) for o in np.argsort(-self.deviation)
                if self.deviation[o] >= 1.0
                and self.ratio[o] > max_deviation_ratio]

    def underfull(self) -> List[int]:
        """Anchor's underfull set, most-starved first."""
        return [int(o) for o in np.argsort(self.deviation)
                if self.deviation[o] <= -0.999 and self.in_osds[o]]


def deviation_stats(m: OSDMap,
                    pool_ids: Optional[List[int]] = None,
                    ) -> Optional[DeviationStats]:
    """Measure fill deviation exactly as calc_pg_upmaps does, from one
    ``pool_mapping`` per pool.  None when the map carries no weight or no
    slots (the anchor's early-break condition)."""
    pools = pool_ids if pool_ids is not None else list(m.pools)
    placements: Dict[int, np.ndarray] = {}
    counts = np.zeros(m.max_osd, dtype=np.int64)
    pcounts = np.zeros(m.max_osd, dtype=np.int64)
    total_slots = 0
    for pid in pools:
        up, upp = m.pool_mapping(pid)
        placements[pid] = up
        valid = up[(up >= 0) & (up < m.max_osd)]
        counts += np.bincount(valid, minlength=m.max_osd)
        pvalid = upp[(upp >= 0) & (upp < m.max_osd)]
        pcounts += np.bincount(pvalid, minlength=m.max_osd)
        total_slots += int((up != CRUSH_ITEM_NONE).sum())

    weights = np.asarray(m.osd_weight[: m.max_osd], dtype=np.float64)
    weights = weights * np.asarray(m.osd_exists[: m.max_osd],
                                   dtype=np.float64)
    wtotal = weights.sum()
    if wtotal <= 0 or total_slots == 0:
        return None
    target = weights / wtotal * total_slots
    in_osds = weights > 0
    deviation = np.where(in_osds, counts - target, 0.0)
    ratio = np.where(target > 0, deviation / np.maximum(target, 1e-9), 0)
    return DeviationStats(counts=counts, primary_counts=pcounts,
                          target=target, deviation=deviation, ratio=ratio,
                          in_osds=in_osds, total_slots=total_slots,
                          placements=placements)


# ---------------------------------------------------------------------------
# Candidate generation: the legal-move cross product, as flat arrays
# ---------------------------------------------------------------------------

@dataclass
class CandidateSet:
    """Flat arrays, one row per legal (pool, pg, src, dst) move: numpy
    int64 from the plain engine, int32 tensors on the map's device from
    the tensor engine (``is_primary`` float64 in both)."""

    pool: object        # (C,) pool id
    seed: object        # (C,) pg seed within the pool
    src: object         # (C,) overfull osd the slot leaves
    dst: object         # (C,) underfull osd it lands on
    is_primary: object  # (C,) float64 1.0 when the slot is rank 0

    def __len__(self) -> int:
        return int(self.pool.shape[0])


def _engine(m: OSDMap, engine: Optional[str]) -> str:
    """The caller's engine, else the map's device's: tensor ops on the
    card, the plain loops for ``device="cpu"``."""
    if engine is not None:
        return engine
    return "device" if resolve_device(m.device).type == "cuda" else "numpy"


def generate_candidates(m: OSDMap, stats: DeviationStats,
                        domains_by_pool: Dict[int, Dict[int, int]],
                        max_deviation_ratio: float = 0.05,
                        engine: Optional[str] = None) -> CandidateSet:
    """Enumerate every move the anchor's validity rules admit.

    A candidate pairs a PG slot on an overfull OSD with an underfull
    destination that (a) is not already a member of the PG and (b) does
    not share a failure domain with any OTHER member (the try_remap_rule
    constraint).  PGs already carrying pg_upmap/pg_upmap_items are
    skipped, exactly as the anchor skips them.  ``engine`` as in
    ``calc_pg_upmaps_vectorized``."""
    overfull = stats.overfull(max_deviation_ratio)
    underfull = stats.underfull()
    if _engine(m, engine) == "device":
        return _candidates_device(m, stats, domains_by_pool, overfull,
                                  underfull)
    cpool: List[int] = []
    cseed: List[int] = []
    csrc: List[int] = []
    cdst: List[int] = []
    cprim: List[float] = []
    if not overfull or not underfull:
        return CandidateSet(*(np.zeros(0, dtype=np.int64) for _ in range(4)),
                            is_primary=np.zeros(0, dtype=np.float64))
    over_set = set(overfull)
    for pid, up in stats.placements.items():
        domains = domains_by_pool[pid]
        rows, cols = np.nonzero(np.isin(up, overfull))
        for r, c in zip(rows, cols):
            src = int(up[r, c])
            if src not in over_set:
                continue
            pgid = PGid(pid, int(r))
            if pgid in m.pg_upmap or pgid in m.pg_upmap_items:
                continue
            members = [int(v) for v in up[r] if v != CRUSH_ITEM_NONE]
            used_doms = {domains.get(o) for o in members if o != src}
            for dst in underfull:
                if dst in members:
                    continue
                if domains.get(dst) in used_doms:
                    continue
                cpool.append(pid)
                cseed.append(int(r))
                csrc.append(src)
                cdst.append(dst)
                cprim.append(1.0 if c == 0 else 0.0)
    return CandidateSet(
        pool=np.asarray(cpool, dtype=np.int64),
        seed=np.asarray(cseed, dtype=np.int64),
        src=np.asarray(csrc, dtype=np.int64),
        dst=np.asarray(cdst, dtype=np.int64),
        is_primary=np.asarray(cprim, dtype=np.float64),
    )


def _candidates_device(m: OSDMap, stats: DeviationStats,
                       domains_by_pool, overfull: List[int],
                       underfull: List[int]) -> CandidateSet:
    """generate_candidates as masked tensor ops on the map's device."""
    dev = resolve_device(m.device)
    i32 = torch.int32
    parts: List[Tuple[torch.Tensor, ...]] = []
    if overfull and underfull:
        n_osd = m.max_osd
        is_over = torch.zeros(n_osd, dtype=torch.bool, device=dev)
        is_over[torch.tensor(overfull, device=dev)] = True
        under = torch.tensor(underfull, dtype=torch.int64, device=dev)
        for pid, up_np in stats.placements.items():
            domains = domains_by_pool[pid]
            dom = torch.tensor([domains[o] for o in range(n_osd)],
                               dtype=torch.int64, device=dev)
            skip = np.zeros(up_np.shape[0], dtype=bool)
            for table in (m.pg_upmap, m.pg_upmap_items):
                seeds = [pg.seed for pg in table
                         if pg.pool == pid and pg.seed < len(skip)]
                skip[seeds] = True
            parts += _pool_candidates(
                pid, torch.from_numpy(up_np).to(dev),
                torch.from_numpy(skip).to(dev), is_over, dom, under,
                dom[under])
    if not parts:
        z = torch.zeros(0, dtype=i32, device=dev)
        return CandidateSet(z, z, z, z, torch.zeros(0, dtype=torch.float64,
                                                    device=dev))
    cols = [torch.cat(c) for c in zip(*parts)]
    return CandidateSet(*cols)


def _pool_candidates(pid, up, skip, is_over, dom, under, dom_under):
    """One pool's candidates, chunked over its overfull slots: a list of
    (pool, seed, src, dst, is_primary) tensor tuples in reference order."""
    n_osd = is_over.shape[0]
    n_under = under.shape[0]
    in_range = (up >= 0) & (up < n_osd)
    upc = up.clamp(0, n_osd - 1)
    member = up != CRUSH_ITEM_NONE
    # a member outside the OSD range has no failure domain (the
    # reference's domains.get() is None for it)
    mdom = torch.where(in_range, dom[upc], _NO_DOMAIN)
    slot = in_range & is_over[upc] & ~skip[:, None]
    rows, cols = slot.nonzero(as_tuple=True)          # row-major
    step = max(1, CHUNK_CELLS // n_under)
    out = []
    for a in range(0, rows.shape[0], step):
        r, c = rows[a:a + step], cols[a:a + step]
        mem, memv, md = up[r], member[r], mdom[r]
        src = mem.gather(1, c[:, None])               # (n, 1)
        bad = torch.zeros((r.shape[0], n_under), dtype=torch.bool,
                          device=up.device)
        for k in range(up.shape[1]):
            mk, vk = mem[:, k:k + 1], memv[:, k:k + 1]
            bad |= vk & (mk == under[None, :])
            bad |= vk & (mk != src) & (md[:, k:k + 1] == dom_under[None, :])
        flat = (~bad).view(-1).nonzero().squeeze(1)    # row-major
        si, ui = flat // n_under, flat % n_under
        out.append((torch.full_like(si, pid, dtype=torch.int32),
                    r[si].to(torch.int32),
                    src[si, 0].to(torch.int32),
                    under[ui].to(torch.int32),
                    (c[si] == 0).to(torch.float64)))
    return out


# ---------------------------------------------------------------------------
# Scoring: one vectorized objective call over the whole batch
# ---------------------------------------------------------------------------

def score_candidates(stats: DeviationStats, cand: CandidateSet,
                     engine: Optional[str] = None,
                     primary_weight: float = 0.0,
                     move_cost: float = 0.0,
                     pg_bytes: float = 0.0):
    """Objective delta per candidate; negative improves balance.

    With ``primary_weight == move_cost == 0`` this is exactly the change
    each move makes to sum((counts - target)^2), the energy the scalar
    anchor descends.  The engine follows the candidates' storage (a
    float64 tensor on their device for tensors, numpy for arrays) unless
    ``engine`` names one; both compute in the same order, bit for bit."""
    n = len(cand)
    on_device = isinstance(cand.src, torch.Tensor)
    eng = engine or ("device" if on_device else "numpy")
    dev = stats.deviation
    pdev = stats.primary_counts.astype(np.float64)
    if eng == "device":
        if not on_device:
            d = resolve_device(None)
            cand = CandidateSet(*(torch.from_numpy(np.asarray(a)).to(d)
                                  for a in vars(cand).values()))
        return _score_device(dev, pdev, cand, n, float(primary_weight),
                             float(move_cost), float(pg_bytes))
    if on_device:
        cand = CandidateSet(*(a.cpu().numpy() for a in vars(cand).values()))
    if n == 0:
        return np.zeros(0, dtype=np.float64)
    KERNELS.inc("balance_score_calls")
    KERNELS.inc("balance_candidates_scored", n)
    d_fill = 2.0 * (dev[cand.dst] - dev[cand.src] + 1.0)
    d_prim = primary_weight * cand.is_primary * \
        (pdev[cand.dst] - pdev[cand.src] + 1.0)
    return d_fill + d_prim + move_cost * float(pg_bytes)


def _score_device(dev, pdev, cand, n, primary_weight, move_cost, pg_bytes):
    """The numpy formula as float64 torch ops on the candidates' device,
    in chunks that bound the temporaries."""
    device = cand.src.device
    out = torch.empty(n, dtype=torch.float64, device=device)
    if n == 0:
        return out
    KERNELS.inc("balance_score_calls")
    KERNELS.inc("balance_candidates_scored", n)
    dev = torch.from_numpy(dev).to(device)
    pdev = torch.from_numpy(pdev).to(device)
    for a in range(0, n, SCORE_CHUNK):
        src = cand.src[a:a + SCORE_CHUNK].long()
        dst = cand.dst[a:a + SCORE_CHUNK].long()
        d_fill = 2.0 * (dev[dst] - dev[src] + 1.0)
        d_prim = primary_weight * cand.is_primary[a:a + SCORE_CHUNK] * \
            (pdev[dst] - pdev[src] + 1.0)
        out[a:a + SCORE_CHUNK] = d_fill + d_prim + move_cost * pg_bytes
    return out


# ---------------------------------------------------------------------------
# Move selection + the full optimizer loop
# ---------------------------------------------------------------------------

class _Walk:
    """The greedy selection of ``_pick_moves`` over candidates fed in
    best-score-first order, one slice at a time."""

    def __init__(self, stats: DeviationStats, max_moves: int):
        self.stats = stats
        self.max_moves = max_moves
        self.dev_adj = stats.deviation.copy()
        self.taken_under: Dict[int, int] = {}
        self.moved_pgs = set()
        self.picked: List[Tuple[int, int, int, int]] = []

    def feed(self, pool, seed, src, dst, scores) -> bool:
        """Walk one slice of the order; True once the walk has ended."""
        deviation = self.stats.deviation
        for i in range(len(scores)):
            if len(self.picked) >= self.max_moves:
                return True
            if scores[i] >= 0:
                return True  # sorted: nothing after this improves either
            s, d = int(src[i]), int(dst[i])
            key = (int(pool[i]), int(seed[i]))
            if key in self.moved_pgs:
                continue
            if self.taken_under.get(d, 0) >= max(1, int(-deviation[d])):
                continue
            if 2.0 * (self.dev_adj[d] - self.dev_adj[s] + 1.0) >= 0:
                continue  # earlier accepts already evened this pair out
            self.picked.append((key[0], key[1], s, d))
            self.moved_pgs.add(key)
            self.taken_under[d] = self.taken_under.get(d, 0) + 1
            self.dev_adj[s] -= 1.0
            self.dev_adj[d] += 1.0
        return False


def sorted_order(scores: torch.Tensor) -> torch.Tensor:
    """Candidate indices best score first, ties in candidate order (the
    order of ``np.argsort(scores, kind="stable")``)."""
    return torch.sort(scores, stable=True).indices


def _pick_moves(stats: DeviationStats, cand: CandidateSet, scores,
                max_moves: int) -> List[Tuple[int, int, int, int]]:
    """Greedy conflict-aware selection from one scored batch.

    Walk candidates best-score first; accept a move only while its fill
    delta stays negative under the deviations ADJUSTED for moves already
    accepted this round (so a round of moves never overshoots), one move
    per PG, and never pour more into one underfull OSD than its original
    starvation (the anchor's taken_under cap).  Device scores are sorted
    on the device, and the walk copies the sorted candidates to the host
    in slices that grow fourfold until it ends."""
    walk = _Walk(stats, max_moves)
    if not isinstance(scores, torch.Tensor):
        order = np.argsort(scores, kind="stable")
        walk.feed(cand.pool[order], cand.seed[order], cand.src[order],
                  cand.dst[order], scores[order])
        return walk.picked
    order = sorted_order(scores)
    start, length = 0, PICK_PREFIX
    while start < order.shape[0]:
        idx = order[start:start + length]
        cols = torch.stack([cand.pool[idx], cand.seed[idx], cand.src[idx],
                            cand.dst[idx]]).cpu().numpy()
        if walk.feed(*cols, scores[idx].cpu().numpy()):
            break
        start += length
        length *= 4
    return walk.picked


def calc_pg_upmaps_vectorized(
        m: OSDMap, pool_ids: Optional[List[int]] = None,
        max_deviation_ratio: float = 0.05,
        max_iterations: int = 30,
        max_moves: Optional[int] = None,
        engine: Optional[str] = None,
        primary_weight: float = 0.0,
        move_cost: float = 0.0,
        pg_bytes: float = 0.0,
) -> Tuple[Dict[PGid, List[Tuple[int, int]]], int]:
    """Vectorized drop-in for the scalar anchor.

    Mutates ``m.pg_upmap_items`` like the anchor and returns
    ``(changes, candidates_scored)``.  Each iteration re-measures through
    ``pool_mapping``, enumerates every legal move, scores the whole batch
    in one call and accepts a conflict-free subset.  ``engine``:
    ``"device"`` (tensor ops on the map's device) or ``"numpy"`` (the
    plain loops); by default the card's tensor ops, and the plain loops
    for a map on ``device="cpu"``."""
    pools = pool_ids if pool_ids is not None else list(m.pools)
    eng = _engine(m, engine)
    changes: Dict[PGid, List[Tuple[int, int]]] = {}
    domains_by_pool = {pid: _failure_domains(m, m.pools[pid].crush_rule)
                       for pid in pools}
    budget = max_moves if max_moves is not None else 1 << 30
    scored_total = 0

    for _ in range(max_iterations):
        if budget <= 0:
            break
        stats = deviation_stats(m, pools)
        if stats is None:
            break
        cand = generate_candidates(m, stats, domains_by_pool,
                                   max_deviation_ratio, engine=eng)
        if len(cand) == 0:
            break
        scores = score_candidates(stats, cand,
                                  primary_weight=primary_weight,
                                  move_cost=move_cost, pg_bytes=pg_bytes)
        scored_total += len(cand)
        picked = _pick_moves(stats, cand, scores, budget)
        if not picked:
            break
        for pid, seed, src, dst in picked:
            pgid = PGid(pid, seed)
            m.pg_upmap_items.setdefault(pgid, []).append((src, dst))
            changes.setdefault(pgid, []).append((src, dst))
        budget -= len(picked)
    return changes, scored_total

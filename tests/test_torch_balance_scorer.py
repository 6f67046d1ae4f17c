"""The port's upmap scorer against ``ceph_tpu``'s.

``ceph_tpu_torch.balance.scorer`` on maps built the same way in both
packages, every case of ``tests/test_balance_scorer.py`` and more:
- ``deviation_stats``: every array bit-exact, the same overfull and
  underfull orders;
- ``generate_candidates``: the same candidates in the same order, from the
  plain loops (``engine="numpy"``, what ``device="cpu"`` runs) and from
  the masked tensor ops (``engine="device"``, what the card runs, here on
  CPU tensors), with upmapped PGs skipped, an erasure pool with holes, and
  the enumeration, scoring and pick chunked small;
- ``score_candidates``: bit-exact (compared as int64 bit patterns), also
  with the primary and move-cost terms on;
- ``calc_pg_upmaps_vectorized``: the same ``changes``, candidate counts and
  ``pg_upmap_items``, at least 1000 candidates counted in ``KERNELS``, the
  move budget respected, a skew no worse than the scalar anchor's and
  every mapping valid; a 256-OSD map of 2,048 PGs as well.

The reference's ``pool_mapping`` runs its own scalar mapper (memoized:
the raw CRUSH placement does not change while the balancer adds upmap
items), which needs no XLA compile.  Every comparison is exact.
"""

import copy

import numpy as np
import pytest
import torch

from ceph_tpu.balance import scorer as jscorer
from ceph_tpu.crush import ScalarMapper as JScalarMapper
from ceph_tpu.osdmap import osdmap as josd
from ceph_tpu_torch.balance import scorer
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.osdmap import balancer as pbalancer
from ceph_tpu_torch.osdmap import osdmap as posd
from ceph_tpu_torch.utils.perf import KERNELS
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

ENGINES = ["numpy", "device"]


class ScalarBatch:
    """The reference's scalar mapper behind its pool_mapping's batched
    call, memoized per (rule, size, weights, x)."""

    def __init__(self, cmap):
        self.sm = JScalarMapper(cmap)
        self.rows = {}

    def do_rule_batch(self, ruleno, xs, result_max, weights):
        memo = self.rows.setdefault(
            (ruleno, result_max, np.asarray(weights).tobytes()), {})
        res = np.zeros((len(xs), result_max), dtype=np.int64)
        rlen = np.zeros(len(xs), dtype=np.int64)
        for i, x in enumerate(np.asarray(xs).tolist()):
            row = memo.get(x)
            if row is None:
                row = memo[x] = self.sm.do_rule(ruleno, x, result_max,
                                                list(weights))
            res[i, : len(row)] = row
            rlen[i] = len(row)
        return res, rlen


def pair(n_osds, per_host, pg_num, ptype=posd.POOL_TYPE_REPLICATED,
         size=3):
    """(port map on the CPU, reference map on its memoized scalar mapper)."""
    p = posd.build_simple_osdmap(n_osds, per_host, pg_num, ptype, size,
                                 device="cpu")
    j = josd.build_simple_osdmap(n_osds, per_host, pg_num, ptype, size)
    j._tensor = ScalarBatch(j.crush)
    return p, j


def mutated(n_osds, per_host, pg_num, ptype=posd.POOL_TYPE_REPLICATED,
            size=3):
    """A pair with a reweight, an out and a down OSD, a pg_upmap and
    pg_upmap_items (PGs the scorer must skip)."""
    p, j = pair(n_osds, per_host, pg_num, ptype, size)
    for m, mod in ((p, posd), (j, josd)):
        m.osd_weight[3] = 0x4000
        m.mark_out(6)
        m.mark_down(9)
        m.pg_upmap[mod.PGid(1, 2)] = m.pg_raw_up(mod.PGid(1, 2))
        m.pg_upmap_items[mod.PGid(1, 5)] = [(m.pg_raw_up(
            mod.PGid(1, 5))[0], n_osds - 1)]
    return p, j


CASES = {
    "16osd_64pg": lambda: pair(16, 4, 64),
    "24osd_128pg": lambda: pair(24, 4, 128),
    "32osd_256pg": lambda: pair(32, 4, 256),
    "mutated_32osd_256pg": lambda: mutated(32, 4, 256),
    "erasure_32osd_256pg": lambda: mutated(32, 4, 256,
                                           posd.POOL_TYPE_ERASURE, 4),
}


def domains(m):
    return {pid: pbalancer._failure_domains(m, m.pools[pid].crush_rule)
            for pid in m.pools}


def jdomains(m):
    return {pid: jscorer._failure_domains(m, m.pools[pid].crush_rule)
            for pid in m.pools}


def arrays(cand):
    return [np.asarray(a.cpu() if isinstance(a, torch.Tensor) else a)
            for a in (cand.pool, cand.seed, cand.src, cand.dst,
                      cand.is_primary)]


def as_np(scores):
    return scores.cpu().numpy() if isinstance(scores, torch.Tensor) \
        else scores


def bits_equal(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64),
                                                 b.view(np.int64))


def by_key(changes):
    return {(pg.pool, pg.seed): v for pg, v in changes.items()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_deviation_stats_bit_exact(case):
    p, j = CASES[case]()
    st, jst = scorer.deviation_stats(p), jscorer.deviation_stats(j)
    for name in ("counts", "primary_counts", "target", "deviation", "ratio",
                 "in_osds"):
        a, b = getattr(st, name), getattr(jst, name)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), name
    assert st.total_slots == jst.total_slots
    assert st.placements.keys() == jst.placements.keys()
    assert all(np.array_equal(st.placements[k], jst.placements[k])
               for k in st.placements)
    assert st.overfull(0.05) == jst.overfull(0.05)
    assert st.underfull() == jst.underfull()
    assert st.overfull(0.05) and st.underfull()


@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_candidates_and_scores_equal_reference(case, engine):
    p, j = CASES[case]()
    st, jst = scorer.deviation_stats(p), jscorer.deviation_stats(j)
    cand = scorer.generate_candidates(p, st, domains(p), engine=engine)
    jcand = jscorer.generate_candidates(j, jst, jdomains(j))
    assert isinstance(cand.src, torch.Tensor) == (engine == "device")
    got, want = arrays(cand), arrays(jcand)
    assert len(cand) == len(jcand) > 0
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert got[4].dtype == np.float64
    for kw in ({}, {"primary_weight": 0.5, "move_cost": 0.25,
                    "pg_bytes": 3.0}):
        scores = scorer.score_candidates(st, cand, **kw)
        jscores = jscorer.score_candidates(jst, jcand, engine="numpy", **kw)
        assert isinstance(scores, torch.Tensor) == (engine == "device")
        assert bits_equal(as_np(scores), jscores)
    # the other engine on the same candidates gives the same bits
    other = "numpy" if engine == "device" else "device"
    if other == "device":
        cand = scorer.CandidateSet(*(torch.from_numpy(a) for a in got))
    assert bits_equal(as_np(scorer.score_candidates(st, cand, engine=other)),
                      jscorer.score_candidates(jst, jcand, engine="numpy"))


def test_upmapped_pgs_are_skipped():
    p, _ = mutated(32, 4, 256)
    st = scorer.deviation_stats(p)
    for engine in ENGINES:
        cand = scorer.generate_candidates(p, st, domains(p), engine=engine)
        seeds = set(arrays(cand)[1].tolist())
        assert not seeds & {2, 5}


def test_fill_score_is_exact_energy_delta():
    p, _ = pair(16, 4, 64)
    st = scorer.deviation_stats(p)
    cand = scorer.generate_candidates(p, st, domains(p), engine="device")
    scores = scorer.score_candidates(st, cand).numpy()
    _, _, src, dst, _ = arrays(cand)
    energy0 = float(np.sum((st.counts - st.target) ** 2))
    for i in range(min(8, len(cand))):
        counts = st.counts.astype(np.float64).copy()
        counts[src[i]] -= 1
        counts[dst[i]] += 1
        delta = float(np.sum((counts - st.target) ** 2)) - energy0
        assert np.isclose(scores[i], delta), (i, scores[i], delta)


@pytest.mark.parametrize("max_moves", [None, 5], ids=["unbounded", "5"])
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("case", sorted(CASES))
def test_changes_equal_reference(case, engine, max_moves):
    p, j = CASES[case]()
    KERNELS.reset()
    changes, scored = scorer.calc_pg_upmaps_vectorized(
        p, max_moves=max_moves, engine=engine)
    jchanges, jscored = jscorer.calc_pg_upmaps_vectorized(
        j, max_moves=max_moves, engine="numpy")
    assert changes and by_key(changes) == by_key(jchanges)
    assert scored == jscored
    assert by_key(p.pg_upmap_items) == by_key(j.pg_upmap_items)
    assert KERNELS.get("balance_candidates_scored") == scored
    if max_moves is not None:
        assert 0 < sum(len(v) for v in changes.values()) <= max_moves
    for pgid, pairs in changes.items():
        assert isinstance(pgid, posd.PGid)
        assert p.pg_upmap_items[pgid][-len(pairs):] == pairs


@pytest.mark.parametrize("engine", ENGINES)
def test_batch_width_at_least_1000_candidates_counted(engine):
    p, _ = pair(32, 4, 256)
    k0 = KERNELS.get("balance_candidates_scored")
    calls0 = KERNELS.get("balance_score_calls")
    changes, scored = scorer.calc_pg_upmaps_vectorized(p, engine=engine)
    assert scored >= 1000, scored
    assert KERNELS.get("balance_candidates_scored") - k0 == scored
    assert KERNELS.get("balance_score_calls") > calls0
    assert changes


def test_skew_no_worse_than_anchor_and_valid():
    p, _ = pair(32, 4, 256)
    m_scalar, m_vec = copy.deepcopy(p), copy.deepcopy(p)
    before = pbalancer.pg_per_osd_stddev(p)
    assert pbalancer.calc_pg_upmaps(m_scalar)
    after_s = pbalancer.pg_per_osd_stddev(m_scalar)
    changes, _ = scorer.calc_pg_upmaps_vectorized(m_vec, engine="device")
    after_v = pbalancer.pg_per_osd_stddev(m_vec)
    assert changes
    assert after_v < before and after_v <= after_s + 1e-9
    dom = pbalancer._failure_domains(m_vec, m_vec.pools[1].crush_rule)
    up, _ = m_vec.pool_mapping(1)
    for s in range(m_vec.pools[1].pg_num):
        members = [int(v) for v in up[s] if v != CRUSH_ITEM_NONE]
        assert len(members) == len(set(members))
        assert len({dom[o] for o in members}) == len(members)


def test_chunked_tensor_engine_equals_reference(monkeypatch):
    """Tiny enumeration, scoring and pick chunks: the same candidates,
    scores and moves as the reference, through many slices."""
    p, j = mutated(32, 4, 256)
    monkeypatch.setattr(scorer, "CHUNK_CELLS", 50)
    monkeypatch.setattr(scorer, "SCORE_CHUNK", 97)
    monkeypatch.setattr(scorer, "PICK_PREFIX", 1)
    st, jst = scorer.deviation_stats(p), jscorer.deviation_stats(j)
    cand = scorer.generate_candidates(p, st, domains(p), engine="device")
    jcand = jscorer.generate_candidates(j, jst, jdomains(j))
    assert all(np.array_equal(g, w)
               for g, w in zip(arrays(cand), arrays(jcand)))
    scores = scorer.score_candidates(st, cand)
    jscores = jscorer.score_candidates(jst, jcand, engine="numpy")
    assert bits_equal(scores.numpy(), jscores)
    for budget in (1, 7, 1 << 30):
        assert scorer._pick_moves(st, cand, scores, budget) == \
            jscorer._pick_moves(jst, jcand, jscores, budget)
    changes, _ = scorer.calc_pg_upmaps_vectorized(p, engine="device")
    jchanges, _ = jscorer.calc_pg_upmaps_vectorized(j, engine="numpy")
    assert by_key(changes) == by_key(jchanges)


def test_engine_follows_the_maps_device(monkeypatch):
    p, _ = pair(16, 4, 64)
    st = scorer.deviation_stats(p)
    assert isinstance(scorer.generate_candidates(p, st, domains(p)).src,
                      np.ndarray)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    p.device = None
    with pytest.raises(RuntimeError, match="CUDA"):
        scorer.calc_pg_upmaps_vectorized(p)


@pytest.fixture(scope="module")
def mid_maps():
    """A 256-OSD map (32 hosts of 8) with a 2,048-PG pool."""
    return pair(256, 8, 2048)


@pytest.mark.parametrize("engine", ENGINES)
def test_mid_size_map_equals_reference(mid_maps, engine):
    p0, j0 = mid_maps
    # fresh copies that share the reference's memoized scalar placements
    batch, j0._tensor = j0._tensor, None
    p, j = copy.deepcopy(p0), copy.deepcopy(j0)
    j0._tensor = j._tensor = batch
    st, jst = scorer.deviation_stats(p), jscorer.deviation_stats(j)
    cand = scorer.generate_candidates(p, st, domains(p), engine=engine)
    jcand = jscorer.generate_candidates(j, jst, jdomains(j))
    assert len(cand) == len(jcand) >= 1000
    assert all(np.array_equal(g, w)
               for g, w in zip(arrays(cand), arrays(jcand)))
    assert bits_equal(as_np(scorer.score_candidates(st, cand)),
                      jscorer.score_candidates(jst, jcand, engine="numpy"))
    changes, scored = scorer.calc_pg_upmaps_vectorized(
        p, max_moves=64, engine=engine)
    jchanges, jscored = jscorer.calc_pg_upmaps_vectorized(
        j, max_moves=64, engine="numpy")
    assert changes and by_key(changes) == by_key(jchanges)
    assert scored == jscored
    assert pbalancer.pg_per_osd_stddev(p) < \
        pbalancer.pg_per_osd_stddev(mid_maps[0])

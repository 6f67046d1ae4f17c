"""The port's OSDMap placement pipeline against ``ceph_tpu``'s.

The same small maps (tens of OSDs, a few hundred PGs) are built in both
packages and put through the same mutations: OSDs marked down and out, a
reweight, pg_upmap, pg_upmap_items, pg_temp, primary_temp and non-default
primary affinity.  The port runs its batched placement on
``device="cpu"``; the reference runs the same post-pass code with its
scalar mapper in place of its JAX one (the two agree bit for bit, which
``tests/test_crush_mapper.py`` pins, and the scalar one needs no XLA
compile).  Checked: ``pool_mapping`` (replicated and erasure),
``rebalance_diff``, ``affected_pgs`` (equal to ``affected_pgs_scalar``
and to the reference's), ``calc_pg_upmaps`` and ``pg_per_osd_stddev``,
``apply_incremental``, and the counted, logged scalar path for map shapes
the batched mapper rejects.  Every comparison is exact.
"""

import copy
import logging
import pickle

import numpy as np
import pytest
import torch

from ceph_tpu.osdmap import balancer as jbalancer
from ceph_tpu.osdmap import osdmap as josd
from ceph_tpu_torch.crush.types import CRUSH_ITEM_NONE
from ceph_tpu_torch.osdmap import balancer as pbalancer
from ceph_tpu_torch.osdmap import osdmap as posd
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

REP, EC = posd.POOL_TYPE_REPLICATED, posd.POOL_TYPE_ERASURE
KINDS = [(REP, 3), (EC, 4)]
KIND_IDS = ["replicated", "erasure"]


def pair(ptype, size, pg_num=200, n_osds=24, per_host=4):
    """(port map on the CPU, reference map on its scalar mapper)."""
    p = posd.build_simple_osdmap(n_osds, per_host, pg_num, ptype, size,
                                 device="cpu")
    j = josd.build_simple_osdmap(n_osds, per_host, pg_num, ptype, size)
    return p, scalar_only(j)


def scalar_only(j):
    """The reference map with its batched mapper replaced by the scalar
    one: its pool_mapping then takes the scalar path of the same code."""
    j._tensor = NotImplementedError("held to the scalar mapper in tests")
    return j


def mutate(m, mod, affinity=False):
    """The same overrides on either package's map."""
    m.mark_down(5)
    m.mark_out(9)
    m.osd_weight[13] = 0x8000
    m.pg_upmap[mod.PGid(1, 3)] = [0, 4, 8, 12][: m.pools[1].size]
    m.pg_upmap[mod.PGid(1, 4)] = [9, 4, 8, 12][: m.pools[1].size]  # out
    m.pg_upmap_items[mod.PGid(1, 7)] = [(m.pg_raw_up(mod.PGid(1, 7))[0], 23)]
    m.pg_upmap_items[mod.PGid(1, 8)] = [(1, 2), (3, 9)]
    m.pg_temp[mod.PGid(1, 11)] = [20, 5, 16]
    m.primary_temp[mod.PGid(1, 12)] = 17
    if affinity:
        m.set_primary_affinity(2, 0)
        m.set_primary_affinity(6, 0x4000)
        m.set_primary_affinity(14, 0xC000)


def scalar_up(m, mod, pool_id=1):
    pool = m.pools[pool_id]
    up = np.full((pool.pg_num, pool.size), CRUSH_ITEM_NONE, dtype=np.int64)
    upp = np.full(pool.pg_num, -1, dtype=np.int64)
    for s in range(pool.pg_num):
        u, p, _a, _ap = m.pg_to_up_acting_osds(mod.PGid(pool_id, s))
        up[s, : len(u)] = u
        upp[s] = p
    return up, upp


@pytest.mark.parametrize("hashpspool", [True, False])
def test_pps_equals_reference(hashpspool):
    p, j = pair(REP, 3, pg_num=200)
    for m in (p, j):
        m.pools[1].hashpspool = hashpspool
        m.pools[1].pgp_num = 150
    seeds = np.arange(300, dtype=np.uint32)
    got = p.pools[1].raw_pg_to_pps_batch(seeds)
    assert got.dtype == np.uint32
    assert np.array_equal(got, j.pools[1].raw_pg_to_pps_batch(seeds))
    assert [p.pools[1].raw_pg_to_pps(int(s)) for s in seeds] == \
        [j.pools[1].raw_pg_to_pps(int(s)) for s in seeds] == got.tolist()
    assert [posd.ceph_stable_mod(x, 150, 255) for x in range(600)] == \
        [josd.ceph_stable_mod(x, 150, 255) for x in range(600)]


@pytest.mark.parametrize("affinity", [False, True], ids=["plain", "affinity"])
@pytest.mark.parametrize("ptype,size", KINDS, ids=KIND_IDS)
def test_pool_mapping_equals_reference(ptype, size, affinity):
    p, j = pair(ptype, size)
    mutate(p, posd, affinity)
    mutate(j, josd, affinity)
    up, upp = p.pool_mapping(1)
    assert isinstance(up, np.ndarray) and up.dtype == np.int64
    assert up.shape == (200, size) and upp.shape == (200,)
    jup, jupp = j.pool_mapping(1)
    assert np.array_equal(up, jup) and np.array_equal(upp, jupp)
    sup, supp = scalar_up(p, posd)
    assert np.array_equal(up, sup) and np.array_equal(upp, supp)
    assert p.scalar_fallbacks == 0
    assert p.tensor_mapper.device.type == "cpu"
    # the overrides took effect
    assert up[3].tolist() == [0, 4, 8, 12][:size]
    assert 23 in up[7]
    if ptype == EC:
        assert CRUSH_ITEM_NONE in up      # down OSDs leave holes in place


def test_acting_sets_equal_reference():
    p, j = pair(REP, 3)
    mutate(p, posd, affinity=True)
    mutate(j, josd, affinity=True)
    for s in range(200):
        assert p.pg_to_up_acting_osds(posd.PGid(1, s)) == \
            j.pg_to_up_acting_osds(josd.PGid(1, s))
    assert p.pg_to_up_acting_osds(posd.PGid(1, 11))[2] == [20, 16]
    assert p.pg_to_up_acting_osds(posd.PGid(1, 12))[3] == 17


@pytest.mark.parametrize("ptype,size", KINDS, ids=KIND_IDS)
def test_rebalance_diff_equals_reference(ptype, size):
    p, j = pair(ptype, size)
    p2, j2 = copy.deepcopy(p), scalar_only(copy.deepcopy(j))
    for m in (p2, j2):
        for osd in range(8, 12):                 # one host out
            m.mark_out(osd)
        m.mark_down(17)
    moved, frac = p.rebalance_diff(1, p2)
    jmoved, jfrac = j.rebalance_diff(1, j2)
    assert np.array_equal(moved, jmoved) and frac == jfrac
    assert 0 < frac < 1
    a, _ = scalar_up(p, posd)
    b, _ = scalar_up(p2, posd)
    assert np.array_equal(moved, np.nonzero((a != b).any(axis=1))[0])


@pytest.mark.parametrize("batch_min", [0, 1000], ids=["batched", "scalar"])
@pytest.mark.parametrize("ptype,size", KINDS, ids=KIND_IDS)
def test_affected_pgs_equal_scalar_and_reference(ptype, size, batch_min):
    p, j = pair(ptype, size)
    p2, j2 = copy.deepcopy(p), scalar_only(copy.deepcopy(j))
    mutate(p2, posd)
    mutate(j2, josd)
    got = posd.affected_pgs(p, p2, 1, batch_min)
    assert got == posd.affected_pgs_scalar(p, p2, 1)
    assert got == josd.affected_pgs(j, j2, 1, batch_min)
    assert got == josd.affected_pgs_scalar(j, j2, 1)
    assert {11, 12} <= got                    # pg_temp / primary_temp
    # snapshots diff to nothing against themselves
    snap = posd.placement_snapshot(p2, 1, batch_min)
    assert posd.placement_delta(snap, snap) == set()
    # pool growth and removal
    p3 = copy.deepcopy(p)
    p3.pools[1].pg_num = 220
    assert set(range(200, 220)) <= posd.affected_pgs(p, p3, 1)
    assert posd.affected_pgs(p, p, 2) == set()


def test_calc_pg_upmaps_equals_reference():
    p, j = pair(REP, 3, pg_num=256, n_osds=32)
    for m in (p, j):
        m.osd_weight[3] = 0x4000
    before = pbalancer.pg_per_osd_stddev(p)
    assert before == jbalancer.pg_per_osd_stddev(j)
    changes = pbalancer.calc_pg_upmaps(p, max_iterations=8)
    jchanges = jbalancer.calc_pg_upmaps(j, max_iterations=8)
    assert changes and \
        {(pg.pool, pg.seed): v for pg, v in changes.items()} == \
        {(pg.pool, pg.seed): v for pg, v in jchanges.items()}
    after = pbalancer.pg_per_osd_stddev(p)
    assert after == jbalancer.pg_per_osd_stddev(j)
    assert after < before


def test_apply_incremental_equals_reference():
    p, j = pair(EC, 4)
    for m, mod in ((p, posd), (j, josd)):
        m.apply_incremental(mod.Incremental(
            epoch=m.epoch + 1, new_down=[3], new_weights={6: 0, 7: 0x9000},
            new_pg_temp={mod.PGid(1, 2): [1, 2, 3, 4]},
            new_pg_upmap_items={mod.PGid(1, 9): [(0, 22)]},
            new_primary_affinity={10: 0}))
    scalar_only(j)
    assert p.epoch == j.epoch
    assert all(np.array_equal(a, b)
               for a, b in zip(p.pool_mapping(1), j.pool_mapping(1)))


def test_scalar_path_is_counted_and_logged(caplog):
    """A map shape the batched mapper rejects maps through the scalar
    oracle, the reference's semantics for it, counted and logged."""
    p, j = pair(REP, 3, pg_num=64)
    for m in (p, j):
        m.crush.buckets[-2].alg = "uniform"
        m.invalidate_mappers()
    scalar_only(j)
    with caplog.at_level(logging.WARNING, logger="ceph_tpu_torch.osdmap"):
        up, upp = p.pool_mapping(1)
    assert p.scalar_fallbacks == 1
    assert "scalar mapper" in caplog.text and "uniform" in caplog.text
    jup, jupp = j.pool_mapping(1)
    assert np.array_equal(up, jup) and np.array_equal(upp, jupp)
    with pytest.raises(NotImplementedError):
        p.tensor_mapper


def test_pickle_drops_mappers():
    p, _ = pair(REP, 3, pg_num=32)
    want = p.pool_mapping(1)
    assert isinstance(p._tensor.items, torch.Tensor)
    q = pickle.loads(pickle.dumps(p))
    assert q._tensor is None and q.device == "cpu"
    got = q.pool_mapping(1)
    assert all(np.array_equal(a, b) for a, b in zip(want, got))

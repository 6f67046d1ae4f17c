"""Regression tests of the batched mapper's faults C1-C3 (ROADMAP §C).

Each fault is a place where ``ceph_tpu_torch.crush.mapper.TensorMapper``
and ``ceph_tpu``'s JAX TensorMapper both differed from the scalar oracle,
so the port is held here to ``ceph_tpu.crush.ScalarMapper`` (mapper.c's
order), never to the JAX mapper:

- C1: a ``chooseleaf indep … type 0`` slot that uses up its tries on out
  devices keeps the last device it drew;
- C2: a step whose ``numrep + result_max <= 0`` empties the working
  vector;
- C3: a TAKE of a bucket whose type equals the step's type still draws
  from that bucket first.

The ROADMAP repro of each runs at the mapper level on all 256 lanes, and
C1's also at the OSDMap level (``pool_mapping`` against the reference's
scalar chain ``pg_to_up_acting_osds``).  A seeded fuzz then puts the three
rule shapes through random two- to four-level maps with zero weights,
empty buckets and out and reweighted devices.  Every comparison is exact.
"""

import numpy as np
import pytest

from ceph_tpu.crush import CrushMap as JCrushMap
from ceph_tpu.crush import ScalarMapper as JScalarMapper
from ceph_tpu.crush.types import Bucket as JBucket
from ceph_tpu.crush.types import Rule as JRule
from ceph_tpu.crush.types import build_hierarchy as jbuild_hierarchy
from ceph_tpu.osdmap import osdmap as josd
from ceph_tpu_torch.crush import Bucket, CrushMap, Rule
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_SET_CHOOSE_TRIES,
    RULE_SET_CHOOSELEAF_TRIES,
    RULE_TAKE,
    build_hierarchy,
)
from ceph_tpu_torch.osdmap import osdmap as posd
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)


def port_rows(cmap, ruleno, xs, result_max, weights):
    res, rlen = TensorMapper(cmap, device="cpu").do_rule_batch(
        ruleno, xs, result_max, weights)
    res, rlen = res.numpy(), rlen.numpy()
    return [[int(v) for v in res[i, : rlen[i]]] for i in range(len(xs))]


def held_to_scalar(pmap, jmap, ruleno, xs, result_max, weights):
    got = port_rows(pmap, ruleno, xs, result_max, weights)
    scalar = JScalarMapper(jmap)
    want = [scalar.do_rule(ruleno, int(x), result_max, list(weights))
            for x in xs]
    bad = [(int(x), g, w) for x, g, w in zip(xs, got, want) if g != w]
    assert not bad, f"{len(bad)}/{len(xs)} lanes differ, first: {bad[:3]}"
    return got


# --------------------------------------------------------------- repros

REPROS = {
    # C1: OSDs 1 and 3 out, chooseleaf indep to type 0 under host -1
    "C1": ([(RULE_TAKE, -1, 0), (RULE_CHOOSELEAF_INDEP, 3, 0),
            (RULE_EMIT, 0, 0)], 3, (1, 3), [0, 2, 1]),
    # C2: a size-1 pool on a firstn -1 rule
    "C2": ([(RULE_TAKE, -5, 0), (RULE_CHOOSELEAF_FIRSTN, -1, 1),
            (RULE_EMIT, 0, 0)], 1, (), []),
    # C3: TAKE a host, then choose firstn 1 type host
    "C3": ([(RULE_TAKE, -1, 0), (RULE_CHOOSE_FIRSTN, 1, 1),
            (RULE_EMIT, 0, 0)], 3, (), []),
}


@pytest.mark.parametrize("fault", sorted(REPROS))
def test_roadmap_repro_equals_reference_scalar(fault):
    steps, result_max, out, first = REPROS[fault]
    pmap, _ = build_hierarchy(4, 4)
    jmap, _ = jbuild_hierarchy(4, 4)
    ruleno = pmap.add_rule(Rule(steps=steps))
    assert jmap.add_rule(JRule(steps=steps)) == ruleno
    weights = np.full(pmap.max_devices, 0x10000, dtype=np.uint32)
    weights[list(out)] = 0
    got = held_to_scalar(pmap, jmap, ruleno, np.arange(256, dtype=np.uint32),
                         result_max, weights)
    assert got[0] == first
    if fault == "C1":
        # the out devices are kept where the tries ran out
        assert any(set(g) & {1, 3} for g in got)
    else:
        # no bucket id is ever emitted as a placement
        assert all(v >= 0 for g in got for v in g)


C1_STEPS = [(RULE_SET_CHOOSELEAF_TRIES, 5, 0), (RULE_SET_CHOOSE_TRIES, 100, 0),
            (RULE_TAKE, -3, 0), (RULE_CHOOSELEAF_INDEP, 0, 0),
            (RULE_EMIT, 0, 0)]


def test_c1_pool_mapping_equals_reference_chain():
    """ROADMAP's OSDMap repro: an erasure pool of size 7 on
    ``chooseleaf indep 0 type 0`` over 8 OSDs, OSDs 1 and 5 out."""
    maps = []
    for mod, kw in ((posd, {"device": "cpu"}), (josd, {})):
        m = mod.build_simple_osdmap(8, 4, 256, mod.POOL_TYPE_ERASURE, 7,
                                    **kw)
        root = min(m.crush.buckets)
        assert root == -3 and m.crush.buckets[root].type == 3
        m.pools[1].crush_rule = m.crush.add_rule(
            type(m.crush.rules[0])(steps=C1_STEPS))
        m.invalidate_mappers()
        m.mark_out(1)
        m.mark_out(5)
        maps.append(m)
    p, j = maps
    up, upp = p.pool_mapping(1)
    want = np.full((256, 7), CRUSH_ITEM_NONE, dtype=np.int64)
    wantp = np.full(256, -1, dtype=np.int64)
    for s in range(256):
        u, pr, _a, _ap = j.pg_to_up_acting_osds(josd.PGid(1, s))
        want[s, : len(u)] = u
        wantp[s] = pr
    assert np.array_equal(up, want) and np.array_equal(upp, wantp)
    assert up[0].tolist() == [7, 5, 6, 4, 3, 2, 0]
    # the port's own scalar chain agrees, and out OSDs hold chunks
    for s in range(0, 256, 17):
        assert p.pg_to_up_acting_osds(posd.PGid(1, s))[0] == \
            up[s].tolist()
    assert np.isin(up, [1, 5]).any(axis=1).all()


# ----------------------------------------------------------------- fuzz

def random_maps(rng, levels):
    """The same random map in both packages: ``levels`` bucket levels
    (types 1..levels, the root at the top), fanouts of 0-4 with zero
    weights, and reweighted and out devices.  Returns (port map, reference
    map, weights, {type: [bucket ids]})."""
    out = []
    state = rng.bit_generator.state
    for CM, B in ((CrushMap, Bucket), (JCrushMap, JBucket)):
        rng.bit_generator.state = state
        cmap = CM()
        by_type = {}
        dev = [0]

        def make(t):
            n = int(rng.integers(0, 5)) if t > 1 else int(rng.integers(1, 5))
            if t == levels:
                n = max(n, 2)
            if t == 1:
                items = list(range(dev[0], dev[0] + n))
                dev[0] += n
                ws = [int(w) * 0x8000 for w in rng.integers(0, 5, n)]
            else:
                items = [make(t - 1) for _ in range(n)]
                ws = [cmap.buckets[i].weight for i in items]
            bid = cmap.add_bucket(B(id=0, type=t, items=items, weights=ws))
            by_type.setdefault(t, []).append(bid)
            return bid

        make(levels)
        out.append((cmap, by_type))
    (pmap, by_type), (jmap, _) = out
    weights = np.full(max(pmap.max_devices, 1), 0x10000, dtype=np.uint32)
    n = len(weights)
    weights[rng.integers(0, n, max(1, n // 4))] = 0
    weights[rng.integers(0, n, max(1, n // 6))] = 0x9000
    return pmap, jmap, weights, by_type


def fuzz_rule(rng, shape, firstn, levels, by_type, result_max):
    """One rule of the named shape."""
    leaf = RULE_CHOOSELEAF_FIRSTN if firstn else RULE_CHOOSELEAF_INDEP
    choose = RULE_CHOOSE_FIRSTN if firstn else RULE_CHOOSE_INDEP
    root = by_type[levels][0]
    tries = [(RULE_SET_CHOOSE_TRIES, int(rng.integers(1, 60)), 0),
             (RULE_SET_CHOOSELEAF_TRIES, int(rng.integers(1, 8)), 0)]
    if shape == "chooseleaf_type0":
        take = root if rng.random() < 0.6 else \
            int(rng.choice(by_type[int(rng.integers(1, levels + 1))]))
        return tries + [(RULE_TAKE, take, 0),
                        (leaf, int(rng.integers(-1, 4)), 0),
                        (RULE_EMIT, 0, 0)]
    if shape == "numrep_plus_result_max_le_0":
        numrep = -result_max - int(rng.integers(0, 3))
        t = int(rng.integers(0, levels))
        steps = [(RULE_TAKE, root, 0)]
        if levels > 2:
            steps.append((choose, 2, levels - 1))
        steps += [(leaf if t else choose, numrep, t), (RULE_EMIT, 0, 0)]
        # a later TAKE starts over from a fresh working vector
        return steps + [(RULE_TAKE, root, 0), (leaf, 1, 1), (RULE_EMIT, 0, 0)]
    # take_bucket_of_step_type: TAKE a bucket of type t, then a step of
    # type t (choose, or chooseleaf when t > 0)
    t = int(rng.integers(1, levels + 1))
    take = int(rng.choice(by_type[t]))
    op = leaf if rng.random() < 0.5 else choose
    return tries[:1] + [(RULE_TAKE, take, 0),
                        (op, int(rng.integers(1, 4)), t), (RULE_EMIT, 0, 0)]


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
@pytest.mark.parametrize("shape", ["chooseleaf_type0",
                                   "numrep_plus_result_max_le_0",
                                   "take_bucket_of_step_type"])
def test_rule_fuzz_equals_reference_scalar(shape, firstn, seed):
    rng = np.random.default_rng([seed, int(firstn), len(shape)])
    levels = int(rng.integers(2, 5))
    pmap, jmap, weights, by_type = random_maps(rng, levels)
    result_max = int(rng.integers(1, 5))
    steps = fuzz_rule(rng, shape, firstn, levels, by_type, result_max)
    ruleno = pmap.add_rule(Rule(steps=steps))
    jmap.add_rule(JRule(steps=steps))
    xs = rng.integers(0, 1 << 32, 160, dtype=np.uint64).astype(np.uint32)
    got = held_to_scalar(pmap, jmap, ruleno, xs, result_max, weights)
    assert all(len(g) <= result_max for g in got)

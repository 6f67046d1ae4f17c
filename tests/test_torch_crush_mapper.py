"""The port's batched CRUSH mapper against the C goldens and the oracle.

``ceph_tpu_torch.crush.mapper.TensorMapper`` on ``device="cpu"``:
- every straw2 scenario of ``tests/golden/crush_golden.jsonl``
  (choose_args included) against the golden results;
- randomized maps with reweighted and out devices, zero-weight items and
  an empty host, firstn and indep, with and without choose_args
  (multi-position weight sets and id remaps), against
  ``ceph_tpu.crush.ScalarMapper``;
- indep segments that overflow ``result_max`` against the scalar oracle;
- chunking and padding with the ``crush_map_*`` counters;
- ``unsupported_reason`` and the raise for legacy, non-straw2 and sparse
  maps.

The same mapper against ``ceph_tpu``'s JAX TensorMapper is in
``tests/test_torch_crush_mapper_jax.py``.  Inputs are seeded numpy; every
comparison is exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.crush import CrushMap as JCrushMap
from ceph_tpu.crush import ScalarMapper as JScalarMapper
from ceph_tpu.crush.types import Bucket as JBucket
from ceph_tpu.crush.types import ChooseArg as JChooseArg
from ceph_tpu.crush.types import Rule as JRule
from ceph_tpu_torch.crush import Bucket, CrushMap, Rule, Tunables
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import (
    CRUSH_ITEM_NONE,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_EMIT,
    RULE_TAKE,
    ChooseArg,
    build_hierarchy,
    build_three_level,
)
from ceph_tpu_torch.utils.perf import KERNELS
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "crush_golden.jsonl"
STRAW2 = [d for d in map(json.loads, GOLDEN.open())
          if d["scenario"] != "hash"
          and all(b.get("alg", "straw2") == "straw2" for b in d["buckets"])
          and not d["tunables"]["fallback"]]


def build_map(d) -> CrushMap:
    tn = d["tunables"]
    cmap = CrushMap(Tunables(
        choose_total_tries=tn["total"],
        choose_local_tries=tn["local"],
        choose_local_fallback_tries=tn["fallback"],
        chooseleaf_descend_once=tn["descend_once"],
        chooseleaf_vary_r=tn["vary_r"],
        chooseleaf_stable=tn["stable"],
    ))
    for b in d["buckets"]:
        cmap.add_bucket(Bucket(id=b["id"], type=b["type"], alg="straw2",
                               items=b["items"], weights=b["weights"]))
    cmap.add_rule(Rule(steps=[tuple(s) for s in d["steps"]]))
    return cmap


def rows(res, rlen):
    res, rlen = res.cpu().numpy(), rlen.cpu().numpy()
    return [[int(v) for v in res[i, : rlen[i]]] for i in range(len(rlen))]


def test_golden_has_the_straw2_scenarios():
    assert {d["scenario"] for d in STRAW2} == {
        "flat_firstn", "host_chooseleaf_firstn", "host_chooseleaf_indep",
        "racks_two_step", "flat_indep", "straw2_choose_args"}


@pytest.mark.parametrize("scen", STRAW2, ids=lambda s: s["scenario"])
def test_matches_golden(scen):
    cmap = build_map(scen)
    cargs = None
    if "choose_args" in scen:
        cargs = {int(bid): ChooseArg(ids=a.get("ids"),
                                     weight_set=a.get("weight_set"))
                 for bid, a in scen["choose_args"].items()}
    mapper = TensorMapper(cmap, device="cpu")
    n = len(scen["results"])
    got = rows(*mapper.do_rule_batch(
        0, np.arange(n, dtype=np.uint32), scen["result_max"],
        np.array(scen["weights"], dtype=np.uint32), choose_args=cargs))
    bad = [(x, g, w) for x, (g, w) in enumerate(zip(got, scen["results"]))
           if g != w]
    assert not bad, f"{len(bad)}/{n} mismatches, first: {bad[:5]}"


def random_maps(seed, n_hosts, empty_host=False):
    """The same randomized host map built in both packages (ids, sizes,
    weights, one zero-weight item; optionally an empty host)."""
    rng = np.random.default_rng(seed)
    sizes = [int(s) for s in rng.integers(2, 7, n_hosts)]
    wts = [[int(w) * 0x10000 for w in rng.integers(1, 5, n)] for n in sizes]
    wts[min(3, n_hosts - 1)][0] = 0
    if empty_host:
        sizes[1], wts[1] = 0, []
    out = []
    for CM, B in ((CrushMap, Bucket), (JCrushMap, JBucket)):
        cmap = CM()
        dev, hosts = 0, []
        for n, w in zip(sizes, wts):
            hosts.append(cmap.add_bucket(B(
                id=0, type=1, items=list(range(dev, dev + n)), weights=w)))
            dev += n
        cmap.add_bucket(B(id=0, type=3, items=hosts,
                          weights=[cmap.buckets[h].weight for h in hosts]))
        out.append(cmap)
    weights = np.full(out[0].max_devices, 0x10000, dtype=np.uint32)
    weights[rng.integers(0, dev, 5)] = 0
    weights[rng.integers(0, dev, 5)] = 0x8000
    return out[0], out[1], weights, rng


def add_rule(pmap, jmap, steps):
    pmap.add_rule(Rule(steps=steps))
    return jmap.add_rule(JRule(steps=steps))


def check_against_scalar(pmap, jmap, ruleno, weights, n, result_max,
                         pargs=None, jargs=None, chunk=1 << 16):
    mapper = TensorMapper(pmap, chunk=chunk, device="cpu")
    got = rows(*mapper.do_rule_batch(
        ruleno, np.arange(n, dtype=np.uint32), result_max, weights,
        choose_args=pargs))
    scalar = JScalarMapper(jmap)
    bad = []
    for x in range(n):
        want = scalar.do_rule(ruleno, x, result_max, list(weights),
                              choose_args=jargs)
        if got[x] != want:
            bad.append((x, got[x], want))
    assert not bad, f"{len(bad)}/{n} mismatches, first: {bad[:5]}"
    return got


@pytest.mark.parametrize("empty_host", [False, True], ids=["full", "empty"])
@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
def test_random_map_equals_reference_scalar(firstn, empty_host):
    pmap, jmap, weights, _ = random_maps(5, 12, empty_host)
    root = min(pmap.buckets)
    op = RULE_CHOOSELEAF_FIRSTN if firstn else RULE_CHOOSELEAF_INDEP
    ruleno = add_rule(pmap, jmap, [(RULE_TAKE, root, 0), (op, 0, 1),
                                   (RULE_EMIT, 0, 0)])
    check_against_scalar(pmap, jmap, ruleno, weights, 600, 4)


def choose_args_pair(pmap, rng, with_ids):
    """Balancer-style overrides: per-position weight sets on the root and
    two hosts, and an id remap on one host."""
    root = min(pmap.buckets)
    rb = pmap.buckets[root]
    cargs = {root: dict(weight_set=[
        [int(w) for w in rng.integers(1, 8, rb.size) * 0x4000]
        for _ in range(3)])}
    for hid in (-1, -3):
        hb = pmap.buckets[hid]
        cargs[hid] = dict(weight_set=[
            [int(w) for w in rng.integers(0, 5, hb.size) * 0x8000]
            for _ in range(2)])
    if with_ids:
        hb = pmap.buckets[-2]
        cargs[-2] = dict(ids=[int(i) + 1000 for i in range(hb.size)])
    return ({b: ChooseArg(**a) for b, a in cargs.items()},
            {b: JChooseArg(**a) for b, a in cargs.items()})


@pytest.mark.parametrize("with_ids", [False, True], ids=["weights", "ids"])
@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
def test_choose_args_equal_reference_scalar(firstn, with_ids):
    pmap, jmap, weights, rng = random_maps(11, 8)
    root = min(pmap.buckets)
    op = RULE_CHOOSELEAF_FIRSTN if firstn else RULE_CHOOSELEAF_INDEP
    ruleno = add_rule(pmap, jmap, [(RULE_TAKE, root, 0), (op, 3, 1),
                                   (RULE_EMIT, 0, 0)])
    pargs, jargs = choose_args_pair(pmap, rng, with_ids)
    got = check_against_scalar(pmap, jmap, ruleno, weights, 500, 3,
                               pargs, jargs)
    plain = rows(*TensorMapper(pmap, device="cpu").do_rule_batch(
        ruleno, np.arange(500, dtype=np.uint32), 3, weights))
    assert got != plain                   # the overrides moved placements
    # a registered name resolves to the same set
    pmap.choose_args["bal"] = pargs
    named = rows(*TensorMapper(pmap, device="cpu").do_rule_batch(
        ruleno, np.arange(500, dtype=np.uint32), 3, weights,
        choose_args="bal"))
    assert named == got


def test_indep_segments_overflowing_result_max_equal_reference_scalar():
    """CHOOSE_INDEP 3 racks, then CHOOSELEAF_INDEP 2 hosts per rack, into
    4 slots: the second segment has room for 1 and the third for none,
    as in the reference's shorter segments."""
    pmap, jmap = CrushMap(), JCrushMap()
    rng = np.random.default_rng(3)
    hw = [int(w) * 0x10000 for w in rng.integers(1, 4, 24)]
    for cmap, B in ((pmap, Bucket), (jmap, JBucket)):
        hosts = [cmap.add_bucket(B(id=0, type=1,
                                   items=[2 * h, 2 * h + 1],
                                   weights=[hw[h], 0x10000]))
                 for h in range(24)]
        racks = [cmap.add_bucket(B(
            id=0, type=2, items=hosts[r * 4:(r + 1) * 4],
            weights=[cmap.buckets[h].weight for h in hosts[r * 4:r * 4 + 4]]))
            for r in range(6)]
        cmap.add_bucket(B(id=0, type=3, items=racks,
                          weights=[cmap.buckets[r].weight for r in racks]))
    root = min(pmap.buckets)
    ruleno = add_rule(pmap, jmap, [
        (RULE_TAKE, root, 0), (RULE_CHOOSE_INDEP, 3, 2),
        (RULE_CHOOSELEAF_INDEP, 2, 1), (RULE_EMIT, 0, 0)])
    weights = np.full(48, 0x10000, dtype=np.uint32)
    weights[[5, 17, 30]] = 0
    got = check_against_scalar(pmap, jmap, ruleno, weights, 400, 4)
    assert {len(g) for g in got} == {4}


def test_three_level_map_places_on_distinct_hosts():
    cmap, rule = build_three_level(3, 4, 4, numrep=3)
    mapper = TensorMapper(cmap, device="cpu")
    weights = np.full(cmap.max_devices, 0x10000, dtype=np.uint32)
    res, rlen = mapper.do_rule_batch(
        rule, np.arange(2048, dtype=np.uint32), 3, weights)
    assert res.dtype == rlen.dtype == torch.int64
    assert bool((rlen == 3).all())
    hosts = (res // 4).numpy()
    assert all(len(set(r)) == 3 for r in hosts)


def test_chunking_and_padding_counters():
    cmap, rule = build_hierarchy(n_hosts=6, osds_per_host=3, numrep=3)
    weights = np.full(cmap.max_devices, 0x10000, dtype=np.uint32)
    weights[4] = 0
    xs = np.arange(1300, dtype=np.uint32) * 7919
    whole = TensorMapper(cmap, chunk=1 << 16, device="cpu")
    parted = TensorMapper(cmap, chunk=512, device="cpu")
    assert parted.chunk == 512
    KERNELS.reset()
    want = whole.do_rule_batch(rule, xs, 3, weights)
    assert (KERNELS.get("crush_map_calls"), KERNELS.get("crush_map_pgs"),
            KERNELS.get("crush_map_pad_lanes")) == (1, 1300, 0)
    KERNELS.reset()
    got = parted.do_rule_batch(rule, torch.from_numpy(xs.astype(np.int64)),
                               3, torch.from_numpy(weights.astype(np.int64)))
    # 1300 = 512 + 512 + 276: the last chunk runs 236 padded lanes
    assert (KERNELS.get("crush_map_calls"), KERNELS.get("crush_map_pgs"),
            KERNELS.get("crush_map_pad_lanes")) == (1, 1300, 236)
    assert got[0].shape == (1300, 3)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    # one chunk exactly: no padding
    KERNELS.reset()
    parted.do_rule_batch(rule, xs[:512], 3, weights)
    assert KERNELS.get("crush_map_pad_lanes") == 0
    # a short weight vector counts the devices past its end as out
    short = rows(*whole.do_rule_batch(rule, xs[:200], 3, weights[:9]))
    assert all(d < 9 for r in short for d in r)
    assert not any(CRUSH_ITEM_NONE in r for r in short)


def test_unsupported_maps_raise():
    cmap, _ = build_hierarchy(n_hosts=3, osds_per_host=2)
    assert TensorMapper.unsupported_reason(cmap) is None
    legacy, _ = build_hierarchy(n_hosts=3, osds_per_host=2)
    legacy.tunables = Tunables.legacy()
    assert TensorMapper.unsupported_reason(legacy) == \
        "legacy tunables (local retries)"
    tree, _ = build_hierarchy(n_hosts=3, osds_per_host=2)
    tree.buckets[-2].alg = "tree"
    assert TensorMapper.unsupported_reason(tree) == \
        "non-straw2 bucket (tree)"
    sparse, _ = build_hierarchy(n_hosts=3, osds_per_host=2)
    sparse.buckets[-7] = sparse.buckets.pop(-2)
    assert TensorMapper.unsupported_reason(sparse) == "sparse bucket ids"
    for bad in (legacy, tree, sparse):
        with pytest.raises(NotImplementedError,
                           match=TensorMapper.unsupported_reason(bad)[:12]):
            TensorMapper(bad, device="cpu")
    # a rule step asking for local retries raises at run time
    steps = [(10, 2, 0)] + list(cmap.rules[0].steps)
    ruleno = cmap.add_rule(Rule(steps=steps))
    with pytest.raises(NotImplementedError, match="local retries"):
        TensorMapper(cmap, device="cpu").do_rule_batch(
            ruleno, np.arange(4, dtype=np.uint32), 3,
            np.full(6, 0x10000, dtype=np.uint32))

"""The port's CRUSH host half against the reference C and the JAX package.

- the port's ``ScalarMapper`` against the C goldens of
  ``tests/golden/crush_golden.jsonl`` (straw2, list, tree and straw
  buckets, the legacy tunables, choose_args), and on uniform buckets,
  which the goldens lack, against ``ceph_tpu``'s ScalarMapper;
- the builder-derived data (tree node weights, straw scaling) against the
  goldens;
- rjenkins1 ``hash1``...``hash5`` against the golden vectors and against
  ``ceph_tpu.ops.jenkins`` on numpy and on torch int64, with values near
  2^32 (wraparound) and negative ids; ``str_hash_rjenkins`` against the
  reference's;
- ``crush_ln`` and its tables against the reference's, every 16-bit input.

Inputs are seeded numpy; every comparison is exact.
"""

import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.crush import ln as jln
from ceph_tpu.ops import jenkins as jjenkins
from ceph_tpu_torch.crush import Bucket, CrushMap, Rule, ScalarMapper, Tunables
from ceph_tpu_torch.crush import ln as pln
from ceph_tpu_torch.crush.types import ChooseArg
from ceph_tpu_torch.ops import jenkins
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "crush_golden.jsonl"
SCENARIOS = [json.loads(line) for line in GOLDEN.open()]
HASH = next(d for d in SCENARIOS if d["scenario"] == "hash")
MAPS = [d for d in SCENARIOS if d["scenario"] != "hash"]


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
    cmap.straw_calc_version = tn.get("straw_calc", 1)
    for b in d["buckets"]:
        cmap.add_bucket(Bucket(id=b["id"], type=b["type"],
                               alg=b.get("alg", "straw2"),
                               items=b["items"], weights=b["weights"]))
    cmap.add_rule(Rule(steps=[tuple(s) for s in d["steps"]]))
    return cmap


def choose_args_of(d):
    if "choose_args" not in d:
        return None
    return {int(bid): ChooseArg(ids=a.get("ids"),
                                weight_set=a.get("weight_set"))
            for bid, a in d["choose_args"].items()}


def test_golden_covers_four_bucket_algorithms_and_legacy_tunables():
    algs = {b.get("alg", "straw2") for d in MAPS for b in d["buckets"]}
    assert algs == {"straw2", "list", "tree", "straw"}
    assert any(d["tunables"]["fallback"] for d in MAPS)


@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
def test_uniform_buckets_equal_reference_scalar(firstn):
    """The fifth algorithm, which the goldens lack: uniform hosts (the
    permutation choose, mapper.c:73-131) under a straw2 root, legacy and
    optimal tunables, against ``ceph_tpu``'s ScalarMapper."""
    from ceph_tpu.crush import CrushMap as JCrushMap
    from ceph_tpu.crush import ScalarMapper as JScalarMapper
    from ceph_tpu.crush import Tunables as JTunables
    from ceph_tpu.crush.types import Bucket as JBucket
    from ceph_tpu.crush.types import Rule as JRule

    rng = np.random.default_rng(31)
    sizes = [int(s) for s in rng.integers(2, 7, 6)]
    op = 6 if firstn else 7                 # CHOOSELEAF_FIRSTN / _INDEP
    for legacy in (False, True):
        maps = []
        for CM, B, R, T in ((CrushMap, Bucket, Rule, Tunables),
                            (JCrushMap, JBucket, JRule, JTunables)):
            cmap = CM(T.legacy() if legacy else T())
            dev, hosts = 0, []
            for n in sizes:
                hosts.append(cmap.add_bucket(B(
                    id=0, type=1, alg="uniform",
                    items=list(range(dev, dev + n)),
                    weights=[0x10000] * n)))
                dev += n
            root = cmap.add_bucket(B(
                id=0, type=3, alg="straw2", items=hosts,
                weights=[cmap.buckets[h].weight for h in hosts]))
            cmap.add_rule(R(steps=[(1, root, 0), (op, 3, 1), (4, 0, 0)]))
            maps.append(cmap)
        weights = [0x10000] * maps[0].max_devices
        weights[2] = 0
        weights[7] = 0x8000
        pm, jm = ScalarMapper(maps[0]), JScalarMapper(maps[1])
        for x in range(300):
            assert pm.do_rule(0, x, 3, weights) == \
                jm.do_rule(0, x, 3, weights), (legacy, x)


@pytest.mark.parametrize("scen", MAPS, ids=lambda s: s["scenario"])
def test_scalar_matches_golden(scen):
    cmap = build_map(scen)
    sm = ScalarMapper(cmap)
    cargs = choose_args_of(scen)
    bad = []
    for x, want in enumerate(scen["results"]):
        got = sm.do_rule(0, x, scen["result_max"], scen["weights"],
                         choose_args=cargs)
        if got != want:
            bad.append((x, got, want))
    assert not bad, f"{len(bad)} mismatches, first: {bad[:5]}"


@pytest.mark.parametrize("scen", MAPS, ids=lambda s: s["scenario"])
def test_builder_derived_data_matches_golden(scen):
    version = scen["tunables"].get("straw_calc", 1)
    for b in scen["buckets"]:
        bk = Bucket(id=b["id"], type=b["type"], alg=b.get("alg", "straw2"),
                    items=b["items"], weights=b["weights"])
        if bk.alg == "list" and "sum_weights" in b:
            assert bk.sum_weights == b["sum_weights"]
        elif bk.alg == "tree" and "node_weights" in b:
            assert bk.tree_data == (b["num_nodes"], b["node_weights"])
        elif bk.alg == "straw" and "straws" in b:
            assert bk.straws(version) == b["straws"]


def test_hash_golden_vectors():
    i = np.arange(64, dtype=np.uint64)
    want = {k: np.array(HASH[k], dtype=np.int64)
            for k in ("h1", "h2", "h3", "h5")}
    assert np.array_equal(
        jenkins.hash1(((i * 2654435761) + 17) & 0xFFFFFFFF), want["h1"])
    assert np.array_equal(
        jenkins.hash2(i, (i * 40503 + 3) & 0xFFFFFFFF), want["h2"])
    assert np.array_equal(jenkins.hash3(i, i + 1, i * 7), want["h3"])
    assert np.array_equal(
        jenkins.hash5(i, 2 * i, 3 * i, 5 * i, 7 * i), want["h5"])
    ti = torch.arange(64, dtype=torch.int64)
    assert torch.equal(jenkins.hash3(ti, ti + 1, ti * 7),
                       torch.from_numpy(want["h3"]))


def _hash_inputs(rng, arity):
    """uint32 operands: random, the top of the range (wraparound) and the
    two's-complement images of small negative ids."""
    n = 512
    cols = []
    for _ in range(arity):
        v = rng.integers(0, 1 << 32, n, dtype=np.uint64)
        v[:32] = (1 << 32) - 1 - rng.integers(0, 64, 32)
        v[32:64] = (-rng.integers(1, 200, 32)) & 0xFFFFFFFF
        v[64:72] = [0, 1, 0x7FFFFFFF, 0x7FFFFFFE, 0x80000000,
                    0xFFFFFFFF, 0xFFFF, 0x10000]
        cols.append(v)
    return cols


@pytest.mark.parametrize("backend", ["numpy", "torch"])
@pytest.mark.parametrize("arity", [1, 2, 3, 4, 5])
def test_hash_equals_reference(arity, backend):
    rng = np.random.default_rng(100 + arity)
    cols = _hash_inputs(rng, arity)
    fn = getattr(jenkins, f"hash{arity}")
    want = np.asarray(getattr(jjenkins, f"hash{arity}")(*cols),
                      dtype=np.int64)
    if backend == "numpy":
        got = fn(*cols)
    else:
        # the device path's inputs: int64 tensors, negative ids unmasked
        tcols = [torch.from_numpy(c.astype(np.int64)) for c in cols]
        tcols[-1] = torch.where(tcols[-1] >= 1 << 31,
                                tcols[-1] - (1 << 32), tcols[-1])
        got = fn(*tcols).numpy()
    assert got.dtype == np.int64
    assert np.array_equal(got, want)
    # Python ints, as the scalar oracle calls it
    for j in range(0, 512, 37):
        args = [int(c[j]) for c in cols]
        assert fn(*args) == int(want[j])
        assert fn(*[a - (1 << 32) if a >= 1 << 31 else a
                    for a in args]) == int(want[j])


def test_str_hash_rjenkins_equals_reference():
    rng = np.random.default_rng(7)
    for n in list(range(0, 40)) + [100, 255, 1000]:
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert jenkins.str_hash_rjenkins(data) == \
            jjenkins.str_hash_rjenkins(data), n
    assert jenkins.str_hash_rjenkins(b"rbd_data.1234") == \
        jjenkins.str_hash_rjenkins(b"rbd_data.1234")


def test_crush_ln_equals_reference_everywhere():
    assert pln.RH_TBL == jln.RH_TBL
    assert pln.LH_TBL == jln.LH_TBL
    assert tuple(pln.LL_TBL) == tuple(jln.LL_TBL)
    got = [pln.crush_ln(u) for u in range(0x10000)]
    assert got == [jln.crush_ln(u) for u in range(0x10000)]
    assert got[0] == 0 and got[0xFFFF] == 0xFFFFF0000000
    # the one non-monotone step the batched mapper's ties depend on
    assert all(a <= b for a, b in zip(got[:0xFFFF], got[1:0xFFFF]))
    assert got[0xFFFE] > got[0xFFFF]

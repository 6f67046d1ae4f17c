"""The port's batched indep placement against ``ceph_tpu``'s JAX mapper.

The ``racks_two_step`` map of ``tests/golden/crush_golden.jsonl`` (root ->
racks -> hosts -> osds, one osd out) with its two-step rule turned indep,
the shape of an LRC rule: ``choose indep 2 type rack`` then ``chooseleaf
indep 2 type host``, through the port's ``TensorMapper(device="cpu")``
and ``ceph_tpu.crush.mapper.TensorMapper`` on JAX-CPU.  The golden
firstn rule itself is held against the C results in
``tests/test_torch_crush_mapper.py``.  Inputs are seeded numpy; every
comparison is exact.
"""

import json
import pathlib

import numpy as np

from ceph_tpu.crush import CrushMap as JCrushMap
from ceph_tpu.crush.mapper import TensorMapper as JTensorMapper
from ceph_tpu.crush.types import Bucket as JBucket
from ceph_tpu.crush.types import Rule as JRule
from ceph_tpu_torch.crush import Bucket, CrushMap, Rule, ScalarMapper
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import (
    RULE_CHOOSE_FIRSTN,
    RULE_CHOOSE_INDEP,
    RULE_CHOOSELEAF_FIRSTN,
    RULE_CHOOSELEAF_INDEP,
    RULE_SET_CHOOSE_TRIES,
)
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "crush_golden.jsonl"
INDEP = {RULE_CHOOSE_FIRSTN: RULE_CHOOSE_INDEP,
         RULE_CHOOSELEAF_FIRSTN: RULE_CHOOSELEAF_INDEP}


def test_racks_two_step_indep_equals_jax():
    scen = next(d for d in map(json.loads, GOLDEN.open())
                if d["scenario"] == "racks_two_step")
    steps = [(INDEP.get(op, op), a1, a2) for op, a1, a2 in scen["steps"]]
    steps.insert(0, (RULE_SET_CHOOSE_TRIES, 100, 0))
    assert [s[0] for s in steps[1:]] == [1, RULE_CHOOSE_INDEP,
                                         RULE_CHOOSELEAF_INDEP, 4]
    pmap, jmap = CrushMap(), JCrushMap()
    for cmap, B, R in ((pmap, Bucket, Rule), (jmap, JBucket, JRule)):
        for b in scen["buckets"]:
            cmap.add_bucket(B(id=b["id"], type=b["type"], items=b["items"],
                              weights=b["weights"]))
        cmap.add_rule(R(steps=steps))
    weights = np.array(scen["weights"], dtype=np.uint32)
    xs = np.random.default_rng(41).integers(
        0, 1 << 32, 1200, dtype=np.uint64).astype(np.uint32)
    pres, plen = TensorMapper(pmap, device="cpu").do_rule_batch(
        0, xs, 4, weights)
    jres, jlen = JTensorMapper(jmap).do_rule_batch(0, xs, 4, weights)
    pres, plen = pres.numpy(), plen.numpy()
    assert np.array_equal(plen, np.asarray(jlen))
    assert np.array_equal(pres, np.asarray(jres).astype(np.int64))
    assert set(plen.tolist()) == {4}
    # and the scalar oracle on a sample
    sm = ScalarMapper(pmap)
    for i in range(0, 1200, 53):
        assert sm.do_rule(0, int(xs[i]), 4, list(weights)) == \
            [int(v) for v in pres[i]]

"""The port's batched CRUSH mapper against ``ceph_tpu``'s JAX mapper.

A three-level root -> rack -> host -> osd map (``build_three_level``, the
shape of ``bench_map`` at a small size) with reweighted and out devices,
built in both packages; ``chooseleaf firstn 3 type host`` through the
port's ``TensorMapper(device="cpu")`` and ``ceph_tpu.crush.mapper.
TensorMapper`` on JAX-CPU, plain and with a choose_args weight set and id
remap.  The JAX mapper compiles slowly on the CPU, so one mapper serves
the module.  Inputs are seeded numpy; every comparison is exact.
"""

import numpy as np
import pytest

from ceph_tpu.crush.mapper import TensorMapper as JTensorMapper
from ceph_tpu.crush.types import ChooseArg as JChooseArg
from ceph_tpu.crush.types import build_three_level as jbuild_three_level
from ceph_tpu_torch.crush.mapper import TensorMapper
from ceph_tpu_torch.crush.types import ChooseArg, build_three_level
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

N = 1500


@pytest.fixture(scope="module")
def maps():
    pmap, rule = build_three_level(3, 4, 4, numrep=3)
    jmap, jrule = jbuild_three_level(3, 4, 4, numrep=3)
    assert rule == jrule
    rng = np.random.default_rng(23)
    weights = np.full(pmap.max_devices, 0x10000, dtype=np.uint32)
    weights[rng.integers(0, 48, 4)] = 0
    weights[rng.integers(0, 48, 4)] = 0x6000
    xs = rng.integers(0, 1 << 32, N, dtype=np.uint64).astype(np.uint32)
    return pmap, jmap, rule, weights, xs, JTensorMapper(jmap)


def both(maps, pargs=None, jargs=None):
    pmap, _jmap, rule, weights, xs, jmapper = maps
    pres, plen = TensorMapper(pmap, device="cpu").do_rule_batch(
        rule, xs, 3, weights, choose_args=pargs)
    jres, jlen = jmapper.do_rule_batch(rule, xs, 3, weights,
                                       choose_args=jargs)
    return (pres.numpy(), plen.numpy()), (np.asarray(jres), np.asarray(jlen))


def test_three_level_firstn_equals_jax(maps):
    (pres, plen), (jres, jlen) = both(maps)
    assert np.array_equal(plen, jlen)
    assert np.array_equal(pres, jres.astype(np.int64))
    assert (plen == 3).mean() > 0.99


def test_three_level_choose_args_equals_jax(maps):
    pmap = maps[0]
    root = min(pmap.buckets)
    rng = np.random.default_rng(29)
    rack = pmap.buckets[-5]
    over = {root: dict(weight_set=[
        [int(w) * 0x8000 for w in rng.integers(1, 9, 3)] for _ in range(3)]),
        -5: dict(weight_set=[
            [int(w) * 0x10000 for w in rng.integers(0, 5, rack.size)]]),
        -2: dict(ids=[1000 + i for i in range(4)])}
    (pres, plen), (jres, jlen) = both(
        maps, {b: ChooseArg(**a) for b, a in over.items()},
        {b: JChooseArg(**a) for b, a in over.items()})
    assert np.array_equal(plen, jlen)
    assert np.array_equal(pres, jres.astype(np.int64))
    base = TensorMapper(pmap, device="cpu").do_rule_batch(
        maps[2], maps[4], 3, maps[3])[0].numpy()
    assert not np.array_equal(base, pres)

"""The port's coalesced stripe layer against ``ceph_tpu.ec.stripe``.

One mixed-size tick (zero-length, sub-stripe, exact-stripe and
multi-stripe objects) on ISA k3m2 through both packages: shards, CRCs
and at-rest planes must be identical, and the planar decode must agree
for every 1- and 2-erasure pattern.  Planes written by one package are
decoded by the other.  The port runs on ``device="cpu"``.
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import stripe as jstripe
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec import stripe

K, M, UNIT = 3, 2, 64
N = K + M
SIZES = [0, 10, K * UNIT, 500, 1000, 4 * K * UNIT + 7]
PATTERNS = [(e,) for e in range(N)] + list(itertools.combinations(range(N), 2))


def _codecs(technique="reed_sol_van"):
    prof = {"plugin": "isa", "k": str(K), "m": str(M),
            "technique": technique}
    return jfactory(dict(prof)), factory(dict(prof), device="cpu")


def _datas(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in SIZES]


def _sinfo():
    return stripe.StripeInfo(K, UNIT), jstripe.StripeInfo(K, UNIT)


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_encode_stripes_multi_equal_reference(technique):
    jc, pc = _codecs(technique)
    ps, js = _sinfo()
    datas = _datas(1)
    flags = [True] * len(datas)
    got = stripe.encode_stripes_multi(pc, ps, datas, want_crcs=flags)
    want = jstripe.encode_stripes_multi(jc, js, datas, want_crcs=flags)
    for (gs, gc), (ws, wc), d in zip(got, want, datas):
        assert np.array_equal(gs, ws)
        assert gc == wc
        assert np.array_equal(gs, stripe.encode_stripes(pc, ps, d))
        assert np.array_equal(gs, jstripe.encode_stripes(jc, js, d))


@pytest.mark.parametrize("technique", ["reed_sol_van", "cauchy"])
def test_encode_planes_multi_equal_reference(technique):
    jc, pc = _codecs(technique)
    ps, js = _sinfo()
    datas = _datas(2)
    flags = [i % 2 == 0 for i in range(len(datas))]
    got = stripe.encode_planes_multi(pc, ps, datas, want_crcs=flags)
    want = jstripe.encode_planes_multi(jc, js, datas, want_crcs=flags)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert gp.shape == wp.shape
        assert np.array_equal(gp, wp)
        assert gc == wc


def _reqs(planes_out, datas, erasures):
    return [({s: p[s] for s in range(N) if s not in erasures}, len(d))
            for (p, _c), d in zip(planes_out, datas)]


@pytest.mark.parametrize("erasures", PATTERNS, ids=str)
def test_decode_planes_multi_equal_reference(erasures):
    jc, pc = _codecs()
    ps, js = _sinfo()
    datas = _datas(3)
    planes = stripe.encode_planes_multi(pc, ps, datas)
    got = stripe.decode_planes_multi(pc, ps, _reqs(planes, datas, erasures))
    want = jstripe.decode_planes_multi(jc, js,
                                       _reqs(planes, datas, erasures))
    assert got == want
    assert got == datas


def test_planes_cross_decode_between_packages():
    """At-rest planes are the persistent state: planes written by the
    reference decode through the port, and the other way round."""
    jc, pc = _codecs("cauchy")
    ps, js = _sinfo()
    datas = _datas(4)
    jplanes = jstripe.encode_planes_multi(jc, js, datas)
    pplanes = stripe.encode_planes_multi(pc, ps, datas)
    for erasures in [(0,), (1, 4), (0, 2)]:
        assert stripe.decode_planes_multi(
            pc, ps, _reqs(jplanes, datas, erasures)) == datas
        assert jstripe.decode_planes_multi(
            jc, js, _reqs(pplanes, datas, erasures)) == datas
    # serialized blobs (the store's form) decode the same way
    blobs = [({s: p[s].tobytes() for s in range(1, N)}, len(d))
             for (p, _c), d in zip(jplanes, datas)]
    assert stripe.decode_planes_multi(pc, ps, blobs) == datas


def test_unsolvable_pattern_raises_until_byte_decode_is_ported():
    _jc, pc = _codecs()
    ps, _js = _sinfo()
    datas = _datas(5)[1:2]
    planes = stripe.encode_planes_multi(pc, ps, datas)
    bad = planes[0][0].copy()
    # a code whose survivor submatrix is singular: zero out the coding
    pc.engine.generator[K:] = 0
    pc.engine._decode_cache = type(pc.engine._decode_cache)()
    with pytest.raises(ECError):
        stripe.decode_planes_multi(
            pc, ps, [({s: bad[s] for s in (1, 3, 4)}, len(datas[0]))])


def test_stripe_info_matches_reference():
    ps, js = _sinfo()
    for off, ln in [(0, 1), (5, 400), (192, 192), (1000, 3)]:
        assert ps.offset_len_to_stripe_bounds(off, ln) == \
            js.offset_len_to_stripe_bounds(off, ln)
    for size in SIZES:
        assert ps.shard_size(size) == js.shard_size(size)
        assert ps.object_stripes(size) == js.object_stripes(size)

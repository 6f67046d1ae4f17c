"""The port's coalesced stripe layer against ``ceph_tpu.ec.stripe``.

One mixed-size tick (zero-length, sub-stripe, exact-stripe and
multi-stripe objects) on ISA k3m2 through both packages: shards, CRCs
and at-rest planes must be identical, and the planar decode must agree
for every 1- and 2-erasure pattern.  Planes written by one package are
decoded by the other.  The byte-at-rest tick of the jerasure pools
(cauchy_good, liberation, reed_sol_van) is held against the reference's
per-op functions.  A SHEC k8m4c3 pool stores planes at rest: planes
written by the reference are decoded and rebuilt by the port, through the
plane engine or the byte relayout.  LRC and reed_sol_van at w=16/32 run
the byte-at-rest tick.  The port runs on ``device="cpu"``.
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import stripe as jstripe
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec import stripe
from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.ops.crc32c import crc32c_rows
from ceph_tpu_torch.utils.perf import KERNELS
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

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


def test_unsolvable_pattern_relayouts_then_raises():
    """A pattern the plane engine cannot solve relayouts to the byte
    decode (counted on the relayout seam); a code with no solution at all
    then raises there, as the reference does."""
    jc, pc = _codecs()
    ps, js = _sinfo()
    datas = _datas(5)[1:2]
    planes = stripe.encode_planes_multi(pc, ps, datas)
    bad = planes[0][0].copy()
    # a code whose survivor submatrix is singular: zero out the coding
    for codec in (pc, jc):
        codec.engine.generator[K:] = 0
        codec.engine._decode_cache = type(codec.engine._decode_cache)()
    reqs = [({s: bad[s] for s in (1, 3, 4)}, len(datas[0]))]
    KERNELS.reset()
    with pytest.raises(gf8.SingularMatrixError):
        stripe.decode_planes_multi(pc, ps, reqs)
    assert KERNELS.dump()["device_kernels"]["ec_planar_relayout_bytes"] > 0
    with pytest.raises(ValueError):
        jstripe.decode_planes_multi(jc, js, reqs)


def test_stripe_info_matches_reference():
    ps, js = _sinfo()
    for off, ln in [(0, 1), (5, 400), (192, 192), (1000, 3)]:
        assert ps.offset_len_to_stripe_bounds(off, ln) == \
            js.offset_len_to_stripe_bounds(off, ln)
    for size in SIZES:
        assert ps.shard_size(size) == js.shard_size(size)
        assert ps.object_stripes(size) == js.object_stripes(size)


# ---------------------------------------------------------------------------
# The byte-at-rest tick of the jerasure slice: encode_stripes_multi,
# decode_stripes_multi and reencode_stripes_multi of the port against the
# reference's PER-OP encode_stripes / decode_stripes / reencode_stripes.
# On a CPU JAX backend the reference's *_multi functions take a host GF
# engine that computes cauchy parity bytewise (it does not check for
# packetsize), so they are deliberately not used as the oracle here.
# ---------------------------------------------------------------------------

# (profile, stripe unit): packet codecs at two super-blocks per chunk, and
# the bytewise reed_sol_van
JERASURE_POOLS = {
    "cauchy_good": ({"plugin": "jerasure", "technique": "cauchy_good",
                     "k": "4", "m": "2", "packetsize": "8"}, 128),
    "liberation": ({"plugin": "jerasure", "technique": "liberation",
                    "k": "4", "w": "7", "packetsize": "4"}, 56),
    "reed_sol_van": ({"plugin": "jerasure", "technique": "reed_sol_van",
                      "k": "4", "m": "2"}, 64),
}
JK, JN = 4, 6
LOST = [(0,), (3,), (4,), (0, 1), (1, 5), (2, 3), (4, 5)]


def _jpool(name):
    prof, unit = JERASURE_POOLS[name]
    return (jfactory(dict(prof)), factory(dict(prof), device="cpu"),
            jstripe.StripeInfo(JK, unit), stripe.StripeInfo(JK, unit))


def _jdatas(unit, seed):
    rng = np.random.default_rng(seed)
    sizes = [0, 10, JK * unit, 500, 3 * JK * unit + 7]
    return [rng.integers(0, 256, s, dtype=np.uint8).tobytes() for s in sizes]


def _lost_reqs(shards_out, datas, lost):
    return [({s: sh[s] for s in range(JN) if s not in lost}, len(d))
            for sh, d in zip(shards_out, datas)]


@pytest.mark.parametrize("pool", sorted(JERASURE_POOLS))
def test_jerasure_encode_stripes_multi_equals_reference_per_op(pool):
    jc, pc, js, ps = _jpool(pool)
    datas = _jdatas(ps.chunk_size, 11)
    got = stripe.encode_stripes_multi(pc, ps, datas,
                                      want_crcs=[True] * len(datas))
    for (gs, gc), d in zip(got, datas):
        want = jstripe.encode_stripes(jc, js, d)
        assert np.array_equal(gs, want)
        assert np.array_equal(gs, stripe.encode_stripes(pc, ps, d))
        assert gc == crc32c_rows(want)


@pytest.mark.parametrize("lost", LOST, ids=str)
@pytest.mark.parametrize("pool", sorted(JERASURE_POOLS))
def test_jerasure_decode_and_reencode_multi_equal_reference_per_op(pool, lost):
    jc, pc, js, ps = _jpool(pool)
    datas = _jdatas(ps.chunk_size, 12)
    shards = [jstripe.encode_stripes(jc, js, d) for d in datas]
    reqs = _lost_reqs(shards, datas, lost)
    got = stripe.decode_stripes_multi(pc, ps, reqs)
    assert got == datas
    rebuilt = stripe.reencode_stripes_multi(pc, ps, reqs)
    for (shmap, size), d, g, full, r in zip(reqs, datas, got, shards,
                                            rebuilt):
        assert g == jstripe.decode_stripes(jc, js, shmap, size)
        assert g == stripe.decode_stripes(pc, ps, shmap, size)
        assert np.array_equal(r, jstripe.reencode_stripes(jc, js, shmap,
                                                          size))
        assert np.array_equal(r, full)
        assert np.array_equal(r, stripe.reencode_stripes(pc, ps, shmap, size))


def test_cauchy_encode_stripes_multi_not_held_to_reference_cpu_multi_fault():
    """The reference fault: on a CPU JAX backend ``encode_stripes_multi``
    computes cauchy parity bytewise.  The port's coalesced encode equals
    the reference's per-op ``encode_stripes`` and its ``codec.encode()``
    (which agree with the C goldens); the reference's ``*_multi`` CPU
    result is not used as the oracle."""
    prof = {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
            "m": "2", "packetsize": "8"}
    jc, pc = jfactory(dict(prof)), factory(dict(prof), device="cpu")
    js, ps = jstripe.StripeInfo(4, 4096), stripe.StripeInfo(4, 4096)
    data = np.random.default_rng(0).integers(0, 256, 2 * 4 * 4096,
                                             dtype=np.uint8).tobytes()
    (got, _crcs), = stripe.encode_stripes_multi(pc, ps, [data])
    assert np.array_equal(got, jstripe.encode_stripes(jc, js, data))
    # per stripe, the shards are the codec's encode() of that stripe
    for st in range(2):
        chunk = data[st * 4 * 4096:(st + 1) * 4 * 4096]
        enc = jc.encode(range(6), chunk)
        for s in range(6):
            assert np.array_equal(got[s, st * 4096:(st + 1) * 4096], enc[s])
    reqs = [({s: got[s] for s in range(2, 6)}, len(data))]
    assert stripe.decode_stripes_multi(pc, ps, reqs) == [data]
    (again,) = stripe.reencode_stripes_multi(pc, ps, reqs)
    assert np.array_equal(again, got)


def test_reencode_without_planar_contract_falls_back_to_decode_encode():
    """A cauchy stripe unit off the w*packetsize quantum has no packet
    planes; recovery then runs coalesced decode + coalesced encode, and
    such a unit cannot be encoded at all (jerasure's blocksize rule)."""
    _jc, pc, _js, _ps = _jpool("cauchy_good")
    ps = stripe.StripeInfo(JK, 96)
    with pytest.raises(ECError):
        stripe.encode_stripes_multi(pc, ps, [b"x" * 100])
    assert stripe.reencode_stripes_multi(pc, ps, [({}, 0)])[0].shape == \
        (JN, 0)
    assert stripe.decode_stripes_multi(pc, ps, [({}, 0)]) == [b""]


# ---------------------------------------------------------------------------
# The recovery tick of a pool with planes at rest, SHEC's relayout branch,
# merge_range, and the byte-at-rest tick of LRC and the wide fields.
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("erasures", PATTERNS, ids=str)
def test_reencode_planes_multi_equal_reference(erasures):
    jc, pc = _codecs()
    ps, js = _sinfo()
    datas = _datas(6)
    planes = jstripe.encode_planes_multi(jc, js, datas)
    reqs = _reqs(planes, datas, erasures)
    got = stripe.reencode_planes_multi(pc, ps, reqs)
    want = jstripe.reencode_planes_multi(jc, js, reqs)
    for g, w, (p, _c) in zip(got, want, planes):
        assert g.shape == w.shape
        assert np.array_equal(g, w)
        assert np.array_equal(g, p)


SHEC_PROFILE = {"plugin": "shec", "k": "8", "m": "4", "c": "3"}
SK, SN, SUNIT = 8, 12, 64
SHEC_SIZES = [0, 10, SK * SUNIT, 500, 3 * SK * SUNIT + 7]
# (erasures, does the plane engine solve it): the first k survivors'
# submatrix is singular for (4,) and (0, 1), so those relayout
SHEC_PATTERNS = [((4,), False), ((0, 1), False), ((3, 9), True),
                 ((0, 5, 11), True)]


def _shec_tick(seed):
    jc = jfactory(dict(SHEC_PROFILE))
    pc = factory(dict(SHEC_PROFILE), device="cpu")
    js, ps = jstripe.StripeInfo(SK, SUNIT), stripe.StripeInfo(SK, SUNIT)
    rng = np.random.default_rng(seed)
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in SHEC_SIZES]
    return jc, pc, js, ps, datas


def test_shec_pool_stores_planes_at_rest():
    jc, pc, js, ps, datas = _shec_tick(30)
    assert stripe.planar_at_rest_ok(pc, SUNIT)
    assert jstripe.planar_at_rest_ok(jc, SUNIT)
    flags = [True] * len(datas)
    got = stripe.encode_planes_multi(pc, ps, datas, want_crcs=flags)
    want = jstripe.encode_planes_multi(jc, js, datas, want_crcs=flags)
    for (gp, gc), (wp, wc) in zip(got, want):
        assert np.array_equal(gp, wp)
        assert gc == wc


@pytest.mark.parametrize("erasures,solved", SHEC_PATTERNS, ids=str)
def test_shec_planes_from_reference_decode_and_reencode_in_port(erasures,
                                                               solved):
    """Planes written by ceph_tpu: the port's decode_planes_multi returns
    the objects and its reencode_planes_multi the at-rest planes, equal to
    the reference's; the unsolvable patterns take the relayout seam."""
    jc, pc, js, ps, datas = _shec_tick(31)
    planes = jstripe.encode_planes_multi(jc, js, datas)
    reqs = [({s: p[s] for s in range(SN) if s not in erasures}, len(d))
            for (p, _c), d in zip(planes, datas)]
    KERNELS.reset()
    got = stripe.decode_planes_multi(pc, ps, reqs)
    relayout = KERNELS.dump()["device_kernels"].get(
        "ec_planar_relayout_bytes", 0)
    assert got == datas
    assert got == jstripe.decode_planes_multi(jc, js, reqs)
    assert (relayout == 0) == solved
    KERNELS.reset()
    rebuilt = stripe.reencode_planes_multi(pc, ps, reqs)
    relayout = KERNELS.dump()["device_kernels"].get(
        "ec_planar_relayout_bytes", 0)
    assert (relayout == 0) == solved
    for r, w, (p, _c) in zip(rebuilt, jstripe.reencode_planes_multi(
            jc, js, reqs), planes):
        assert np.array_equal(r, w)
        assert np.array_equal(r, p)


def test_shec_reencode_counts_its_ticks():
    _jc, pc, _js, ps, datas = _shec_tick(32)
    planes = stripe.encode_planes_multi(pc, ps, datas)
    reqs = [({s: p[s] for s in range(SN) if s not in (3, 9)}, len(d))
            for (p, _c), d in zip(planes, datas)]
    KERNELS.reset()
    stripe.reencode_planes_multi(pc, ps, reqs)
    counts = KERNELS.dump()["device_kernels"]
    assert counts["ec_coalesced_reencode_ticks"] == 1
    assert counts["ec_coalesced_reencodes"] == len(datas) - 1
    assert stripe.reencode_planes_multi(pc, ps, [({}, 0)])[0].shape == \
        (SN, 8, 0)
    # a relayout group takes one coalesced byte pass, not one per op
    reqs = [({s: p[s] for s in range(SN) if s != 4}, len(d))
            for (p, _c), d in zip(planes, datas)]
    KERNELS.reset()
    assert stripe.decode_planes_multi(pc, ps, reqs) == datas
    assert KERNELS.dump()["device_kernels"]["ec_coalesced_read_ticks"] == 2
    KERNELS.reset()
    stripe.reencode_planes_multi(pc, ps, reqs)
    assert KERNELS.dump()["device_kernels"][
        "ec_coalesced_reencode_ticks"] == 2


@pytest.mark.parametrize("case", [
    (b"", 0, 0, b"abc"),
    (b"hello world", 11, 6, b"WORLD"),
    (b"hello", 5, 8, b"xy"),
    (b"hello world", 11, 2, b"L"),
    (b"abc", 3, 0, b""),
], ids=str)
def test_merge_range_equal_reference(case):
    assert stripe.merge_range(*case) == jstripe.merge_range(*case)


BYTE_POOLS = {
    "lrc_k4m2l3": ({"plugin": "lrc", "k": "4", "m": "2", "l": "3"}, 4, 8),
    "reed_sol_van_w16": ({"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "16"}, 4, 6),
    "reed_sol_van_w32": ({"plugin": "jerasure", "technique": "reed_sol_van",
                          "k": "4", "m": "2", "w": "32"}, 4, 6),
}
BYTE_LOST = [(0,), (5,), (0, 1), (1, 5), (4, 5)]


@pytest.mark.parametrize("lost", BYTE_LOST, ids=str)
@pytest.mark.parametrize("pool", sorted(BYTE_POOLS))
def test_lrc_and_wide_byte_tick_equal_reference(pool, lost):
    prof, k, n = BYTE_POOLS[pool]
    jc, pc = jfactory(dict(prof)), factory(dict(prof), device="cpu")
    unit = 64
    js, ps = jstripe.StripeInfo(k, unit), stripe.StripeInfo(k, unit)
    assert not stripe.planar_at_rest_ok(pc, unit) or pc.w == 8
    rng = np.random.default_rng(33)
    datas = [rng.integers(0, 256, s, dtype=np.uint8).tobytes()
             for s in [0, 10, k * unit, 500, 3 * k * unit + 7]]
    enc = stripe.encode_stripes_multi(pc, ps, datas,
                                      want_crcs=[True] * len(datas))
    jenc = jstripe.encode_stripes_multi(jc, js, datas,
                                        want_crcs=[True] * len(datas))
    for (gs, gc), (ws, wc), d in zip(enc, jenc, datas):
        assert np.array_equal(gs, ws)
        assert np.array_equal(gs, jstripe.encode_stripes(jc, js, d))
        assert gc == wc
    reqs = [({s: sh[s] for s in range(n) if s not in lost}, len(d))
            for (sh, _c), d in zip(enc, datas)]
    got = stripe.decode_stripes_multi(pc, ps, reqs)
    assert got == datas
    assert got == jstripe.decode_stripes_multi(jc, js, reqs)
    rebuilt = stripe.reencode_stripes_multi(pc, ps, reqs)
    for r, w, (sh, _c) in zip(rebuilt,
                              jstripe.reencode_stripes_multi(jc, js, reqs),
                              enc):
        assert np.array_equal(r, w)
        assert np.array_equal(r, sh)

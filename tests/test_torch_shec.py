"""The port's SHEC plugin against the JAX package and the C goldens.

Each scenario of ``tests/test_ec_shec.py`` runs through the port on
``device="cpu"`` and, where it produces bytes or read sets, through the
reference on JAX-CPU beside it.  On top: the coding matrices at every
technique and w, ``minimum_to_decode`` over every pattern of up to m
erasures for k8m4c3 and k4m3c2, ``decode_batch``/``decode_planar`` at
w=8/16/32, and the SHEC rows of ``tests/golden/ec_golden.jsonl``.  Inputs
are seeded numpy; every comparison is exact (tolerance 0, GF arithmetic).
"""

import errno
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import shec as jshec
from ceph_tpu.ec.interface import ECError as JECError
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec import shec
from ceph_tpu_torch.ec.shec import ErasureCodeShec, make_shec, shec_coding_matrix
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "ec_golden.jsonl"


def _pair(k, m, c, w=8, technique="multiple"):
    prof = {"plugin": "shec", "k": str(k), "m": str(m), "c": str(c),
            "w": str(w), "technique": technique}
    return jfactory(dict(prof)), factory(dict(prof), device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _shec(profile):
    return make_shec(dict(profile), device="cpu")


# -- the scenarios of tests/test_ec_shec.py ---------------------------------

def test_profile_defaults():
    codec = _shec({})
    assert (codec.k, codec.m, codec.c) == (4, 3, 2)
    assert codec.get_chunk_count() == 7
    assert codec.get_data_chunk_count() == 4
    jc = jshec.make_shec({})
    assert np.array_equal(codec.engine.coding, jc.engine.coding)


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "3"},
    {"k": "4", "m": "3", "c": "4"},
    {"k": "13", "m": "3", "c": "2"},
    {"k": "12", "m": "9", "c": "2"},
    {"k": "3", "m": "4", "c": "2"},
    {"k": "4", "m": "3", "c": "2", "technique": "bogus"},
])
def test_profile_constraints(profile):
    with pytest.raises(ECError) as pe:
        _shec(profile)
    with pytest.raises(JECError) as je:
        jshec.make_shec(dict(profile))
    assert pe.value.errno == je.value.errno


def test_shingle_matrix_has_zero_pattern():
    mat = shec_coding_matrix(6, 4, 3, technique=0)
    assert mat.shape == (4, 6)
    assert (mat == 0).sum() > 0
    assert (mat != 0).any(axis=0).all()
    assert (mat != 0).any(axis=1).all()
    assert np.array_equal(mat, jshec.shec_coding_matrix(6, 4, 3, technique=0))


def test_single_technique_matrix():
    mat = shec_coding_matrix(6, 4, 3, technique=1)
    assert mat.shape == (4, 6)
    assert (mat != 0).any(axis=0).all()
    assert np.array_equal(mat, jshec.shec_coding_matrix(6, 4, 3, technique=1))


def test_roundtrip_no_erasure():
    codec = _shec({"k": "6", "m": "4", "c": "3"})
    data = bytes(range(256)) * 24
    chunks = codec.encode(range(10), data)
    assert len(chunks) == 10
    assert codec.decode_concat(chunks)[: len(data)] == data


@pytest.mark.parametrize("n_erasures", [1, 2, 3])
def test_exhaustive_erasure_recovery(n_erasures):
    """SHEC(6,4,3) recovers every <= c erasure pattern, with the same
    bytes as the reference."""
    jc, pc = _pair(6, 4, 3)
    data = np.random.default_rng(3).integers(0, 256, 6000,
                                             dtype=np.uint8).tobytes()
    chunks = pc.encode(range(10), data)
    jchunks = jc.encode(range(10), data)
    for i in range(10):
        assert np.array_equal(chunks[i], jchunks[i])
    for erase in itertools.combinations(range(10), n_erasures):
        avail = {i: c for i, c in chunks.items() if i not in erase}
        decoded = pc.decode(set(erase), avail)
        for e in erase:
            assert np.array_equal(decoded[e], chunks[e]), (erase, e)


def test_minimum_to_decode_reads_fewer_than_k():
    jc, pc = _pair(6, 4, 3)
    smaller_than_k = 0
    chunks = pc.encode(range(10), b"m" * 3000)
    for erased in range(6):
        avail = set(range(10)) - {erased}
        minimum = pc.minimum_to_decode({erased}, avail)
        assert minimum == jc.minimum_to_decode({erased}, avail)
        assert erased not in minimum and len(minimum) <= 6
        smaller_than_k += len(minimum) < 6
        decoded = pc.decode({erased}, {i: chunks[i] for i in minimum})
        assert np.array_equal(decoded[erased], chunks[erased])
    assert smaller_than_k > 0


def test_minimum_to_decode_nothing_missing():
    jc, pc = _pair(6, 4, 3)
    got = pc.minimum_to_decode({2, 3}, set(range(10)))
    assert got <= set(range(10))
    assert got == jc.minimum_to_decode({2, 3}, set(range(10)))


def test_unrecoverable_pattern_raises():
    codec = _shec({"k": "4", "m": "3", "c": "2"})
    chunks = codec.encode(range(7), b"u" * 1000)
    avail = {i: c for i, c in chunks.items() if i not in {0, 1, 4, 5, 6}}
    with pytest.raises(ECError) as ei:
        codec.decode({0, 1}, avail)
    assert ei.value.errno == errno.EIO


def test_decode_table_cache_hit():
    codec = _shec({"k": "6", "m": "4", "c": "3"})
    chunks = codec.encode(range(10), b"c" * 3000)
    avail = {i: c for i, c in chunks.items() if i != 2}
    codec.decode({2}, avail)
    before = len(codec._plan_cache)
    assert before >= 1
    codec.decode({2}, avail)
    assert len(codec._plan_cache) == before


def test_batch_decode_matches_single():
    jc, pc = _pair(6, 4, 3)
    batch = np.random.default_rng(11).integers(0, 256, (8, 6, 96),
                                               dtype=np.uint8)
    parity = _np(pc.encode_batch(batch))
    assert np.array_equal(parity, np.asarray(jc.encode_batch(batch)))
    full = np.concatenate([batch, parity], axis=1)
    out = _np(pc.decode_batch((1,), full))
    assert np.array_equal(out[:, 0, :], batch[:, 1, :])
    assert np.array_equal(out, np.asarray(jc.decode_batch((1,), full)))


def test_registry_exposes_shec():
    codec = factory({"plugin": "shec", "k": "6", "m": "4", "c": "3"},
                    device="cpu")
    assert isinstance(codec, ErasureCodeShec)
    assert codec.device.type == "cpu"
    assert codec.engine._enc_bitmat.device.type == "cpu"


def test_batch_decode_parity_erasure():
    jc, pc = _pair(6, 4, 3)
    batch = np.random.default_rng(12).integers(0, 256, (8, 6, 96),
                                               dtype=np.uint8)
    parity = _np(pc.encode_batch(batch))
    full = np.concatenate([batch, parity], axis=1)
    out = _np(pc.decode_batch((7,), full))
    assert np.array_equal(out[:, 0, :], parity[:, 1, :])
    zeroed = full.copy()
    zeroed[:, [0, 3, 7], :] = 0
    out = _np(pc.decode_batch((0, 3, 7), zeroed))
    assert np.array_equal(out, full[:, [0, 3, 7], :])
    assert np.array_equal(out, np.asarray(jc.decode_batch((0, 3, 7),
                                                          zeroed)))


def test_batch_decode_want_subset():
    _jc, pc = _pair(6, 4, 3)
    batch = np.random.default_rng(13).integers(0, 256, (4, 6, 96),
                                               dtype=np.uint8)
    full = np.concatenate([batch, _np(pc.encode_batch(batch))], axis=1)
    zeroed = full.copy()
    zeroed[:, [2, 8], :] = 0
    out = _np(pc.decode_batch((2, 8), zeroed, want=(2,)))
    assert out.shape[1] == 1
    assert np.array_equal(out[:, 0, :], batch[:, 2, :])


@pytest.mark.parametrize("w", [16, 32])
def test_shec_wide_w_roundtrip(w):
    jc, pc = _pair(6, 4, 3, w)
    assert pc.w == w
    rng = np.random.default_rng(5 + w)
    obj = rng.integers(0, 256, pc.get_alignment() * 2,
                       dtype=np.uint8).tobytes()
    chunks = pc.encode(set(range(10)), obj)
    jchunks = jc.encode(set(range(10)), obj)
    for i in range(10):
        assert np.array_equal(chunks[i], jchunks[i])
    avail = {i: c for i, c in chunks.items() if i not in (0, 3, 7)}
    assert pc.decode_concat(avail)[:len(obj)] == obj
    minimum = pc.minimum_to_decode({0}, set(range(10)) - {0})
    assert len(minimum) <= pc.k
    s = pc.get_alignment() // pc.k
    data = rng.integers(0, 256, (4, 6, s), dtype=np.uint8)
    full = np.concatenate([data, _np(pc.encode_batch(data))], axis=1)
    got = _np(pc.decode_batch((1, 5, 8), full))
    assert np.array_equal(got, full[:, [1, 5, 8], :])


# -- beyond the reference's scenarios ---------------------------------------

MATRIX_CASES = [(k, m, c, t, w)
                for (k, m, c) in [(8, 4, 3), (4, 3, 2), (6, 4, 3), (12, 8, 4),
                                  (5, 2, 1)]
                for t in ("multiple", "single") for w in (8, 16, 32)]


@pytest.mark.parametrize("case", MATRIX_CASES,
                         ids=lambda c: "k{}m{}c{}-{}-w{}".format(*c))
def test_coding_matrix_and_bitmatrix_equal_reference(case):
    k, m, c, technique, w = case
    jc, pc = _pair(k, m, c, w, technique)
    assert pc.engine.coding.dtype == jc.engine.coding.dtype
    assert np.array_equal(pc.engine.coding, jc.engine.coding)
    assert np.array_equal(pc.engine._enc_bitmat.numpy(),
                          np.asarray(jc.engine._enc_bitmat))
    assert pc.get_alignment() == jc.get_alignment()
    for size in (1, 1000, 65536 + 3):
        assert pc.get_chunk_size(size) == jc.get_chunk_size(size)


def _min_or_errno(codec, want, avail):
    try:
        return codec.minimum_to_decode(want, avail)
    except (ECError, JECError) as e:
        return e.errno


@pytest.mark.parametrize("kmc", [(8, 4, 3), (4, 3, 2)],
                         ids=lambda p: "k{}m{}c{}".format(*p))
def test_minimum_to_decode_every_pattern_equals_reference(kmc):
    k, m, _c = kmc
    jc, pc = _pair(*kmc)
    n = k + m
    for r in range(1, m + 1):
        for erased in itertools.combinations(range(n), r):
            avail = set(range(n)) - set(erased)
            for want in ({erased[0]}, set(erased), {0, erased[-1]}):
                assert _min_or_errno(pc, want, avail) == \
                    _min_or_errno(jc, want, avail), (erased, want)


DECODE_PATTERNS = [(4,), (0, 1), (3, 9), (0, 5, 11), (8,), (2, 10)]


@pytest.mark.parametrize("w", [8, 16, 32])
def test_decode_batch_and_planar_equal_reference(w):
    """k8m4c3 at every w: the byte-layout batch decode and the planar
    decode (the plan's S sources may differ from k) against the
    reference, planes and bytes."""
    jc, pc = _pair(8, 4, 3, w)
    rng = np.random.default_rng(40 + w)
    data = rng.integers(0, 256, (3, 8, 4 * w), dtype=np.uint8)
    parity = _np(pc.encode_batch(data))
    full = np.concatenate([data, parity], axis=1)
    ppb, jpb = pc.to_planar(full), jc.to_planar(full)
    assert np.array_equal(ppb.planes.numpy(), np.asarray(jpb.planes))
    penc = pc.encode_planar(pc.to_planar(data))
    assert np.array_equal(_np(penc.to_batch()), parity)
    for erasures in DECODE_PATTERNS:
        want = tuple(e for e in erasures if e < 8) or erasures
        chunks = full.copy()
        chunks[:, list(erasures), :] = 0
        got = _np(pc.decode_batch(erasures, chunks, want=want))
        assert np.array_equal(
            got, np.asarray(jc.decode_batch(erasures, chunks, want=want)))
        assert np.array_equal(got, full[:, list(want), :])
        bitmat, src = pc._planar_decode_plan(erasures, want)
        jbitmat, jsrc = jc._planar_decode_plan(erasures, want)
        assert src == jsrc
        assert np.array_equal(bitmat.numpy(), np.asarray(jbitmat))
        assert tuple(bitmat.shape) == (len(want) * w, len(src) * w)
        pdec = pc.decode_planar(erasures, ppb, want=want)
        assert np.array_equal(
            pdec.planes.numpy(),
            np.asarray(jc.decode_planar(erasures, jpb, want=want).planes))
        assert np.array_equal(_np(pdec.to_batch()), full[:, list(want), :])


def test_some_decode_plans_read_other_than_k_sources():
    """The non-MDS plans: at least one pattern's source list is not k long,
    so the decode bit-matrix of B1 is not (r*8, k*8)."""
    _jc, pc = _pair(8, 4, 3)
    lengths = {len(pc._batch_plan(e, tuple(x for x in e if x < 8) or e)[1])
               for e in DECODE_PATTERNS}
    assert lengths - {8}


def _golden():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f if line.strip()]
    return [c for c in cases if c["plugin"] == "shec"]


def _lcg_bytes(seed: int, n: int) -> bytes:
    x = seed & 0x7FFFFFFF
    out = bytearray(n)
    for i in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out[i] = (x >> 16) & 0xFF
    return bytes(out)


def _fnv1a64(data: bytes) -> str:
    h = 1469598103934665603
    for b in data:
        h ^= b
        h = (h * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


@pytest.mark.parametrize(
    "case", _golden(),
    ids=lambda c: f"{c['technique']}-k{c['k']}m{c['m']}c{c['c']}-w{c['w']}")
def test_shec_golden_rows_through_port(case):
    """The independent C oracle's SHEC rows, replayed through the port as
    tests/test_ec_golden.py replays them through ceph_tpu."""
    codec = factory({"plugin": "shec", "technique": case["technique"],
                     "k": str(case["k"]), "m": str(case["m"]),
                     "c": str(case["c"]), "w": str(case["w"])}, device="cpu")
    mat = np.asarray(case["matrix"], dtype=np.uint64).reshape(
        case["m"], case["k"])
    assert np.array_equal(codec.engine.coding.astype(np.uint64), mat)
    assert codec.get_chunk_size(case["object_size"]) == case["chunk_size"]
    data = _lcg_bytes(case["seed"], case["object_size"])
    n = codec.get_chunk_count()
    chunks = codec.encode(range(n), data)
    for i in range(n):
        blob = chunks[i].tobytes()
        assert len(blob) == case["chunk_size"]
        assert blob[:16].hex() == case["chunks"][i]["head"]
        assert _fnv1a64(blob) == case["chunks"][i]["fnv1a64"]


def test_golden_has_five_shec_rows():
    assert len(_golden()) == 5
    assert {c["w"] for c in _golden()} == {8, 16, 32}


def test_decode_chunks_device_matmul_for_long_chunks():
    """Chunks of 4096 bytes or more take the device matmul in the
    reference's decode_chunks; the bytes equal the host path's."""
    jc, pc = _pair(4, 3, 2)
    data = np.random.default_rng(9).integers(0, 256, 4 * 4096,
                                             dtype=np.uint8).tobytes()
    chunks = pc.encode(range(7), data)
    assert len(chunks[0]) == 4096
    for erased in [(1,), (0, 5)]:
        avail = {i: c for i, c in chunks.items() if i not in erased}
        dec = pc.decode(set(erased), avail)
        jdec = jc.decode(set(erased), avail)
        for e in erased:
            assert np.array_equal(dec[e], chunks[e])
            assert np.array_equal(dec[e], jdec[e])

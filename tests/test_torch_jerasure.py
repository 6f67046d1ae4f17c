"""The port's jerasure plugin against the JAX package and the C goldens.

Every technique is built by both packages from the same profile; the
port runs on ``device="cpu"`` (the plain versions of its kernels), the
reference on JAX-CPU.  Inputs are seeded numpy; every comparison is exact
(tolerance 0, GF arithmetic):

- coding matrices and bit-matrices for every technique at every w it
  allows (7 and 6 for the liberation family, 8, 16, 32);
- ``encode``/``decode_concat``, ``encode_batch``/``decode_batch`` and the
  packet-planar ``encode_planar``/``decode_planar`` of every technique;
- the table kernel B2 reads for each packet technique's encode and decode
  matrices (block words and classes, packed on the host and cached);
- the jerasure rows of ``tests/golden/ec_golden.jsonl`` replayed through
  the port, ``reed_sol_*`` at w=16/32 among them;
- ``reed_sol_*`` at w=16/32 through the byte and bitpack-planar layouts.
"""

import errno
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import matrices as jmatrices
from ceph_tpu.ec.interface import ECError as JECError
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec import jerasure, matrices
from ceph_tpu_torch.ops import gf8_bytes_cuda, gf8_cuda
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "ec_golden.jsonl"

# (technique, k, m, w, packetsize): every technique at every w it allows
PROFILES = [
    ("reed_sol_van", 4, 2, 8, 0),
    ("reed_sol_van", 3, 2, 8, 0),
    ("reed_sol_r6_op", 4, 2, 8, 0),
    ("cauchy_orig", 3, 2, 8, 8),
    ("cauchy_good", 4, 2, 8, 8),
    ("cauchy_good", 5, 3, 8, 8),
    ("cauchy_orig", 4, 2, 16, 4),
    ("cauchy_good", 4, 2, 16, 4),
    ("cauchy_good", 3, 2, 32, 4),
    ("liberation", 4, 2, 7, 4),
    ("liberation", 3, 2, 5, 8),
    ("blaum_roth", 4, 2, 6, 4),
    ("blaum_roth", 3, 2, 4, 8),
    ("liber8tion", 5, 2, 8, 4),
]
WIDE_MATRIX_PROFILES = [
    ("reed_sol_van", 4, 2, 16, 0),
    ("reed_sol_van", 4, 2, 32, 0),
    ("reed_sol_r6_op", 4, 2, 16, 0),
    ("reed_sol_r6_op", 5, 2, 32, 0),
]


def _ids(p):
    return f"{p[0]}-k{p[1]}m{p[2]}-w{p[3]}" + (f"-ps{p[4]}" if p[4] else "")


def _profile(technique, k, m, w, ps):
    prof = {"plugin": "jerasure", "technique": technique, "k": str(k),
            "m": str(m), "w": str(w)}
    if ps:
        prof["packetsize"] = str(ps)
    return prof


def _pair(*p):
    prof = _profile(*p)
    return jfactory(dict(prof)), factory(dict(prof), device="cpu")


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _patterns(n):
    return [(e,) for e in range(n)] + list(itertools.combinations(range(n), 2))


def _chunk_len(codec):
    """A batch chunk length the technique's layout accepts."""
    if getattr(codec, "packetsize", 0):
        return 2 * codec.w * codec.packetsize
    return 8 * codec.w


@pytest.mark.parametrize("prof", PROFILES + WIDE_MATRIX_PROFILES, ids=_ids)
def test_coding_matrices_equal_reference(prof):
    jc, pc = _pair(*prof)
    assert pc.technique == jc.technique
    assert (pc.k, pc.m, pc.w) == (jc.k, jc.m, jc.w)
    assert pc.get_alignment() == jc.get_alignment()
    for size in (1, 1000, 4096, 65536 + 3):
        assert pc.get_chunk_size(size) == jc.get_chunk_size(size)
    if getattr(jc, "bit_engine", None) is not None:
        assert np.array_equal(pc.bit_engine.coding_bits,
                              jc.bit_engine.coding_bits)
        assert np.array_equal(pc.bit_engine.generator_bits,
                              jc.bit_engine.generator_bits)
        return
    assert pc.engine.coding.dtype == jc.engine.coding.dtype
    assert np.array_equal(pc.engine.coding, jc.engine.coding)
    assert np.array_equal(pc.engine.generator, jc.engine.generator)
    assert np.array_equal(pc.engine._enc_bitmat.numpy(),
                          np.asarray(jc.engine._enc_bitmat))
    if getattr(jc, "packetsize", None):
        assert np.array_equal(pc._encode_bits(), jc._encode_bits())


@pytest.mark.parametrize("k,m", [(2, 1), (4, 2), (6, 3), (8, 4), (10, 4)])
@pytest.mark.parametrize("w", [8, 16, 32])
def test_matrix_builders_equal_reference(k, m, w):
    assert np.array_equal(
        matrices.reed_sol_vandermonde_coding_matrix_w(k, m, w),
        jmatrices.reed_sol_vandermonde_coding_matrix_w(k, m, w))
    assert np.array_equal(matrices.reed_sol_r6_coding_matrix_w(k, w),
                          jmatrices.reed_sol_r6_coding_matrix_w(k, w))
    assert np.array_equal(matrices.cauchy_original_coding_matrix_w(k, m, w),
                          jmatrices.cauchy_original_coding_matrix_w(k, m, w))
    assert np.array_equal(matrices.cauchy_good_coding_matrix_w(k, m, w),
                          jmatrices.cauchy_good_coding_matrix_w(k, m, w))
    if w == 8:
        assert np.array_equal(
            matrices.reed_sol_vandermonde_coding_matrix(k, m),
            jmatrices.reed_sol_vandermonde_coding_matrix(k, m))
        assert np.array_equal(matrices.reed_sol_r6_coding_matrix(k),
                              jmatrices.reed_sol_r6_coding_matrix(k))
        assert np.array_equal(matrices.cauchy_original_coding_matrix(k, m),
                              jmatrices.cauchy_original_coding_matrix(k, m))
        assert np.array_equal(matrices.cauchy_good_coding_matrix(k, m),
                              jmatrices.cauchy_good_coding_matrix(k, m))


@pytest.mark.parametrize("prof", PROFILES, ids=_ids)
def test_encode_decode_concat_equal_reference(prof):
    jc, pc = _pair(*prof)
    n = pc.get_chunk_count()
    raw = np.random.default_rng(n * 7 + pc.w).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    pchunks = pc.encode(range(n), raw)
    jchunks = jc.encode(range(n), raw)
    for i in range(n):
        assert np.array_equal(pchunks[i], jchunks[i]), i
    for erasures in _patterns(n):
        avail = {i: c for i, c in pchunks.items() if i not in erasures}
        if prof[0] == "blaum_roth" and len(erasures) == 2 \
                and max(erasures) < pc.k and prof[3] == 7:
            continue                  # w=7 blaum_roth is not MDS
        out = pc.decode_concat(avail)
        assert out == jc.decode_concat(
            {i: c for i, c in jchunks.items() if i not in erasures})
        assert out[:len(raw)] == raw
        dec = pc.decode(set(erasures), avail)
        for e in erasures:
            assert np.array_equal(dec[e], pchunks[e]), (erasures, e)


@pytest.mark.parametrize("prof", PROFILES, ids=_ids)
def test_batch_and_planar_paths_equal_reference(prof):
    jc, pc = _pair(*prof)
    k, n = pc.k, pc.get_chunk_count()
    s = _chunk_len(pc)
    rng = np.random.default_rng(k * 10 + pc.w)
    data = rng.integers(0, 256, (3, k, s), dtype=np.uint8)
    parity = _np(pc.encode_batch(data))
    assert np.array_equal(parity, np.asarray(jc.encode_batch(data)))
    full = np.concatenate([data, parity], axis=1)
    packet = bool(getattr(pc, "packetsize", 0))
    if packet:
        b1, b2 = gf8_cuda.launches, gf8_bytes_cuda.launches
        ppb = pc.to_planar(data)
        jpb = jc.to_planar(data)
        assert ppb.layout == jpb.layout == "packet"
        assert np.array_equal(ppb.planes.numpy(), np.asarray(jpb.planes))
        ppar = pc.encode_planar(ppb)
        assert np.array_equal(ppar.planes.numpy(),
                              np.asarray(jc.encode_planar(jpb).planes))
        assert np.array_equal(_np(ppar.to_batch()), parity)
        full_pb, jfull_pb = pc.to_planar(full), jc.to_planar(full)
        # CPU tensors never reach either CUDA kernel
        assert (b1, b2) == (gf8_cuda.launches, gf8_bytes_cuda.launches)
    # one data, one parity and one mixed pair (each pattern is a JAX compile)
    for erasures in [(1,), (k,), (0, k + 1)]:
        want = tuple(e for e in erasures if e < k) or erasures
        chunks = full.copy()
        chunks[:, list(erasures), :] = 0
        got = _np(pc.decode_batch(erasures, chunks, want=want))
        assert np.array_equal(
            got, np.asarray(jc.decode_batch(erasures, chunks, want=want)))
        assert np.array_equal(got, full[:, list(want), :])
        if packet:
            pdec = pc.decode_planar(erasures, full_pb, want=want)
            assert np.array_equal(
                pdec.planes.numpy(),
                np.asarray(jc.decode_planar(erasures, jfull_pb,
                                            want=want).planes))
            assert np.array_equal(_np(pdec.to_batch()),
                                  full[:, list(want), :])


@pytest.mark.parametrize("prof", [p for p in PROFILES if p[4]], ids=_ids)
def test_packet_codec_passes_b2_its_cached_lane_table(prof):
    """encode_planar/decode_planar hand kernel B2 the host-packed table of
    their lane matrix: zero and identity blocks only, the identity mask
    being the 0/1 matrix itself, one cached object per matrix."""
    _jc, pc = _pair(*prof)
    src = tuple(range(1, pc.k + 1))
    for m01 in (pc._encode_bits(), pc._decode_bits(src, (0,))):
        lane, blocks = pc._lane_and_blocks(m01)
        assert lane is pc._lane(m01)
        assert blocks is pc._lane_and_blocks(m01)[1]
        table = blocks.numpy().view(np.uint64)
        assert np.array_equal(table,
                              gf8_bytes_cuda.pack_blocks(lane.numpy())
                              .view(np.uint64))
        r, c = m01.shape
        words = table[:r * c].reshape(r, c)
        assert np.array_equal(words != 0, m01.astype(bool))
        assert set(np.unique(words).tolist()) <= {0, 0x8040201008040201}
        classes = table[r * c:].reshape(-1, c)
        ident = np.zeros_like(classes)
        for j in range(r):
            ident[j // 32] |= m01[j].astype(np.uint64) << np.uint64(j % 32)
        assert np.array_equal(classes, ident)


def _golden():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f if line.strip()]
    return [c for c in cases if c["plugin"] == "jerasure"]


def _wide_reed_sol(case):
    return case["technique"].startswith("reed_sol") and case["w"] != 8


def _golden_id(c):
    return (f"{c['technique']}-k{c['k']}m{c['m']}-w{c['w']}"
            + (f"-ps{c['packetsize']}" if c["packetsize"] else ""))


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


def _golden_codec(case):
    profile = {"plugin": "jerasure", "technique": case["technique"],
               "k": str(case["k"]), "m": str(case["m"]), "w": str(case["w"])}
    if case["packetsize"]:
        profile["packetsize"] = str(case["packetsize"])
    codec = factory(profile, device="cpu")
    w = case["w"]
    if "bitmatrix" in case:
        bm = np.asarray(case["bitmatrix"], dtype=np.uint8).reshape(
            case["m"] * w, case["k"] * w)
        assert np.array_equal(codec.bit_engine.coding_bits, bm)
    else:
        mat = np.asarray(case["matrix"], dtype=np.uint64).reshape(
            case["m"], case["k"])
        assert np.array_equal(codec.engine.coding.astype(np.uint64), mat)
    assert codec.get_chunk_size(case["object_size"]) == case["chunk_size"]
    return codec


@pytest.mark.parametrize(
    "case", [c for c in _golden() if not _wide_reed_sol(c)], ids=_golden_id)
def test_jerasure_golden_rows_through_port(case):
    """The independent C oracle's jerasure rows, replayed through the port
    exactly as tests/test_ec_golden.py replays them through ceph_tpu."""
    codec = _golden_codec(case)
    data = _lcg_bytes(case["seed"], case["object_size"])
    n = codec.get_chunk_count()
    chunks = codec.encode(range(n), data)
    for i in range(n):
        blob = chunks[i].tobytes()
        assert len(blob) == case["chunk_size"]
        assert blob[:16].hex() == case["chunks"][i]["head"]
        assert _fnv1a64(blob) == case["chunks"][i]["fnv1a64"]


@pytest.mark.parametrize(
    "case", [c for c in _golden() if _wide_reed_sol(c)], ids=_golden_id)
def test_wide_reed_sol_golden_rows_through_port(case):
    """reed_sol_* at w=16/32 encode through the word-layout device half
    of gfw: every chunk equals the C oracle's and the reference's, and a
    decode with two chunks lost gives the object back."""
    codec = _golden_codec(case)
    data = _lcg_bytes(case["seed"], case["object_size"])
    n = codec.get_chunk_count()
    chunks = codec.encode(range(n), data)
    ref = jfactory(dict(codec.get_profile())).encode(range(n), data)
    for i in range(n):
        blob = chunks[i].tobytes()
        assert len(blob) == case["chunk_size"]
        assert blob[:16].hex() == case["chunks"][i]["head"]
        assert _fnv1a64(blob) == case["chunks"][i]["fnv1a64"]
        assert np.array_equal(chunks[i], ref[i])
    avail = {i: c for i, c in chunks.items() if i not in (0, n - 1)}
    assert codec.decode_concat(avail)[:len(data)] == data


@pytest.mark.parametrize("prof", WIDE_MATRIX_PROFILES, ids=_ids)
def test_wide_reed_sol_batch_and_planar_equal_reference(prof):
    """reed_sol_* at w=16/32: byte-layout batch encode/decode and the
    bitpack planes (B1's (m*w, k*w) bit-matrices) against the reference."""
    jc, pc = _pair(*prof)
    k, n, w = pc.k, pc.get_chunk_count(), pc.w
    data = np.random.default_rng(k * 10 + w).integers(
        0, 256, (3, k, 2 * w), dtype=np.uint8)
    parity = _np(pc.encode_batch(data))
    assert np.array_equal(parity, np.asarray(jc.encode_batch(data)))
    ppb, jpb = pc.to_planar(data), jc.to_planar(data)
    assert ppb.layout == jpb.layout == "bitpack"
    assert tuple(ppb.planes.shape) == (k * w, 3 * 2)
    assert np.array_equal(ppb.planes.numpy(), np.asarray(jpb.planes))
    ppar = pc.encode_planar(ppb)
    assert np.array_equal(ppar.planes.numpy(),
                          np.asarray(jc.encode_planar(jpb).planes))
    assert np.array_equal(_np(ppar.to_batch()), parity)
    full = np.concatenate([data, parity], axis=1)
    full_pb, jfull_pb = pc.to_planar(full), jc.to_planar(full)
    for erasures in [(1,), (k,), (0, k + 1), (0, 1)]:
        chunks = full.copy()
        chunks[:, list(erasures), :] = 0
        got = _np(pc.decode_batch(erasures, chunks))
        assert np.array_equal(got, np.asarray(jc.decode_batch(erasures,
                                                              chunks)))
        assert np.array_equal(got, full[:, list(erasures), :])
        pdec = pc.decode_planar(erasures, full_pb)
        assert np.array_equal(
            pdec.planes.numpy(),
            np.asarray(jc.decode_planar(erasures, jfull_pb).planes))
        assert np.array_equal(_np(pdec.to_batch()), full[:, list(erasures), :])


def test_golden_rows_cover_every_technique():
    cases = _golden()
    assert {c["technique"] for c in cases} == set(jerasure.TECHNIQUES)
    assert sum(not _wide_reed_sol(c) for c in cases) == 13
    assert sum(_wide_reed_sol(c) for c in cases) == 3


def test_default_profile_is_jerasure_reed_sol_van_k2m1():
    """Ceph's default pool profile, the one the cluster falls back to."""
    codec = factory({}, device="cpu")
    assert isinstance(codec, jerasure.ReedSolomonVandermonde)
    assert (codec.k, codec.m, codec.w) == (2, 1, 8)
    jc = jfactory({})
    raw = bytes(range(256)) * 9
    pch = codec.encode(range(3), raw)
    jch = jc.encode(range(3), raw)
    for i in range(3):
        assert np.array_equal(pch[i], jch[i])
    assert codec.decode_concat({1: pch[1], 2: pch[2]})[:len(raw)] == raw


@pytest.mark.parametrize("profile,code", [
    ({"technique": "nope"}, errno.ENOENT),
    ({"technique": "reed_sol_van", "w": "12"}, errno.EINVAL),
    ({"technique": "cauchy_good", "w": "7"}, errno.EINVAL),
    ({"technique": "cauchy_good", "packetsize": "6"}, errno.EINVAL),
    ({"technique": "reed_sol_van", "k": "1"}, errno.EINVAL),
    ({"technique": "reed_sol_van", "k": "2", "m": "1", "mapping": "DD"},
     errno.EINVAL),
])
def test_bad_profiles_raise_like_reference(profile, code):
    prof = {"plugin": "jerasure", **profile}
    with pytest.raises(ECError) as ei:
        factory(dict(prof), device="cpu")
    assert ei.value.errno == code
    with pytest.raises(JECError) as ji:
        jfactory(dict(prof))
    assert ji.value.errno == code


def test_mapping_and_minimum_to_decode_like_reference():
    prof = {"plugin": "jerasure", "technique": "reed_sol_van", "k": "2",
            "m": "1", "mapping": "_DD"}
    pc, jc = factory(dict(prof), device="cpu"), jfactory(dict(prof))
    assert pc.get_chunk_mapping() == jc.get_chunk_mapping() == [1, 2, 0]
    prof = {"plugin": "jerasure", "technique": "cauchy_good", "k": "4",
            "m": "2"}
    pc, jc = factory(dict(prof), device="cpu"), jfactory(dict(prof))
    for want, avail in [({0, 1}, {0, 1, 2}), ({0}, {1, 2, 3, 4, 5})]:
        assert pc.minimum_to_decode(want, avail) == \
            jc.minimum_to_decode(want, avail)
    assert pc.stripe_unit(4096) == jc.stripe_unit(4096) == 16384


def test_cauchy_rejects_chunks_off_the_packet_quantum():
    pc = factory({"plugin": "jerasure", "technique": "cauchy_good",
                  "k": "4", "m": "2", "packetsize": "8"}, device="cpu")
    with pytest.raises(ECError) as ei:
        pc.encode_batch(np.zeros((1, 4, 60), dtype=np.uint8))
    assert ei.value.errno == errno.EINVAL
    assert not pc.planar_supported(60)
    assert pc.planar_supported(128)

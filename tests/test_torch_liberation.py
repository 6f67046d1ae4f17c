"""The port's liberation family (liberation / blaum_roth / liber8tion).

Mirrors tests/test_ec_liberation.py as parametrised cases run through
``ceph_tpu_torch`` on ``device="cpu"``: exhaustive 2-erasure MDS sweeps,
matrix structure, geometry rules and batch-vs-single consistency of the
packet layout.  Every bit-matrix and every chunk is also held against the
JAX package (tolerance 0).
"""

import itertools

import numpy as np
import pytest

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import liberation as jlib
from ceph_tpu.ec.interface import ECError as JECError
from ceph_tpu.ops import gfw as jgfw
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec import liberation as lib
from ceph_tpu_torch.ops import gfw
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

MDS_CASES = (
    [("liberation", k, w) for k, w in [(2, 3), (4, 7), (7, 7), (5, 11)]]
    + [("blaum_roth", k, w) for k, w in [(2, 4), (4, 4), (5, 6), (7, 10)]]
    + [("liber8tion", k, 8) for k in [2, 5, 8]])


def _profile(technique, k, w):
    prof = {"plugin": "jerasure", "technique": technique, "k": str(k),
            "packetsize": "4"}
    if technique != "liber8tion":
        prof["w"] = str(w)
    return prof


def _ids(case):
    return f"{case[0]}-k{case[1]}w{case[2]}"


@pytest.mark.parametrize("case", MDS_CASES, ids=_ids)
def test_mds_two_erasure_sweep_equals_reference(case):
    """Every pair of lost chunks is rebuilt bit-exactly, and the chunks
    equal the JAX package's."""
    prof = _profile(*case)
    codec = factory(dict(prof), device="cpu")
    assert codec.m == 2 and codec.w == case[2]
    n = codec.get_chunk_count()
    data = bytes(range(256)) * 40
    chunks = codec.encode(range(n), data)
    jchunks = jfactory(dict(prof)).encode(range(n), data)
    for i in range(n):
        assert np.array_equal(chunks[i], jchunks[i]), i
    for er in itertools.combinations(range(n), 2):
        avail = {i: v for i, v in chunks.items() if i not in er}
        dec = codec.decode(set(er), avail)
        for e in er:
            assert np.array_equal(dec[e], chunks[e]), er


@pytest.mark.parametrize("k,w", [(2, 3), (4, 7), (7, 7), (5, 11), (3, 5)])
def test_liberation_bitmatrix_equals_reference(k, w):
    bm = lib.liberation_coding_bitmatrix(k, w)
    assert np.array_equal(bm, jlib.liberation_coding_bitmatrix(k, w))
    assert bm.shape == (2 * w, k * w)
    assert np.array_equal(bm[:w], np.tile(np.eye(w, dtype=np.uint8), (1, k)))
    # minimal density: block (1, 0) has w ones, blocks (1, j>0) have w+1
    for j in range(k):
        ones = int(bm[w:, j * w:(j + 1) * w].sum())
        assert ones == (w if j == 0 else w + 1), j


@pytest.mark.parametrize("k,w", [(2, 4), (3, 4), (5, 6), (7, 10), (4, 7)])
def test_blaum_roth_bitmatrix_equals_reference(k, w):
    bm = lib.blaum_roth_coding_bitmatrix(k, w)
    assert np.array_equal(bm, jlib.blaum_roth_coding_bitmatrix(k, w))
    if k >= 3:
        b1 = bm[w:, w:2 * w]          # multiply-by-x
        b2 = bm[w:, 2 * w:3 * w]      # multiply-by-x^2
        assert np.array_equal((b1.astype(int) @ b1.astype(int)) % 2, b2)


@pytest.mark.parametrize("k", [2, 5, 8])
def test_liber8tion_bitmatrix_equals_reference(k):
    assert np.array_equal(lib.liber8tion_coding_bitmatrix(k),
                          jlib.liber8tion_coding_bitmatrix(k))


@pytest.mark.parametrize("bm,w,k", [
    (lib.liberation_coding_bitmatrix(5, 7), 7, 5),
    (lib.blaum_roth_coding_bitmatrix(5, 6), 6, 5),
    (lib.liber8tion_coding_bitmatrix(6), 8, 6),
], ids=["liberation", "blaum_roth", "liber8tion"])
def test_blocks_invertible_and_inverses_equal_reference(bm, w, k):
    """The RAID-6 MDS conditions on the X blocks directly."""
    blocks = [bm[w:, j * w:(j + 1) * w] for j in range(k)]
    for x in blocks:
        assert np.array_equal(gfw.gf2_invert_matrix(x),
                              jgfw.gf2_invert_matrix(x))
    for a, b in itertools.combinations(blocks, 2):
        gfw.gf2_invert_matrix(a ^ b)   # raises if singular


@pytest.mark.parametrize("profile", [
    {"technique": "liberation", "k": "4", "w": "8"},      # w not prime
    {"technique": "liberation", "k": "8", "w": "7"},      # k > w
    {"technique": "liberation", "k": "4", "w": "7", "packetsize": "3"},
    {"technique": "blaum_roth", "k": "4", "w": "5"},      # w+1 not prime
    {"technique": "liber8tion", "k": "9"},                # k > 8
], ids=["w-not-prime", "k-above-w", "packetsize", "br-w", "l8-k"])
def test_rejects_bad_profiles(profile):
    prof = {"plugin": "jerasure", "packetsize": "4", **profile}
    with pytest.raises(ECError):
        factory(dict(prof), device="cpu")
    with pytest.raises(JECError):
        jfactory(dict(prof))


@pytest.mark.parametrize("technique,w", [("liberation", 7),
                                         ("blaum_roth", 6),
                                         ("liber8tion", 8)])
def test_chunk_geometry_equals_reference(technique, w):
    prof = _profile(technique, 4, w)
    codec, jc = factory(dict(prof), device="cpu"), jfactory(dict(prof))
    # alignment = k*w*packetsize*sizeof(int) (reference get_alignment)
    assert codec.get_alignment() == jc.get_alignment() == 4 * w * 4 * 4
    for size in (1, 500, 4 * w * 4 * 4 + 1):
        cs = codec.get_chunk_size(size)
        assert cs == jc.get_chunk_size(size) and cs % (w * 4) == 0
    assert codec.stripe_unit(4096) == jc.stripe_unit(4096)


@pytest.mark.parametrize("technique,w", [("liberation", 7),
                                         ("blaum_roth", 6),
                                         ("liber8tion", 8)])
def test_batch_matches_single(technique, w):
    codec = factory(_profile(technique, 4, w), device="cpu")
    n, k = codec.get_chunk_count(), 4
    s = w * 4 * 2
    rng = np.random.default_rng(31)
    batch = rng.integers(0, 256, (3, k, s), dtype=np.uint8)
    parity = codec.encode_batch(batch).numpy()
    for b in range(3):
        ch = {i: batch[b, i].copy() for i in range(k)}
        for i in range(k, n):
            ch[i] = np.zeros(s, dtype=np.uint8)
        codec.encode_chunks(ch)
        for i in range(n - k):
            assert np.array_equal(parity[b, i], ch[k + i])
    full = np.concatenate([batch, parity], axis=1)
    out = codec.decode_batch((0, k), full).numpy()
    assert np.array_equal(out[:, 0], batch[:, 0])
    assert np.array_equal(out[:, 1], parity[:, 0])


def test_select_chunk_rows_takes_w7_blocks():
    from ceph_tpu_torch.ec.planar import _select_chunk_rows

    codec = factory(_profile("liberation", 4, 7), device="cpu")
    data = np.random.default_rng(5).integers(0, 256, (2, 6, 56),
                                             dtype=np.uint8)
    pb = codec.to_planar(data)
    assert tuple(pb.planes.shape) == (6 * 7, 2 * 2 * 4)
    sel = _select_chunk_rows(pb.planes, 7, (4, 1))
    assert np.array_equal(sel[:7].numpy(), pb.planes[28:35].numpy())
    assert np.array_equal(sel[7:].numpy(), pb.planes[7:14].numpy())
    assert np.array_equal(pb.select((4, 1)).to_batch().numpy(),
                          data[:, [4, 1], :])


def test_blaum_roth_w7_encodes_but_is_not_mds():
    """w=7 (w+1 = 8, not prime) is tolerated for backward compatibility
    (reference ErasureCodeJerasure.cc:446-459), but double data-erasure
    recovery fails: the survivor bit-matrix is singular."""
    codec = factory(_profile("blaum_roth", 4, 7), device="cpu")
    data = bytes(range(256)) * 40
    n = codec.get_chunk_count()
    chunks = codec.encode(range(n), data)
    avail = {i: v for i, v in chunks.items() if i not in (0, 1)}
    with pytest.raises(ValueError, match="singular"):
        codec.decode({0, 1}, avail)
    avail = {i: v for i, v in chunks.items() if i != 2}
    dec = codec.decode({2}, avail)
    assert np.array_equal(dec[2], chunks[2])

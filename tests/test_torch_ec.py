"""The port's ISA codec against the JAX package, bit for bit.

Every profile the slice serves (ISA k8m4, k4m2, k3m2; reed_sol_van and
cauchy) is built by both packages; the port runs on ``device="cpu"``
(plain versions of its kernels), the reference on JAX-CPU.  Inputs are
seeded numpy; every comparison is exact (tolerance 0, GF arithmetic).
"""

import errno
import itertools
import json
import pathlib

import numpy as np
import pytest
import torch

from ceph_tpu.ec import factory as jfactory
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec.codec import engine_from_reference
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

GOLDEN = pathlib.Path(__file__).parent / "golden" / "ec_golden.jsonl"

GEOMETRIES = [(8, 4), (4, 2), (3, 2)]
TECHNIQUES = ["reed_sol_van", "cauchy"]
PROFILES = [(k, m, t) for (k, m) in GEOMETRIES for t in TECHNIQUES]


def _ids(p):
    return f"k{p[0]}m{p[1]}-{p[2]}"


def _profile(k, m, technique):
    return {"plugin": "isa", "k": str(k), "m": str(m),
            "technique": technique}


def _pair(k, m, technique):
    prof = _profile(k, m, technique)
    return jfactory(dict(prof)), factory(dict(prof), device="cpu")


def _patterns(k, m):
    """Every 1- and 2-erasure pattern for the small codes, a fixed sample
    of them for k8m4."""
    n = k + m
    pats = [(e,) for e in range(n)] + list(itertools.combinations(range(n), 2))
    if n > 8:
        pats = pats[::7] + [(0, 11), (7, 8)]
    return pats


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("prof", PROFILES, ids=_ids)
def test_engine_state_equal_and_engine_from_reference(prof):
    jc, pc = _pair(*prof)
    assert np.array_equal(pc.engine.coding, jc.engine.coding)
    ref_bitmat = np.asarray(jc.engine._enc_bitmat)
    assert np.array_equal(pc.engine._enc_bitmat.numpy(), ref_bitmat)
    k, m, _t = prof
    eng = engine_from_reference(jc.engine.coding, k, m, w=8,
                                enc_bitmat=ref_bitmat, device="cpu")
    assert np.array_equal(eng.coding, jc.engine.coding)
    assert np.array_equal(eng.generator, jc.engine.generator)
    tampered = ref_bitmat.copy()
    tampered[0, 0] ^= 1
    with pytest.raises(AssertionError):
        engine_from_reference(jc.engine.coding, k, m, enc_bitmat=tampered,
                              device="cpu")


@pytest.mark.parametrize("prof", PROFILES, ids=_ids)
def test_batch_and_planar_paths_equal_reference(prof):
    k, m, _t = prof
    jc, pc = _pair(*prof)
    rng = np.random.default_rng(k * 10 + m)
    data = rng.integers(0, 256, (3, k, 64), dtype=np.uint8)
    parity = _np(pc.encode_batch(data))
    assert np.array_equal(parity, np.asarray(jc.encode_batch(data)))
    jpb = jc.to_planar(data)
    ppb = pc.to_planar(data)
    assert np.array_equal(ppb.planes.numpy(), np.asarray(jpb.planes))
    ppar = pc.encode_planar(ppb)
    assert np.array_equal(ppar.planes.numpy(),
                          np.asarray(jc.encode_planar(jpb).planes))
    assert np.array_equal(_np(ppar.to_batch()), parity)
    full = np.concatenate([data, parity], axis=1)
    full_pb = pc.to_planar(full)
    jfull_pb = jc.to_planar(full)
    for erasures in _patterns(k, m):
        want = tuple(e for e in erasures if e < k) or erasures
        chunks = full.copy()
        chunks[:, list(erasures), :] = 0
        got = _np(pc.decode_batch(erasures, chunks, want=want))
        assert np.array_equal(
            got, np.asarray(jc.decode_batch(erasures, chunks, want=want)))
        assert np.array_equal(got, full[:, list(want), :])
        pdec = pc.decode_planar(erasures, full_pb, want=want)
        assert np.array_equal(
            pdec.planes.numpy(),
            np.asarray(jc.decode_planar(erasures, jfull_pb,
                                        want=want).planes))
        assert np.array_equal(_np(pdec.to_batch()), full[:, list(want), :])


@pytest.mark.parametrize("prof", PROFILES, ids=_ids)
def test_encode_decode_concat_equal_reference(prof):
    k, m, _t = prof
    jc, pc = _pair(*prof)
    n = k + m
    raw = np.random.default_rng(n).integers(0, 256, 1000,
                                            dtype=np.uint8).tobytes()
    pchunks = pc.encode(range(n), raw)
    jchunks = jc.encode(range(n), raw)
    for i in range(n):
        assert np.array_equal(pchunks[i], jchunks[i]), i
    for erasures in _patterns(k, m):
        avail = {i: c for i, c in pchunks.items() if i not in erasures}
        out = pc.decode_concat(avail)
        assert out == jc.decode_concat(
            {i: c for i, c in jchunks.items() if i not in erasures})
        assert out[:len(raw)] == raw


def _golden_isa():
    with open(GOLDEN) as f:
        cases = [json.loads(line) for line in f if line.strip()]
    return [c for c in cases if c["plugin"] == "isa"]


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
    "case", _golden_isa(),
    ids=lambda c: f"{c['technique']}-k{c['k']}m{c['m']}")
def test_isa_golden_rows_through_port(case):
    """The independent C oracle's ISA rows, replayed through the port
    exactly as tests/test_ec_golden.py replays them through ceph_tpu."""
    codec = factory({"plugin": "isa", "technique": case["technique"],
                     "k": str(case["k"]), "m": str(case["m"]), "w": "8"},
                    device="cpu")
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


def test_golden_has_three_isa_rows():
    assert len(_golden_isa()) == 3


@pytest.mark.parametrize("plugin", ["lrc", "shec"])
def test_lrc_shec_registered_equal_reference(plugin):
    """The plugins that later slices brought are registered now: the
    profile Ceph's documentation gives for each builds a codec on the CPU
    that encodes like the reference's, and only an unknown plugin name
    raises ENOENT."""
    prof = {"plugin": plugin, "k": "4", "m": "2",
            **({"l": "3"} if plugin == "lrc" else {"c": "2"})}
    codec = factory(dict(prof), device="cpu")
    assert codec.device.type == "cpu"
    raw = np.random.default_rng(len(plugin)).integers(
        0, 256, 3000, dtype=np.uint8).tobytes()
    n = codec.get_chunk_count()
    got = codec.encode(range(n), raw)
    want = jfactory(dict(prof)).encode(range(n), raw)
    for i in range(n):
        assert np.array_equal(got[i], want[i]), i
    with pytest.raises(ECError) as ei:
        factory({"plugin": f"no-{plugin}"}, device="cpu")
    assert ei.value.errno == errno.ENOENT


def test_wide_engine_equals_reference():
    """The w=16 engine, built from a coding matrix as the reference's is:
    its bit-matrices and decode matrices, and its byte-layout encodes
    (single stripe and batch) and decode, equal the reference engine's."""
    from ceph_tpu.ec.codec import _DeviceMatrixEngine as JEngine

    coding = np.random.default_rng(16).integers(
        1, 1 << 16, (2, 4)).astype(np.uint64)
    eng = engine_from_reference(coding, 4, 2, w=16, device="cpu")
    jeng = JEngine(4, 2, coding, w=16)
    assert tuple(eng._enc_bitmat.shape) == (32, 64)
    assert np.array_equal(eng._enc_bitmat.numpy(),
                          np.asarray(jeng._enc_bitmat))
    assert np.array_equal(eng.decode_matrix((0, 1, 2, 4), (3,)),
                          jeng.decode_matrix((0, 1, 2, 4), (3,)))
    rng = np.random.default_rng(17)
    data = rng.integers(0, 256, (4, 64), dtype=np.uint8)
    parity = eng.encode_parity(data)
    assert np.array_equal(parity, np.asarray(jeng.encode_parity(data)))
    batch = rng.integers(0, 256, (3, 4, 64), dtype=np.uint8)
    pbatch = eng.encode_parity_batch(batch).numpy()
    assert np.array_equal(pbatch, np.asarray(jeng.encode_parity_batch(batch)))
    full = np.concatenate([batch, pbatch], axis=1)
    src = (0, 1, 2, 4)
    rec = eng.reconstruct_batch_from(src, (3, 5), full).numpy()
    assert np.array_equal(rec, full[:, [3, 5], :])
    assert np.array_equal(
        eng.reconstruct(src, (3,), np.stack([data[0], data[1], data[2],
                                             parity[0]])),
        data[3:4])

"""The port's LRC plugin against the JAX package.

Each scenario of ``tests/test_ec_lrc.py`` runs through the port on
``device="cpu"`` and, where it produces bytes or read sets, through the
reference on JAX-CPU beside it.  On top: the flattened coding matrix, the
three encodes (literal layer walk, batch, planar) agreeing, the composed
batch and planar decodes with their pruned source sets, and
``create_rule``'s steps equal to the reference's, mapped through the
port's batched CRUSH mapper.  Inputs are seeded numpy;
every comparison is exact (tolerance 0, GF arithmetic).
"""

import errno
import itertools
import json

import numpy as np
import pytest
import torch

from ceph_tpu.ec import factory as jfactory
from ceph_tpu.ec import lrc as jlrc
from ceph_tpu.ec.interface import ECError as JECError
from ceph_tpu_torch.ec import ECError, factory
from ceph_tpu_torch.ec.lrc import ErasureCodeLrc, make_lrc
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

KML = {"k": "4", "m": "2", "l": "3"}
EXPLICIT = {
    "mapping": "__DD__DD",
    "layers": json.dumps([
        ["_cDD_cDD", ""],
        ["cDDD____", ""],
        ["____cDDD", ""],
    ]),
}
OVERRIDE = {
    "mapping": "DD__DD__",
    "layers": json.dumps([
        ["DDc_DDc_", {"plugin": "isa", "technique": "reed_sol_van"}],
        ["DDDc____", ""],
        ["____DDDc", ""],
    ]),
}
PROFILES = {"kml": KML, "explicit": EXPLICIT, "override": OVERRIDE}


def _lrc(profile):
    return make_lrc(dict(profile), device="cpu")


def _pair(profile):
    return jlrc.make_lrc(dict(profile)), _lrc(profile)


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# -- the scenarios of tests/test_ec_lrc.py ----------------------------------

def test_kml_profile_generation():
    codec = _lrc(KML)
    assert codec.get_chunk_count() == 8
    assert codec.get_data_chunk_count() == 4
    assert [layer.chunks_map for layer in codec.layers] == \
        ["DDc_DDc_", "DDDc____", "____DDDc"]
    assert "mapping" not in codec.get_profile()
    assert "layers" not in codec.get_profile()
    assert codec.get_chunk_mapping() == \
        jlrc.make_lrc(dict(KML)).get_chunk_mapping()


@pytest.mark.parametrize("profile", [
    {"k": "4", "m": "2"},
    {"k": "4", "m": "2", "l": "5"},
    {"k": "4", "m": "2", "l": "3", "mapping": "DD"},
])
def test_kml_constraint_errors(profile):
    with pytest.raises(ECError) as pe:
        _lrc(profile)
    with pytest.raises(JECError) as je:
        jlrc.make_lrc(dict(profile))
    assert pe.value.errno == je.value.errno == errno.EINVAL


def test_kml_roundtrip_single_erasure():
    jc, pc = _pair(KML)
    data = bytes(range(256)) * 13
    chunks = pc.encode(range(8), data)
    jchunks = jc.encode(range(8), data)
    for i in range(8):
        assert np.array_equal(chunks[i], jchunks[i])
    for erase in range(8):
        avail = {i: c for i, c in chunks.items() if i != erase}
        decoded = pc.decode({erase}, avail)
        assert np.array_equal(decoded[erase], chunks[erase]), erase
    assert pc.decode_concat(chunks)[: len(data)] == data


def test_kml_roundtrip_double_erasure():
    pc = _lrc(KML)
    data = np.random.default_rng(7).integers(0, 256, 4096,
                                             dtype=np.uint8).tobytes()
    chunks = pc.encode(range(8), data)
    avail = {i: c for i, c in chunks.items() if i not in (0, 4)}
    decoded = pc.decode({0, 4}, avail)
    assert np.array_equal(decoded[0], chunks[0])
    assert np.array_equal(decoded[4], chunks[4])


def test_minimum_to_decode_is_local():
    pc = _lrc(KML)
    minimum = pc.minimum_to_decode({1}, set(range(8)) - {1})
    assert minimum == {0, 2, 3}
    assert pc.minimum_to_decode({2, 5}, set(range(8))) == {2, 5}


def test_minimum_to_decode_falls_back_to_global():
    pc = _lrc(KML)
    avail = set(range(8)) - {0, 1}
    minimum = pc.minimum_to_decode({0}, avail)
    assert 0 not in minimum and 1 not in minimum and minimum <= avail
    chunks = pc.encode(range(8), bytes(range(128)) * 31)
    decoded = pc.decode({0, 1}, {i: chunks[i] for i in avail})
    assert np.array_equal(decoded[0], chunks[0])
    assert np.array_equal(decoded[1], chunks[1])


def test_minimum_to_decode_unrecoverable():
    pc = _lrc(KML)
    with pytest.raises(ECError) as ei:
        pc.minimum_to_decode({0}, set(range(8)) - {0, 1, 2, 3})
    assert ei.value.errno == errno.EIO


def test_explicit_layers_profile():
    codec = factory({"plugin": "lrc", **EXPLICIT}, device="cpu")
    jc = jfactory({"plugin": "lrc", **EXPLICIT})
    assert codec.get_chunk_count() == 8
    assert codec.get_data_chunk_count() == 4
    data = bytes(range(64)) * 61
    chunks = codec.encode(range(8), data)
    jchunks = jc.encode(range(8), data)
    for erase in range(8):
        assert np.array_equal(chunks[erase], jchunks[erase])
        avail = {i: c for i, c in chunks.items() if i != erase}
        decoded = codec.decode({erase}, avail)
        assert np.array_equal(decoded[erase], chunks[erase])
    assert codec.decode_concat(chunks)[: len(data)] == data


def test_layer_profile_override():
    jc, pc = _pair(OVERRIDE)
    assert pc.layers[0].profile["plugin"] == "isa"
    assert pc.layers[1].profile["plugin"] == "jerasure"
    chunks = pc.encode(range(8), b"x" * 4096)
    jchunks = jc.encode(range(8), b"x" * 4096)
    for i in range(8):
        assert np.array_equal(chunks[i], jchunks[i])
    avail = {i: c for i, c in chunks.items() if i != 5}
    assert np.array_equal(pc.decode({5}, avail)[5], chunks[5])


def test_rule_steps_kml():
    pc = _lrc({**KML, "crush-locality": "rack",
               "crush-failure-domain": "host"})
    assert [(s.op, s.type, s.n) for s in pc.rule_steps] == \
        [("choose", "rack", 2), ("chooseleaf", "host", 4)]


def _rule_pair(profile, racks=3, hosts=4, osds=2):
    """create_rule of the same profile into the same three-level map, in
    both packages: (port map, port rule, reference map, reference rule)."""
    from ceph_tpu.crush import types as jct
    from ceph_tpu_torch.crush import types as pct

    jc, pc = _pair(profile)
    pmap, _ = pct.build_three_level(racks, hosts, osds)
    jmap, _ = jct.build_three_level(racks, hosts, osds)
    return (pmap, pc.create_rule("lrcrule", pmap),
            jmap, jc.create_rule("lrcrule", jmap))


def _rule_state(cmap, ruleno):
    r = cmap.rules[ruleno]
    return list(r.steps), r.ruleset, r.type, r.min_size, r.max_size


def test_create_rule_equals_reference():
    """k4m2l3 over racks (the example of erasure-code-lrc.rst): SET
    tries, TAKE, CHOOSE_INDEP 2 racks, CHOOSELEAF_INDEP 4 hosts, EMIT, and
    the rule maps through the port's batched mapper as the reference's
    scalar mapper maps it."""
    from ceph_tpu.crush import ScalarMapper as JScalarMapper
    from ceph_tpu_torch.crush import types as pct
    from ceph_tpu_torch.crush.mapper import TensorMapper

    pmap, pr, jmap, jr = _rule_pair({**KML, "crush-locality": "rack",
                                     "crush-failure-domain": "host"})
    assert pr == jr == 1
    assert _rule_state(pmap, pr) == _rule_state(jmap, jr)
    assert [s[0] for s in pmap.rules[pr].steps] == [
        pct.RULE_SET_CHOOSELEAF_TRIES, pct.RULE_SET_CHOOSE_TRIES,
        pct.RULE_TAKE, pct.RULE_CHOOSE_INDEP, pct.RULE_CHOOSELEAF_INDEP,
        pct.RULE_EMIT]
    assert pmap.rules[pr].max_size == 8
    weights = np.full(pmap.max_devices, 0x10000, dtype=np.uint32)
    weights[[3, 10]] = 0
    res, rlen = TensorMapper(pmap, device="cpu").do_rule_batch(
        pr, np.arange(300, dtype=np.uint32), 8, weights)
    sm = JScalarMapper(jmap)
    for x in range(300):
        assert [int(v) for v in res[x, : rlen[x]]] == \
            sm.do_rule(jr, x, 8, list(weights))
    assert set(rlen.tolist()) == {8}


@pytest.mark.parametrize("profile", [
    KML, {**KML, "crush-failure-domain": "osd"},
    {**KML, "crush-root": "rack1"}, EXPLICIT],
    ids=["kml", "osd-domain", "root", "explicit"])
def test_create_rule_default_steps_equal_reference(profile):
    pmap, pr, jmap, jr = _rule_pair(profile)
    assert _rule_state(pmap, pr) == _rule_state(jmap, jr)
    assert pmap.rules[pr].steps[2] == \
        (1, -10 if "crush-root" in profile else -16, 0)


def test_create_rule_crush_steps_json_and_errors_equal_reference():
    profile = {**OVERRIDE,
               "crush-steps": json.dumps([["choose", "rack", 2],
                                          ["chooseleaf", "host", 4]])}
    pmap, pr, jmap, jr = _rule_pair(profile)
    assert _rule_state(pmap, pr) == _rule_state(jmap, jr)
    assert pmap.rules[pr].steps[3:5] == [(3, 2, 2), (7, 4, 1)]
    from ceph_tpu.crush import types as jct
    from ceph_tpu_torch.crush import types as pct

    for bad, code in (({"crush-root": "nowhere"}, errno.ENOENT),
                      ({"crush-steps": json.dumps([["choose", "row", 2]])},
                       errno.EINVAL)):
        jc, pc = _pair({**OVERRIDE, **bad})
        with pytest.raises(JECError) as jerr:
            jc.create_rule("r", jct.build_three_level(2, 2, 2)[0])
        with pytest.raises(ECError) as perr:
            pc.create_rule("r", pct.build_three_level(2, 2, 2)[0])
        assert perr.value.errno == jerr.value.errno == code
        assert str(perr.value) == str(jerr.value)


def test_crush_steps_json_profile():
    profile = {**OVERRIDE,
               "layers": json.dumps([["DDc_DDc_", ""], ["DDDc____", ""],
                                     ["____DDDc", ""]]),
               "crush-steps": json.dumps([["choose", "rack", 2],
                                          ["chooseleaf", "host", 4]])}
    jc, pc = _pair(profile)
    assert [(s.op, s.type, s.n) for s in pc.rule_steps] == \
        [(s.op, s.type, s.n) for s in jc.rule_steps] == \
        [("choose", "rack", 2), ("chooseleaf", "host", 4)]


def test_registry_exposes_lrc():
    codec = factory({"plugin": "lrc", **KML}, device="cpu")
    assert isinstance(codec, ErasureCodeLrc)
    assert codec.device.type == "cpu"
    for layer in codec.layers:
        assert layer.erasure_code.device.type == "cpu"
        assert layer.erasure_code.engine._enc_bitmat.device.type == "cpu"


def test_batch_encode_matches_single():
    jc, pc = _pair(KML)
    batch = np.random.default_rng(21).integers(0, 256, (4, 4, 64),
                                               dtype=np.uint8)
    parity = _np(pc.encode_batch(batch))
    assert parity.shape == (4, 4, 64)
    assert np.array_equal(parity, np.asarray(jc.encode_batch(batch)))
    for b in range(4):
        chunks = {pc.chunk_index(i): batch[b, i].copy() for i in range(4)}
        for i in range(4, 8):
            chunks[pc.chunk_index(i)] = np.zeros(64, dtype=np.uint8)
        pc.encode_chunks(chunks)
        for i in range(4):
            assert np.array_equal(parity[b, i],
                                  chunks[pc.chunk_index(4 + i)]), (b, i)


def test_batch_decode_roundtrip():
    jc, pc = _pair(KML)
    batch = np.random.default_rng(22).integers(0, 256, (4, 4, 64),
                                               dtype=np.uint8)
    parity = _np(pc.encode_batch(batch))
    full = np.concatenate([batch, parity], axis=1)
    for erasures in [(1,), (0, 4)]:
        zeroed = full.copy()
        zeroed[:, list(erasures), :] = 0
        out = _np(pc.decode_batch(erasures, zeroed))
        assert np.array_equal(out, full[:, list(erasures), :])
        assert np.array_equal(out, np.asarray(jc.decode_batch(erasures,
                                                              zeroed)))


# -- beyond the reference's scenarios ---------------------------------------

@pytest.mark.parametrize("name", sorted(PROFILES))
def test_flat_coding_matrix_and_three_encodes_agree(name):
    """The flattened generator equals the reference's, and the layer walk
    (encode_chunks), the batch encode and the planar encode give the same
    parity."""
    jc, pc = _pair(PROFILES[name])
    flat = pc._flat_coding_matrix()
    assert np.array_equal(flat, jc._flat_coding_matrix())
    k, n = pc.get_data_chunk_count(), pc.get_chunk_count()
    assert tuple(pc._flat_encode_bitmat().shape) == (8 * (n - k), 8 * k)
    data = np.random.default_rng(23).integers(0, 256, (3, k, 64),
                                              dtype=np.uint8)
    parity = _np(pc.encode_batch(data))
    assert np.array_equal(parity, np.asarray(jc.encode_batch(data)))
    ppb, jpb = pc.to_planar(data), jc.to_planar(data)
    penc = pc.encode_planar(ppb)
    assert np.array_equal(penc.planes.numpy(),
                          np.asarray(jc.encode_planar(jpb).planes))
    assert np.array_equal(_np(penc.to_batch()), parity)
    for b in range(3):
        chunks = {pc.chunk_index(i): data[b, i].copy() for i in range(k)}
        for i in range(k, n):
            chunks[pc.chunk_index(i)] = np.zeros(64, dtype=np.uint8)
        pc.encode_chunks(chunks)
        walked = np.stack([chunks[pc.chunk_index(i)] for i in range(k, n)])
        assert np.array_equal(walked, parity[b])


def _lrc_patterns():
    pats = [(e,) for e in range(8)] + list(itertools.combinations(range(8), 2))
    return pats[::3] + [(0, 1), (0, 2), (1, 5), (2, 3)]


@pytest.mark.parametrize("name", sorted(PROFILES))
def test_decode_batch_and_planar_equal_reference(name):
    jc, pc = _pair(PROFILES[name])
    k = pc.get_data_chunk_count()
    data = np.random.default_rng(24).integers(0, 256, (3, k, 64),
                                              dtype=np.uint8)
    full = np.concatenate([data, _np(pc.encode_batch(data))], axis=1)
    full_pb, jfull_pb = pc.to_planar(full), jc.to_planar(full)
    for erasures in _lrc_patterns():
        chunks = full.copy()
        chunks[:, list(erasures), :] = 0
        try:
            ref = np.asarray(jc.decode_batch(erasures, chunks))
        except JECError:
            with pytest.raises(ECError):
                pc.decode_batch(erasures, chunks)
            continue
        got = _np(pc.decode_batch(erasures, chunks))
        assert np.array_equal(got, ref)
        assert np.array_equal(got, full[:, list(erasures), :])
        pdec = pc.decode_planar(erasures, full_pb)
        assert np.array_equal(
            pdec.planes.numpy(),
            np.asarray(jc.decode_planar(erasures, jfull_pb).planes))
        bitmat, src = pc._dec_plans[(erasures, erasures)]
        _fn, jbitmat, jsrc = jc._dec_jit[(erasures, erasures)]
        assert src == jsrc
        assert np.array_equal(bitmat.numpy(), np.asarray(jbitmat))


def test_single_local_loss_gathers_only_its_group():
    """A lost data chunk decodes from its l+1 group's l survivors: the
    pruned recovery reads 3 chunks, not k=4 or n-1=7."""
    pc = _lrc(KML)
    for lost in range(4):
        bitmat, src = pc._decode_plan_for((lost,), (lost,))
        group = set(range(0, 2)) | {4, 5} if lost < 2 \
            else set(range(2, 4)) | {6, 7}
        assert set(src) == group - {lost}
        assert tuple(bitmat.shape) == (8, 8 * 3)

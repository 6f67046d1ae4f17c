"""The frozen plain reference against the C reference's vectors in
``tests/golden/`` (read, never edited) and against its own definitions."""

import json
import os

import numpy as np
import pytest

from conftest import ROOT
from portbench.reference import crc32c, ec, gf256, planar
from portbench.reference.crush import jenkins
from portbench.reference.crush.scalar import ScalarMapper
from portbench.reference.crush.types import (
    Bucket, ChooseArg, CrushMap, Rule, Tunables)
from portbench.reference.placement import Placement

GOLDEN = os.path.join(ROOT, "tests", "golden")
EC_CASES = [("isa", "reed_sol_van", 8, 4), ("isa", "reed_sol_van", 4, 2),
            ("jerasure", "cauchy_good", 4, 2),
            ("jerasure", "cauchy_good", 5, 3)]


def _lines(name):
    with open(os.path.join(GOLDEN, name)) as f:
        return [json.loads(line) for line in f if line.strip()]


def _lcg(seed, n):
    """The golden generator's bytes: x = 1103515245 x + 12345 mod 2^31,
    byte = (x >> 16) & 0xff."""
    x = seed & 0x7FFFFFFF
    out = bytearray(n)
    for i in range(n):
        x = (1103515245 * x + 12345) & 0x7FFFFFFF
        out[i] = (x >> 16) & 0xFF
    return bytes(out)


def _fnv1a64(data):
    h = 1469598103934665603
    for b in data:
        h = ((h ^ b) * 1099511628211) & 0xFFFFFFFFFFFFFFFF
    return f"{h:016x}"


def _ec_case(key):
    return next(c for c in _lines("ec_golden.jsonl")
                if (c["plugin"], c["technique"], c["k"], c["m"]) == key
                and c.get("w", 8) == 8)


@pytest.mark.parametrize("key", EC_CASES, ids=lambda k: "-".join(map(str, k)))
def test_encode_matches_the_c_goldens(key):
    case = _ec_case(key)
    code = ec.Code({"plugin": key[0], "technique": key[1], "k": key[2],
                    "m": key[3], "packetsize": case["packetsize"]})
    assert code.coding.reshape(-1).tolist() == case["matrix"]
    data = np.frombuffer(_lcg(case["seed"], case["object_size"]),
                         dtype=np.uint8).reshape(code.k, -1)
    chunks = code.encode(data)
    for i in range(code.n):
        blob = chunks[i].tobytes()
        assert blob[:16].hex() == case["chunks"][i]["head"]
        assert _fnv1a64(blob) == case["chunks"][i]["fnv1a64"]


@pytest.mark.parametrize("key", EC_CASES, ids=lambda k: "-".join(map(str, k)))
def test_every_loss_of_up_to_m_chunks_decodes(key):
    case = _ec_case(key)
    code = ec.Code({"plugin": key[0], "technique": key[1], "k": key[2],
                    "m": key[3], "packetsize": case["packetsize"]})
    rng = np.random.default_rng(7)
    rows = code.encode(rng.integers(0, 256, (code.k, case["chunk_size"]),
                                    dtype=np.uint8))
    for lost in [(0,), (code.k - 1, code.k), tuple(range(code.m))]:
        got = code.decode({s: rows[s] for s in range(code.n)
                           if s not in lost}, lost)
        for s in lost:
            assert np.array_equal(got[s], rows[s])


def test_object_stripes_round_trip_and_pad():
    code = ec.Code({"plugin": "jerasure", "technique": "cauchy_good",
                    "k": 4, "m": 2, "packetsize": 8})
    obj = bytes(range(256)) * 5                # 1280 B: two stripes of 1024
    shards = code.shards(obj, 256)
    assert shards.shape == (6, 512)
    assert code.logical(shards, 256, len(obj)) == obj
    # stripe 0's chunk 1 is object bytes 256..511
    assert shards[1, :256].tobytes() == obj[256:512]


def test_gf256_inverse_and_bitmatrix():
    a = np.array([[3, 7], [9, 200]], dtype=np.uint8)
    assert np.array_equal(gf256.matmul(a, gf256.invert(a)),
                          np.eye(2, dtype=np.uint8))
    bits = gf256.bitmatrix(np.array([[2]], dtype=np.uint8))
    # multiply-by-2: column u is the bits of 2 << u reduced by 0x11D
    assert bits[:, 0].tolist() == [0, 1, 0, 0, 0, 0, 0, 0]
    assert bits[:, 7].tolist() == [1, 0, 1, 1, 1, 0, 0, 0]


def test_crc32c_check_value_and_rows():
    # CRC-32C's catalogue check value, with Ceph's raw update inverted
    assert crc32c.crc32c(0xFFFFFFFF, b"123456789") ^ 0xFFFFFFFF == 0xE3069283
    rng = np.random.default_rng(3)
    rows = rng.integers(0, 256, (3, 8192), dtype=np.uint8)
    got = crc32c.crc32c_rows(rows, block=1024)
    assert [int(c) for c in got] == [crc32c.crc32c(0xFFFFFFFF, r.tobytes())
                                     for r in rows]
    odd = rows[:, :1000]
    assert [int(c) for c in crc32c.crc32c_rows(odd)] == \
        [crc32c.crc32c(0xFFFFFFFF, r.tobytes()) for r in odd]


def test_planes_follow_their_definition():
    row = np.zeros((1, 16), dtype=np.uint8)
    row[0, 3] = 0b101                          # byte 3: bits 0 and 2
    row[0, 9] = 0x80                           # byte 9 = 8*1 + 1: bit 7
    p = planar.rows_to_planes(row)
    assert p.shape == (1, 8, 2)
    assert p[0, 0].tolist() == [1 << 3, 0]
    assert p[0, 2].tolist() == [1 << 3, 0]
    assert p[0, 7].tolist() == [0, 1 << 1]
    rng = np.random.default_rng(4)
    rows = rng.integers(0, 256, (3, 64), dtype=np.uint8)
    assert np.array_equal(planar.planes_to_rows(planar.rows_to_planes(rows)),
                          rows)


def test_hash_matches_the_c_goldens():
    h = next(d for d in _lines("crush_golden.jsonl")
             if d["scenario"] == "hash")
    i = range(64)
    assert [jenkins.hash1(((x * 2654435761) + 17) & 0xFFFFFFFF)
            for x in i] == h["h1"]
    assert [jenkins.hash2(x, (x * 40503 + 3) & 0xFFFFFFFF) for x in i] \
        == h["h2"]
    assert [jenkins.hash3(x, x + 1, x * 7) for x in i] == h["h3"]
    assert [jenkins.hash5(x, 2 * x, 3 * x, 5 * x, 7 * x) for x in i] \
        == h["h5"]


CRUSH_MAPS = [d for d in _lines("crush_golden.jsonl")
              if d["scenario"] != "hash"]


@pytest.mark.parametrize("scen", CRUSH_MAPS, ids=lambda s: s["scenario"])
def test_scalar_crush_matches_the_c_goldens(scen):
    tn = scen["tunables"]
    cmap = CrushMap(Tunables(
        choose_total_tries=tn["total"], choose_local_tries=tn["local"],
        choose_local_fallback_tries=tn["fallback"],
        chooseleaf_descend_once=tn["descend_once"],
        chooseleaf_vary_r=tn["vary_r"], chooseleaf_stable=tn["stable"]))
    cmap.straw_calc_version = tn.get("straw_calc", 1)
    for b in scen["buckets"]:
        cmap.add_bucket(Bucket(id=b["id"], type=b["type"],
                               alg=b.get("alg", "straw2"),
                               items=b["items"], weights=b["weights"]))
    cmap.add_rule(Rule(steps=[tuple(s) for s in scen["steps"]]))
    cargs = None
    if "choose_args" in scen:
        cargs = {int(bid): ChooseArg(ids=a.get("ids"),
                                     weight_set=a.get("weight_set"))
                 for bid, a in scen["choose_args"].items()}
    sm = ScalarMapper(cmap)
    bad = [x for x, want in enumerate(scen["results"])
           if sm.do_rule(0, x, scen["result_max"], scen["weights"],
                         choose_args=cargs) != want]
    assert not bad, f"{len(bad)} mismatches, first x={bad[:5]}"


def test_placement_keeps_every_shard_on_its_own_host():
    with open(os.path.join(ROOT, "portbench", "configs",
                           "isa_k8m4.json")) as f:
        cfg = json.load(f)
    cluster = dict(cfg["cluster"], racks=4, hosts_per_rack=4,
                   osds_per_host=2)
    pl = Placement(cluster, dict(cfg["pool"], pg_num=64))
    for seed in range(64):
        up, primary = pl.up(seed, out=[5])
        hosts = [o // 2 for o in up if o != 0x7FFFFFFF]
        assert len(hosts) == len(set(hosts)) == 12
        assert 5 not in up and primary == up[0]

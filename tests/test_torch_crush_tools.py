"""The port's crushtool halves against ``ceph_tpu``'s.

- ``compiler.compile_text`` / ``decompile``: a hand-written text map and
  generated maps with device classes compile to the same map in both
  packages, decompile to the same text, and round-trip to the same
  placements; bad maps raise alike.
- ``CrushTester.test``: the reports (device counts, first choices, bad
  mappings, expected shares, deviation) equal the reference's for every
  bucket algorithm, with reweights and choose_args.  On straw2 maps the
  port runs its batched mapper on ``device="cpu"``; the reference is held
  to its scalar mapper (bit-exact with its JAX one, and free of an XLA
  compile).  Other algorithms take the scalar oracle in both, which the
  port counts and logs.

Every comparison is exact.
"""

import logging

import pytest

from ceph_tpu.crush import ScalarMapper as JScalarMapper
from ceph_tpu.crush import compiler as jcompiler
from ceph_tpu.crush import mapper as jmapper
from ceph_tpu.crush import tester as jtester
from ceph_tpu.crush import types as jtypes
from ceph_tpu_torch.crush import compiler as pcompiler
from ceph_tpu_torch.crush import tester as ptester
from ceph_tpu_torch.crush import types as ptypes
from ceph_tpu_torch.crush.scalar import ScalarMapper
from ceph_tpu_torch.utils.perf import KERNELS
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

TEXT_MAP = """
# begin crush map
tunable choose_total_tries 50
tunable chooseleaf_descend_once 1
tunable chooseleaf_vary_r 1
tunable chooseleaf_stable 1

device 0 osd.0
device 1 osd.1 class ssd
device 2 osd.2
device 3 osd.3 class ssd
device 4 osd.4
device 5 osd.5

type 0 osd
type 1 host
type 3 root

host host0 {
    id -1
    alg straw2
    hash 0
    item osd.0 weight 1.000
    item osd.1 weight 1.000
}
host host1 {
    id -2
    alg list
    hash 0
    item osd.2 weight 1.000
    item osd.3 weight 2.000
}
host host2 {
    id -3
    alg tree
    hash 0
    item osd.4 weight 1.500
    item osd.5 weight 0.500
}
root default {
    id -4
    alg straw2
    hash 0
    item host0 weight 2.000
    item host1 weight 3.000
    item host2 weight 2.000
}

rule replicated_rule {
    ruleset 0
    type replicated
    min_size 1
    max_size 10
    step take default
    step chooseleaf firstn 0 type host
    step emit
}
rule ec_rule {
    ruleset 1
    type erasure
    min_size 3
    max_size 6
    step take default
    step chooseleaf indep 3 type host
    step emit
}
# end crush map
"""


def map_state(cmap):
    return (
        {bid: (b.type, b.alg, list(b.items), list(b.weights))
         for bid, b in cmap.buckets.items()},
        [(list(r.steps), r.ruleset, r.type, r.min_size, r.max_size)
         for r in cmap.rules],
        vars(cmap.tunables), cmap.max_devices, dict(cmap.item_names),
        dict(cmap.type_names), dict(cmap.device_class))


def test_compile_hand_written_map_equals_reference():
    pmap = pcompiler.compile_text(TEXT_MAP)
    jmap = jcompiler.compile_text(TEXT_MAP)
    assert map_state(pmap) == map_state(jmap)
    assert pcompiler.decompile(pmap) == jcompiler.decompile(jmap)
    sm, jsm = ScalarMapper(pmap), JScalarMapper(jmap)
    for rule in (0, 1):
        for x in range(200):
            assert sm.do_rule(rule, x, 3, [0x10000] * 6) == \
                jsm.do_rule(rule, x, 3, [0x10000] * 6)


@pytest.mark.parametrize("firstn", [True, False], ids=["firstn", "indep"])
def test_round_trip_equals_reference(firstn):
    pmap, _ = ptypes.build_hierarchy(5, 3, numrep=3, firstn=firstn)
    jmap, _ = jtypes.build_hierarchy(5, 3, numrep=3, firstn=firstn)
    for m in (pmap, jmap):
        for dev in range(15):
            m.set_device_class(dev, "ssd" if dev % 3 else "hdd")
    text = pcompiler.decompile(pmap)
    assert text == jcompiler.decompile(jmap)
    back = pcompiler.compile_text(text)
    assert map_state(back) == map_state(jcompiler.compile_text(text))
    assert pcompiler.decompile(back) == text
    a, b = ScalarMapper(pmap), ScalarMapper(back)
    for x in range(300):
        assert a.do_rule(0, x, 3, [0x10000] * 15) == \
            b.do_rule(0, x, 3, [0x10000] * 15)


@pytest.mark.parametrize("text", [
    "device 0 osd.0\nhost h {\n id -1\n alg bogus\n item osd.0 weight 1\n}\n",
    "type 0 osd\nrule r {\n step take nowhere\n step emit\n}\n",
    "host h {\n id -1\n alg straw2\n item osd.9 weight 1\n}\n",
], ids=["alg", "take", "item"])
def test_bad_maps_raise_like_reference(text):
    with pytest.raises(Exception) as jerr:
        jcompiler.compile_text(text)
    with pytest.raises(type(jerr.value)) as perr:
        pcompiler.compile_text(text)
    assert str(perr.value) == str(jerr.value)


def flat_maps(alg, n=12):
    out = []
    for t in (ptypes, jtypes):
        cmap = t.CrushMap(t.Tunables())
        root = cmap.add_bucket(t.Bucket(
            id=0, type=3, alg=alg, items=list(range(n)),
            weights=[0x10000 * (1 + i % 3) for i in range(n)]), name="root")
        cmap.add_rule(t.Rule(steps=[(t.RULE_TAKE, root, 0),
                                    (t.RULE_CHOOSE_FIRSTN, 3, 0),
                                    (t.RULE_EMIT, 0, 0)]))
        out.append(cmap)
    return out


@pytest.fixture
def reference_on_scalar(monkeypatch):
    def refuse(self, *a, **k):
        raise NotImplementedError("held to the scalar mapper in tests")
    monkeypatch.setattr(jmapper.TensorMapper, "__init__", refuse)


@pytest.mark.parametrize("alg", ["straw2", "list", "tree", "straw"])
def test_tester_report_equals_reference(alg, reference_on_scalar, caplog):
    pmap, jmap = flat_maps(alg)
    w = [0x10000] * 12
    w[0], w[5] = 0, 0x8000
    KERNELS.reset()
    with caplog.at_level(logging.WARNING, logger="ceph_tpu_torch.crush"):
        got = ptester.CrushTester(pmap, device="cpu").test(
            0, 3, 0, 1023, weights=w)
    want = jtester.CrushTester(jmap).test(0, 3, 0, 1023, weights=w)
    assert vars(got) == vars(want)
    assert got.summary() == want.summary()
    assert got.device_counts.get(0, 0) == 0
    fell_back = alg != "straw2"
    assert KERNELS.get("crush_scalar_fallbacks") == int(fell_back)
    assert KERNELS.get("crush_map_calls") == int(not fell_back)
    assert ("scalar mapper" in caplog.text) == fell_back


def test_tester_choose_args_equal_reference(reference_on_scalar):
    pmap, jmap = flat_maps("straw2")
    pmap.choose_args["bal"] = {-1: ptypes.ChooseArg(
        weight_set=[[0x10000] * 12])}
    jmap.choose_args["bal"] = {-1: jtypes.ChooseArg(
        weight_set=[[0x10000] * 12])}
    got = ptester.CrushTester(pmap, device="cpu").test(
        0, 3, 0, 2047, choose_args="bal")
    want = jtester.CrushTester(jmap).test(0, 3, 0, 2047, choose_args="bal")
    assert vars(got) == vars(want)
    spread = max(got.device_counts.values()) / \
        min(got.device_counts.values())
    assert spread < 1.25

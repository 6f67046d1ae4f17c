"""The port's operator tools against ``ceph_tpu``'s: the same flags, the
same printed text, the same exit codes.

``crushtool`` (``--compile``, ``--decompile`` to text and to json,
``--test`` with and without ``--show-utilization`` and
``--show-mappings``) and ``osdmaptool`` (``--print``, ``--test-map-pgs``,
``--upmap`` with its deviation, iteration and pool flags) run on maps
built the same way in both packages, each tool through its ``main``.  The
port's tools run on ``device="cpu"``; the reference is held to its scalar
mapper (its TensorMapper refuses to build, so it takes its own scalar
path, with no XLA compile).  Every comparison is exact.
"""

import json
import pickle

import pytest

from ceph_tpu.crush import mapper as jmapper
from ceph_tpu.crush.types import build_hierarchy as jbuild_hierarchy
from ceph_tpu.osdmap import osdmap as josd
from ceph_tpu.tools import crushtool as jcrushtool
from ceph_tpu.tools import osdmaptool as josdmaptool
from ceph_tpu_torch.crush.types import build_hierarchy
from ceph_tpu_torch.osdmap import osdmap as posd
from ceph_tpu_torch.tools import crushtool, osdmaptool
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)


@pytest.fixture(autouse=True)
def reference_on_scalar(monkeypatch):
    def refuse(self, *a, **k):
        raise NotImplementedError("held to the scalar mapper in tests")
    monkeypatch.setattr(jmapper.TensorMapper, "__init__", refuse)


def run(capsys, main, argv, **kw):
    rc = main(argv, **kw)
    return rc, capsys.readouterr().out


def both(capsys, pmain, jmain, pargs, jargs):
    got = run(capsys, pmain, pargs, device="cpu")
    want = run(capsys, jmain, jargs)
    assert got == want
    return got


@pytest.fixture
def map_files(tmp_path):
    """The same map as json, per package, and compiled to each package's
    binary form."""
    out = {}
    for name, tool, build in (("port", crushtool, build_hierarchy),
                              ("ref", jcrushtool, jbuild_hierarchy)):
        cmap, rule = build(4, 3, numrep=3)
        jf = tmp_path / f"{name}.json"
        jf.write_text(json.dumps(tool.map_to_json(cmap)))
        bf = tmp_path / f"{name}.bin"
        assert tool.main(["-i", str(jf), "--compile", "-o", str(bf)]) == 0
        out[name] = (jf, bf, rule)
    assert out["port"][0].read_text() == out["ref"][0].read_text()
    return out


@pytest.mark.parametrize("flags", [["--decompile"],
                                   ["--decompile", "--json"]],
                         ids=["text", "json"])
def test_crushtool_decompile_equals_reference(map_files, capsys, flags):
    rc, out = both(capsys, crushtool.main, jcrushtool.main,
                   ["-i", str(map_files["port"][1])] + flags,
                   ["-i", str(map_files["ref"][1])] + flags)
    assert rc == 0 and ("step chooseleaf firstn 3 type host" in out
                        or '"steps"' in out)


@pytest.mark.parametrize("extra", [
    [], ["--show-utilization"], ["--show-mappings", "--max-x", "63"],
    ["--num-rep", "5", "--max-x", "255"],
    ["--num-rep", "2", "--min-x", "100", "--max-x", "611",
     "--show-utilization"]], ids=["plain", "utilization", "mappings",
                                  "bad_mappings", "range"])
def test_crushtool_test_equals_reference(map_files, capsys, extra):
    rule = map_files["port"][2]
    args = ["--test", "--rule", str(rule)] + extra
    for source in (0, 1):        # json and binary input
        rc, out = both(capsys, crushtool.main, jcrushtool.main,
                       ["-i", str(map_files["port"][source])] + args,
                       ["-i", str(map_files["ref"][source])] + args)
        assert out.startswith("CRUSH rule" if "--show-mappings" in extra
                              else "tested")
        assert rc == (1 if "--num-rep" in extra and "5" in extra else 0)


def test_crushtool_usage_errors_equal_reference(map_files, capsys):
    for argv in ([], ["-i", str(map_files["port"][0])]):
        with pytest.raises(SystemExit) as got:
            crushtool.main(argv, device="cpu")
        perr = capsys.readouterr().err
        with pytest.raises(SystemExit) as want:
            jcrushtool.main(argv)
        assert got.value.code == want.value.code == 2
        assert perr == capsys.readouterr().err


def osdmaps(ptype, size, pg_num=64):
    """The same OSDMap in both packages: 12 OSDs on 4 hosts, one pool,
    one OSD down and one out, a reweight and an upmap item."""
    maps = []
    for mod, kw in ((posd, {"device": "cpu"}), (josd, {})):
        m = mod.build_simple_osdmap(12, 3, pg_num, ptype, size, **kw)
        m.mark_down(4)
        m.mark_out(7)
        m.osd_weight[2] = 0x9000
        m.pg_upmap_items[mod.PGid(1, 3)] = [(m.pg_raw_up(
            mod.PGid(1, 3))[0], 11)]
        maps.append(m)
    return maps


@pytest.mark.parametrize("ptype,size", [(posd.POOL_TYPE_REPLICATED, 3),
                                        (posd.POOL_TYPE_ERASURE, 4)],
                         ids=["replicated", "erasure"])
def test_osdmaptool_print_and_test_map_pgs_equal_reference(
        tmp_path, capsys, ptype, size):
    p, j = osdmaps(ptype, size)
    pf, jf = tmp_path / "p.bin", tmp_path / "j.bin"
    pf.write_bytes(pickle.dumps(p))
    jf.write_bytes(pickle.dumps(j))
    for flags in (["--print"], ["--test-map-pgs"], ["--test-map-pgs",
                                                    "--pool", "1"],
                  ["--print", "--test-map-pgs"]):
        rc, out = both(capsys, osdmaptool.main, josdmaptool.main,
                       [str(pf)] + flags, [str(jf)] + flags)
        assert rc == 0
    assert "osd.7 up out weight 0.0000" in out
    assert "osd.4 down in" in out
    assert "pool 1 pg_num 64" in out


@pytest.mark.parametrize("flags", [[], ["--upmap-deviation", "0.01"],
                                   ["--upmap-max", "2", "--pool", "1"]],
                         ids=["defaults", "deviation", "max_pool"])
def test_osdmaptool_upmap_equals_reference(tmp_path, capsys, flags):
    p, j = osdmaps(posd.POOL_TYPE_REPLICATED, 3, pg_num=128)
    # a map pickled without a device runs where main() is told
    p.device = None
    pf, jf = tmp_path / "p.bin", tmp_path / "j.bin"
    pf.write_bytes(pickle.dumps(p))
    jf.write_bytes(pickle.dumps(j))
    po, jo = tmp_path / "p_out.bin", tmp_path / "j_out.bin"
    rc, out = both(capsys, osdmaptool.main, josdmaptool.main,
                   [str(pf), "--upmap", str(po)] + flags,
                   [str(jf), "--upmap", str(jo)] + flags)
    assert rc == 0 and "pg_upmap_items" in out and "upmap 1." in out
    pm, jm = pickle.loads(po.read_bytes()), pickle.loads(jo.read_bytes())
    assert isinstance(pm, posd.OSDMap) and pm.device == "cpu"
    assert {(pg.pool, pg.seed): v for pg, v in pm.pg_upmap_items.items()} \
        == {(pg.pool, pg.seed): v for pg, v in jm.pg_upmap_items.items()}
    assert len(pm.pg_upmap_items) > 1

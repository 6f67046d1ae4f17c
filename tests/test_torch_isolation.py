"""The port stands alone and defaults to the card.

- importing the package pulls in neither JAX nor any ``ceph_tpu`` module;
- no source file of the package imports jax, ceph_tpu or google_crc32c;
- an entry point asked for no device runs on CUDA, and raises where there
  is none instead of running on the CPU; an LRC codec's layers run on its
  device; so do CRUSH's batched mapper and an OSDMap's batched placement;
- the B1 and B2 wrappers never answer a non-CPU tensor with their plain
  versions.
"""

import os
import pathlib
import re
import subprocess
import sys

import numpy as np
import pytest
import torch

import ceph_tpu_torch
from ceph_tpu_torch.ec import codec as pcodec
from ceph_tpu_torch.ec import factory
from ceph_tpu_torch.ops import _build, gf8_bytes_cuda, gf8_cuda

PKG = pathlib.Path(ceph_tpu_torch.__file__).parent
REPO = PKG.parent

_FORBIDDEN = re.compile(
    r"^\s*(?:import|from)\s+(jax\b|ceph_tpu\b(?!_torch)|google_crc32c\b)",
    re.MULTILINE)


def test_import_leaves_jax_and_reference_out():
    code = (
        "import sys\n"
        "import ceph_tpu_torch, ceph_tpu_torch.ec, ceph_tpu_torch.ops.gf8_cuda\n"
        "import ceph_tpu_torch.ec.stripe, ceph_tpu_torch.ops.crc32c\n"
        "import ceph_tpu_torch.ec.jerasure, ceph_tpu_torch.ec.liberation\n"
        "import ceph_tpu_torch.ec.planar, ceph_tpu_torch.ops.gfw\n"
        "import ceph_tpu_torch.ops.gf8_bytes_cuda\n"
        "import ceph_tpu_torch.ec.lrc, ceph_tpu_torch.ec.shec\n"
        "import ceph_tpu_torch.ops.jenkins, ceph_tpu_torch.crush\n"
        "import ceph_tpu_torch.crush._ll_table, ceph_tpu_torch.crush.ln\n"
        "import ceph_tpu_torch.crush.types, ceph_tpu_torch.crush.scalar\n"
        "import ceph_tpu_torch.crush.mapper, ceph_tpu_torch.crush.compiler\n"
        "import ceph_tpu_torch.crush.tester, ceph_tpu_torch.osdmap\n"
        "import ceph_tpu_torch.osdmap.osdmap, ceph_tpu_torch.osdmap.balancer\n"
        "import ceph_tpu_torch.balance, ceph_tpu_torch.balance.scorer\n"
        "import ceph_tpu_torch.ops.checksum, ceph_tpu_torch.ops.sloppy_crc\n"
        "import ceph_tpu_torch.ops.profiling, ceph_tpu_torch.ec.registry\n"
        "import ceph_tpu_torch.tools, ceph_tpu_torch.tools.crushtool\n"
        "import ceph_tpu_torch.tools.osdmaptool\n"
        "from ceph_tpu_torch.osdmap.osdmap import build_simple_osdmap\n"
        "build_simple_osdmap(device='cpu').pool_mapping(1)\n"
        "from ceph_tpu_torch.balance import calc_pg_upmaps_vectorized\n"
        "calc_pg_upmaps_vectorized(build_simple_osdmap(device='cpu'),"
        " engine='device')\n"
        "from ceph_tpu_torch.ops.checksum import Checksummer\n"
        "Checksummer('xxhash64', device='cpu').calculate(8, bytes(64))\n"
        "from ceph_tpu_torch.ec import factory\n"
        "factory({'plugin': 'jerasure', 'technique': 'cauchy_good',"
        " 'k': '4', 'm': '2'}, device='cpu')\n"
        "factory({'plugin': 'lrc', 'k': '4', 'm': '2', 'l': '3'},"
        " device='cpu')\n"
        "factory({'plugin': 'shec', 'k': '8', 'm': '4', 'c': '3'},"
        " device='cpu')\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ceph_tpu' or m.startswith('ceph_tpu.')"
        " or m == 'google_crc32c']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


def test_no_source_imports_reference_or_jax():
    offenders = []
    for path in sorted(PKG.rglob("*.py")):
        if "_build" in path.relative_to(PKG).parts:
            continue                      # kernel build cache, not source
        text = path.read_text()
        for m in _FORBIDDEN.finditer(text):
            offenders.append(f"{path.relative_to(REPO)}: {m.group(0).strip()}")
    assert not offenders, offenders
    # the scan itself catches what it is meant to catch
    assert _FORBIDDEN.search("import jax.numpy as jnp")
    assert _FORBIDDEN.search("    from ceph_tpu.ops import gf8")
    assert not _FORBIDDEN.search("from ceph_tpu_torch.ops import gf8")


def test_factory_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        factory({"plugin": "isa", "k": "4", "m": "2"})
    for technique in ("reed_sol_van", "cauchy_good", "liberation"):
        with pytest.raises(RuntimeError, match="CUDA"):
            factory({"plugin": "jerasure", "technique": technique})
    with pytest.raises(RuntimeError, match="CUDA"):
        factory({})                 # the default plugin, jerasure
    with pytest.raises(RuntimeError, match="CUDA"):
        factory({"plugin": "shec", "k": "8", "m": "4", "c": "3"})
    with pytest.raises(RuntimeError, match="CUDA"):
        factory({"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
    with pytest.raises(RuntimeError, match="CUDA"):
        pcodec.engine_from_reference(np.ones((2, 4), dtype=np.uint8), 4, 2)
    assert pcodec.resolve_device("cpu").type == "cpu"
    assert factory({"plugin": "isa", "k": "4", "m": "2"},
                   device="cpu").device.type == "cpu"
    lrc = factory({"plugin": "lrc", "k": "4", "m": "2", "l": "3"},
                  device="cpu")
    assert {layer.erasure_code.device.type for layer in lrc.layers} == {"cpu"}


def test_placement_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    """CRUSH's batched mapper and an OSDMap's batched placement, asked for
    no device, want CUDA and raise without it; an OSDMap still answers
    through its scalar chain, which needs no device."""
    from ceph_tpu_torch.crush.mapper import TensorMapper
    from ceph_tpu_torch.crush.tester import CrushTester
    from ceph_tpu_torch.crush.types import build_hierarchy
    from ceph_tpu_torch.osdmap.osdmap import PGid, build_simple_osdmap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cmap, rule = build_hierarchy(4, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TensorMapper(cmap)
    with pytest.raises(RuntimeError, match="CUDA"):
        CrushTester(cmap).test(rule, 3, 0, 15)
    m = build_simple_osdmap(8, 2, 16)
    assert len(m.pg_to_up_acting_osds(PGid(1, 0))[0]) == 3
    with pytest.raises(RuntimeError, match="CUDA"):
        m.tensor_mapper
    with pytest.raises(RuntimeError, match="CUDA"):
        m.pool_mapping(1)
    assert m.scalar_fallbacks == 0
    assert TensorMapper(cmap, device="cpu").device.type == "cpu"
    assert build_simple_osdmap(8, 2, 16, device="cpu") \
        .tensor_mapper.device.type == "cpu"
    # with a card present the default is the card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "to", lambda self, *a, **k: self)
    assert TensorMapper(cmap).device.type == "cuda"
    assert build_simple_osdmap(8, 2, 16).tensor_mapper.device.type == "cuda"


def test_scorer_tools_and_checksums_default_to_cuda(monkeypatch, tmp_path):
    """The balancer scorer, the tools, the checksummer and gf_matmul,
    asked for no device, want CUDA and raise without it."""
    import json
    import pickle

    from ceph_tpu_torch.balance import calc_pg_upmaps_vectorized
    from ceph_tpu_torch.crush.types import build_hierarchy
    from ceph_tpu_torch.ops import checksum, gf8
    from ceph_tpu_torch.osdmap.osdmap import build_simple_osdmap
    from ceph_tpu_torch.tools import crushtool, osdmaptool

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        calc_pg_upmaps_vectorized(build_simple_osdmap(16, 4, 64))
    with pytest.raises(RuntimeError, match="CUDA"):
        checksum.Checksummer("crc32c")
    with pytest.raises(RuntimeError, match="CUDA"):
        gf8.gf_matmul(np.ones((1, 1), np.uint8), np.ones((1, 4), np.uint8))
    cmap, _ = build_hierarchy(4, 2)
    mapf = tmp_path / "map.json"
    mapf.write_text(json.dumps(crushtool.map_to_json(cmap)))
    with pytest.raises(RuntimeError, match="CUDA"):
        crushtool.main(["-i", str(mapf), "--test"])
    osdf = tmp_path / "osdmap.bin"
    osdf.write_bytes(pickle.dumps(build_simple_osdmap(8, 2, 16)))
    with pytest.raises(RuntimeError, match="CUDA"):
        osdmaptool.main([str(osdf), "--test-map-pgs"])
    # the plain engine runs only where the caller names the CPU
    changes, scored = calc_pg_upmaps_vectorized(
        build_simple_osdmap(16, 4, 64, device="cpu"))
    assert scored > 0


def test_lrc_layers_follow_the_codec_to_cuda(monkeypatch):
    """An LRC codec on CUDA builds every layer codec on CUDA: the device
    reaches the registry.  (Here CUDA is faked as present and the layers'
    bit-matrices stay on the host, so only the device choice is checked.)"""
    from ceph_tpu_torch.ec import codec as pcodec_mod

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.Tensor, "to",
                        lambda self, *a, **k: self)
    lrc = factory({"plugin": "lrc", "k": "4", "m": "2", "l": "3"})
    shec = factory({"plugin": "shec", "k": "8", "m": "4", "c": "3"})
    assert lrc.device.type == shec.device.type == "cuda"
    assert {layer.erasure_code.device.type for layer in lrc.layers} == \
        {"cuda"}
    assert pcodec_mod.resolve_device().type == "cuda"


def test_b1_wrapper_refuses_instead_of_falling_back(monkeypatch, tmp_path):
    """A request off the CPU launches the kernel or raises: here the
    kernel cannot be built (no nvcc, no card), and nothing quietly runs
    the plain version instead."""
    bm = torch.ones((8, 8), dtype=torch.uint8, device="meta")
    planes = torch.zeros((8, 16), dtype=torch.uint8, device="meta")
    before = gf8_cuda.launches
    with pytest.raises(ValueError):
        gf8_cuda.planar_matmul(bm, planes)
    with pytest.raises(ValueError):
        gf8_cuda.planar_matmul(bm, torch.zeros((8, 16), dtype=torch.uint8))
    assert gf8_cuda.launches == before
    # the CUDA branch needs the built kernel; building raises without nvcc
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at the default path")
    monkeypatch.setattr(gf8_cuda, "_fn", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        gf8_cuda._kernel()


def test_b2_wrapper_refuses_instead_of_falling_back(monkeypatch, tmp_path):
    """Kernel B2's wrapper, like B1's: off the CPU it launches the kernel
    or raises, and never runs the plain version instead."""
    bm = torch.ones((8, 8), dtype=torch.uint8, device="meta")
    data = torch.zeros((1, 16), dtype=torch.uint8, device="meta")
    calls = []
    monkeypatch.setattr(gf8_bytes_cuda, "bitmatrix_matmul_ref",
                        lambda *a: calls.append(a))
    before = gf8_bytes_cuda.launches
    with pytest.raises(ValueError):
        gf8_bytes_cuda.bitmatrix_matmul(bm, data)
    with pytest.raises(ValueError):
        gf8_bytes_cuda.bitmatrix_matmul(
            bm, torch.zeros((1, 16), dtype=torch.uint8))
    assert gf8_bytes_cuda.launches == before and not calls
    monkeypatch.setattr(_build, "_libs", {})
    monkeypatch.setattr(_build, "BUILD_ROOT", str(tmp_path))
    monkeypatch.setattr(_build.shutil, "which", lambda _name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    if os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("this machine has nvcc at the default path")
    monkeypatch.setattr(gf8_bytes_cuda, "_fn", None)
    with pytest.raises(RuntimeError, match="nvcc"):
        gf8_bytes_cuda._kernel()


def test_kernel_sources_and_build_flags_target_hopper():
    srcs = sorted(p.name for p in (PKG / "csrc").glob("*.cu"))
    assert srcs == ["gf8_bytes.cu", "gf8_planar.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.NVCC_FLAGS
    text = (PKG / "csrc" / "gf8_planar.cu").read_text()
    assert 'extern "C" int gf8_planar_matmul' in text
    assert "_planar_kernel" in text       # names the TPU kernel it replaces
    text = (PKG / "csrc" / "gf8_bytes.cu").read_text()
    assert 'extern "C" int gf8_bytes_matmul' in text
    assert "gf8_pallas.py::_kernel" in text

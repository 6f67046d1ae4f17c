"""The port stands alone and defaults to the card.

- importing the package pulls in neither JAX nor any ``ceph_tpu`` module;
- no source file of the package imports jax, ceph_tpu or google_crc32c;
- an entry point asked for no device runs on CUDA, and raises where there
  is none instead of running on the CPU; an LRC codec's layers run on its
  device; so do CRUSH's batched mapper, an OSDMap's batched placement and
  the device mesh with its EC engine;
- the B1 and B2 wrappers never answer a non-CPU tensor with their plain
  versions;
- a ``ReadBatcher`` whose OSD names no device verifies on CUDA, and raises
  where there is none; an ``EncodeBatcher`` tick of a codec off the CPU
  never answers with the plain version of B1 or B2;
- a ``Monitor`` and a ``MgrDaemon`` that name no device run on CUDA, and
  raise where there is none;
- so do an ``OSDDaemon``, a ``RadosClient`` and ``start_cluster``; and a
  CPU cluster started, written and read in a fresh process leaves JAX and
  ``ceph_tpu`` out of ``sys.modules``;
- so do an ``MDSDaemon``, ``Cluster.start_mds`` of a cluster that names
  no device, the ``rados`` and ``ceph`` CLIs and the EC sidecar; and an
  RBD image, a CephFS file and an RGW object written and read on a CPU
  cluster in a fresh process leave JAX and ``ceph_tpu`` out of
  ``sys.modules``; so does importing the saturation ramp, the soak
  runner and the load CLI, the front-door and elastic runners and the
  chaos and blackbox CLIs;
- ``run_frontdoor``, ``run_elastic`` and the chaos CLI's ``run``, asked
  for no device, boot their cluster on CUDA, and without a card raise
  (the CLI exits 2) before anything boots.
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
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

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
        "import ceph_tpu_torch.parallel, ceph_tpu_torch.parallel.mesh\n"
        "import ceph_tpu_torch.parallel.engine, ceph_tpu_torch.utils\n"
        "import ceph_tpu_torch.utils.perf, ceph_tpu_torch.utils.config\n"
        "import ceph_tpu_torch.utils.backoff, ceph_tpu_torch.utils.deadline\n"
        "import ceph_tpu_torch.utils.tasks, ceph_tpu_torch.utils.compressor\n"
        "import ceph_tpu_torch.utils.lockdep, ceph_tpu_torch.utils.schedfuzz\n"
        "import ceph_tpu_torch.utils.admin_socket, ceph_tpu_torch.chaos\n"
        "import ceph_tpu_torch.chaos.rng, ceph_tpu_torch.chaos.counters\n"
        "import ceph_tpu_torch.cluster, ceph_tpu_torch.cluster.auth\n"
        "import ceph_tpu_torch.trace, ceph_tpu_torch.trace.span\n"
        "import ceph_tpu_torch.trace.attribution, ceph_tpu_torch.trace.flight\n"
        "import ceph_tpu_torch.trace.loopmon, ceph_tpu_torch.trace.perfetto\n"
        "import ceph_tpu_torch.trace.postmortem\n"
        "import ceph_tpu_torch.chaos.clock, ceph_tpu_torch.chaos.points\n"
        "import ceph_tpu_torch.chaos.disk, ceph_tpu_torch.chaos.net\n"
        "import ceph_tpu_torch.cluster.optracker, ceph_tpu_torch.cluster.kv\n"
        "import ceph_tpu_torch.cluster.store, ceph_tpu_torch.cluster.filestore\n"
        "import ceph_tpu_torch.cluster.bluestore\n"
        "import ceph_tpu_torch.cluster.messenger\n"
        "import ceph_tpu_torch.cluster.messages\n"
        "import ceph_tpu_torch.cluster.batcher\n"
        "import ceph_tpu_torch.cluster.monclient, ceph_tpu_torch.cluster.paxos\n"
        "import ceph_tpu_torch.cluster.mon, ceph_tpu_torch.cluster.mgr\n"
        "import ceph_tpu_torch.balance.balancer\n"
        "import ceph_tpu_torch.balance.autoscaler\n"
        "import ceph_tpu_torch.balance.reshape\n"
        "import ceph_tpu_torch.analysis, ceph_tpu_torch.analysis.racecheck\n"
        "import ceph_tpu_torch.cluster.pglog, ceph_tpu_torch.cluster.snaps\n"
        "import ceph_tpu_torch.cluster.objclass\n"
        "import ceph_tpu_torch.cluster.dmclock\n"
        "import ceph_tpu_torch.cluster.sharded_wq, ceph_tpu_torch.cluster.pg\n"
        "import ceph_tpu_torch.cluster.backend_replicated\n"
        "import ceph_tpu_torch.cluster.backend_ec\n"
        "import ceph_tpu_torch.cluster.client_ops\n"
        "import ceph_tpu_torch.cluster.tiering\n"
        "import ceph_tpu_torch.cluster.recovery, ceph_tpu_torch.cluster.scrub\n"
        "import ceph_tpu_torch.cluster.osd, ceph_tpu_torch.cluster.objecter\n"
        "import ceph_tpu_torch.cluster.vstart\n"
        "import ceph_tpu_torch.load.ramp, ceph_tpu_torch.load.soak\n"
        "import ceph_tpu_torch.tools.load\n"
        "import ceph_tpu_torch.chaos.frontdoor, ceph_tpu_torch.chaos.balance\n"
        "import ceph_tpu_torch.tools.chaos, ceph_tpu_torch.tools.blackbox\n"
        "import asyncio\n"
        "from ceph_tpu_torch.cluster.vstart import start_cluster\n"
        "async def io():\n"
        "    c = await start_cluster(3, device='cpu')\n"
        "    try:\n"
        "        cl = await c.client()\n"
        "        for kind, prof in (('erasure', {'plugin': 'isa', 'k': '2',"
        " 'm': '1'}), ('replicated', None)):\n"
        "            p = await cl.pool_create(kind, kind, pg_num=4,"
        " ec_profile=prof)\n"
        "            await cl.ioctx(p).write_full('o', b'y' * 5000)\n"
        "            assert await cl.ioctx(p).read('o') == b'y' * 5000\n"
        "        await c.osds[0].scrub_pg(next(iter(c.osds[0].pgs.values())))\n"
        "    finally:\n"
        "        await c.stop()\n"
        "asyncio.run(asyncio.wait_for(io(), 60))\n"
        "import tempfile\n"
        "from ceph_tpu_torch.cluster.bluestore import BlueStore\n"
        "from ceph_tpu_torch.cluster.store import Transaction\n"
        "bs = BlueStore(tempfile.mkdtemp() + '/bs', size=1 << 20)\n"
        "bs.mount()\n"
        "bs.queue_transaction(Transaction().write('c', 'o', 0, b'x' * 9000))\n"
        "assert bs.read('c', 'o') == b'x' * 9000\n"
        "bs.umount()\n"
        "from ceph_tpu_torch.parallel import make_mesh, distributed_ec_step\n"
        "step, args = distributed_ec_step(make_mesh(devices=['cpu'] * 8),"
        " 8, 4, 8, 64)\n"
        "assert int(step(*args)[0]) == 0\n"
        "from ceph_tpu_torch.utils import Config\n"
        "Config(auth_supported='cephx', auth_shared_secret='k')"
        ".cephx_context('osd.0').ensure_ticket()\n"
        "from ceph_tpu_torch.osdmap.osdmap import build_simple_osdmap\n"
        "build_simple_osdmap(device='cpu').pool_mapping(1)\n"
        "build_simple_osdmap(device='cpu').pool_raw_up(1)\n"
        "from ceph_tpu_torch.cluster.mon import Monitor\n"
        "from ceph_tpu_torch.cluster.mgr import MgrDaemon\n"
        "from ceph_tpu_torch.osdmap.osdmap import Incremental\n"
        "mon = Monitor(build_simple_osdmap(device='cpu'), device='cpu')\n"
        "mon._mint_pg_temp(Incremental(epoch=3, new_weights={0: 0}))\n"
        "MgrDaemon(('127.0.0.1', 1), device='cpu')\n"
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


def test_mesh_defaults_to_cuda_and_refuses_cpu_fallback(monkeypatch):
    """``make_mesh``, ``MeshECEngine``, ``mesh_for_codec`` and
    ``wrap_codec_for_mesh``, asked for no device, want CUDA and raise
    without it; only named devices give a CPU mesh."""
    from ceph_tpu_torch.ec import matrices
    from ceph_tpu_torch.parallel import MeshECEngine, make_mesh
    from ceph_tpu_torch.parallel.engine import (mesh_for_codec,
                                                wrap_codec_for_mesh)

    codec = factory({"plugin": "isa", "k": "4", "m": "2"}, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        make_mesh(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MeshECEngine(None, 4, 2, matrices.isa_rs_matrix(4, 2))
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_for_codec(codec)
    with pytest.raises(RuntimeError, match="CUDA"):
        wrap_codec_for_mesh(codec, 2)
    assert {d.type for d in make_mesh(devices=["cpu"] * 4).devices.flat} \
        == {"cpu"}
    # with cards present the default mesh is one slot per card
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    mesh = make_mesh()
    assert mesh.shape == {"data": 1, "shard": 4}
    assert [str(d) for d in mesh.devices.flat] == \
        ["cuda:0", "cuda:1", "cuda:2", "cuda:3"]
    eng = MeshECEngine(None, 4, 2, matrices.isa_rs_matrix(4, 2))
    assert eng.mesh == mesh
    with pytest.raises(ValueError, match="need 8 devices, have 4"):
        make_mesh(8)


class _StubOSD:
    """The batchers' view of an OSD: config, counters, clock, tasks and
    the tick compute in an executor thread."""

    def __init__(self, **kw):
        from ceph_tpu_torch.chaos.clock import ChaosClock
        from ceph_tpu_torch.utils import Config, PerfCounters

        self._stopped = False
        self.config = Config(osd_batch_tick_ops=64)
        self.perf = PerfCounters("osd.stub")
        self.clock = ChaosClock()
        self._tasks = set()
        self.__dict__.update(kw)

    def _track(self, task):
        self._tasks.add(task)
        return task

    def _chaos_point(self, name):
        pass

    async def _compute(self, fn, *args):
        import asyncio
        import functools

        return await asyncio.get_running_loop().run_in_executor(
            None, functools.partial(fn, *args))


def test_read_batcher_defaults_to_cuda_and_refuses_cpu_fallback(
        monkeypatch):
    from ceph_tpu_torch.cluster.batcher import ReadBatcher

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ReadBatcher(_StubOSD())
    with pytest.raises(RuntimeError, match="CUDA"):
        ReadBatcher(_StubOSD(device="cuda"))
    assert ReadBatcher(_StubOSD(device="cpu")).device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert ReadBatcher(_StubOSD()).device.type == "cuda"


@pytest.mark.parametrize("planar", [True, False])
@pytest.mark.parametrize("profile", [
    {"plugin": "isa", "k": "8", "m": "4"},
    {"plugin": "jerasure", "technique": "cauchy_good", "k": "8", "m": "4",
     "packetsize": "2048"}], ids=["isa", "cauchy"])
def test_encode_batcher_tick_off_the_cpu_never_runs_plain_kernels(
        monkeypatch, profile, planar):
    """A codec off the CPU (here the meta device stands in for the card,
    which this machine lacks): every request of the tick fails with the
    wrappers' refusal, and neither plain version runs."""
    import asyncio

    from ceph_tpu_torch.cluster.batcher import EncodeBatcher
    from ceph_tpu_torch.ec.stripe import StripeInfo

    calls = []
    monkeypatch.setattr(gf8_cuda, "planar_matmul_ref",
                        lambda *a: calls.append("B1"))
    monkeypatch.setattr(gf8_bytes_cuda, "bitmatrix_matmul_ref",
                        lambda *a: calls.append("B2"))
    codec = factory(dict(profile), device="meta")
    sinfo = StripeInfo(8, 4096 if planar else 16384)
    before = (gf8_cuda.launches, gf8_bytes_cuda.launches)

    async def tick():
        osd = _StubOSD(device="meta")
        eb = EncodeBatcher(osd)
        res = await asyncio.gather(
            *(eb.encode(codec, sinfo, bytes(n), True, planar=planar)
              for n in (4096, 70000, 200000)), return_exceptions=True)
        return res, osd.perf.get("osd_batch_ticks")

    res, ticks = asyncio.run(asyncio.wait_for(tick(), timeout=60))
    assert [type(r).__name__ for r in res] == ["ValueError"] * 3
    assert all("CUDA device or the CPU" in str(r) for r in res)
    assert ticks == 0 and not calls
    assert (gf8_cuda.launches, gf8_bytes_cuda.launches) == before


def test_monitor_and_mgr_default_to_cuda_and_refuse_cpu_fallback(
        monkeypatch):
    """The monitor and the mgr, asked for no device, want CUDA and raise
    without it; with a card they name it by index and put every map they
    take in on it."""
    from ceph_tpu_torch.cluster.mgr import MgrDaemon
    from ceph_tpu_torch.cluster.mon import Monitor
    from ceph_tpu_torch.osdmap.osdmap import build_simple_osdmap

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Monitor(build_simple_osdmap(8, 2, 16))
    with pytest.raises(RuntimeError, match="CUDA"):
        Monitor(build_simple_osdmap(8, 2, 16), device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        MgrDaemon(("127.0.0.1", 1))
    mon = Monitor(build_simple_osdmap(8, 2, 16), device="cpu")
    assert mon.device.type == mon.osdmap.device.type == "cpu"
    assert MgrDaemon(("127.0.0.1", 1), device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    mon = Monitor(build_simple_osdmap(8, 2, 16, device="cpu"))
    assert mon.device == mon.osdmap.device == torch.device("cuda", 0)
    assert MgrDaemon(("127.0.0.1", 1)).device == torch.device("cuda", 0)


def test_osd_client_and_cluster_default_to_cuda_and_refuse_cpu_fallback(
        monkeypatch):
    """An OSD, a client and ``start_cluster`` asked for no device want
    CUDA and raise without it (before any daemon starts); with a card they
    name it by index."""
    import asyncio

    from ceph_tpu_torch.cluster.objecter import RadosClient
    from ceph_tpu_torch.cluster.osd import OSDDaemon
    from ceph_tpu_torch.cluster.vstart import start_cluster

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (lambda **kw: OSDDaemon(0, ("127.0.0.1", 1), **kw),
                 lambda **kw: RadosClient(("127.0.0.1", 1), **kw)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
        with pytest.raises(RuntimeError, match="CUDA"):
            make(device="cuda")
    assert OSDDaemon(0, ("127.0.0.1", 1), device="cpu").device.type == "cpu"
    assert RadosClient(("127.0.0.1", 1),
                       device="cpu").objecter.device.type == "cpu"
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(asyncio.wait_for(start_cluster(3), 30))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert OSDDaemon(0, ("127.0.0.1", 1)).device == torch.device("cuda", 0)
    assert RadosClient(("127.0.0.1", 1)).objecter.device == \
        torch.device("cuda", 0)


def test_mds_clis_and_sidecar_default_to_cuda_and_refuse_cpu_fallback(
        monkeypatch):
    """An MDS rank, ``start_mds`` of a cluster that names no device, the
    ``rados`` and ``ceph`` CLIs and the EC sidecar, asked for no device,
    want CUDA and raise without it (before anything connects); with a
    card they name it by index."""
    import asyncio

    from ceph_tpu_torch.cluster.mds import MDSDaemon
    from ceph_tpu_torch.cluster.vstart import Cluster
    from ceph_tpu_torch.tools import ceph, rados
    from ceph_tpu_torch.tools.ec_sidecar import Sidecar
    from ceph_tpu_torch.utils import Config

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        MDSDaemon(("127.0.0.1", 1), 1, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        MDSDaemon(("127.0.0.1", 1), 1, 2, device="cuda")
    assert MDSDaemon(("127.0.0.1", 1), 1, 2,
                     device="cpu").device.type == "cpu"
    cluster = Cluster(mons=[], osds={}, mon_addrs=[("127.0.0.1", 1)],
                      config=Config())
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(cluster.start_mds(1, 2))
    assert not cluster.mdss
    for argv in (["--mon", "127.0.0.1:1", "lspools"],
                 ["--mon", "127.0.0.1:1", "-p", "p", "bench", "1"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            asyncio.run(rados._run(rados.parse_args(argv)))
    with pytest.raises(RuntimeError, match="CUDA"):
        asyncio.run(ceph._run(ceph.parse_args(["--mon", "127.0.0.1:1",
                                               "status"])))
    with pytest.raises(RuntimeError, match="CUDA"):
        Sidecar()
    assert Sidecar(device="cpu").device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    assert MDSDaemon(("127.0.0.1", 1), 1, 2).device == \
        torch.device("cuda", 0)
    assert Sidecar().device == torch.device("cuda", 0)


def test_start_mds_hands_the_clusters_device_to_the_rank(monkeypatch):
    """``start_mds`` builds its rank on the cluster's device, and the
    rank's own RADOS client on the rank's."""
    import asyncio

    from ceph_tpu_torch.cluster import objecter
    from ceph_tpu_torch.cluster.mds import MDSDaemon
    from ceph_tpu_torch.cluster.vstart import Cluster
    from ceph_tpu_torch.utils import Config

    seen = []

    async def start(self, host="127.0.0.1", port=0):
        seen.append(self.device)
        client = objecter.RadosClient(self.mon_addr, device=self.device)
        seen.append(client.objecter.device)
        return ("127.0.0.1", 9)

    monkeypatch.setattr(MDSDaemon, "start", start)
    cluster = Cluster(mons=[], osds={}, mon_addrs=[("127.0.0.1", 1)],
                      config=Config(), device=torch.device("cpu"))
    daemon = asyncio.run(cluster.start_mds(1, 2, rank=1))
    assert daemon.device.type == "cpu" and cluster.mdss == {1: daemon}
    assert [d.type for d in seen] == ["cpu", "cpu"]


def test_clients_leave_jax_and_reference_out():
    """A fresh process starts a CPU cluster, writes an RBD image on an EC
    pool, a CephFS file through an MDS and an RGW object, reads each
    back, and has imported neither JAX nor ``ceph_tpu``."""
    code = (
        "import asyncio, sys\n"
        "from ceph_tpu_torch.cluster.vstart import start_cluster\n"
        "from ceph_tpu_torch.cluster.rbd import RBD\n"
        "from ceph_tpu_torch.cluster.mds import MDSClient\n"
        "from ceph_tpu_torch.cluster.rgw import RGW\n"
        "from ceph_tpu_torch.cluster.rgw_http import RGWFrontend\n"
        "import ceph_tpu_torch.cluster.rgw_sync\n"
        "import ceph_tpu_torch.cluster.rbd_mirror\n"
        "import ceph_tpu_torch.tools.rados, ceph_tpu_torch.tools.ceph\n"
        "import ceph_tpu_torch.tools.objectstore_tool\n"
        "import ceph_tpu_torch.tools.ec_sidecar\n"
        "async def io():\n"
        "    c = await start_cluster(3, device='cpu')\n"
        "    try:\n"
        "        cl = await c.client()\n"
        "        ec = await cl.pool_create('ec', 'erasure', pg_num=4,"
        " ec_profile={'plugin': 'isa', 'k': '2', 'm': '1'})\n"
        "        rep = await cl.pool_create('rep', 'replicated', pg_num=4,"
        " size=2)\n"
        "        rbd = RBD(cl.ioctx(ec))\n"
        "        await rbd.create('img', 1 << 16, stripe_unit=8192,"
        " object_size=16384)\n"
        "        img = await rbd.open('img')\n"
        "        await img.write(1000, b'r' * 20000)\n"
        "        assert await img.read(1000, 20000) == b'r' * 20000\n"
        "        await c.start_mds(rep, ec)\n"
        "        for _ in range(400):\n"
        "            await cl.objecter._refresh_map()\n"
        "            if cl.objecter.osdmap.mds_addrs:\n"
        "                break\n"
        "            await asyncio.sleep(0.05)\n"
        "        assert c.mds.device.type == 'cpu'\n"
        "        fs = MDSClient(cl, ec, meta_pool=rep)\n"
        "        await fs.create('/f')\n"
        "        await fs.write('/f', 0, b'f' * 9000)\n"
        "        assert await fs.read('/f') == b'f' * 9000\n"
        "        rgw = RGW(cl.ioctx(rep))\n"
        "        await rgw.create_bucket('b')\n"
        "        await rgw.put_object('b', 'k', b'g' * 7000)\n"
        "        assert (await rgw.get_object('b', 'k'))[1] == b'g' * 7000\n"
        "    finally:\n"
        "        await c.stop()\n"
        "asyncio.run(asyncio.wait_for(io(), 90))\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'ceph_tpu' or m.startswith('ceph_tpu.')"
        " or m == 'google_crc32c']\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=150)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "clean"


class _Booted(Exception):
    pass


def _chaos_entry_points():
    import asyncio

    from ceph_tpu_torch.chaos.balance import elastic_scenarios, run_elastic
    from ceph_tpu_torch.chaos.frontdoor import (frontdoor_scenarios,
                                                run_frontdoor)
    from ceph_tpu_torch.tools import chaos as chaos_cli

    def run(coro):
        return asyncio.run(asyncio.wait_for(coro, 30))

    def cli(**kw):
        argv = ["run", "--scenario", "frontdoor-smoke", "--no-postmortem"]
        if "device" in kw:
            argv += ["--device", kw["device"]]
        rc = chaos_cli.main(argv)
        if rc == 2:
            raise RuntimeError("no CUDA card: the CLI exited 2")
        return rc

    fd = frontdoor_scenarios(1.0)["frontdoor-smoke"]
    el = elastic_scenarios(0.03)["expand-drain-smoke"]
    return {
        "run_frontdoor": lambda **kw: run(run_frontdoor(fd, 7, **kw)),
        "run_elastic": lambda **kw: run(run_elastic(el, 7, **kw)),
        "tools.chaos run": cli,
    }


@pytest.mark.parametrize("entry", ["run_frontdoor", "run_elastic",
                                   "tools.chaos run"])
def test_chaos_runners_and_cli_default_to_cuda_and_refuse_cpu_fallback(
        entry, monkeypatch):
    """With no ``device`` the cluster boots on the CUDA card; without a
    card the runner raises (the CLI exits 2) before it boots anything;
    ``device="cpu"`` boots on the CPU."""
    import ceph_tpu_torch.cluster.vstart as vstart

    booted = []

    async def fake_start(*args, device=None, **kwargs):
        booted.append(device)
        raise _Booted()

    monkeypatch.setattr(vstart, "start_cluster", fake_start)
    call = _chaos_entry_points()[entry]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
    assert booted == []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    with pytest.raises(_Booted):
        call()
    with pytest.raises(_Booted):
        call(device="cpu")
    assert booted == [torch.device("cuda", 0), torch.device("cpu")]

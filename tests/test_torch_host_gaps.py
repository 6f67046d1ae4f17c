"""The port's small host-side modules against ``ceph_tpu``'s.

- ``ops/checksum.py``: the published xxhash vectors, and ``calculate`` /
  ``verify`` equal to the reference's for every algorithm and block
  count, the crc32c batch path (eight blocks or more, through
  ``crc32c_batch`` on the checksummer's device) equal to the one-block
  path;
- ``ops/sloppy_crc.py``: the same write, read and truncate results;
- ``ec/registry.py``: ``remove`` and ``preload``;
- ``ops/gf8.py``: ``gf_div`` and ``gf_matmul`` with its counters;
- ``ops/profiling.py::device_loop_slope`` on the CPU: the return shape,
  the clamp and the ``t_<tag>`` counter.

Inputs are seeded numpy; every comparison is exact.
"""

import errno

import numpy as np
import pytest
import torch

from ceph_tpu.ec.registry import ErasureCodePluginRegistry as JRegistry
from ceph_tpu.ops import checksum as jchecksum
from ceph_tpu.ops import gf8 as jgf8
from ceph_tpu.ops.sloppy_crc import SloppyCRCMap as JSloppyCRCMap
from ceph_tpu_torch.ec.interface import ECError
from ceph_tpu_torch.ec.registry import ErasureCodePluginRegistry
from ceph_tpu_torch.ops import checksum, gf8, profiling
from ceph_tpu_torch.ops.sloppy_crc import SloppyCRCMap
from ceph_tpu_torch.utils.perf import KERNELS
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

ALGOS = ("none", "crc32c", "crc32c_16", "crc32c_8", "xxhash32", "xxhash64")


# ------------------------------------------------------------- checksum

def test_xxh32_known_vectors():
    assert checksum.xxhash32(b"") == 0x02CC5D05
    assert checksum.xxhash32(b"", seed=1) == 0x0B2CB792
    assert checksum.xxhash32(b"a") == 0x550D7456
    assert checksum.xxhash32(b"abc") == 0x32D153FF
    assert checksum.xxhash32(b"Hello, world!") == 0x31B7405D


def test_xxh64_known_vectors():
    assert checksum.xxhash64(b"") == 0xEF46DB3751D8E999
    assert checksum.xxhash64(b"a") == 0xD24EC4F1A98C6E5B
    assert checksum.xxhash64(b"abc") == 0x44BC2CF5AD770999


@pytest.mark.parametrize("n", [0, 1, 3, 17, 31, 32, 100, 1000])
def test_xxhash_equals_reference(n):
    data = np.random.default_rng(n).integers(0, 256, n, np.uint8).tobytes()
    for seed in (0, 7, 0xFFFFFFFF):
        assert checksum.xxhash32(data, seed) == \
            jchecksum.xxhash32(data, seed)
        assert checksum.xxhash64(data, seed) == \
            jchecksum.xxhash64(data, seed)


@pytest.mark.parametrize("blocks", [1, 4, 8, 16], ids=lambda b: f"{b}blk")
@pytest.mark.parametrize("algo", ALGOS)
def test_checksummer_equals_reference(algo, blocks):
    rng = np.random.default_rng(blocks)
    data = rng.integers(0, 256, 512 * blocks, dtype=np.uint8).tobytes()
    cs = checksum.Checksummer(algo, device="cpu")
    vec = cs.calculate(512, data)
    assert vec == jchecksum.Checksummer(algo).calculate(512, data)
    assert len(vec) == blocks * cs.VALUE_SIZE[algo]
    assert cs.verify(512, data, vec) is None
    bad = bytearray(data)
    bad[512 * (blocks - 1) + 5] ^= 0x40
    want = None if algo == "none" else 512 * (blocks - 1)
    assert cs.verify(512, bytes(bad), vec) == want == \
        jchecksum.Checksummer(algo).verify(512, bytes(bad), vec)


@pytest.mark.parametrize("algo", ["crc32c", "crc32c_16", "crc32c_8"])
def test_crc32c_batch_path_equals_one_block_path(algo):
    data = np.random.default_rng(1).integers(
        0, 256, 512 * 16, dtype=np.uint8).tobytes()
    cs = checksum.Checksummer(algo, device="cpu")
    calls = KERNELS.get("crc32c_batch_calls")
    batched = cs.calculate(512, data)          # 16 blocks -> batch path
    assert KERNELS.get("crc32c_batch_calls") == calls + 1
    one = b"".join(cs.calculate(512, data[i * 512:(i + 1) * 512])
                   for i in range(16))
    assert KERNELS.get("crc32c_batch_calls") == calls + 1
    assert batched == one


def test_checksummer_rejects_unknown_and_defaults_to_cuda(monkeypatch):
    with pytest.raises(ValueError):
        checksum.Checksummer("md5", device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        checksum.Checksummer("crc32c")


# ----------------------------------------------------------- sloppy crc

def test_sloppy_crc_map_equals_reference():
    rng = np.random.default_rng(5)
    maps = (SloppyCRCMap(4096), JSloppyCRCMap(4096))
    disk = bytearray(4096 * 12)
    recorded = mismatches = 0
    for _ in range(40):
        off = int(rng.integers(0, 4096 * 10))
        if rng.random() < 0.5:
            off -= off % 4096
        n = int(rng.integers(1, 4096 * 3))
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        disk[off:off + n] = data
        for m in maps:
            m.write(off, data)
        assert maps[0].crc == maps[1].crc
        r_off = int(rng.integers(0, 4096 * 8))
        view = bytearray(disk[r_off:r_off + 4096 * 3])
        if rng.random() < 0.5 and view:
            view[int(rng.integers(0, len(view)))] ^= 1
        got = maps[0].read(r_off, bytes(view))
        assert got == maps[1].read(r_off, bytes(view))
        recorded += len(maps[0].crc)
        mismatches += len(got)
        if rng.random() < 0.2:
            size = int(rng.integers(0, 4096 * 12))
            for m in maps:
                m.truncate(size)
            assert maps[0].crc == maps[1].crc
    assert recorded and mismatches


# ------------------------------------------------------------- registry

def test_registry_remove_and_preload():
    reg, jreg = ErasureCodePluginRegistry(), JRegistry()
    reg._register_builtins()
    jreg._register_builtins()
    for r in (reg, jreg):
        r.preload(["isa", "jerasure", "lrc", "shec"])
        r.add("extra", r.load("isa"))
        r.preload(["extra"])
        r.remove("extra")
        r.remove("never-registered")
    with pytest.raises(ECError) as e:
        reg.preload(["isa", "extra"])
    assert e.value.errno == errno.ENOENT
    with pytest.raises(Exception) as jerr:
        jreg.preload(["isa", "extra"])
    assert str(jerr.value) == str(e.value)
    assert "isa" in reg._factories and "extra" not in reg._factories


# ------------------------------------------------------------------ gf8

def test_gf_div_equals_reference():
    a = np.arange(256, dtype=np.uint8)
    for b in (1, 2, 3, 29, 142, 255):
        assert np.array_equal(gf8.gf_div(a, b), jgf8.gf_div(a, b))
        assert np.array_equal(gf8.gf_mul(gf8.gf_div(a, b), b), a)
    with pytest.raises(ZeroDivisionError):
        gf8.gf_div(3, 0)


@pytest.mark.parametrize("r,k,n", [(1, 1, 1), (4, 8, 100), (3, 5, 4096)])
def test_gf_matmul_equals_reference(r, k, n):
    rng = np.random.default_rng(r * k * n)
    m = rng.integers(0, 256, (r, k), dtype=np.uint8)
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    calls = KERNELS.get("gf8_matmul_calls")
    nbytes = KERNELS.get("gf8_matmul_bytes")
    got = gf8.gf_matmul(m, data, device="cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    assert KERNELS.get("gf8_matmul_calls") == calls + 1
    assert KERNELS.get("gf8_matmul_bytes") == nbytes + k * n
    want = np.asarray(jgf8.gf_matmul(m, data))
    assert np.array_equal(got.numpy(), want)
    assert np.array_equal(want, gf8.gf_matmul_ref(m, data))
    # a tensor runs on its own device
    assert torch.equal(gf8.gf_matmul(m, torch.from_numpy(data)), got)


# ----------------------------------------------------------------- timer

def test_device_loop_slope_on_the_cpu():
    data = torch.arange(4096, dtype=torch.int64)
    steps = []

    def step(d):
        steps.append(1)
        return d * 3

    def feedback(d, out):
        return d ^ (out & 1)

    KERNELS.reset()
    out = profiling.device_loop_slope(step, feedback, data, repeats=3,
                                      L1=4, L2=20, tag="unit_step")
    assert isinstance(out, tuple) and len(out) == 3
    med, best, worst = out
    assert all(isinstance(v, float) and v >= 1e-12 for v in out)
    assert best <= med <= worst
    # (1 warm + 3 timed) runs of each of L1 and L2 steps
    assert len(steps) == 4 * (4 + 20)
    entry = KERNELS.dump()["device_kernels"]["t_unit_step"]
    assert entry["avgcount"] == 1 and entry["last"] == med
    assert profiling.device_loop_slope(step, feedback, data, repeats=1,
                                       L1=2, L2=3) is not None
    assert KERNELS.dump()["device_kernels"]["t_unit_step"]["avgcount"] == 1


def test_device_loop_slope_clamps_at_1e_12(monkeypatch):
    """A slope driven to or below 0 by noise is clamped, never negative."""
    # a clock that never moves: every sample is 0 s
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: 1.0)
    data = torch.zeros(4)
    med, best, worst = profiling.device_loop_slope(
        lambda d: d, lambda d, o: d, data, repeats=2, L1=1, L2=5, tag="flat")
    assert (med, best, worst) == (1e-12, 1e-12, 1e-12)
    assert KERNELS.dump()["device_kernels"]["t_flat"]["last"] == 1e-12

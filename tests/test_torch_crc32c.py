"""The port's crc32c against the JAX package, bit for bit.

Host path: the port's numpy table path against ``ceph_tpu.ops.crc32c``
(which may use google_crc32c here).  Device formula: the torch matmul
versions of ``crc32c_batch``/``crc32c_rows``/``crc32c_planar_rows``,
forced on CPU tensors, against the reference's CRCs.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ec import planar_store as jpstore
from ceph_tpu.ops import crc32c as jcrc
from ceph_tpu_torch.ops import crc32c as crc
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

LENGTHS = [0, 1, 7, 100, 4096, 5000, 9000]


@pytest.mark.parametrize("length", LENGTHS)
def test_host_crc32c_equal_reference(length):
    data = np.random.default_rng(length).integers(
        0, 256, length, dtype=np.uint8).tobytes()
    for seed in (0, 0xFFFFFFFF, 0x1234ABCD):
        assert crc.crc32c(seed, data) == jcrc.crc32c(seed, data)
    assert crc.crc32c(5, None, length) == jcrc.crc32c(5, None, length)
    assert crc.crc32c_zeros(77, length) == jcrc.crc32c_zeros(77, length)
    a, b = data[: length // 2], data[length // 2:]
    assert crc.crc32c_combine(crc.crc32c(0, a), crc.crc32c(0, b), len(b)) \
        == crc.crc32c(0, data)


def test_message_bitmat_equal_reference():
    assert np.array_equal(crc._message_bitmat(24), jcrc._message_bitmat(24))


@pytest.mark.parametrize("block", [1, 2, 3, 8, 255, 256, 2048, 4097])
def test_message_bitmat_by_doubling_equals_reference(block):
    """The port builds the matrix over the bits of the length (doubling
    and one-byte steps); the reference steps one byte at a time."""
    assert np.array_equal(crc._message_bitmat(block),
                          jcrc._message_bitmat(block))


@pytest.mark.parametrize("seed", [0, 0xFFFFFFFF])
def test_crc32c_batch_equal_reference(seed):
    data = np.random.default_rng(1).integers(0, 256, (6, 40), dtype=np.uint8)
    got = crc.crc32c_batch(torch.from_numpy(data), seed=seed).numpy()
    want = np.asarray(jcrc.crc32c_batch(jnp.asarray(data), seed=seed))
    assert np.array_equal(got.astype(np.uint32), want)
    assert [int(c) for c in got] == [jcrc.crc32c(seed, r.tobytes())
                                     for r in data]


@pytest.mark.parametrize("device_formula", [True, False])
@pytest.mark.parametrize("length", [0, 64, 512, 1024, 1000])
def test_crc32c_rows_equal_reference(length, device_formula):
    rows = np.random.default_rng(length).integers(0, 256, (5, length),
                                                  dtype=np.uint8)
    got = crc.crc32c_rows(torch.from_numpy(rows), block=64,
                          device_formula=device_formula)
    want = [jcrc.crc32c(0xFFFFFFFF, r.tobytes()) for r in rows]
    assert got == want
    assert got == jcrc.crc32c_rows(rows)


@pytest.mark.parametrize("cols,dev_max", [(0, None), (8, None), (64, None),
                                          (512, 256), (100, None)])
def test_crc32c_planar_rows_equal_reference(cols, dev_max, monkeypatch):
    if dev_max is not None:
        # shards longer than the cap take the host-spread design, whose
        # spread streams still go through the device formula
        monkeypatch.setattr(crc, "_PLANAR_DEV_MAX", dev_max)
    planes = np.random.default_rng(cols).integers(0, 256, (3 * 8, cols),
                                                  dtype=np.uint8)
    want = jcrc.crc32c_planar_rows(planes)
    anchor = [jcrc.crc32c(0xFFFFFFFF, jpstore.planes_to_shard(
        planes[g * 8:(g + 1) * 8])) for g in range(3)]
    assert want == anchor
    t = torch.from_numpy(planes)
    assert crc.crc32c_planar_rows(t, device_formula=True) == want
    assert crc.crc32c_planar_rows(t) == want
    assert crc.crc32c_planar_rows(planes, seed=0) == \
        jcrc.crc32c_planar_rows(planes, seed=0)


def test_planar_rows_rejects_ragged_groups():
    with pytest.raises(ValueError):
        crc.crc32c_planar_rows(np.zeros((7, 8), dtype=np.uint8))

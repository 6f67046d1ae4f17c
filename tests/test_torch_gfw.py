"""The port's GF(2^w) word-layout device functions against the JAX package.

``ceph_tpu_torch.ops.gfw``'s device half runs on CPU tensors (the plain
PyTorch ops the card runs too), ``ceph_tpu.ops.gfw`` on JAX-CPU.  Inputs
are seeded numpy; every comparison is exact (tolerance 0, GF arithmetic):
each function at w=8, 16 and 32, the round trips of both layouts, and the
planar matmul on wide-field planes against the byte-layout matmul.
"""

import numpy as np
import pytest
import torch

from ceph_tpu.ops import gfw as jgfw
from ceph_tpu_torch.ops import gf8, gfw
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

WIDTHS = [8, 16, 32]


def _rng(w, salt=0):
    return np.random.default_rng(1000 * w + salt)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("w", WIDTHS)
def test_unpack_and_pack_bits_w_equal_reference(w):
    wb = w // 8
    data = _rng(w).integers(0, 256, (3, 7 * wb), dtype=np.uint8)
    bits = gfw.unpack_bits_w(torch.from_numpy(data), wb)
    ref = np.asarray(jgfw.unpack_bits_w(data, wb))
    assert bits.shape == ref.shape == (3 * w, 7)
    assert np.array_equal(_np(bits), ref)
    packed = gfw.pack_bits_w(bits, wb)
    assert np.array_equal(_np(packed), np.asarray(jgfw.pack_bits_w(ref, wb)))
    assert np.array_equal(_np(packed), data)


@pytest.mark.parametrize("w", WIDTHS)
def test_bitmatrix_matmul_w_equal_reference(w):
    wb = w // 8
    rng = _rng(w, 1)
    bm = rng.integers(0, 2, (2 * w, 3 * w), dtype=np.uint8)
    data = rng.integers(0, 256, (3, 40 * wb), dtype=np.uint8)
    got = gfw.bitmatrix_matmul_w(bm, torch.from_numpy(data), wb)
    assert np.array_equal(_np(got),
                          np.asarray(jgfw.bitmatrix_matmul_w(bm, data, wb)))


def test_bitmatrix_matmul_w_column_chunks_agree(monkeypatch):
    """A budget that forces several column passes gives the same bytes."""
    rng = _rng(16, 2)
    bm = rng.integers(0, 2, (32, 48), dtype=np.uint8)
    data = torch.from_numpy(rng.integers(0, 256, (3, 202), dtype=np.uint8))
    whole = gfw.bitmatrix_matmul_w(bm, data, 2)
    monkeypatch.setattr(gf8, "_UNPACKED_BUDGET", 4 * 3 * 16 * 7)
    assert torch.equal(gfw.bitmatrix_matmul_w(bm, data, 2), whole)


@pytest.mark.parametrize("w", WIDTHS)
def test_encode_batch_w_equal_reference(w):
    wb = w // 8
    rng = _rng(w, 3)
    bm = rng.integers(0, 2, (2 * w, 4 * w), dtype=np.uint8)
    batch = rng.integers(0, 256, (5, 4, 6 * wb), dtype=np.uint8)
    got = gfw.encode_batch_w(bm, torch.from_numpy(batch), wb)
    assert np.array_equal(_np(got),
                          np.asarray(jgfw.encode_batch_w(bm, batch, wb)))


@pytest.mark.parametrize("w", WIDTHS)
def test_bytes_to_planar_w_round_trip_equal_reference(w):
    data = _rng(w, 4).integers(0, 256, (3, 5 * w), dtype=np.uint8)
    planes = gfw.bytes_to_planar_w(torch.from_numpy(data), w)
    ref = np.asarray(jgfw.bytes_to_planar_w(data, w))
    assert planes.shape == ref.shape == (3 * w, 5)
    assert np.array_equal(_np(planes), ref)
    back = gfw.planar_to_bytes_w(planes, w)
    assert np.array_equal(_np(back),
                          np.asarray(jgfw.planar_to_bytes_w(ref, w)))
    assert np.array_equal(_np(back), data)


def test_bytes_to_planar_w_rejects_partial_words():
    with pytest.raises(ValueError):
        gfw.bytes_to_planar_w(torch.zeros((1, 24), dtype=torch.uint8), 16)


@pytest.mark.parametrize("w", [16, 32])
def test_planar_matmul_on_wide_planes_equals_byte_matmul(w):
    """B1's plain version on (r*w, k*w) bit-matrices and wide planes gives
    the bytes of the word-layout matmul: the planar path serves every w."""
    wb = w // 8
    rng = _rng(w, 5)
    coding = rng.integers(0, 1 << 16, (2, 3)).astype(np.uint64)
    bm = gfw.expand_bitmatrix_w(coding, w)
    data = rng.integers(0, 256, (3, 4 * w), dtype=np.uint8)
    planes = gfw.bytes_to_planar_w(torch.from_numpy(data), w)
    out = gf8.planar_matmul(torch.from_numpy(bm), planes)
    assert np.array_equal(
        _np(gfw.planar_to_bytes_w(out, w)),
        _np(gfw.bitmatrix_matmul_w(bm, torch.from_numpy(data), wb)))

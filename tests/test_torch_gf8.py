"""The port's GF(2^8) substrate against the JAX package, bit for bit.

Same seeded numpy inputs through ``ceph_tpu.ops.gf8`` on JAX-CPU and
``ceph_tpu_torch.ops.gf8`` on the CPU (the plain versions of the port's
kernels).  Tolerance 0 everywhere: this is integer GF arithmetic.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ceph_tpu.ec import matrices as jmatrices
from ceph_tpu.ops import gf8 as jgf8
from ceph_tpu_torch.ops import gf8, gf8_cuda
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

# the ragged planar shapes of the TPU kernel check (k, m, packed columns)
PLANAR_SHAPES = [(8, 4, 2048 * 3), (8, 4, 2048 * 2 + 100), (4, 2, 5000),
                 (10, 4, 2048), (2, 1, 2048), (3, 2, 1), (8, 4, 7)]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_tables_equal_reference():
    assert np.array_equal(gf8.GF_EXP, jgf8.GF_EXP)
    assert np.array_equal(gf8.GF_LOG, jgf8.GF_LOG)
    assert np.array_equal(gf8.GF_MUL, jgf8.GF_MUL)
    assert np.array_equal(gf8.GF_BITMAT, jgf8.GF_BITMAT)
    a = np.arange(1, 256, dtype=np.uint8)
    assert np.array_equal(gf8.gf_inv(a), jgf8.gf_inv(a))
    with pytest.raises(ZeroDivisionError):
        gf8.gf_inv(0)


@pytest.mark.parametrize("seed", range(4))
def test_expand_invert_matmul_equal_reference(seed):
    rng = np.random.default_rng(seed)
    m = rng.integers(0, 256, (5, 7), dtype=np.uint8)
    assert np.array_equal(gf8.expand_bitmatrix(m), jgf8.expand_bitmatrix(m))
    d = rng.integers(0, 256, (7, 33), dtype=np.uint8)
    assert np.array_equal(gf8.gf_matmul_ref(m, d), jgf8.gf_matmul_ref(m, d))
    # survivor submatrices of an ISA generator invert identically
    gen = jmatrices.generator_matrix(jmatrices.isa_rs_matrix(4, 3))
    rows = sorted(rng.choice(7, size=4, replace=False).tolist())
    assert np.array_equal(gf8.gf_invert_matrix(gen[rows]),
                          jgf8.gf_invert_matrix(gen[rows]))


def test_singular_matrix_raises_like_reference():
    sing = np.array([[1, 2], [1, 2]], dtype=np.uint8)
    with pytest.raises(jgf8.SingularMatrixError):
        jgf8.gf_invert_matrix(sing)
    with pytest.raises(gf8.SingularMatrixError):
        gf8.gf_invert_matrix(sing)


@pytest.mark.parametrize("c,length", [(1, 8), (3, 64), (12, 520)])
def test_bytes_planar_roundtrip_equal_reference(c, length):
    data = np.random.default_rng(c).integers(0, 256, (c, length),
                                             dtype=np.uint8)
    planes = gf8.bytes_to_planar(_t(data)).numpy()
    assert np.array_equal(planes,
                          np.asarray(jgf8.bytes_to_planar(jnp.asarray(data))))
    back = gf8.planar_to_bytes(_t(planes)).numpy()
    assert np.array_equal(back, data)
    assert np.array_equal(
        back, np.asarray(jgf8.planar_to_bytes(jnp.asarray(planes))))


def test_planar_bit_order_is_lsb_first():
    """planar[j*8 + t, i] bit u == bit t of data[j, 8i + u]."""
    data = np.zeros((2, 16), dtype=np.uint8)
    data[1, 8 + 3] = 1 << 5          # chunk 1, byte 8i+u with i=1, u=3; t=5
    planes = gf8.bytes_to_planar(_t(data)).numpy()
    expect = np.zeros((16, 2), dtype=np.uint8)
    expect[1 * 8 + 5, 1] = 1 << 3
    assert np.array_equal(planes, expect)


@pytest.mark.parametrize("k,m,npk", PLANAR_SHAPES)
def test_planar_matmul_plain_equal_reference(k, m, npk):
    rng = np.random.default_rng(11)
    bm = jgf8.expand_bitmatrix(jmatrices.isa_rs_matrix(k, m))
    planes = rng.integers(0, 256, (k * 8, npk), dtype=np.uint8)
    want = np.asarray(jgf8.planar_matmul_xla(jnp.asarray(bm),
                                             jnp.asarray(planes)))
    before = gf8_cuda.launches
    got = gf8.planar_matmul(_t(bm), _t(planes)).numpy()
    assert np.array_equal(got, want)
    assert gf8_cuda.planar_matmul_ref(_t(bm), _t(planes)).numpy().tobytes() \
        == want.tobytes()
    # a CPU tensor never reaches the CUDA kernel
    assert gf8_cuda.launches == before


def test_planar_matmul_plain_column_chunks(monkeypatch):
    """The plain version's column chunking (the budget that keeps the
    unpacked bits small on the card) changes no byte."""
    rng = np.random.default_rng(3)
    bm = rng.integers(0, 2, (40, 24), dtype=np.uint8)
    planes = rng.integers(0, 256, (24, 1001), dtype=np.uint8)
    whole = gf8_cuda.planar_matmul_ref(_t(bm), _t(planes)).numpy()
    monkeypatch.setattr(gf8_cuda, "_UNPACKED_BUDGET", 24 * 32 * 100)
    assert np.array_equal(
        gf8_cuda.planar_matmul_ref(_t(bm), _t(planes)).numpy(), whole)
    assert np.array_equal(
        whole, np.asarray(jgf8.planar_matmul_xla(jnp.asarray(bm),
                                                 jnp.asarray(planes))))


@pytest.mark.parametrize("budget", [None, 32 * 5 * 50])
def test_bitmatrix_matmul_equal_reference(budget, monkeypatch):
    if budget is not None:
        monkeypatch.setattr(gf8, "_UNPACKED_BUDGET", budget)
    rng = np.random.default_rng(5)
    mat = rng.integers(0, 256, (3, 5), dtype=np.uint8)
    bm = jgf8.expand_bitmatrix(mat)
    data = rng.integers(0, 256, (5, 777), dtype=np.uint8)
    want = np.asarray(jgf8.bitmatrix_matmul(jnp.asarray(bm),
                                            jnp.asarray(data)))
    got = gf8.bitmatrix_matmul(bm, _t(data)).numpy()
    assert np.array_equal(got, want)
    assert np.array_equal(got, jgf8.gf_matmul_ref(mat, data))


def test_unpack_pack_bits_equal_reference():
    data = np.random.default_rng(9).integers(0, 256, (4, 50), dtype=np.uint8)
    bits = gf8.unpack_bits(_t(data)).numpy()
    assert np.array_equal(bits, np.asarray(jgf8.unpack_bits(
        jnp.asarray(data))).astype(np.uint8))
    assert np.array_equal(gf8.pack_bits(_t(bits)).numpy(), data)
    assert np.array_equal(
        np.asarray(jgf8.pack_bits(jnp.asarray(bits))), data)

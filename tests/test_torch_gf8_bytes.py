"""Kernel B2's plain version and wrapper against the JAX package.

``ceph_tpu_torch.ops.gf8_bytes_cuda.bitmatrix_matmul`` on CPU tensors is
the plain version of the Hopper kernel; it must equal JAX
``gf8.bitmatrix_matmul`` (the Pallas kernel's own plain reference) and,
on a few shapes, the Pallas kernel ``gf8_pallas._kernel`` itself run in
interpret mode.  Shapes: the general ISA bit-matrices the TPU kernel was
validated with (``scripts/tpu_checks.py:32-33``) and the lane-expanded
packet matrices of the jerasure slice.  Tolerance 0 (GF(2) arithmetic).
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl

from ceph_tpu.ec import matrices as jmatrices
from ceph_tpu.ops import gf8 as jgf8
from ceph_tpu.ops import gf8_pallas as jpallas
from ceph_tpu_torch.ec import factory
from ceph_tpu_torch.ec.codec import _lane_expand
from ceph_tpu_torch.ops import gf8_bytes_cuda

# the TPU kernel's check shapes (k, m, N)
TPU_CHECK_SHAPES = [(8, 4, 16384 * 3), (8, 4, 16384 * 2 + 1000),
                    (4, 2, 5000), (10, 4, 16384)]

LANE_PROFILES = {
    "cauchy_good-k8m4": {"technique": "cauchy_good", "k": "8", "m": "4"},
    "cauchy_orig-k4m2-w16": {"technique": "cauchy_orig", "k": "4", "m": "2",
                             "w": "16"},
    "liberation-k7w7": {"technique": "liberation", "k": "7", "w": "7"},
    "blaum_roth-k6w6": {"technique": "blaum_roth", "k": "6", "w": "6"},
    "liber8tion-k8": {"technique": "liber8tion", "k": "8"},
}


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _jax_ref(bm, data):
    return np.asarray(jgf8.bitmatrix_matmul(jnp.asarray(bm),
                                            jnp.asarray(data)))


def _pallas_interpret(bm, data, tile=512):
    """The TPU kernel ``gf8_pallas._kernel`` on the CPU in interpret mode,
    driven as ``gf8_pallas._matmul_tiled`` drives it (bit-major matrix,
    column tiles), with a tile small enough for the CPU."""
    rw, kw = bm.shape
    k, r = kw // 8, rw // 8
    rowp, colp = jpallas._bitmajor_perm(rw, kw)
    bm_bm = jnp.asarray(bm)[rowp][:, colp].astype(jnp.int8)
    n = data.shape[1]
    return np.asarray(pl.pallas_call(
        functools.partial(jpallas._kernel, k=k, r=r),
        out_shape=jax.ShapeDtypeStruct((r, n), jnp.uint8),
        grid=(n // tile,),
        in_specs=[pl.BlockSpec((rw, kw), lambda i: (0, 0)),
                  pl.BlockSpec((k, tile), lambda i: (0, i))],
        out_specs=pl.BlockSpec((r, tile), lambda i: (0, i)),
        interpret=True)(bm_bm, jnp.asarray(data)))


def _lane(profile):
    codec = factory({"plugin": "jerasure", "packetsize": "8", **profile},
                    device="cpu")
    return codec, codec._lane(codec._encode_bits())


@pytest.mark.parametrize("k,m,n", TPU_CHECK_SHAPES)
def test_plain_equals_reference_on_tpu_check_shapes(k, m, n):
    rng = np.random.default_rng(7)
    bm = jgf8.expand_bitmatrix(jmatrices.isa_rs_matrix(k, m))
    data = rng.integers(0, 256, (k, n), dtype=np.uint8)
    before = gf8_bytes_cuda.launches
    got = gf8_bytes_cuda.bitmatrix_matmul(_t(bm), _t(data)).numpy()
    assert np.array_equal(got, _jax_ref(bm, data))
    assert np.array_equal(got, jgf8.gf_matmul_ref(jmatrices.isa_rs_matrix(k, m),
                                                  data))
    # a CPU tensor never reaches the CUDA kernel
    assert gf8_bytes_cuda.launches == before


@pytest.mark.parametrize("name", sorted(LANE_PROFILES))
def test_plain_equals_reference_on_lane_matrices(name):
    codec, lane = _lane(LANE_PROFILES[name])
    m01 = codec._encode_bits()
    assert np.array_equal(lane.numpy(),
                          np.kron(m01, np.eye(8, dtype=np.uint8)))
    rng = np.random.default_rng(len(name))
    data = rng.integers(0, 256, (m01.shape[1], 3000), dtype=np.uint8)
    got = gf8_bytes_cuda.bitmatrix_matmul(lane, _t(data)).numpy()
    assert np.array_equal(got, _jax_ref(lane.numpy(), data))
    # a lane matrix is the XOR of the data rows m01 selects
    want = np.zeros((m01.shape[0], 3000), dtype=np.uint8)
    for r in range(m01.shape[0]):
        for c in np.nonzero(m01[r])[0]:
            want[r] ^= data[c]
    assert np.array_equal(got, want)


@pytest.mark.parametrize("case", ["isa-k8m4", "cauchy_good-k8m4-lane"])
def test_plain_equals_pallas_kernel_in_interpret_mode(case):
    rng = np.random.default_rng(3)
    if case == "isa-k8m4":
        bm = jgf8.expand_bitmatrix(jmatrices.isa_rs_matrix(8, 4))
    else:
        bm = _lane(LANE_PROFILES["cauchy_good-k8m4"])[1].numpy()
    data = rng.integers(0, 256, (bm.shape[1] // 8, 1024), dtype=np.uint8)
    got = gf8_bytes_cuda.bitmatrix_matmul(_t(bm), _t(data)).numpy()
    assert np.array_equal(got, _pallas_interpret(bm, data))


@pytest.mark.parametrize("n", [1, 7, 4097])
def test_plain_takes_ragged_and_misaligned_slices(n):
    """A column slice of a packet-row matrix: rows start off any word
    boundary and the row stride is not N."""
    rng = np.random.default_rng(n)
    bm = rng.integers(0, 2, (40, 48), dtype=np.uint8)
    big = rng.integers(0, 256, (6, n + 11), dtype=np.uint8)
    view = _t(big)[:, 3:3 + n]
    assert view.stride(0) == n + 11 and view.storage_offset() == 3
    got = gf8_bytes_cuda.bitmatrix_matmul(_t(bm), view).numpy()
    assert np.array_equal(got, _jax_ref(bm, big[:, 3:3 + n]))


def test_lane_expand_is_cached_per_matrix_and_device():
    m01 = np.eye(3, 4, dtype=np.uint8)
    a = _lane_expand(m01.tobytes(), m01.shape, torch.device("cpu"))
    b = _lane_expand(m01.tobytes(), m01.shape, torch.device("cpu"))
    assert a is b
    assert a.dtype == torch.uint8 and tuple(a.shape) == (24, 32)

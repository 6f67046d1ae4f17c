"""Kernel B2's plain version and wrapper against the JAX package.

``ceph_tpu_torch.ops.gf8_bytes_cuda.bitmatrix_matmul`` on CPU tensors is
the plain version of the Hopper kernel; it must equal JAX
``gf8.bitmatrix_matmul`` (the Pallas kernel's own plain reference) and,
on a few shapes, the Pallas kernel ``gf8_pallas._kernel`` itself run in
interpret mode.  Shapes: the general ISA bit-matrices the TPU kernel was
validated with (``scripts/tpu_checks.py:32-33``) and the lane-expanded
packet matrices of the jerasure slice.  Tolerance 0 (GF(2) arithmetic).

The kernel's table (``pack_blocks``: block words and zero/identity/general
classes, packed on the host and cached per matrix by the codec) is held
against a plain bit-by-bit packing, and the ``blocks`` argument against
the call without it.
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
from ceph_tpu_torch.ec.codec import _lane_blocks, _lane_expand
from ceph_tpu_torch.ops import gf8_bytes_cuda
from tests._torch_threads import _one_torch_thread  # noqa: F401  (fixture)

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


def _plain_pack(bm):
    """The kernel's table written out block by block and bit by bit."""
    r, k = bm.shape[0] // 8, bm.shape[1] // 8
    words = []
    for j in range(r):
        for i in range(k):
            c = 0
            for t in range(8):
                for u in range(8):
                    c |= int(bm[8 * j + t, 8 * i + u] & 1) << (8 * u + t)
            words.append(c)
    classes = []
    for g in range(-(-r // 32)):
        for i in range(k):
            ident = general = 0
            for jj in range(min(32, r - 32 * g)):
                c = words[(32 * g + jj) * k + i]
                if c == gf8_bytes_cuda._IDENTITY:
                    ident |= 1 << jj
                elif c:
                    general |= 1 << jj
            classes.append(ident | general << 32)
    return np.array(words + classes, dtype=np.uint64)


def _mixed_matrix(r, k, seed):
    """(8r, 8k) bits with zero, identity and general blocks, r > 32."""
    rng = np.random.default_rng(seed)
    bm = rng.integers(0, 2, (8 * r, 8 * k), dtype=np.uint8)
    kind = rng.integers(0, 3, (r, k))
    for j, i in zip(*np.nonzero(kind == 0)):
        bm[8 * j:8 * j + 8, 8 * i:8 * i + 8] = 0
    for j, i in zip(*np.nonzero(kind == 1)):
        bm[8 * j:8 * j + 8, 8 * i:8 * i + 8] = np.eye(8, dtype=np.uint8)
    return bm


PACK_CASES = ([f"lane:{name}" for name in sorted(LANE_PROFILES)]
              + [f"isa:k{k}m{m}" for k, m, _n in TPU_CHECK_SHAPES]
              + ["mixed:r40k5", "mixed:r64k3"])


def _pack_case(case):
    kind, name = case.split(":")
    if kind == "lane":
        return _lane(LANE_PROFILES[name])[1].numpy()
    if kind == "isa":
        k, m = (int(x) for x in name[1:].split("m"))
        return jgf8.expand_bitmatrix(jmatrices.isa_rs_matrix(k, m))
    r, k = (int(x) for x in name[1:].split("k"))
    return _mixed_matrix(r, k, r * k)


@pytest.mark.parametrize("case", PACK_CASES)
def test_host_packed_table_equals_plain_packing(case):
    bm = _pack_case(case)
    r, k = bm.shape[0] // 8, bm.shape[1] // 8
    got = gf8_bytes_cuda.pack_blocks(bm)
    assert got.dtype == np.int64
    assert got.shape == (gf8_bytes_cuda.table_len(r, k),)
    assert np.array_equal(got.view(np.uint64), _plain_pack(bm))
    words = got[:r * k].view(np.uint64)
    if case.startswith("lane:"):
        # kron(m01, I8): every block is zero or the identity
        assert set(np.unique(words).tolist()) <= {0, gf8_bytes_cuda._IDENTITY}
        assert not np.any(got[r * k:].view(np.uint64) >> np.uint64(32))


@pytest.mark.parametrize("case", ["cauchy_good-k8m4", "liberation-k7w7"])
def test_lane_blocks_are_cached_per_matrix_and_device(case):
    codec, lane = _lane(LANE_PROFILES[case])
    m01 = np.ascontiguousarray(codec._encode_bits())
    key = (m01.tobytes(), m01.shape, torch.device("cpu"))
    a = _lane_blocks(*key)
    assert a is _lane_blocks(*key)
    assert codec._lane_and_blocks(m01)[1] is a
    assert codec._lane_and_blocks(m01)[0] is lane
    assert np.array_equal(a.numpy(), gf8_bytes_cuda.pack_blocks(lane.numpy()))
    other = np.ascontiguousarray(m01[:-1])
    assert _lane_blocks(other.tobytes(), other.shape,
                        torch.device("cpu")) is not a


@pytest.mark.parametrize("blocks", ["packed", "short", "long", "int32",
                                    "2-d"])
def test_blocks_argument_on_cpu(blocks):
    """``blocks`` changes nothing on the CPU and a wrong table raises."""
    rng = np.random.default_rng(11)
    bm = _mixed_matrix(40, 6, 5)
    data = _t(rng.integers(0, 256, (6, 777), dtype=np.uint8))
    table = torch.from_numpy(gf8_bytes_cuda.pack_blocks(bm))
    bad = {"short": table[:-1], "long": torch.cat([table, table[:1]]),
           "int32": table.to(torch.int32), "2-d": table[None]}
    if blocks == "packed":
        got = gf8_bytes_cuda.bitmatrix_matmul(_t(bm), data, table)
        assert torch.equal(got, gf8_bytes_cuda.bitmatrix_matmul(_t(bm), data))
        assert np.array_equal(got.numpy(), _jax_ref(bm, data.numpy()))
        return
    with pytest.raises(ValueError, match="blocks"):
        gf8_bytes_cuda.bitmatrix_matmul(_t(bm), data, bad[blocks])

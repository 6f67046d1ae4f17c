"""crc32c (Castagnoli): host table path and batched torch device path.

Counterpart of ``ceph_tpu/ops/crc32c.py``.  Semantics are the reference's
ceph_crc32c (src/include/crc32c.h:43, src/common/sctp_crc32.c): a raw
reflected CRC-32C update from a caller seed, with NO pre/post inversion,
and data=None meaning "length zero bytes" (src/common/crc32c.cc:214-239).

The host side is the reference package's numpy table path.  The device
side uses that CRC is GF(2)-linear in the message bits,
``update(seed, m) = update(seed, 0^len) ^ L(m)``, so a batch of
fixed-size blocks is one GF(2) bit-matrix matmul (``gf8.bitmatrix_matmul``,
a float32 ``torch.matmul`` on 0/1 operands: every sum is at most
8 * 32768 < 2**24, so it is exact).  The JAX package sends those matmuls
to XLA; their port is torch ops.  Message matrices are cached on the
device per block length.

Engine choice: a CUDA tensor always takes the device formula (the JAX
package's "hardware crc32c present -> host" shortcut is not taken); a
CPU tensor or numpy array takes the host table path unless the caller
forces the device formula with ``device_formula=True``.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch

from ceph_tpu_torch.ops import gf8
from ceph_tpu_torch.utils.perf import KERNELS

CRC32C_POLY_REFLECTED = 0x82F63B78


def _build_table():
    tbl = np.zeros(256, dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (CRC32C_POLY_REFLECTED if c & 1 else 0)
        tbl[i] = c
    return tbl


CRC_TABLE = _build_table()

# ---------------------------------------------------------------------------
# GF(2) 32x32 matrix algebra (matrices as 32 uint32 columns)
# ---------------------------------------------------------------------------


def _mat_vec(m: np.ndarray, v: int) -> int:
    out = 0
    vv = int(v)
    j = 0
    while vv:
        if vv & 1:
            out ^= int(m[j])
        vv >>= 1
        j += 1
    return out


def _mat_mat(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(a . b)[j] = a . b[j]; vectorized column combine."""
    bits = (b[:, None] >> np.arange(32)[None, :]) & 1
    sel = np.where(bits.astype(bool), a[None, :], 0)
    return np.bitwise_xor.reduce(sel, axis=1).astype(np.uint32)


def _identity():
    return (np.uint32(1) << np.arange(32)).astype(np.uint32)


def _zero_byte_op():
    """A_1: one zero-byte update, crc' = (crc >> 8) ^ tbl[crc & 0xff]."""
    cols = np.zeros(32, dtype=np.uint32)
    for j in range(32):
        e = 1 << j
        cols[j] = ((e >> 8) ^ int(CRC_TABLE[e & 0xFF])) & 0xFFFFFFFF
    return cols


_A1 = _zero_byte_op()


@functools.lru_cache(maxsize=256)
def _zeros_op(length: int) -> bytes:
    """A_1^length, cached (returned as bytes for hashability)."""
    result = _identity()
    sq = _A1.copy()
    n = length
    while n:
        if n & 1:
            result = _mat_mat(sq, result)
        sq = _mat_mat(sq, sq)
        n >>= 1
    return result.tobytes()


def _zeros_mat(length: int) -> np.ndarray:
    return np.frombuffer(_zeros_op(length), dtype=np.uint32)


# ---------------------------------------------------------------------------
# Host path
# ---------------------------------------------------------------------------


def crc32c(crc: int, data: Optional[bytes], length: Optional[int] = None) -> int:
    """ceph_crc32c semantics: raw update from seed; data=None means zeros."""
    crc &= 0xFFFFFFFF
    if data is None:
        if not length:
            return crc
        return crc32c_zeros(crc, length)
    buf = np.frombuffer(memoryview(data), dtype=np.uint8)
    if length is not None:
        buf = buf[:length]
    if len(buf) == 0:
        return crc
    # block-parallel: split into lanes, CRC each lane vectorized bytewise,
    # then combine with the zero-extension operator
    lane = 4096
    if len(buf) <= lane:
        c = np.uint32(crc)
        for b in buf:
            c = CRC_TABLE[(c ^ b) & np.uint32(0xFF)] ^ (c >> np.uint32(8))
        return int(c)
    n_full = len(buf) // lane
    blocks = buf[: n_full * lane].reshape(n_full, lane)
    cs = np.zeros(n_full, dtype=np.uint32)
    for i in range(lane):
        cs = CRC_TABLE[(cs ^ blocks[:, i]) & np.uint32(0xFF)] ^ (cs >> np.uint32(8))
    total = crc
    for c in cs:
        total = crc32c_zeros(total, lane) ^ int(c)
    tail = buf[n_full * lane:]
    if len(tail):
        total = crc32c(total, tail.tobytes())
    return total & 0xFFFFFFFF


def crc32c_zeros(crc: int, length: int) -> int:
    """CRC across `length` zero bytes (reference crc32c.cc:214)."""
    return _mat_vec(_zeros_mat(length), crc)


def crc32c_combine(crc_a: int, crc_b: int, len_b: int) -> int:
    """CRC of a||b from crc(a) and crc(b) (b seeded with 0)."""
    return crc32c_zeros(crc_a, len_b) ^ crc_b


def _matvec_rows(m: np.ndarray, v: np.ndarray) -> np.ndarray:
    """The GF(2) 32x32 operator applied to a VECTOR of crc words."""
    bits = (v[:, None] >> np.arange(32, dtype=np.uint32)[None, :]) & 1
    sel = np.where(bits.astype(bool), m[None, :], 0)
    return np.bitwise_xor.reduce(sel, axis=1).astype(np.uint32)


def _fold_blocks(cs2d: np.ndarray, lane: int) -> np.ndarray:
    """(R, nb) per-block crcs (each seeded 0) -> (R,) ``update(0, row)``
    via a pairwise zero-extension tree.  Left-padding with zero crcs is
    the identity (leading zero bytes of a zero-seeded crc stay zero)."""
    r, nb = cs2d.shape
    pow2 = 1 << max(0, nb - 1).bit_length() if nb > 1 else 1
    if pow2 != nb:
        cs2d = np.concatenate(
            [np.zeros((r, pow2 - nb), np.uint32), cs2d], axis=1)
        nb = pow2
    span = 1
    while nb > 1:
        ext = _zeros_mat(lane * span)
        left = np.ascontiguousarray(cs2d[:, 0::2]).reshape(-1)
        right = np.ascontiguousarray(cs2d[:, 1::2]).reshape(-1)
        cs2d = (_matvec_rows(ext, left) ^ right).reshape(r, nb // 2)
        nb //= 2
        span *= 2
    return cs2d[:, 0]


def _host_lane(total_bytes: int) -> int:
    """Lane of the host table loop for a batch of ``total_bytes``.

    Each loop step is one numpy pass over every lane, so a small batch
    (a store transaction's few blocks) wants short lanes and few steps,
    and a large one longer lanes and fewer fold levels.  The thresholds
    are where the loop and the fold tree cost about the same on one
    host core."""
    for lane, upto in ((32, 1 << 15), (64, 1 << 18), (128, 1 << 20)):
        if total_bytes <= upto:
            return lane
    return 256


def _block_crcs_host(arr: np.ndarray, lane: int) -> np.ndarray:
    """(R, L) rows -> (R, L/lane) zero-seeded per-block crcs, the table
    loop vectorized across every block of every row."""
    r, length = arr.shape
    nb = length // lane
    bt = np.ascontiguousarray(arr.reshape(r * nb, lane).T)
    cs = np.zeros(r * nb, dtype=np.uint32)
    for i in range(lane):
        cs = CRC_TABLE[(cs ^ bt[i]) & np.uint32(0xFF)] ^ \
            (cs >> np.uint32(8))
    return cs.reshape(r, nb)


# ---------------------------------------------------------------------------
# Device path: batched fixed-size blocks as one GF(2) matmul
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=16)
def _message_bitmat(block: int) -> np.ndarray:
    """(32, 8*block) GF(2) matrix L with update(0, m) = L @ bits(m).

    Column (p, i): contribution of bit i of byte p, i.e.
    A_1^(block-1-p) . tbl[1 << i]."""
    t_cols = np.array([CRC_TABLE[1 << i] for i in range(8)], dtype=np.uint32)
    m = np.zeros((32, 8 * block), dtype=np.uint8)
    p_op = _identity()
    for p in range(block - 1, -1, -1):
        cols = np.array([_mat_vec(p_op, int(c)) for c in t_cols], dtype=np.uint32)
        bits = (cols[None, :] >> np.arange(32)[:, None]) & 1
        m[:, 8 * p: 8 * p + 8] = bits.astype(np.uint8)
        p_op = _mat_mat(_A1, p_op)
    return m


@functools.lru_cache(maxsize=16)
def _message_bitmat_dev(block: int, device: str) -> torch.Tensor:
    """Device-resident float32 copy of the message matrix, cached per
    block length so no call uploads it again."""
    return torch.from_numpy(_message_bitmat(block)).to(
        device=device, dtype=torch.float32)


@functools.lru_cache(maxsize=16)
def _planar_message_bitmat_dev(length: int, device: str) -> torch.Tensor:
    """Device copy of ``_message_bitmat(length)`` column-permuted so it
    applies directly to a plane-group BLOB (8 rows of length/8 packed
    bytes, row-major): blob bit 8*(t*cols+i)+u is D-bit 8*(8i+u)+t."""
    cols = length // 8
    base = _message_bitmat(length)
    t, i, u = np.meshgrid(np.arange(8), np.arange(cols), np.arange(8),
                          indexing="ij")
    src = (8 * (8 * i + u) + t).reshape(-1)
    return torch.from_numpy(np.ascontiguousarray(base[:, src])).to(
        device=device, dtype=torch.float32)


def _as_tensor(data, device=None) -> torch.Tensor:
    if isinstance(data, torch.Tensor):
        return data
    return torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8)).to(
        device or "cpu")


def _batch_crcs(bitmat: torch.Tensor, data: torch.Tensor,
                const: int) -> torch.Tensor:
    """(N, B) blocks -> (N,) int64 crcs: ``L @ bits(block) ^ const``."""
    out = gf8.bitmatrix_matmul(bitmat, data.T).to(torch.int64)   # (4, N)
    crcs = out[0] | (out[1] << 8) | (out[2] << 16) | (out[3] << 24)
    return crcs ^ const


def crc32c_batch(data, seed: int = 0xFFFFFFFF, device=None) -> torch.Tensor:
    """(N, B) uint8 blocks -> (N,) CRCs (int64 holding uint32 values), on
    the data's device: [ceph_crc32c(seed, row) for row in data] as one
    GF(2) matmul (``update(seed, m) = L(m) ^ update(seed, 0^B)``)."""
    t = _as_tensor(data, device)
    n, block = t.shape
    KERNELS.inc("crc32c_batch_calls")
    KERNELS.inc("crc32c_batch_bytes", int(n) * int(block))
    bitmat = _message_bitmat_dev(int(block), str(t.device))
    return _batch_crcs(bitmat, t, crc32c_zeros(seed, int(block)))


def _use_device(t_or_arr, device, device_formula: Optional[bool]) -> bool:
    if device_formula is not None:
        return device_formula
    if isinstance(t_or_arr, torch.Tensor):
        return t_or_arr.is_cuda
    return device is not None and torch.device(device).type == "cuda"


def crc32c_rows(rows, seed: int = 0xFFFFFFFF, block: int = 4096,
                device=None, device_formula: Optional[bool] = None):
    """(R, L) uint8 rows -> list of R ``ceph_crc32c(seed, row)`` values,
    the bulk byte work batched across the whole row set.

    Device formula: rows are cut into ``block``-byte blocks and every
    block of every row rides one ``crc32c_batch`` matmul.  Host path: the
    lane-vectorized table loop over the same whole-batch block set.
    Either way the per-block crcs fold per row with the zero-extension
    operator tree (``update(s, a||b) = A^len(b)(update(s, a)) ^
    update(0, b)``).  Row lengths not divisible by the block take the
    per-row host path.  ``rows`` is numpy (placed on ``device``) or a
    tensor (used where it lies)."""
    on_dev = _use_device(rows, device, device_formula)
    r, length = (int(x) for x in rows.shape)
    if r == 0:
        return []
    lane = block if on_dev else _host_lane(r * length)
    if length == 0 or length % lane:
        arr = rows.cpu().numpy() if isinstance(rows, torch.Tensor) \
            else np.asarray(rows, dtype=np.uint8)
        return [crc32c(seed, row.tobytes()) for row in arr]
    nb = length // lane
    if on_dev:
        t = _as_tensor(rows, device)
        cs = crc32c_batch(t.reshape(r * nb, lane), seed=0)
        cs = cs.cpu().numpy().astype(np.uint32).reshape(r, nb)
    else:
        arr = rows.cpu().numpy() if isinstance(rows, torch.Tensor) \
            else np.asarray(rows, dtype=np.uint8)
        cs = _block_crcs_host(arr, lane)
    folded = _fold_blocks(cs, lane)
    head = np.uint32(crc32c_zeros(seed, length))
    return [int(c) for c in (folded ^ head)]


# ---------------------------------------------------------------------------
# Planar row view: CRC the BYTE stream of packed bit-planes without
# materializing it
# ---------------------------------------------------------------------------
#
# An at-rest planar shard (ec/planar_store.py) is its (8, cols) packed
# bit-plane matrix; its logical byte stream D (length M = 8*cols) never
# exists on the steady-state path.  D = XOR_t S_t where S_t is the M-byte
# "spread" of plane t (S_t[8i+u] = bit t of D[8i+u], at bit position t), so
#
#   update(seed, D) = XOR_t update(0, S_t) ^ update(seed, 0^M)
#
# (the 8 linear-part constants cancel pairwise — 8 is even).

# Longest shard (bytes) whose full-length planar message matrix
# ((32, 8*M) bits) the device formula builds.  Longer shards keep the
# reference package's host-spread design: that is its own rule for long
# shards, not a fallback.
_PLANAR_DEV_MAX = 1 << 15


def _planar_spread(planes: np.ndarray) -> np.ndarray:
    """(g8, cols) packed planes -> (g8, 8*cols) spread byte streams S_t
    (row 8g+t spreads plane t of group g)."""
    bits = np.unpackbits(planes, axis=1, bitorder="little")
    shifts = (np.arange(planes.shape[0], dtype=np.uint8) % 8)[:, None]
    return (bits << shifts).astype(np.uint8)


def crc32c_planar_rows(planes, seed: int = 0xFFFFFFFF,
                       device_formula: Optional[bool] = None):
    """(G*8, cols) packed bit-planes -> list of G ``ceph_crc32c(seed,
    byte_view)`` values, one per 8-row plane group, WITHOUT building the
    byte view.

    Group g = rows 8g..8g+7 = one shard's at-rest planes.  The device
    formula is one matmul over the raw plane blobs with a column-permuted
    message matrix; the host path CRCs the 8 spread streams per group
    through ``crc32c_rows`` and XOR-folds.  Both are bit-identical to
    ``crc32c(seed, planes_to_shard(group))``."""
    if planes.ndim != 2 or planes.shape[0] % 8:
        raise ValueError("planes must be (G*8, cols)")
    g8, cols = (int(x) for x in planes.shape)
    g = g8 // 8
    if g == 0:
        return []
    length = 8 * cols
    KERNELS.inc("crc32c_planar_calls")
    KERNELS.inc("crc32c_planar_bytes", g * length)
    if length == 0:
        return [crc32c(seed, b"")] * g
    on_dev = _use_device(planes, None, device_formula)
    dev = planes.device if isinstance(planes, torch.Tensor) else None
    if on_dev and length <= _PLANAR_DEV_MAX:
        t = _as_tensor(planes)
        bitmat = _planar_message_bitmat_dev(length, str(t.device))
        blobs = t.contiguous().reshape(g, length)
        crcs = _batch_crcs(bitmat, blobs, crc32c_zeros(seed, length))
        return [int(c) for c in crcs.cpu().tolist()]
    arr = planes.cpu().numpy() if isinstance(planes, torch.Tensor) \
        else np.ascontiguousarray(planes, dtype=np.uint8)
    parts = np.asarray(
        crc32c_rows(_planar_spread(arr), seed=0, device=dev,
                    device_formula=device_formula),
        dtype=np.uint32).reshape(g, 8)
    folded = np.bitwise_xor.reduce(parts, axis=1)
    head = np.uint32(crc32c_zeros(seed, length))
    return [int(c) for c in (folded ^ head)]

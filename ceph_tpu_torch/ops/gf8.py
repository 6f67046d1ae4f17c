"""GF(2^8) arithmetic: host tables and the torch device functions.

Counterpart of ``ceph_tpu/ops/gf8.py``.  The field is GF(2^8) with the
polynomial x^8+x^4+x^3+x^2+1 (0x11d), shared by gf-complete/jerasure and
ISA-L.  Multiplication by a constant is GF(2)-linear, so an (r, k) byte
coding matrix expands to an (8r, 8k) bit-matrix and an encode is one
GF(2) matmul (``expand_bitmatrix``).

Host side (numpy, k x m bytes, never data): the log/antilog/product
tables, ``gf_div``, ``gf_pow``, ``expand_bitmatrix``,
``gf_invert_matrix``, ``gf_matmul_ref``.

Device side (torch, on whatever device the tensors live):

- the byte path ``unpack_bits``/``pack_bits``/``bitmatrix_matmul``/
  ``gf_matmul``/``encode_batch`` (also the plain version of kernel B2,
  ``gf8_bytes_cuda``);
- the packed bit-planar layout ``bytes_to_planar``/``planar_to_bytes``;
- ``planar_matmul``, which hands packed planes to the hand-written CUDA
  kernel (``gf8_cuda``) for a CUDA tensor and to its plain version for a
  CPU tensor.

The layout functions take the word width: bytes (w=8) by default, or the
little-endian 16- and 32-bit words of GF(2^16)/GF(2^32), which ``gfw``
exports under the reference's ``_w`` names.
"""

from __future__ import annotations

import numpy as np
import torch

from ceph_tpu_torch.utils.device import resolve_device
from ceph_tpu_torch.utils.perf import KERNELS

# x^8 + x^4 + x^3 + x^2 + 1 — the polynomial shared by gf-complete (octal
# 0435, jerasure galois.c) and ISA-L (erasure_code tables).
GF_POLY = 0x11D


def _build_tables():
    exp = np.zeros(512, dtype=np.uint8)
    log = np.zeros(256, dtype=np.int32)
    x = 1
    for i in range(255):
        exp[i] = x
        log[x] = i
        x <<= 1
        if x & 0x100:
            x ^= GF_POLY
    exp[255:510] = exp[0:255]
    return exp, log


GF_EXP, GF_LOG = _build_tables()


def _build_mul_table():
    a = np.arange(256)
    la = GF_LOG[a][:, None]
    lb = GF_LOG[a][None, :]
    prod = GF_EXP[(la + lb) % 255]
    prod[0, :] = 0
    prod[:, 0] = 0
    return prod.astype(np.uint8)


# Full 256x256 product table; 64 KiB, host-resident.
GF_MUL = _build_mul_table()


def gf_mul(a, b):
    """Elementwise GF(2^8) product (numpy, host)."""
    return GF_MUL[np.asarray(a, dtype=np.uint8), np.asarray(b, dtype=np.uint8)]


def gf_inv(a):
    """Multiplicative inverse; a must be nonzero."""
    a = np.asarray(a, dtype=np.uint8)
    if np.any(a == 0):
        raise ZeroDivisionError("gf_inv(0)")
    return GF_EXP[255 - GF_LOG[a]]


def gf_div(a, b):
    return gf_mul(a, gf_inv(b))


def gf_pow(a, n):
    """a**n in GF(2^8)."""
    a = int(a)
    n = int(n)
    if n == 0:
        return 1
    if a == 0:
        return 0
    return int(GF_EXP[(GF_LOG[a] * n) % 255])


def gf_matmul_ref(m, d):
    """Reference bytewise GF matmul on host numpy: (r,k) @ (k,n) -> (r,n).

    out[i, n] = XOR_j gfmul(m[i, j], d[j, n]); the correctness oracle for
    the device paths."""
    m = np.asarray(m, dtype=np.uint8)
    d = np.asarray(d, dtype=np.uint8)
    prod = GF_MUL[m[:, :, None], d[None, :, :]]
    return np.bitwise_xor.reduce(prod, axis=1)


def _build_bitmat_table():
    """BITMAT[a] is the 8x8 GF(2) matrix of multiply-by-a, LSB-first:
    BITMAT[a][t, u] = bit t of gfmul(a, 1 << u)."""
    a = np.arange(256, dtype=np.uint8)
    basis = (1 << np.arange(8)).astype(np.uint8)
    prods = GF_MUL[a[:, None], basis[None, :]]
    bits = (prods[:, None, :] >> np.arange(8)[None, :, None]) & 1
    return bits.astype(np.uint8)


GF_BITMAT = _build_bitmat_table()


def expand_bitmatrix(m):
    """Expand a byte matrix (r, k) into its (8r, 8k) GF(2) bit-matrix.

    Block (i, j) is the multiply-by-``m[i, j]`` matrix, so that
    ``bitmatrix @ bits(d) == bits(m @gf d)`` columnwise (jerasure's
    ``jerasure_matrix_to_bitmatrix``)."""
    m = np.asarray(m, dtype=np.uint8)
    r, k = m.shape
    blocks = GF_BITMAT[m]                                 # (r, k, 8, 8)
    return blocks.transpose(0, 2, 1, 3).reshape(r * 8, k * 8)


# ---------------------------------------------------------------------------
# Byte path: unpack -> GF(2) matmul -> pack
# ---------------------------------------------------------------------------

# The unpacked {0,1} operand of one bitmatrix_matmul pass stays under this
# many bytes; wider inputs run in column chunks.
_UNPACKED_BUDGET = 256 << 20


def _shifts(device) -> torch.Tensor:
    return torch.arange(8, dtype=torch.uint8, device=device)


def unpack_bits(data: torch.Tensor, word_bytes: int = 1) -> torch.Tensor:
    """(k, n) uint8 -> (k*w, n/word_bytes) uint8 of {0,1}, w = 8*word_bytes.

    Row j*w + t holds bit t of every little-endian w-bit word of chunk j:
    bit t%8 of byte t//8 (LSB-first bytes at w=8; the layout
    galois_wNN_region_multiply sees on x86 at w=16/32)."""
    k, n = data.shape
    nw = n // word_bytes
    words = data.reshape(k, nw, word_bytes).permute(0, 2, 1)   # (k, wb, nw)
    bits = (words[:, :, None, :] >> _shifts(data.device)[:, None]) & 1
    return bits.reshape(k * word_bytes * 8, nw)


def pack_bits(bits: torch.Tensor, word_bytes: int = 1) -> torch.Tensor:
    """(r*w, nw) {0,1} -> (r, nw*word_bytes) uint8 (unpack_bits^-1)."""
    rw, nw = bits.shape
    r = rw // (8 * word_bytes)
    b = bits.reshape(r, word_bytes, 8, nw).to(torch.uint8)
    out = torch.zeros((r, word_bytes, nw), dtype=torch.uint8,
                      device=bits.device)
    for t in range(8):
        out |= b[:, :, t, :] << t
    return out.permute(0, 2, 1).reshape(r, nw * word_bytes)


def bitmatrix_matmul(bitmat, data: torch.Tensor,
                     word_bytes: int = 1) -> torch.Tensor:
    """GF(2^w) matmul in bit-matrix form on raw bytes of w-bit words.

    bitmat: (r*w, k*w) {0,1}; data: (k, n) uint8 -> (r, n) uint8, with
    w = 8*word_bytes (``gfw.expand_bitmatrix_w`` builds the wide ones).

    The JAX package leaves this to XLA, so the port leaves it to
    ``torch.matmul`` in float32 on the unpacked bits.  That is exact:
    every entry is 0 or 1, which TF32 also represents exactly, and every
    sum is at most k*w <= 8192 < 2**24, which float32 holds exactly.
    """
    bm = torch.as_tensor(bitmat, device=data.device).to(torch.float32)
    k, n = data.shape
    w = 8 * word_bytes
    r = bm.shape[0] // w
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    # words per pass: the unpacked float32 operand stays under the budget
    step = max(1, _UNPACKED_BUDGET // max(1, 4 * k * w)) * word_bytes
    for c0 in range(0, n, step):
        bits = unpack_bits(data[:, c0:c0 + step], word_bytes).to(
            torch.float32)
        acc = torch.matmul(bm, bits).to(torch.int32) & 1
        out[:, c0:c0 + step] = pack_bits(acc, word_bytes)
    return out


def gf_matmul(m, data, device=None) -> torch.Tensor:
    """Convenience: GF matmul from a byte matrix (r, k) on (k, n) uint8
    data through ``bitmatrix_matmul`` (host expand).  ``data`` as a
    tensor runs on its device; as numpy on ``device`` (CUDA unless the
    caller names the CPU)."""
    if not isinstance(data, torch.Tensor):
        data = torch.from_numpy(np.ascontiguousarray(data, dtype=np.uint8))
        data = data.to(resolve_device(device))
    KERNELS.inc("gf8_matmul_calls")
    KERNELS.inc("gf8_matmul_bytes", int(data.numel()))
    return bitmatrix_matmul(expand_bitmatrix(m), data)


def encode_batch(bitmat, data: torch.Tensor,
                 word_bytes: int = 1) -> torch.Tensor:
    """(B, k, S) -> (B, r, S) through ``bitmatrix_matmul``."""
    b, k, s = data.shape
    cols = data.permute(1, 0, 2).reshape(k, b * s)
    out = bitmatrix_matmul(bitmat, cols, word_bytes)
    return out.reshape(out.shape[0], b, s).permute(1, 0, 2).contiguous()


# ---------------------------------------------------------------------------
# Bit-planar layout: the device format for EC batches
# ---------------------------------------------------------------------------
#
# A shard row of L bytes = L/(w/8) little-endian w-bit words is stored as w
# PACKED bit-planes of L/w bytes each: plane t, packed byte i holds bit t of
# words 8i..8i+7 (word 8i+u at bit u), where bit t of a word is bit t%8 of
# its byte t//8.  Rows are chunk-major -- plane row j*w + t is bit-plane t
# of chunk j -- which matches the bit-matrix's row blocks, so the planar
# GF(2) matmul uses the SAME bit-matrix as the byte path.  For each chunk,
# packed column i and word byte b, the 8 bytes b of words 8i..8i+7 form an
# 8x8 bit matrix whose transpose is the 8 plane bytes b*8 .. b*8+7 of
# column i.  Total bytes equal the byte layout for every w.


def _as_words(data: torch.Tensor) -> torch.Tensor:
    """(..., 8n) uint8 -> (..., n) int64 words over the same bytes."""
    if not data.is_contiguous() or data.storage_offset() % 8:
        data = data.clone(memory_format=torch.contiguous_format)
    return data.view(torch.int64)


def _transpose8(x: torch.Tensor) -> torch.Tensor:
    """Transpose the 8x8 bit matrix held in each int64 word: bit 8u+t
    moves to bit 8t+u (three masked swap rounds; an involution).  The
    arithmetic right shifts are safe: every mask clears the bits a sign
    extension could set."""
    t = (x ^ (x >> 7)) & 0x00AA00AA00AA00AA
    x = x ^ t ^ (t << 7)
    t = (x ^ (x >> 14)) & 0x0000CCCC0000CCCC
    x = x ^ t ^ (t << 14)
    t = (x ^ (x >> 28)) & 0x00000000F0F0F0F0
    return x ^ t ^ (t << 28)


def bytes_to_planar(data: torch.Tensor, w: int = 8) -> torch.Tensor:
    """(c, L) uint8 bytes -> (c*w, L/w) packed bit-planes, chunk-major rows.

    At w=8: planar[j*8 + t, i] bit u  ==  bit t of data[j, 8i + u]."""
    c, length = data.shape
    if length % w:
        raise ValueError(f"row length {length} not a multiple of w={w}")
    wb = w // 8
    npk = length // w                   # packed bytes per plane (= words/8)
    groups = data.reshape(c, npk, 8, wb).permute(0, 3, 1, 2).reshape(-1, 8)
    planes = _transpose8(_as_words(groups)).view(torch.uint8)
    return planes.reshape(c, wb, npk, 8).permute(0, 1, 3, 2).reshape(
        c * w, npk)


def planar_to_bytes(planes: torch.Tensor, w: int = 8) -> torch.Tensor:
    """(c*w, npk) packed bit-planes -> (c, npk*w) bytes
    (bytes_to_planar^-1)."""
    cw, npk = planes.shape
    c = cw // w
    wb = w // 8
    groups = planes.reshape(c, wb, 8, npk).permute(0, 1, 3, 2).reshape(-1, 8)
    words = _transpose8(_as_words(groups)).view(torch.uint8)
    return words.reshape(c, wb, npk, 8).permute(0, 2, 3, 1).reshape(
        c, npk * w)


def planar_matmul(bitmat: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """GF(2) matmul on packed bit-planes, planes in AND out.

    bitmat (rw, kw) {0,1} uint8, planes (kw, npk) uint8 -> (rw, npk).  A
    CUDA tensor goes to the hand-written kernel, a CPU tensor to its plain
    version (``gf8_cuda.planar_matmul``)."""
    from ceph_tpu_torch.ops import gf8_cuda
    from ceph_tpu_torch.ops.profiling import record_planar_matmul

    record_planar_matmul(tuple(bitmat.shape), planes.numel())
    return gf8_cuda.planar_matmul(bitmat, planes)


# ---------------------------------------------------------------------------
# Matrix inversion (decode-matrix construction; host, k x k bytes)
# ---------------------------------------------------------------------------

class SingularMatrixError(ValueError):
    pass


def gf_invert_matrix(a):
    """Gauss-Jordan inversion over GF(2^8) (ISA-L ``gf_invert_matrix``,
    reference src/erasure-code/isa/ErasureCodeIsa.cc:274).  Raises
    SingularMatrixError when not invertible."""
    a = np.array(a, dtype=np.uint8, copy=True)
    n = a.shape[0]
    if a.shape != (n, n):
        raise ValueError("square matrix required")
    inv = np.eye(n, dtype=np.uint8)
    for col in range(n):
        pivot = None
        for row in range(col, n):
            if a[row, col] != 0:
                pivot = row
                break
        if pivot is None:
            raise SingularMatrixError(f"singular at column {col}")
        if pivot != col:
            a[[col, pivot]] = a[[pivot, col]]
            inv[[col, pivot]] = inv[[pivot, col]]
        scale = gf_inv(a[col, col])
        a[col] = gf_mul(a[col], scale)
        inv[col] = gf_mul(inv[col], scale)
        for row in range(n):
            if row != col and a[row, col] != 0:
                factor = a[row, col]
                a[row] ^= gf_mul(factor, a[col])
                inv[row] ^= gf_mul(factor, inv[col])
    return inv

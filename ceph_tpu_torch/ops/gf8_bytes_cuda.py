"""Kernel B2: the GF(2)-linear map on raw bytes, CUDA on Hopper.

Counterpart of ``ceph_tpu/ops/gf8_pallas.py::bitmatrix_matmul`` (kernel
``_kernel``).  The kernel is ``ceph_tpu_torch/csrc/gf8_bytes.cu``, built by
``_build`` and bound with ``ctypes``.  ``bitmatrix_matmul`` launches it
for a CUDA tensor and raises if it cannot; a CPU tensor goes to the plain
version ``bitmatrix_matmul_ref``.  The TPU path sent the ragged column
tail (``N % 16384``) to XLA; here the library takes every N, every row
stride and every base alignment itself, so a column slice of a packet-row
matrix needs no copy.

Two kernel paths: the staged kernel takes calls whose row starts, row
stride and N are multiples of 16 bytes (every call of the codecs' planar
paths); the kept kernel, bytewise with the edge masked, takes the rest.
The kernel reads the matrix as a table of block words and classes
(``pack_blocks``).  A caller that holds the matrix as a constant packs
the table once and passes it as ``blocks``: the call is then one launch.
Without ``blocks`` the library packs it on the card first, into scratch.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from ceph_tpu_torch.ops import gf8_cuda

# launches of the CUDA kernel in this process, and those of them that took
# the kept (bytewise) path; reset both to 0 to count a run
launches = 0
kept_launches = 0

# the staged kernel's limits (csrc/gf2_stream.cuh): 16-byte rows, and its
# row lists and class entries within its table
_VEC = 16
_GROUP = 32
# an 8x8 identity block as a block word: col_u = 1 << u
_IDENTITY = 0x8040201008040201

_fn = None


def table_len(r: int, k: int) -> int:
    """Length in 64-bit words of the table of r x k blocks: r*k block
    words and one class entry per (group of 32 output rows, input row)."""
    return r * k + -(-r // _GROUP) * k


def pack_blocks(bitmat: np.ndarray) -> np.ndarray:
    """The kernel's table of an (8r, 8k) {0,1} bit-matrix, as int64:
    word j*k + i holds block (j, i) with byte u = its column u (bit t =
    bitmat[8j+t, 8i+u]); word r*k + g*k + i holds the identity mask (low
    32 bits) and the general mask (high 32 bits) of blocks (32g + jj, i),
    bit jj each.  Zero blocks are in neither mask."""
    bm = np.asarray(bitmat, dtype=np.uint8) & 1
    r, k = bm.shape[0] // 8, bm.shape[1] // 8
    shift = (8 * np.arange(8, dtype=np.uint64)[None, :]
             + np.arange(8, dtype=np.uint64)[:, None])       # [t, u]
    bits = bm.reshape(r, 8, k, 8).transpose(0, 2, 1, 3).astype(np.uint64)
    words = (bits << shift).sum(axis=(2, 3), dtype=np.uint64)  # (r, k)
    ngroups = -(-r // _GROUP)
    padded = np.zeros((ngroups * _GROUP, k), dtype=np.uint64)
    padded[:r] = words
    ident = padded == np.uint64(_IDENTITY)
    general = (padded != 0) & ~ident
    weight = (np.uint64(1) << np.arange(_GROUP, dtype=np.uint64))[None, :,
                                                                   None]
    by_group = (ngroups, _GROUP, k)
    id_mask = (ident.reshape(by_group) * weight).sum(axis=1, dtype=np.uint64)
    gen_mask = (general.reshape(by_group) * weight).sum(axis=1,
                                                        dtype=np.uint64)
    classes = id_mask | (gen_mask << np.uint64(32))
    return np.concatenate([words.ravel(), classes.ravel()]).view(np.int64)


def bitmatrix_matmul_ref(bitmat: torch.Tensor,
                         data: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: the float32 matmul on unpacked bits
    (``gf8.bitmatrix_matmul``, the JAX package's own plain reference)."""
    from ceph_tpu_torch.ops import gf8

    return gf8.bitmatrix_matmul(bitmat, data)


def _kernel():
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.load("gf8_bytes").gf8_bytes_matmul
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_longlong,
                       ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                       ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def staged_config(device=None):
    """(CTAs of the persistent grid, threads per CTA, dynamic shared
    memory bytes per CTA) of the staged kernel on a CUDA device."""
    from ceph_tpu_torch.ops import _build

    return gf8_cuda.read_staged_config(
        _build.load("gf8_bytes").gf8_bytes_staged_config, device)


def _check_blocks(blocks: torch.Tensor, data: torch.Tensor, r: int,
                  k: int) -> None:
    want = table_len(r, k)
    if blocks.dtype != torch.int64 or blocks.dim() != 1 \
            or int(blocks.shape[0]) != want:
        raise ValueError(f"bitmatrix_matmul blocks: want int64 of length "
                         f"{want} (r={r}, k={k}), got {blocks.dtype} "
                         f"{tuple(blocks.shape)}")
    if blocks.device != data.device or not blocks.is_contiguous():
        raise ValueError("bitmatrix_matmul blocks must be contiguous and on "
                         f"{data.device}, got {blocks.device}")


def bitmatrix_matmul(bitmat: torch.Tensor, data: torch.Tensor,
                     blocks: torch.Tensor = None) -> torch.Tensor:
    """bitmat (8r, 8k) {0,1} uint8 x data (k, N) uint8 -> (r, N) uint8:
    output byte j, bit t = parity of sum over (i, u) of
    bitmat[8j+t, 8i+u] * bit u of data[i].  ``data`` may be any view
    whose bytes within a row are contiguous (``stride(1) == 1``).
    ``blocks``, when given, is ``pack_blocks(bitmat)`` on data's device."""
    global launches, kept_launches
    if bitmat.dim() != 2 or data.dim() != 2 or bitmat.shape[0] % 8 \
            or bitmat.shape[1] != 8 * data.shape[0]:
        raise ValueError(f"bitmatrix_matmul shapes {tuple(bitmat.shape)} x "
                         f"{tuple(data.shape)}")
    k, n = int(data.shape[0]), int(data.shape[1])
    r = int(bitmat.shape[0]) // 8
    if blocks is not None:
        _check_blocks(blocks, data, r, k)
    if bitmat.device.type == "cpu" and data.device.type == "cpu":
        return bitmatrix_matmul_ref(bitmat, data)
    if not (bitmat.is_cuda and data.is_cuda and bitmat.device == data.device):
        raise ValueError(
            f"bitmatrix_matmul: bitmat on {bitmat.device}, data on "
            f"{data.device}; both must be on one CUDA device or the CPU")
    if bitmat.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"bitmatrix_matmul wants uint8, got {bitmat.dtype} "
                        f"and {data.dtype}")
    if not bitmat.is_contiguous():
        raise ValueError("bitmatrix_matmul wants a contiguous bitmat")
    if n > 1 and data.stride(1) != 1:
        raise ValueError("bitmatrix_matmul wants data rows of contiguous "
                         f"bytes, got strides {data.stride()}")
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    if r == 0 or n == 0:
        return out
    ld = int(data.stride(0)) if k > 1 else n
    pack = blocks is None
    if pack:
        blocks = torch.empty(table_len(r, k), dtype=torch.int64,
                             device=data.device)
    fn = _kernel()
    table = gf8_cuda.list_bytes(r, k) + -(-r // _GROUP) * k * 8
    staged = (n % _VEC == 0 and ld % _VEC == 0
              and data.data_ptr() % _VEC == 0 and out.data_ptr() % _VEC == 0
              and table <= gf8_cuda.TABLE_BYTES)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = fn(bitmat.data_ptr(), data.data_ptr(), ld, out.data_ptr(),
                 blocks.data_ptr(), r, k, n, int(pack), int(staged), stream)
    if err:
        raise RuntimeError(f"gf8_bytes_matmul launch failed: CUDA error {err}")
    launches += 1
    kept_launches += not staged
    return out

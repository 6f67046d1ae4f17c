"""Kernel B2: the GF(2)-linear map on raw bytes, CUDA on Hopper.

Counterpart of ``ceph_tpu/ops/gf8_pallas.py::bitmatrix_matmul`` (kernel
``_kernel``).  The kernel is ``ceph_tpu_torch/csrc/gf8_bytes.cu``, built by
``_build`` and bound with ``ctypes``.  ``bitmatrix_matmul`` launches it
for a CUDA tensor and raises if it cannot; a CPU tensor goes to the plain
version ``bitmatrix_matmul_ref``.  The TPU path sent the ragged column
tail (``N % 16384``) to XLA; here the kernel takes every N, every row
stride and every base alignment itself, so a column slice of a packet-row
matrix needs no copy.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel in this process; reset it to 0 to count a run
launches = 0

_fn = None


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
                       ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def bitmatrix_matmul(bitmat: torch.Tensor, data: torch.Tensor) -> torch.Tensor:
    """bitmat (8r, 8k) {0,1} uint8 x data (k, N) uint8 -> (r, N) uint8:
    output byte j, bit t = parity of sum over (i, u) of
    bitmat[8j+t, 8i+u] * bit u of data[i].  ``data`` may be any view
    whose bytes within a row are contiguous (``stride(1) == 1``)."""
    global launches
    if bitmat.device.type == "cpu" and data.device.type == "cpu":
        return bitmatrix_matmul_ref(bitmat, data)
    if not (bitmat.is_cuda and data.is_cuda and bitmat.device == data.device):
        raise ValueError(
            f"bitmatrix_matmul: bitmat on {bitmat.device}, data on "
            f"{data.device}; both must be on one CUDA device or the CPU")
    if bitmat.dtype != torch.uint8 or data.dtype != torch.uint8:
        raise TypeError(f"bitmatrix_matmul wants uint8, got {bitmat.dtype} "
                        f"and {data.dtype}")
    if bitmat.dim() != 2 or data.dim() != 2 or bitmat.shape[0] % 8 \
            or bitmat.shape[1] != 8 * data.shape[0]:
        raise ValueError(f"bitmatrix_matmul shapes {tuple(bitmat.shape)} x "
                         f"{tuple(data.shape)}")
    if not bitmat.is_contiguous():
        raise ValueError("bitmatrix_matmul wants a contiguous bitmat")
    k, n = int(data.shape[0]), int(data.shape[1])
    if n > 1 and data.stride(1) != 1:
        raise ValueError("bitmatrix_matmul wants data rows of contiguous "
                         f"bytes, got strides {data.stride()}")
    r = int(bitmat.shape[0]) // 8
    out = torch.empty((r, n), dtype=torch.uint8, device=data.device)
    if r == 0 or n == 0:
        return out
    ld = int(data.stride(0)) if k > 1 else n
    blocks = torch.empty(r * k, dtype=torch.int64, device=data.device)
    fn = _kernel()
    aligned = (n % 8 == 0 and ld % 8 == 0 and data.data_ptr() % 8 == 0
               and out.data_ptr() % 8 == 0)
    stream = torch.cuda.current_stream(data.device).cuda_stream
    with torch.cuda.device(data.device):
        err = fn(bitmat.data_ptr(), data.data_ptr(), ld, out.data_ptr(),
                 blocks.data_ptr(), r, k, n, int(aligned), stream)
    if err:
        raise RuntimeError(f"gf8_bytes_matmul launch failed: CUDA error {err}")
    launches += 1
    return out

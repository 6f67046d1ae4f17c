"""Kernel B1: the packed bit-planar GF(2) matmul, CUDA on Hopper.

Counterpart of ``ceph_tpu/ops/gf8_pallas.py::planar_matmul`` (kernel
``_planar_kernel``).  The kernel is ``ceph_tpu_torch/csrc/gf8_planar.cu``,
built by ``_build`` and bound with ``ctypes``.  ``planar_matmul`` launches
it for a CUDA tensor and raises if it cannot; a CPU tensor goes to the
plain version ``planar_matmul_ref``.  The TPU path sent the ragged
column tail to XLA; here the kernel takes every column count itself.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel in this process; reset it to 0 to count a run
launches = 0

_fn = None

# the unpacked {0,1} operand of one plain-version pass stays under this
_UNPACKED_BUDGET = 256 << 20


def planar_matmul_ref(bitmat: torch.Tensor,
                      planes: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: unpack the planes to bits, one float32
    matmul, keep the parity bit, repack (``gf8.planar_matmul_xla``).

    Exact: 0/1 operands and sums of at most kw <= 2048 terms."""
    rw, kw = bitmat.shape
    npk = planes.shape[1]
    dev = planes.device
    bm = (bitmat.to(device=dev, dtype=torch.uint8) & 1).to(torch.float32)
    shifts = torch.arange(8, dtype=torch.uint8, device=dev)
    out = torch.empty((rw, npk), dtype=torch.uint8, device=dev)
    step = max(1, _UNPACKED_BUDGET // max(1, 32 * kw))
    for c0 in range(0, npk, step):
        p = planes[:, c0:c0 + step]
        n = p.shape[1]
        bits = ((p[:, :, None] >> shifts) & 1).reshape(kw, n * 8)
        acc = torch.matmul(bm, bits.to(torch.float32)).to(torch.int32) & 1
        acc = acc.reshape(rw, n, 8).to(torch.uint8)
        packed = torch.zeros((rw, n), dtype=torch.uint8, device=dev)
        for u in range(8):
            packed |= acc[:, :, u] << u
        out[:, c0:c0 + step] = packed
    return out


def _kernel():
    global _fn
    if _fn is None:
        from ceph_tpu_torch.ops import _build

        fn = _build.load("gf8_planar").gf8_planar_matmul
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _fn = fn
    return _fn


def planar_matmul(bitmat: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """bitmat (rw, kw) {0,1} uint8 x planes (kw, npk) uint8 -> (rw, npk)
    uint8, mod 2 on packed bit-planes."""
    global launches
    if bitmat.device.type == "cpu" and planes.device.type == "cpu":
        return planar_matmul_ref(bitmat, planes)
    if not (bitmat.is_cuda and planes.is_cuda
            and bitmat.device == planes.device):
        raise ValueError(
            f"planar_matmul: bitmat on {bitmat.device}, planes on "
            f"{planes.device}; both must be on one CUDA device or the CPU")
    if bitmat.dtype != torch.uint8 or planes.dtype != torch.uint8:
        raise TypeError(f"planar_matmul wants uint8, got {bitmat.dtype} "
                        f"and {planes.dtype}")
    if bitmat.dim() != 2 or planes.dim() != 2 \
            or bitmat.shape[1] != planes.shape[0]:
        raise ValueError(f"planar_matmul shapes {tuple(bitmat.shape)} x "
                         f"{tuple(planes.shape)}")
    if not (bitmat.is_contiguous() and planes.is_contiguous()):
        raise ValueError("planar_matmul wants contiguous tensors")
    rw, kw = int(bitmat.shape[0]), int(bitmat.shape[1])
    npk = int(planes.shape[1])
    out = torch.empty((rw, npk), dtype=torch.uint8, device=planes.device)
    if rw == 0 or npk == 0:
        return out
    fn = _kernel()
    aligned = (npk % 8 == 0 and planes.data_ptr() % 8 == 0
               and out.data_ptr() % 8 == 0)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = fn(bitmat.data_ptr(), planes.data_ptr(), out.data_ptr(),
                 rw, kw, npk, int(aligned), stream)
    if err:
        raise RuntimeError(f"gf8_planar_matmul launch failed: CUDA error {err}")
    launches += 1
    return out

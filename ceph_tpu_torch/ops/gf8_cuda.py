"""Kernel B1: the packed bit-planar GF(2) matmul, CUDA on Hopper.

Counterpart of ``ceph_tpu/ops/gf8_pallas.py::planar_matmul`` (kernel
``_planar_kernel``).  The kernel is ``ceph_tpu_torch/csrc/gf8_planar.cu``,
built by ``_build`` and bound with ``ctypes``.  ``planar_matmul`` launches
it for a CUDA tensor and raises if it cannot; a CPU tensor goes to the
plain version ``planar_matmul_ref``.  The TPU path sent the ragged
column tail to XLA; here the library takes every column count itself.

Two kernel paths: the staged kernel takes calls whose rows are multiples
of 16 bytes and whose matrix fits its mask table (every call of the codec
and stripe paths); the kept kernel, bytewise with the edge masked, takes
the rest.
"""

from __future__ import annotations

import ctypes

import torch

# launches of the CUDA kernel in this process, and those of them that took
# the kept (bytewise) path; reset both to 0 to count a run
launches = 0
kept_launches = 0

# the staged kernel's limits (csrc/gf2_stream.cuh): 16-byte rows, and its
# table within 16 KiB
_VEC = 16
_GROUP = 32
_PASS = 16
TABLE_BYTES = 16 << 10


def list_bytes(r: int, k: int) -> int:
    """Bytes of the staged kernel's lists for r output and k input rows:
    320 for each group of 32 output rows and 16 input rows (64 of row
    lists, 256 of subset lists)."""
    return -(-r // _GROUP) * -(-k // _PASS) * 320

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


def read_staged_config(fn, device=None):
    """Call a library's ``*_staged_config`` C function on a CUDA device:
    (CTAs of the persistent grid, threads per CTA, dynamic shared memory
    bytes per CTA)."""
    vals = [ctypes.c_int(0) for _ in range(3)]
    fn.argtypes = [ctypes.c_void_p] * 3
    fn.restype = ctypes.c_int
    with torch.cuda.device(device):
        err = fn(*(ctypes.addressof(v) for v in vals))
    if err:
        raise RuntimeError(f"staged kernel config failed: CUDA error {err}")
    return tuple(v.value for v in vals)


def staged_config(device=None):
    """(CTAs of the persistent grid, threads per CTA, dynamic shared
    memory bytes per CTA) of the staged kernel on a CUDA device."""
    from ceph_tpu_torch.ops import _build

    return read_staged_config(
        _build.load("gf8_planar").gf8_planar_staged_config, device)


def planar_matmul(bitmat: torch.Tensor, planes: torch.Tensor) -> torch.Tensor:
    """bitmat (rw, kw) {0,1} uint8 x planes (kw, npk) uint8 -> (rw, npk)
    uint8, mod 2 on packed bit-planes."""
    global launches, kept_launches
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
    staged = (npk % _VEC == 0 and planes.data_ptr() % _VEC == 0
              and out.data_ptr() % _VEC == 0
              and list_bytes(rw, kw) <= TABLE_BYTES)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    with torch.cuda.device(planes.device):
        err = fn(bitmat.data_ptr(), planes.data_ptr(), out.data_ptr(),
                 rw, kw, npk, int(staged), stream)
    if err:
        raise RuntimeError(f"gf8_planar_matmul launch failed: CUDA error {err}")
    launches += 1
    kept_launches += not staged
    return out

"""The device an entry point of the port runs on."""

from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """CUDA unless the caller names another device.  Raises when CUDA is
    asked for (or defaulted to) and absent; it never drops to the CPU on
    its own."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "ceph_tpu_torch runs on a CUDA device and none is available; "
            "pass device='cpu' to run the plain PyTorch versions")
    return dev


def resolve_device_index(device=None) -> torch.device:
    """``resolve_device``, with a CUDA device named by its index (the
    current one when the caller gave none): a daemon that runs device
    work in executor threads makes each thread's current device its own,
    whatever device the thread last used."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def run_on(device: torch.device, fn, *args):
    """``fn(*args)`` with ``device`` as the calling thread's current CUDA
    device (a plain call for any other device): what a daemon's executor
    thread runs its device work under."""
    if device.type == "cuda":
        with torch.cuda.device(device):
            return fn(*args)
    return fn(*args)


def warm_device(device: torch.device) -> None:
    """Make ready on a CUDA ``device`` what the first device op of a
    process would otherwise wait for: the kernels' build and load, the
    card's context, and cuBLAS (the float32 matmuls of device crc32c and
    of the plain GF(2) maps).  A no-op for any other device."""
    if device.type != "cuda":
        return
    from ceph_tpu_torch.ops import _build

    _build.build_all()
    with torch.cuda.device(device):
        a = torch.ones((8, 8), device=device)
        torch.matmul(a, a)
        torch.cuda.synchronize(device)

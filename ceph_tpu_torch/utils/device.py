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

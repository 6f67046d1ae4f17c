"""Clean device-loop code: host metadata (shape, ndim, dtype) read in the
step, torch.where for the tensor-valued decision, host tensors at module
scope, and host readbacks outside the timed region."""

import torch

from ceph_tpu_torch.ops.profiling import device_loop_slope

HOST_TABLE = torch.arange(256, dtype=torch.uint8)  # a host tensor: fine


def step(d):
    if d.ndim != 1:  # host metadata, no sync
        raise ValueError("1-D only")
    n = int(d.shape[0])
    return torch.where(d > 0, d, -d)[:n]


def feedback(d, out):
    return d ^ out


def table_on(device):
    # a tensor made on the card inside a function, not at import
    return HOST_TABLE.to("cuda") if device == "cuda" else HOST_TABLE


def measure(data):
    med, best, worst = device_loop_slope(step, feedback, data)
    # host work on the result, outside the timed region
    return float(med), data.sum().item()

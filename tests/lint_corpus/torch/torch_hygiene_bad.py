"""Every host-sync family of the port's timed region: host syncs and
host materialization inside the device-loop step, wall-clock calls,
Python branching on a tensor, and module-scope tensors on the card."""

import time

import numpy as np
import torch

from ceph_tpu_torch.ops.profiling import device_loop_slope

DEVICE_TABLE = torch.arange(256, device="cuda")  # the card at import
DEVICE_GRID = torch.zeros(16).cuda()              # ditto, moved there


def bad_item(d):
    return d + d.sum().item()  # readback of a device scalar


def bad_cpu(d):
    return d.cpu()  # a copy to the host each step


def bad_numpy(d):
    return torch.from_numpy(d.numpy())  # a copy to the host each step


def bad_sync(d):
    torch.cuda.synchronize()  # host sync in the measured region
    return d


def bad_float(d):
    return d * float(d[0])  # scalar coercion forces a host sync


def bad_asarray(d):
    return torch.from_numpy(np.asarray(d))  # host materialization


def bad_clock(d):
    t0 = time.perf_counter()  # times the enqueue, not the step
    return d + round(t0)


def bad_branch(d):
    if d.any():  # Python branch on a tensor: an implicit bool()
        return d
    return -d


def feedback(d, out):
    return d ^ out


def run(data):
    device_loop_slope(bad_item, feedback, data)
    device_loop_slope(bad_cpu, feedback, data)
    device_loop_slope(bad_numpy, feedback, data)
    device_loop_slope(bad_sync, feedback, data)
    device_loop_slope(bad_float, feedback, data)
    device_loop_slope(bad_asarray, feedback, data)
    device_loop_slope(bad_clock, feedback, data)
    device_loop_slope(bad_branch, feedback, data)
    device_loop_slope(lambda d: torch.tensor(d.tolist()), feedback, data)

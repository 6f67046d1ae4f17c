"""Telemetry for the planar EC path, booked into ``KERNELS``, and the
device-loop timer.

Counterpart of ``ceph_tpu/ops/profiling.py``.  The TPU version also
accounted the MXU shape-padding of the K-stacked matrix; the Hopper
kernel has no matrix unit and no stacking, so only calls and bytes are
kept.  ``device_loop_slope`` times a step with its repeat loop on the
device.
"""

from __future__ import annotations

import statistics
import time
from typing import Optional

import torch

from ceph_tpu_torch.utils.perf import KERNELS


def record_planar_matmul(bitmat_shape, payload_bytes: int) -> None:
    """One planar GF(2) matmul over ``payload_bytes`` of packed planes."""
    del bitmat_shape
    KERNELS.inc("planar_matmul_calls")
    KERNELS.inc("planar_matmul_bytes", int(payload_bytes))


def record_planar_convert(direction: str, payload_bytes: int) -> None:
    """Layout conversion of a stripe batch: ``to_planar`` or ``to_bytes``.
    The layout contract allows at most one each way per client op."""
    KERNELS.inc(f"planar_convert_{direction}_calls")
    KERNELS.inc(f"planar_convert_{direction}_bytes", int(payload_bytes))
    KERNELS.inc("planar_convert_bytes", int(payload_bytes))


def record_planar_at_rest(event: str, payload_bytes: int) -> None:
    """Conversion at an at-rest seam: ``ingest`` (client bytes -> planes
    at encode), ``egress`` (planes -> logical bytes at read),
    ``relayout`` or ``unseamed`` (a byte view outside the seams, which the
    steady state keeps at zero)."""
    KERNELS.inc(f"ec_planar_{event}_conversions")
    KERNELS.inc(f"ec_planar_{event}_bytes", int(payload_bytes))


def device_loop_slope(step, feedback, data, repeats: int = 3,
                      L1: int = 300, L2: int = 1200,
                      tag: Optional[str] = None):
    """Seconds-per-step of ``step`` with the repeat loop ON THE DEVICE.

    Chains L1 and L2 iterations, each feeding its output back into the
    next through ``feedback(d, out)`` (a cheap xor) so nothing can be
    hoisted, with no host work in between: on a CUDA ``data`` tensor each
    chain is one CUDA graph, replayed between two CUDA events and
    synchronised once; on the CPU (the tests) it is a plain loop on the
    host clock.  The per-iteration time is the slope
    ``(t_L2 - t_L1) / (L2 - L1)``, in which the launch and the
    synchronisation cancel.  Returns (median, best, worst) across
    conservative pairings of the ``repeats`` samples, each clamped to at
    least 1e-12; ``tag`` also tincs the median into KERNELS as
    ``t_<tag>``.  ``step`` and ``feedback`` must not synchronise with the
    host."""

    def chain(d, L):
        for _ in range(L):
            d = feedback(d, step(d))
        return d

    if isinstance(data, torch.Tensor) and data.is_cuda:
        run = _graph_runner(chain, data)
    else:
        def run(L):
            t0 = time.perf_counter()
            chain(data, L)
            return time.perf_counter() - t0
    ts = {}
    for L in (L1, L2):
        run(L)  # warm (and, on the card, capture)
        ts[L] = [run(L) for _ in range(repeats)]
    dL = L2 - L1
    # clamp against timing noise driving a slope to <= 0 (a negative or
    # infinite rate must never become the number of record)
    med = max((statistics.median(ts[L2]) - statistics.median(ts[L1])) / dL,
              1e-12)
    best = max((min(ts[L2]) - max(ts[L1])) / dL, 1e-12)
    worst = max((max(ts[L2]) - min(ts[L1])) / dL, 1e-12)
    if tag is not None:
        KERNELS.tinc(f"t_{tag}", med)
    return med, best, worst


def _graph_runner(chain, data: torch.Tensor):
    """``run(L)`` -> seconds of one replay of a CUDA graph holding the
    L-step chain from ``data`` (captured on the first call per L)."""
    graphs = {}

    def run(L):
        g = graphs.get(L)
        if g is None:
            side = torch.cuda.Stream(data.device)
            side.wait_stream(torch.cuda.current_stream(data.device))
            with torch.cuda.stream(side):
                chain(data, 1)  # lazy initialisation outside the capture
            torch.cuda.current_stream(data.device).wait_stream(side)
            g = graphs[L] = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                chain(data, L)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3

    return run

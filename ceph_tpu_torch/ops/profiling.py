"""Telemetry for the planar EC path, booked into ``KERNELS``.

Counterpart of ``ceph_tpu/ops/profiling.py:28-82``.  The TPU version
also accounted the MXU shape-padding of the K-stacked matrix; the Hopper
kernel has no matrix unit and no stacking, so only calls and bytes are
kept.  Kernel times come from CUDA events in ``chip_smoke.py``.
"""

from __future__ import annotations

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

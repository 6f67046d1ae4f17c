"""Arithmetic the metric readers in ``metrics/`` share.

Each reader returns None when its run has nothing for it to read: no
trace, no device event, no work of its kind.  A share of a roofline or a
peak is never made up from host time and never clipped.
"""

from __future__ import annotations

from typing import Optional

from portbench import peaks
from portbench.drivers.common import percentile


def _device_trace(ctx):
    tr = ctx.trace
    if tr is None or not tr.device or tr.window_us <= 0:
        return None
    return tr


def idle_pct(ctx) -> Optional[float]:
    """Share of the traced window in which the device ran nothing."""
    tr = _device_trace(ctx)
    if tr is None:
        return None
    return 100.0 * (1.0 - tr.busy_us() / tr.window_us)


def kernel_us(tr) -> float:
    return sum(d for _n, _s, d in tr.of("kernel"))


def codec_roofline_pct(ctx) -> Optional[float]:
    """The least time the erasure code's bytes take at the card's memory
    bandwidth (inputs read once, outputs written once), over the summed
    time of every kernel the traced units launched."""
    tr = _device_trace(ctx)
    if tr is None:
        return None
    nbytes = tr.work.get("codec_bytes", 0)
    busy = kernel_us(tr)
    if not nbytes or busy <= 0:
        return None
    least_us = nbytes / peaks.HBM_BYTES_PER_S * 1e6
    return 100.0 * least_us / busy


def copy_ms_per_unit(ctx) -> Optional[float]:
    """Device time of host-device copies per traced unit."""
    tr = _device_trace(ctx)
    units = tr.work.get("units", 0) if tr is not None else 0
    if not units:
        return None
    return sum(d for _n, _s, d in tr.of("gpu_memcpy")) / 1e3 / units


def kernels_per_unit(ctx) -> Optional[float]:
    tr = _device_trace(ctx)
    units = tr.work.get("units", 0) if tr is not None else 0
    kernels = len(tr.of("kernel")) if tr is not None else 0
    if not units or not kernels:
        return None
    return kernels / units


def op_p95_ms(ctx) -> Optional[float]:
    ops = ctx.stats.get("op_ms") or []
    return percentile(ops, 95) if ops else None


def rate_mb_s(ctx, key: str) -> Optional[float]:
    nbytes = ctx.stats.get(key, 0)
    window = ctx.stats.get("window_s", 0)
    if not nbytes or window <= 0:
        return None
    return nbytes / window / 1e6

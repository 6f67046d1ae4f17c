"""The metric arithmetic on a canned profiler event list."""

import pytest

from portbench import peaks, readers
from portbench import trace as trace_mod
from portbench.harness import Context


def _events():
    """A 1000 us window: kernels at 100-300 and 250-400 (overlapping),
    a 200 us host-to-device copy at 600-800; host ops around them."""
    return [
        {"ph": "X", "cat": "user_annotation", "name": "portbench.window",
         "ts": 1000.0, "dur": 1000.0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::cat", "ts": 1000.0,
         "dur": 90.0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::copy_", "ts": 1400.0,
         "dur": 500.0, "tid": 7},
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync",
         "ts": 1450.0, "dur": 100.0, "tid": 7},
        {"ph": "X", "cat": "cpu_op", "name": "aten::other_thread",
         "ts": 1000.0, "dur": 1000.0, "tid": 8},
        {"ph": "X", "cat": "kernel", "name": "gf8_planar", "ts": 1100.0,
         "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "crc_matmul", "ts": 1250.0,
         "dur": 150.0},
        {"ph": "X", "cat": "gpu_memcpy", "name": "Memcpy HtoD", "ts": 1600.0,
         "dur": 200.0},
        {"ph": "X", "cat": "kernel", "name": "outside", "ts": 5000.0,
         "dur": 10.0},
    ]


def _ctx(work):
    tr = trace_mod.from_events(_events())
    tr.work = work
    return Context(cell=None, stats={"op_ms": [float(i) for i in
                                               range(1, 101)],
                                     "window_s": 2.0,
                                     "client_bytes_written": 4e6},
                   counters={}, trace=tr)


def test_busy_idle_and_gaps():
    tr = trace_mod.from_events(_events())
    assert tr.window_us == 1000.0
    assert len(tr.device) == 3                  # the kernel outside is out
    assert tr.busy_us() == pytest.approx(500.0)  # 300 (merged) + 200
    assert tr.gaps() == [(1000.0, 1100.0), (1400.0, 1600.0),
                         (1800.0, 2000.0)]
    ctx = _ctx({"units": 2})
    assert readers.idle_pct(ctx) == pytest.approx(50.0)


def test_idle_gaps_are_named_by_the_innermost_host_op():
    tr = trace_mod.from_events(_events())
    gaps = dict(tr.idle_gaps())
    # 1000-1100 (middle 1050: aten::cat), 1400-1600 (middle 1500:
    # cudaMemcpyAsync inside aten::copy_), 1800-2000 (1900: aten::copy_
    # ends at 1900, so still inside it)
    assert gaps == pytest.approx({"aten::cat": 100e-6,
                                  "cudaMemcpyAsync": 200e-6,
                                  "aten::copy_": 200e-6})
    ops = dict(tr.device_ops())
    assert ops == pytest.approx({"gf8_planar": 200e-6, "crc_matmul": 150e-6,
                                 "Memcpy HtoD": 200e-6})


def test_roofline_copy_kernels_and_tail():
    ctx = _ctx({"units": 2, "codec_bytes": 335e6})
    # 335 MB at 3.35 TB/s is 100 us; the kernels took 350 us
    assert peaks.HBM_BYTES_PER_S == 3.35e12
    assert readers.codec_roofline_pct(ctx) == pytest.approx(100 * 100 / 350)
    assert readers.copy_ms_per_unit(ctx) == pytest.approx(0.1)
    assert readers.kernels_per_unit(ctx) == pytest.approx(1.0)
    assert readers.op_p95_ms(ctx) == 95.0
    assert readers.rate_mb_s(ctx, "client_bytes_written") == \
        pytest.approx(2.0)


def test_nothing_to_read_reads_none():
    bare = Context(cell=None, stats={"op_ms": [], "window_s": 1.0},
                   counters={}, trace=None)
    for fn in (readers.idle_pct, readers.codec_roofline_pct,
               readers.copy_ms_per_unit, readers.kernels_per_unit,
               readers.op_p95_ms):
        assert fn(bare) is None
    host_only = trace_mod.from_events(_events()[:5])
    ctx = Context(cell=None, stats={}, counters={}, trace=host_only)
    host_only.work = {"units": 1, "codec_bytes": 1e6}
    assert readers.idle_pct(ctx) is None
    assert readers.codec_roofline_pct(ctx) is None
    no_work = _ctx({"units": 2})
    assert readers.codec_roofline_pct(no_work) is None


def test_a_trace_without_the_window_reads_nothing():
    assert trace_mod.from_events(_events()[1:]) is None

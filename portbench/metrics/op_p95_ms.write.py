"""95th percentile of the window's op latencies, submission to results
on the host (host clock)."""

from portbench import readers


def read(ctx):
    return readers.op_p95_ms(ctx)

"""The erasure code's least time at HBM bandwidth over all kernel time
of the traced ticks (device trace)."""

from portbench import readers


def read(ctx):
    return readers.codec_roofline_pct(ctx)

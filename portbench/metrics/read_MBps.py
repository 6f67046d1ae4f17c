"""Client bytes returned by completed reads (10^6 B) over the whole
window (host clock)."""

from portbench import readers


def read(ctx):
    return readers.rate_mb_s(ctx, "client_bytes_read")

"""Share of the traced window in which the card ran nothing (device
trace)."""

from portbench import readers


def read(ctx):
    return readers.idle_pct(ctx)

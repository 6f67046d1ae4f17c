"""Device milliseconds of host-device copies per traced tick (device
trace)."""

from portbench import readers


def read(ctx):
    return readers.copy_ms_per_unit(ctx)

"""Device kernels launched per traced map change (device trace)."""

from portbench import readers


def read(ctx):
    return readers.kernels_per_unit(ctx)

"""The device's idle share over a profiled stretch of solves, %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)

"""The device's idle share over a profiled stretch of preconditioner
applies (vmult and its norm's read), %."""

from portbench import readers


def read(ctx):
    return readers.idle_share(ctx)

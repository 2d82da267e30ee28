"""Device ms per V-cycle (Hierarchy.vmult) of the cell's hierarchy, profiled
in a precond cell."""

from portbench import readers


def read(ctx):
    return readers.vcycle_device_ms(ctx)

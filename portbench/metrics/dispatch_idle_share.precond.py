"""The share of the device stretch of preconditioner applies in which the
device is idle while the host runs a program span other than a sync, %."""

from portbench import spans


def read(ctx):
    return spans.dispatch_idle_share(ctx)

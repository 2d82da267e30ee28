"""The 95th percentile of the wall times of all the window's solves, ms."""

from portbench.loadgen import percentile


def read(ctx):
    return 1e3 * percentile(ctx.window.latencies, 95)

"""Fine dofs times solves completed in the window over its seconds, Mdof/s."""

from portbench import readers


def read(ctx):
    return readers.rate(ctx)

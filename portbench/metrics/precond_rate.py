"""Fine dofs times preconditioner applies (vmult) completed in the window
over its seconds, Mdof/s."""

from portbench import readers


def read(ctx):
    return readers.rate(ctx)

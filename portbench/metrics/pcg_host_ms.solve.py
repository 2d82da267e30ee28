"""Host ms of the outer CG's own dispatch per solve: the ``solve`` span
less its ``vcycle`` and ``sync`` spans, the mean over the host stretch."""

from portbench import spans


def read(ctx):
    return spans.pcg_host_ms(ctx)

"""Host ms of a V-cycle inside the solves: the mean ``vcycle`` span of the
host stretch (its Python, allocation and launches; no sync inside)."""

from portbench import spans


def read(ctx):
    return spans.vcycle_host_ms(ctx)

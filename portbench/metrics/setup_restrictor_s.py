"""Seconds of the restrictors of levels 1 and below in the hierarchy's
synchronised set-up stages (``setup_seconds``)."""

from portbench import spans


def read(ctx):
    return spans.stage_sum(ctx, spans.RESTRICTOR)

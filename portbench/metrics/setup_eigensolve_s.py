"""Seconds of level 0's agglomerate batch and eigensolve in the hierarchy's
synchronised set-up stages (``setup_seconds``)."""

from portbench import spans


def read(ctx):
    return spans.stage_sum(ctx, spans.EIGENSOLVE)

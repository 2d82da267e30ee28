"""Seconds from the process's start to the first timed request: imports,
the kernels loaded (built in a checkout's first run), mesh and problem, the
hierarchy, the input pool and the warm-up requests."""


def read(ctx):
    return ctx.setup_s

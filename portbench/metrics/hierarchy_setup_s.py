"""Host seconds of Hierarchy(problem, config), up to a synchronised device."""


def read(ctx):
    return ctx.system.hierarchy_s

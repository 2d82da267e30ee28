"""Host seconds to build the mesh and the Laplace problem."""


def read(ctx):
    return ctx.system.problem_s

"""PCG iterations per solve, the mean over the window's solves (solve_cg's
own count)."""


def read(ctx):
    its = [c["iterations"] for c in ctx.window.counters]
    return sum(its) / len(its)

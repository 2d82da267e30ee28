"""The fine operator's apply alone, where it is an ELL matrix: its bound
(the operator's nonzeros, x and y once) over its device time, %."""

from portbench import readers, work
from portbench.trace import device_ms_per_call


def read(ctx):
    op = ctx.system.hier.levels[0].op
    if not ctx.cuda or type(op).__name__ != "ELLMatrix":
        return None
    x = ctx.pool[0]
    t = device_ms_per_call(lambda: op(x))
    if t is None:
        return None
    _, cells, constrained = ctx.system.mesh()
    nnz = work.mesh_operator_nnz(cells, constrained)
    vb = readers.vector_bytes(ctx)
    sec, by = work.bound(*work.ell_work(nnz, ctx.system.n, ctx.system.n,
                                        vb, 4, vb))
    ctx.notes["ell_bound_by"] = by
    return 100.0 * sec / (t / 1e3)

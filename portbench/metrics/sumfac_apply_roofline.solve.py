"""The fine operator's apply alone, where it is the sum-factorised Q_k
operator: its bound (work_mf.sumfac_work: u, y, the metric, the cells, the
diagonal and the Dirichlet flags once) over its device time, %."""

from portbench import readers, work, work_mf
from portbench.trace import device_ms_per_call


def read(ctx):
    op = ctx.system.hier.levels[0].op
    if not ctx.cuda or type(op).__name__ != "SumFactoredOperator":
        return None
    x = ctx.pool[0]
    t = device_ms_per_call(lambda: op(x))
    if t is None:
        return None
    cells = ctx.system.mesh()[1]
    dim, k = ctx.config["assumed"]["dim"], ctx.config["laplace"]["fe_degree"]
    vb = readers.vector_bytes(ctx)
    sec, by = work.bound(*work_mf.sumfac_work(ctx.system.n, len(cells), k + 1,
                                              k + 1, dim, vb, vb, 8))
    ctx.notes["sumfac_bound_by"] = by
    return 100.0 * sec / (t / 1e3)

"""Level 0's pre-smoothing (with the V-cycle's residual) and post-smoothing
of one V-cycle, each timed alone on the device (K2 on the stencil path): the
sum of their bounds over the sum of their device times, %."""

import torch

from portbench import readers, work
from portbench.trace import device_ms_per_call


def read(ctx):
    l0 = ctx.system.hier.levels[0]
    sm, shapes = l0.smoother, readers.cube_shapes(ctx)
    if not ctx.cuda or shapes is None or not hasattr(sm, "apply_with_residual"):
        return None
    b = ctx.pool[0]
    x0 = torch.zeros_like(b)
    x1 = sm.apply(l0.op, b, x0)
    t_pre = device_ms_per_call(lambda: sm.apply_with_residual(l0.op, b, x0))
    t_post = device_ms_per_call(lambda: sm.apply(l0.op, b, x1))
    if t_pre is None or t_post is None:
        return None
    n, nnz = shapes["n0"], shapes["a0_nnz"]
    half, deg = work.symmetric_half(nnz, n), ctx.config["smoother"]["degree"]
    bounds = [work.bound(*work.k2_work(n, half, nnz, deg, res,
                                       readers.coeff_bytes(ctx),
                                       readers.vector_bytes(ctx)))
              for res in (True, False)]
    ctx.notes["smoother_bound_by"] = [bb for _, bb in bounds]
    return 100.0 * sum(s for s, _ in bounds) / ((t_pre + t_post) / 1e3)

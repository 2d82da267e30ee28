"""The level-1 sub-cycle of the V-cycle (levels 1 and 2, the fused coarse
tail) timed alone on the device, as the program runs it: its bound over its
device time, %."""

from portbench import readers, work
from portbench.trace import device_ms_per_call


def read(ctx):
    hier = ctx.system.hier
    fused, shapes = getattr(hier.levels[0], "fused", None), readers.cube_shapes(ctx)
    if not ctx.cuda or fused is None or shapes is None:
        return None
    if getattr(fused, "fine_grid", None) is not None:
        return None                        # the full-mode tail: not this cell's
    from mfmg_torch.ops.fused_cycle import fused_subcycle_apply
    b1 = hier.levels[0].transfer.restrict(ctx.pool[0])
    t = device_ms_per_call(lambda: fused_subcycle_apply(fused, b1))
    if t is None:
        return None
    sm = ctx.config["smoother"]
    sec, by = work.bound(*work.tail_subcycle_work(
        shapes["n1"], shapes["n2"], shapes["a1_nnz"], shapes["r1_nnz"],
        sm["degree"], sm["n_smoothing_steps"], readers.coeff_bytes(ctx),
        readers.vector_bytes(ctx)))
    ctx.notes["tail_bound_by"] = by
    return 100.0 * sec / (t / 1e3)

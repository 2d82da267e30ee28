"""What several per-layer metrics share: the sizes of a hierarchy on the
Q1 cube, bytes per entry of the configuration's types, and the readings
that more than one traffic reports (device ms a V-cycle, the idle share,
the rate).  Device times come from torch.profiler (trace.py); the work from
work.py's frozen counts at the cell's shapes.  A reading whose layer is not
on this cell's path returns None, and the metric is left out, never 0."""

from __future__ import annotations

from portbench import work
from portbench.trace import device_ms_per_call

BYTES = {"float32": 4, "bfloat16": 2, "float16": 2, "float64": 8}


def vector_bytes(ctx) -> int:
    return BYTES[ctx.config["assumed"]["dtype"]]


def coeff_bytes(ctx) -> int:
    a = ctx.config["assumed"]
    return BYTES[a["coeff_dtype"] or a["dtype"]]


def cube_shapes(ctx) -> dict | None:
    """work.cube_levels at the run's size, where the mesh is the cube cut
    into equal block agglomerates; None elsewhere."""
    cfg = ctx.config
    agg = cfg["agglomeration"]
    if not (cfg["laplace"]["mesh"] == "hyper_cube" and agg["partitioner"] == "block"
            and agg["nx"] == agg["ny"] == agg["nz"]):
        return None
    return work.cube_levels(ctx.n_refinements, agg["nx"],
                            cfg["eigensolver"]["n_eigenvectors"],
                            cfg["assumed"]["n_eigenvectors_deep"])


def vcycle_device_ms(ctx) -> float | None:
    """Device ms per ``vmult`` on the pool's first input."""
    if not ctx.cuda:
        return None
    hier, b = ctx.system.hier, ctx.pool[0]
    return device_ms_per_call(lambda: hier.vmult(b), 20)


def idle_share(ctx) -> float | None:
    """1 - device busy time / wall time over the profiled stretch, %."""
    p = ctx.traced()
    if p is None or p.wall_s <= 0:
        return None
    return 100.0 * (1.0 - p.busy_s / p.wall_s)


def rate(ctx) -> float:
    """Fine dofs times requests completed in the window over its seconds,
    Mdof/s."""
    w = ctx.window
    return ctx.system.n * w.completed / w.seconds / 1e6

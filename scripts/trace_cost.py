"""What the port's tracing (mfmg_torch/utils/trace.py) costs in one cell of
the benchmark, and how its spans line up with the profiler's events.

    python3 scripts/trace_cost.py --workload <cell> --seed <n> [--pairs 3]

Builds the cell as ``portbench/run.py`` does, then, in this one process:

- on: the host ms of a request over the cell's ``trace_requests`` requests
  with tracing off and on, in turns (``--pairs`` of each);
- off: the host ns of one null span, times the spans a request opens;
- the offset of each span's start from the start of its
  ``record_function`` host event under a CPU profile (us: median, p99,
  min, max).

Prints one line per reading and the card's name and power limit first.
Needs a CUDA device.
"""

import argparse
import os
import statistics
import sys
import timeit

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from mfmg_torch.utils import trace  # noqa: E402
from portbench import core, spans  # noqa: E402


def request_ms(ctx, on):
    """Host ms a request over ``trace_requests`` requests; spans dropped."""
    ctx.system.synchronize()
    t0, t1 = spans._timed(ctx, trace, on)
    trace.take()
    return (t1 - t0) / 1e6 / ctx.traffic["trace_requests"]


def null_span_ns(calls=200_000):
    """Host ns of one span while tracing is off: the call and its null
    context's entry and exit."""
    span = trace.span

    def site():
        with span("x"):
            pass
    return min(timeit.repeat(site, number=calls, repeat=3)) / calls * 1e9


def range_offsets_us(ctx):
    """Each span's start less the start of the ``record_function`` host
    event that it opened, us."""
    from torch.profiler import ProfilerActivity, profile
    n = ctx.traffic["trace_requests"]
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trace.enable()
        try:
            for k in range(n):
                ctx.serve(ctx.pool[k % ctx.pool.shape[0]])
            ctx.system.synchronize()
        finally:
            trace.disable()
    kept = trace.take()
    names = {s.name for s in kept}
    events = {}
    for e in prof.profiler.kineto_results.events():
        if e.name() in names:
            events.setdefault(e.name(), []).append(e.start_ns())
    out = []
    for name, starts in events.items():
        mine = [s.start_ns for s in kept if s.name == name]
        out += [(a - b) / 1e3 for a, b in zip(mine, sorted(starts))]
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--pairs", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 3
    print(f"card: {core.card_line()}; torch {torch.__version__}", flush=True)
    cell = core.Cell(core.load_json(core.ROOT / "BENCHMARK.json"), args.workload)
    n_ref = core.n_refinements(cell.config, False)
    system, inputs, serve = core.set_up(cell, torch.device("cuda", 0), n_ref,
                                        args.seed)
    ctx = core.Context(cell, system, inputs["pool"], serve, None, 0.0, n_ref)

    ms = {"off": [], "on": []}
    for _ in range(args.pairs):
        for state in ms:
            ms[state].append(request_ms(ctx, state == "on"))
    print(f"request ms off {ms['off']} on {ms['on']}; median on / off "
          f"{statistics.median(ms['on']) / statistics.median(ms['off']):.4f}")

    st = spans._run(ctx, trace)
    per = sum(st.counts.values()) / st.n
    ns = null_span_ns()
    off_us = per * ns / 1e3
    print(f"null span {ns:.1f} ns; {per:.1f} spans a request: {off_us:.2f} us "
          f"a request, {100 * off_us / 1e3 / statistics.median(ms['off']):.3f}% "
          f"of its ms")

    d = sorted(range_offsets_us(ctx))
    if d:
        p99 = d[min(len(d) - 1, int(0.99 * len(d)))]
        print(f"span start less its record_function start, us, over {len(d)}: "
              f"median {statistics.median(d):.2f} p99 {p99:.2f} min {d[0]:.2f} "
              f"max {d[-1]:.2f}")
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The readings that a cell's limits are set from, in one process.

    python3 portbench/control.py --workload <cell> --seeds 1 2 3 ... \
        [--seconds 3] [--faults] [--dry]

For each seed, the program's readings: the traffic's warm-up requests and a
short window at the cell's load (the run's own set-up, request and loop),
its kept answers judged as a run judges them.  Then the control's: the reference's own solver in the
program's place (a plain Jacobi-preconditioned CG to the configuration's
tolerance, solve and preconditioner alike), computed in bfloat16, the
precision below the configuration's float32, on the first three rows of
the pools of the first CONTROL_SEEDS seeds; and in float32 on the first, to show that the reference's solver meets the limits at the
configuration's precision.  With ``--faults``, each of faults.py's faults
planted in the program on the first CONTROL_SEEDS seeds, at the same load.
Every reading goes through the run's own
comparison (judge.decide), which prints ``correct``.  One JSON line per
reading.  The benchmark's runs never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

import torch  # noqa: E402

from portbench.core import (ROOT, Cell, check_answers, kept_for_check,  # noqa: E402
                            load_json, n_refinements, reference_problem)

CONTROL_SEEDS, CONTROL_MAXITER = 3, 1000


def program_reading(cell, system, problem, seed: int, seconds: float) -> dict:
    """A window's kept answers at ``seed``, judged."""
    from portbench.loadgen import run
    inputs = cell.request.inputs(cell.traffic, system, seed, problem)
    serve = cell.request.serve(system, cell.config, cell.traffic)
    pool = inputs["pool"]
    for j in range(cell.traffic["warmup"]):
        serve(pool[j % pool.shape[0]])
    w = run(cell.traffic, serve, pool, seconds, seed)
    kept = kept_for_check(system, w, inputs)
    return {"side": "program", "seed": seed, "requests": w.completed,
            "summary": cell.request.summary(w.counters),
            "kept": kept["answers"].shape[0],
            "readings": check_answers(cell, kept, None, None, problem())}


def control_reading(cell, system, problem, seed: int, dtype,
                    maxiter: int) -> dict:
    """The reference's CG in ``dtype`` in the program's place on the first
    three rows of the pool at ``seed`` (where the traffic makes its inputs
    in groups of three, the first group), judged."""
    from portbench.reference.solver import cg
    inputs = cell.request.inputs(cell.traffic, system, seed, problem)
    ref = problem()
    tol = cell.config["solver"]["tolerance"]
    rows = [0, 1, 2]
    answers, its = [], []
    for j in rows:
        x, it = cg(ref.op, ref.to_ref(inputs["pool"][j]), tol, maxiter, dtype)
        answers.append(ref.to_program(x))
        its.append(it)
    kept = {key: v[rows] for key, v in inputs.items()}
    kept.update(nodes=None, constrained=None, index=torch.tensor(rows),
                answers=torch.stack(answers))
    return {"side": f"control {str(dtype).replace('torch.', '')}", "seed": seed,
            "iterations": its,
            "readings": check_answers(cell, kept, None, None, ref)}


def main(argv=None) -> int:
    from portbench.reference.judge import decide
    from portbench.system import System
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--faults", action="store_true")
    ap.add_argument("--dry", action="store_true")
    args = ap.parse_args(argv)

    cell = Cell(load_json(ROOT / "BENCHMARK.json"), args.workload)
    device = torch.device("cpu" if args.dry else "cuda")
    n_ref = n_refinements(cell.config, args.dry)
    t0 = time.perf_counter()
    system = System(cell.config, device, n_ref)
    built = reference_problem(cell, system, n_ref)()
    problem = lambda store=True: built                    # noqa: E731
    print(json.dumps({"cell": cell.name, "levels": system.levels,
                      "setup_s": time.perf_counter() - t0}), flush=True)

    def show(r, t):
        r["correct"], _ = decide(r["readings"], cell.limits)
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)

    for seed in args.seeds:
        t = time.perf_counter()
        show(program_reading(cell, system, problem, seed, args.seconds), t)
    runs = [(s, torch.bfloat16, CONTROL_MAXITER) for s in args.seeds[:CONTROL_SEEDS]]
    runs.append((args.seeds[0], torch.float32, 3 * CONTROL_MAXITER))
    for seed, dtype, maxiter in runs:
        t = time.perf_counter()
        show(control_reading(cell, system, problem, seed, dtype, maxiter), t)
    if args.faults:
        from portbench import faults
        request = cell.traffic["request"]
        for fault in faults.ALTER[request]:
            for seed in args.seeds[:CONTROL_SEEDS]:
                t = time.perf_counter()
                with faults.planted(request, fault):
                    r = program_reading(cell, system, problem, seed, args.seconds)
                r["side"] = f"fault {fault}"
                show(r, t)
    return 0


if __name__ == "__main__":
    sys.exit(main())

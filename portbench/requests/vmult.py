"""vmult: one application of the preconditioner, y = M^-1 r
(``Hierarchy.vmult``, one V-cycle), followed by one host read of the norm of
y, as an outer Krylov method makes.

The inputs are r = A e, with A the reference's own operator in float64, in
groups of three rows: two e drawn from the seed (``uniform``), their r
rounded to the program's precision, and the sum of the two, e and r alike.

A V-cycle approximates A^-1, so y is judged by its error in the energy
norm, ||e - y||_A / ||e||_A, under the same operator.  That error is the
V-cycle's own (some hundredths), which no loss of precision moves, so the
answers are also judged by what any V-cycle is, a linear map: the answer to
a group's sum less the answers to its two rows, ||y_c - y_a - y_b||_A /
||y_c||_A, is rounding at the working precision and grows with any lower
one."""

from __future__ import annotations

import math

import torch

from portbench.loadgen import uniform


def _groups(x: torch.Tensor) -> torch.Tensor:
    """x (2h, n) as h groups of three rows: two rows of x and their sum."""
    pairs = x.reshape(-1, 2, x.shape[1])
    return torch.cat([pairs, pairs.sum(1, keepdim=True)], 1).reshape(-1, x.shape[1])


def inputs(traffic: dict, system, seed: int, problem) -> dict:
    if traffic["pool"] % 3:
        raise ValueError("a vmult pool is made of groups of three rows")
    e = uniform(traffic["pool"] // 3 * 2, system.n, system.mesh()[2], seed,
                system.device, system.dtype)
    ref = problem(store=False)
    r = ref.to_program(ref.op.apply(ref.to_ref(e.T))).T.to(system.dtype)
    return {"pool": _groups(r).contiguous(), "truth": _groups(e)}


def serve(system, cfg: dict, traffic: dict):
    hier = system.hier

    def vmult(r):
        y = hier.vmult(r)
        norm = float(torch.linalg.norm(y))
        return y, {"ok": math.isfinite(norm)}
    return vmult


def summary(counters: list) -> str:
    return f"{sum(c['ok'] for c in counters)} of {len(counters)} finite"


def energy_error(op, E: torch.Tensor, Y: torch.Tensor) -> list[float]:
    """||e - y||_A / ||e||_A in float64 for each column of E (n, k) and Y."""
    E = E.to(device=op.device, dtype=torch.float64)
    Y = Y.to(device=op.device, dtype=torch.float64)
    return (op.energy(E - Y) / op.energy(E)).tolist()


def linearity_gap(op, Y: torch.Tensor, index) -> float:
    """The largest ||y_c - y_a - y_b||_A / ||y_c||_A over the kept answers
    (columns of Y, (n, k)) to the rows 3g, 3g + 1 and 3g + 2 of the pool
    (``index``: the row of each column), the first kept of each row,
    float64; NaN where no such three are kept."""
    first = {}
    for col, row in enumerate(torch.as_tensor(index).tolist()):
        first.setdefault(row, col)
    triples = [(first[3 * g], first[3 * g + 1], first[3 * g + 2])
               for g in range(max(first) // 3 + 1)
               if {3 * g, 3 * g + 1, 3 * g + 2} <= first.keys()]
    if not triples:
        return math.nan
    Y = Y.to(device=op.device, dtype=torch.float64)
    a, b, c = (list(t) for t in zip(*triples))
    gap = op.energy(Y[:, c] - Y[:, a] - Y[:, b]) / op.energy(Y[:, c])
    return float(gap.max())


def judge(problem, kept: dict) -> dict:
    E, Y = problem.to_ref(kept["truth"].T), problem.to_ref(kept["answers"].T)
    if E is None:
        return {"energy_error_max": math.nan, "linearity_gap_max": math.nan}
    err = energy_error(problem.op, E, Y)
    lin = linearity_gap(problem.op, Y, kept["index"])
    print(f"energy-norm error of {len(err)} kept applies: min {min(err):.6e} "
          f"max {max(err):.6e}; linearity gap {lin:.6e}", flush=True)
    return {"energy_error_max": max(err), "linearity_gap_max": lin}

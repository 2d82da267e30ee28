"""solve: x of A x = b by the hierarchy-preconditioned CG
(``Hierarchy.solve_cg``) to the configuration's tolerance, b the next
right-hand side of the pool; judged by its true residual ||b - A x|| / ||b||
under the reference's own operator in float64."""

from __future__ import annotations

import math

import torch

from portbench.loadgen import uniform


def inputs(traffic: dict, system, seed: int, problem) -> dict:
    return {"pool": uniform(traffic["pool"], system.n, system.mesh()[2], seed,
                            system.device, system.dtype)}


def serve(system, cfg: dict, traffic: dict):
    tol, maxiter = cfg["solver"]["tolerance"], traffic["maxiter"]
    hier = system.hier

    def solve(b):
        x, info = hier.solve_cg(b, tol=tol, maxiter=maxiter)
        system.synchronize()
        return x, {"iterations": info["iterations"],
                   "ok": info["relres"] <= tol}
    return solve


def summary(counters: list) -> str:
    its = [c["iterations"] for c in counters]
    return f"PCG iterations {({k: its.count(k) for k in sorted(set(its))})}"


def true_relres(op, B: torch.Tensor, X: torch.Tensor) -> list[float]:
    """||b - A x||_2 / ||b||_2 in float64 for each column of B (n, k) and X."""
    B = B.to(device=op.device, dtype=torch.float64)
    X = X.to(device=op.device, dtype=torch.float64)
    R = B - op.apply(X)
    return (torch.linalg.norm(R, dim=0) / torch.linalg.norm(B, dim=0)).tolist()


def judge(problem, kept: dict) -> dict:
    B, X = problem.to_ref(kept["pool"].T), problem.to_ref(kept["answers"].T)
    if B is None:
        return {"true_relres_max": math.nan}
    rel = true_relres(problem.op, B, X)
    print(f"true relres of {len(rel)} kept solves: min {min(rel):.6e} "
          f"max {max(rel):.6e}", flush=True)
    return {"true_relres_max": max(rel)}

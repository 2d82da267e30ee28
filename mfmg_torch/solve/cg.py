"""Preconditioned conjugate gradients.

Port of mfmg_tpu/solve/cg.py (the reference's dealii::SolverCG with the
Hierarchy as preconditioner, tests/laplace.hpp:206-219).  A Python loop with
the reference's stopping rule ||r|| <= tol * ||b||; the norm check is the
one host synchronization per iteration.
"""

from __future__ import annotations

import torch

from mfmg_torch.solve.operator import apply_op


def cg_solve(op, b, preconditioner=None, x0=None, tol=1e-12, maxiter=1000):
    """Solve A x = b.  Returns (x, {"iterations": int, "relres": float})."""
    if preconditioner is None:
        def preconditioner(r):
            return r
    x = torch.zeros_like(b) if x0 is None else x0
    b_norm = float(torch.linalg.norm(b))
    scale = b_norm if b_norm > 0 else 1.0
    atol = tol * scale

    r = b - apply_op(op, x)
    z = preconditioner(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter and float(torch.linalg.norm(r)) > atol:
        Ap = apply_op(op, p)
        alpha = rz / torch.dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = preconditioner(r)
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, {"iterations": k, "relres": float(torch.linalg.norm(r)) / scale}

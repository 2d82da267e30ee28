"""Preconditioned conjugate gradients.

Port of mfmg_tpu/solve/cg.py (the reference's dealii::SolverCG with the
Hierarchy as preconditioner, tests/laplace.hpp:206-219).  A Python loop with
the reference's stopping rule ||r|| <= tol * ||b||; the norm check is the
one host synchronization per iteration.  Spans (utils/trace.py): each pass of
the loop is "pcg.iteration", each apply of the operator "pcg.operator", and
each host read that waits on the device ("sync") the norm of b, the loop's
test and the final relative residual.
"""

from __future__ import annotations

import torch

from mfmg_torch.solve.operator import apply_op
from mfmg_torch.utils.trace import span


def cg_solve(op, b, preconditioner=None, x0=None, tol=1e-12, maxiter=1000):
    """Solve A x = b.  Returns (x, {"iterations": int, "relres": float})."""
    if preconditioner is None:
        def preconditioner(r):
            return r
    x = torch.zeros_like(b) if x0 is None else x0
    with span("sync"):
        b_norm = float(torch.linalg.norm(b))
    scale = b_norm if b_norm > 0 else 1.0
    atol = tol * scale

    with span("pcg.operator"):
        r = b - apply_op(op, x)
    z = preconditioner(r)
    p = z
    rz = torch.dot(r, z)
    k = 0
    while k < maxiter:
        with span("sync"):
            r_norm = float(torch.linalg.norm(r))
        if not r_norm > atol:
            break
        with span("pcg.iteration"):
            with span("pcg.operator"):
                Ap = apply_op(op, p)
            alpha = rz / torch.dot(p, Ap)
            x = x + alpha * p
            r = r - alpha * Ap
            z = preconditioner(r)
            rz_new = torch.dot(r, z)
            p = z + (rz_new / rz) * p
            rz = rz_new
        k += 1
    with span("sync"):
        relres = float(torch.linalg.norm(r)) / scale
    return x, {"iterations": k, "relres": relres}

"""A plain Jacobi-preconditioned conjugate-gradient solver over the
reference operator, in any precision: the control that stands in the
program's place, computed in the precision below the configuration's."""

from __future__ import annotations

import torch


def _dot(a, b):
    return (a * b).sum()


def cg(op, b: torch.Tensor, tol: float, maxiter: int, dtype) -> tuple[torch.Tensor, int]:
    """Solve op x = b to ||r|| <= tol ||b|| or ``maxiter`` iterations, every
    vector, product and sum in ``dtype``.  Returns (x, iterations)."""
    b = b.to(device=op.device, dtype=dtype)
    dinv = (1.0 / op.diag).to(dtype)
    x = torch.zeros_like(b)
    r = b.clone()
    z = dinv * r
    p = z
    rz = _dot(r, z)
    atol = tol * float(torch.linalg.norm(b.double()))
    k = 0
    while k < maxiter and float(torch.linalg.norm(r.double())) > atol:
        Ap = op.apply(p, dtype)
        alpha = rz / _dot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = dinv * r
        rz_new = _dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
        k += 1
    return x, k

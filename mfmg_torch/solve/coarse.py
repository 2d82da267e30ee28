"""Coarsest-level direct solver.

Port of the "direct" branch of mfmg_tpu/solve/coarse.py, the analog of the
reference's Amesos-KLU / cusolver dense solves (source/dealii/
dealii_solver.cc:25-87, source/cuda/cuda_solver.cu:42-515): the coarse
matrix is inverted once on the host and the apply is one dense matvec.
The CG, AMG and ML coarse solvers are not ported yet (ROADMAP Queue 1,
Slice E).
"""

from __future__ import annotations

import numpy as np
import scipy.linalg
import scipy.sparse as sp
import torch
from torch import nn


class DirectCoarseSolver(nn.Module):
    """x = A_c^+ b as one matmul.  A pseudoinverse (eigh with a relative
    cutoff) rather than a factorization because AMGe coarse matrices can be
    exactly consistent-singular (dependent restriction rows)."""

    def __init__(self, inv: torch.Tensor):
        super().__init__()
        self.register_buffer("inv", inv)

    def apply(self, b):
        return self.inv @ b


def build_coarse_solver(A_c: sp.spmatrix, coarse_cfg, dtype, device):
    """Factory (analog of HierarchyHelpers::build_coarse_solver), "direct"
    family only.  A large float32 problem takes the reference's jittered
    float32 Cholesky inverse on the host; otherwise, and where that
    factorization fails (a consistent-singular coarse matrix, e.g. the
    ball's level 2 at 14,336 dofs), the pseudoinverse comes from float64
    ``torch.linalg.eigh`` on ``device`` with the reference's relative
    cutoff.  The inverse is returned on the device it was made on."""
    ctype = coarse_cfg.type.strip().lower()
    if ctype not in ("direct", "cholesky", "lu_dense", "amesos-klu"):
        raise NotImplementedError(f"coarse solver {coarse_cfg.type!r} is not "
                                  f"ported yet (ROADMAP Queue 1, Slice E)")
    Ad = np.asarray(A_c.todense())
    Ad = 0.5 * (Ad + Ad.T)                 # symmetrize against assembly roundoff
    n = Ad.shape[0]
    if n >= 2048 and dtype != torch.float64:
        # large coarse problems: jittered float32 Cholesky inverse on the
        # host (the jitter keeps consistent-singular matrices factorizable)
        A32 = Ad.astype(np.float32)
        jitter = np.float32(1e-6 * (np.trace(A32) / n))
        try:
            c = scipy.linalg.cho_factor(A32 + jitter * np.eye(n, dtype=np.float32))
            inv = scipy.linalg.cho_solve(c, np.eye(n, dtype=np.float32))
            if np.all(np.isfinite(inv)):
                return DirectCoarseSolver(torch.from_numpy(inv).to(dtype))
        except scipy.linalg.LinAlgError:
            pass                           # fall through to the eigh pinv
    w, V = torch.linalg.eigh(torch.from_numpy(Ad).to(device, torch.float64))
    cut = w > 1e-10 * max(float(w[-1]), 0.0)
    Vc = V[:, cut]
    return DirectCoarseSolver(((Vc / w[cut]) @ Vc.T).to(dtype))

"""Host CSR assembly and Dirichlet elimination (scipy, setup time).

Copied from mfmg_tpu/ops/sparse.py.  The port's apply path never uses the
assembled matrix; it serves the coarse Galerkin fallback of a one-level
hierarchy, the tests, and the true-residual check.  The ELL device matrix is
not ported yet (ROADMAP Queue 1, Slice E).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def eliminate_dirichlet(A_raw: sp.spmatrix, constrained: np.ndarray) -> sp.csr_matrix:
    """Zero constrained rows/cols, keep the raw diagonal entry at constrained
    dofs (the analog of deal.II AffineConstraints condensation, reference
    tests/laplace.hpp:197-199; the raw diagonal preserves the partition of
    unity sum_agg local_diag/global_diag = 1)."""
    A = sp.coo_matrix(A_raw)
    keep = (~constrained[A.row] & ~constrained[A.col]) | (A.row == A.col)
    return sp.csr_matrix((A.data[keep], (A.row[keep], A.col[keep])), shape=A.shape)


def assemble_csr(cells: np.ndarray, A_loc: np.ndarray, n_dofs: int) -> sp.csr_matrix:
    """Assemble batched cell matrices (n_cells, n_loc, n_loc) into a global
    CSR."""
    n_cells, n_loc = cells.shape
    rows = np.broadcast_to(cells[:, :, None], (n_cells, n_loc, n_loc)).reshape(-1)
    cols = np.broadcast_to(cells[:, None, :], (n_cells, n_loc, n_loc)).reshape(-1)
    A = sp.csr_matrix((A_loc.reshape(-1), (rows, cols)), shape=(n_dofs, n_dofs))
    A.sum_duplicates()
    return A

"""Restriction matrix assembly with partition-of-unity weights.

Port of mfmg_tpu/amge/restriction.py (host scipy).  Analog of
AMGe::compute_restriction_sparse_matrix (reference
common/amge.templates.hpp:271-325): row (agglomerate g, eigenvector k) has
entries  w_i * evec_k[i]  over the agglomerate's dofs i, with the diagonal
partition-of-unity weight

    w_i = local_diag_g[i] / global_diag[i]          (amge.templates.hpp:314-317)

so that Σ_g w_i = 1 at every dof (asserted by check_restriction, the analog of
check_restriction_matrix in common/utils.hpp:81-155).

Also produces the eigenvector matrix E and ΔE = (w-1)·evec needed by the
fast-AP construction (amge.templates.hpp:327-410).
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp

from mfmg_torch.amge.local_problems import AgglomerateBatch


def build_restriction(batch: AgglomerateBatch, evecs: np.ndarray,
                      global_diag: np.ndarray, n_dofs: int,
                      with_fast_ap_matrices: bool = False):
    """Assemble R (and optionally E, ΔE) as scipy CSR.

    evecs: (n_agg, m_max, n_ev) from the batched eigensolver (zero on padding).
    Returns R of shape (n_agg * n_ev, n_dofs), rows ordered by (agg, evec).
    """
    n_agg, m_max, n_ev = evecs.shape
    w = np.where(batch.valid, batch.diag / np.where(batch.dof_map >= 0, global_diag[batch.dof_map], 1.0), 0.0)

    # COO arrays: entry (g, k, i) -> row g*n_ev + k, col dof_map[g, i]
    gi, ii = np.nonzero(batch.valid)
    cols = batch.dof_map[gi, ii]                          # (nnz_per_k,)
    rows_base = gi * n_ev
    data_R, data_E, data_dE, rows_all, cols_all = [], [], [], [], []
    for k in range(n_ev):
        vals = evecs[gi, ii, k]
        rows_all.append(rows_base + k)
        cols_all.append(cols)
        data_R.append(w[gi, ii] * vals)
        if with_fast_ap_matrices:
            data_E.append(vals)
            data_dE.append((w[gi, ii] - 1.0) * vals)
    rows_all = np.concatenate(rows_all)
    cols_all = np.concatenate(cols_all)
    shape = (n_agg * n_ev, n_dofs)
    R = sp.csr_matrix((np.concatenate(data_R), (rows_all, cols_all)), shape=shape)
    if not with_fast_ap_matrices:
        return R
    E = sp.csr_matrix((np.concatenate(data_E), (rows_all, cols_all)), shape=shape)
    dE = sp.csr_matrix((np.concatenate(data_dE), (rows_all, cols_all)), shape=shape)
    return R, E, dE


def check_restriction(batch: AgglomerateBatch, global_diag: np.ndarray,
                      n_dofs: int, tol: float = 1e-12) -> None:
    """Debug self-check (analog of check_restriction_matrix,
    common/utils.hpp:81-155): local diagonals sum to the global diagonal and
    PoU weights sum to 1 at every dof covered by an agglomerate."""
    diag_sum = np.zeros(n_dofs)
    gi, ii = np.nonzero(batch.valid)
    np.add.at(diag_sum, batch.dof_map[gi, ii], batch.diag[gi, ii])
    covered = np.zeros(n_dofs, dtype=bool)
    covered[batch.dof_map[gi, ii]] = True
    rel = np.abs(diag_sum[covered] - global_diag[covered]) / np.abs(global_diag[covered])
    if rel.max() > tol:
        raise AssertionError(f"partition of unity violated: max rel err {rel.max():.3e}")

"""The ELL device matrix, host CSR assembly and Dirichlet elimination.

Port of mfmg_tpu/ops/sparse.py.  ``ELLMatrix`` is the assembled operator of
the library's default matrix path (``Config(operator="ell")``), the
restriction and prolongation of levels without a structured transfer, and
the coarse operator of levels outside the block-stencil window: padded rows
of (value, column), applied as one gather of x and a row sum (the
reference's ``ell_spmv``, mfmg_tpu/ops/sparse.py:48-51, an XLA gather that
is no Pallas kernel; here PyTorch ops on the tensor's device).  Setup-time
sparse products (the Galerkin triple product R A R^T) stay on the host in
scipy, as in the reference.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch
from torch import nn

from mfmg_torch.utils.trace import span


class ELLMatrix(nn.Module):
    """ELL (padded-row) sparse matrix.

    vals : (n_rows, L) float buffer
    cols : (n_rows, L) int32 buffer; padded entries point at column 0 with
           value 0.
    n_cols : the number of columns.
    ``forward(x)`` is y = A x; the module moves with ``.to(device)``.
    """

    def __init__(self, vals: torch.Tensor, cols: torch.Tensor, n_cols: int):
        super().__init__()
        self.register_buffer("vals", vals)
        self.register_buffer("cols", cols)
        self.n_cols = int(n_cols)

    @property
    def shape(self):
        return (self.vals.shape[0], self.n_cols)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with span("ell.apply"):
            return (self.vals * x[self.cols]).sum(dim=1)


class ELLTransfer(nn.Module):
    """The transfer of a level without a structured or window transfer: R
    (restriction into the next level) and R^T (prolongation) as ELL
    matrices, the reference's LevelData.R / LevelData.RT
    (mfmg_tpu/amge/hierarchy.py:54-60)."""

    def __init__(self, R: ELLMatrix, RT: ELLMatrix):
        super().__init__()
        self.R = R
        self.RT = RT

    @property
    def shape(self):
        return self.R.shape

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        return self.R(x)

    def prolong(self, xc: torch.Tensor) -> torch.Tensor:
        return self.RT(xc)


def ell_transfer_from_scipy(R: sp.spmatrix, dtype=torch.float64,
                            device="cpu") -> ELLTransfer:
    """ELLTransfer of the restriction R (n_coarse, n_fine)."""
    R = sp.csr_matrix(R)
    return ELLTransfer(ell_from_scipy(R, dtype=dtype, device=device),
                       ell_from_scipy(R.T.tocsr(), dtype=dtype, device=device))


def ell_pack_plain(indptr, indices, data, n_rows: int, L: int):
    """The numpy version of native.ell_pack (the reference's vectorized
    fill): (vals (n_rows, L) float64, cols (n_rows, L) int32)."""
    vals = np.zeros((n_rows, L), dtype=np.float64)
    cols = np.zeros((n_rows, L), dtype=np.int32)
    row_nnz = np.diff(indptr)
    nnz = int(indptr[-1]) if n_rows else 0
    if nnz > 0:
        rows = np.repeat(np.arange(n_rows), row_nnz)
        pos = np.arange(nnz) - np.repeat(indptr[:-1], row_nnz)
        vals[rows, pos] = data
        cols[rows, pos] = indices
    return vals, cols


def ell_from_scipy(A: sp.spmatrix, dtype=torch.float64, device="cpu",
                   pad_to: int | None = None) -> ELLMatrix:
    """A scipy sparse matrix as an ELLMatrix of ``dtype`` on ``device``,
    rows padded to the longest row (at least ``pad_to``); packed in float64
    by the host library, then cast."""
    from mfmg_torch import native
    A = sp.csr_matrix(A)
    A.sum_duplicates()
    n, m = A.shape
    row_nnz = np.diff(A.indptr)
    L = int(row_nnz.max()) if n > 0 else 0
    if pad_to is not None:
        L = max(L, pad_to)
    if A.nnz > 0:
        vals, cols = native.ell_pack(A.indptr, A.indices, A.data, n, L)
    else:
        vals = np.zeros((n, L))
        cols = np.zeros((n, L), dtype=np.int32)
    return ELLMatrix(torch.from_numpy(vals).to(device=device, dtype=dtype),
                     torch.from_numpy(cols).to(device), m)


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

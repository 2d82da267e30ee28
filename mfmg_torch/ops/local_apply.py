"""Matrix-free operator apply: gather -> batched cell matvec -> sum.

Port of mfmg_tpu/ops/local_apply.py, the replacement for deal.II
MatrixFree::cell_loop + FEEvaluation (reference
tests/laplace_matrix_free.hpp:129-156) and for
DealIIMatrixFreeOperator::vmult / CudaMatrixFreeOperator::vmult: all cells
in one batched contraction, the constraints as masked elementwise passes.

Two compute modes:
  * "local_matrix": per-cell stiffness matrices A_loc[c,i,j] precomputed at
    setup; the apply is one batched (n_cells, n_loc, n_loc) matvec;
  * "quadrature": through the quadrature-point gradients,
    t[c,q,d] = G[c,q,d,j] u[c,j]; y[c,i] = G[c,q,d,i] (JxW*coeff*t).

Dirichlet dofs are identity rows scaled by the raw diagonal (the
convention of ops.sparse.eliminate_dirichlet), so the matrix-free and the
assembled applies agree to roundoff, as the reference asserts at 1e-9
(tests/test_hierarchy.cc:647-695).

Where the reference scatter-adds the cell results (``.at[].add``), the
port sums them by gather in a fixed order: ``incidence`` lists, for each
dof, the (cell, slot) entries that land on it, built once at setup, and
``gather_sum`` adds them in that order.  An ``index_add_`` on CUDA adds with
atomics in an order that changes from run to run; the gather gives the
same bits on every run, so PCG counts do not move between runs.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn


def incidence(index: np.ndarray, n: int) -> torch.Tensor:
    """(n, K) int64: row t lists the positions p of ``index`` (a flat int
    array; negative entries are skipped) with index[p] == t in increasing
    p, padded with len(index), the position of the zero that ``gather_sum``
    appends; K is the largest count."""
    index = np.asarray(index, dtype=np.int64).reshape(-1)
    pos = np.nonzero(index >= 0)[0]
    tgt = index[pos]
    counts = np.bincount(tgt, minlength=n)
    K = int(counts.max()) if len(tgt) else 0
    order = np.argsort(tgt, kind="stable")
    start = np.concatenate([[0], np.cumsum(counts)[:-1]])
    rank = np.arange(len(tgt)) - start[tgt[order]]
    inc = np.full((n, K), len(index), dtype=np.int64)
    inc[tgt[order], rank] = pos[order]
    return torch.from_numpy(inc)


def gather_sum(src: torch.Tensor, inc: torch.Tensor) -> torch.Tensor:
    """out[t] = sum_k src[inc[t, k]] (flat src; the padding reads a zero),
    in the same order on every run."""
    return torch.cat([src, src.new_zeros(1)])[inc].sum(dim=1)


class MatrixFreeOperator(nn.Module):
    """The matrix-free apply data for one mesh.

    cells (n_cells, n_loc) int64; constrained (n_dofs,) bool Dirichlet mask;
    diag (n_dofs,) the raw diagonal (identity-row scale at constrained
    dofs); A_loc (n_cells, n_loc, n_loc) in local_matrix mode, G (n_cells,
    n_q, dim, n_loc) and scale (n_cells, n_q) (JxW * coeff) in quadrature
    mode.

    Hanging-node meshes (the reference applies them through deal.II
    MatrixFree + AffineConstraints, tests/laplace.hpp:126-141): the hc_*
    buffers carry the constraints u[slave] = sum_m w u[master] and the apply
    is the condensed C^T A C cell-wise: distribute into the slaves, raw cell
    apply, collect the slave rows into the masters.  hc_slaves (n_h,),
    hc_masters (n_h, m_max) and hc_weights (n_h, m_max) zero-padded past
    hc_n_masters (n_h,); diag_all (n_dofs,) the condensed eliminated
    operator's diagonal.
    """

    def __init__(self, cells, constrained, diag, A_loc=None, G=None,
                 scale=None, hc_slaves=None, hc_masters=None, hc_weights=None,
                 hc_n_masters=None, diag_all=None):
        super().__init__()
        cells = torch.as_tensor(cells).to(torch.int64)
        n = diag.shape[0]
        for name, t in (("cells", cells), ("constrained", constrained),
                        ("diag", diag), ("A_loc", A_loc), ("G", G),
                        ("scale", scale), ("hc_slaves", hc_slaves),
                        ("hc_masters", hc_masters), ("hc_weights", hc_weights),
                        ("diag_all", diag_all)):
            self.register_buffer(name, t)
        self.register_buffer("inc", incidence(cells.cpu().numpy(), n).to(
            cells.device))
        inc_m = None
        if hc_slaves is not None:
            m = hc_masters.cpu().numpy()
            valid = np.arange(m.shape[1])[None] < np.asarray(hc_n_masters)[:, None]
            inc_m = incidence(np.where(valid, m, -1), n).to(cells.device)
        self.register_buffer("inc_masters", inc_m)

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def forward(self, u):
        return mf_apply(self, u)


def mf_apply(op: MatrixFreeOperator, u: torch.Tensor) -> torch.Tensor:
    uz = torch.where(op.constrained, torch.zeros_like(u), u)
    if op.hc_slaves is not None:
        # C x: the slaves interpolated from the (Dirichlet-zeroed) masters
        uz = uz.clone()
        uz[op.hc_slaves] = (op.hc_weights * uz[op.hc_masters]).sum(dim=1)
    u_loc = uz[op.cells]                                    # (c, nl)
    if op.A_loc is not None:
        y_loc = torch.bmm(op.A_loc, u_loc.unsqueeze(-1)).squeeze(-1)
    else:
        t = torch.einsum("cqdj,cj->cqd", op.G, u_loc) * op.scale[..., None]
        y_loc = torch.einsum("cqdi,cqd->ci", op.G, t)
    y = gather_sum(y_loc.reshape(-1), op.inc)
    if op.hc_slaves is not None:
        # C^T y: the slave rows collected into the masters, then identity
        # rows (raw diagonal at the slaves, condensed at Dirichlet dofs)
        ys = y[op.hc_slaves]
        y = y + gather_sum((op.hc_weights * ys[:, None]).reshape(-1),
                           op.inc_masters)
        y[op.hc_slaves] = op.diag[op.hc_slaves] * u[op.hc_slaves]
        return torch.where(op.constrained, op.diag_all * u, y)
    return torch.where(op.constrained, op.diag * u, y)


def mf_diagonal(op: MatrixFreeOperator) -> torch.Tensor:
    """The operator diagonal without unit-vector probing (the reference
    probes per local dof, laplace_matrix_free.hpp:158-199): the local
    matrix diagonals summed per dof; the condensed diagonal on a hanging
    mesh."""
    if op.diag_all is not None:
        return op.diag_all
    if op.A_loc is not None:
        d_loc = torch.diagonal(op.A_loc, dim1=-2, dim2=-1)
    else:
        d_loc = torch.einsum("cqdi,cq,cqdi->ci", op.G, op.scale, op.G)
    d = gather_sum(d_loc.reshape(-1), op.inc)
    return torch.where(op.constrained, op.diag, d)

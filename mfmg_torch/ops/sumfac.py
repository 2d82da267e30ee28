"""Sum-factorized Q_k matrix-free operator apply.

Port of mfmg_tpu/ops/sumfac.py, the high-order form of the reference's
matrix-free operator (tests/laplace_matrix_free.hpp:129-156;
hierarchy_driver.cc dispatches fe_degree 1..10).  Where the quadrature mode
of ops/local_apply.py contracts through a per-cell (n_q, dim, n_loc)
gradient table, this factors the tensor-product structure of Q_k:

  reference gradient   t_a = (D_1d on axis a, V_1d elsewhere) u
  metric contraction   s_a = K[c,q,a,b] t_b
  integration          y  += (D_1d^T on axis a, V_1d^T elsewhere) s_a

with the per-cell data shrunk to the (n_q, dim, dim) metric K
(fem/geometry.py compute_metric).  Every contraction is one batched matmul
over all cells.  The local dof and quadrature orderings are the reference
element's x-fastest flatten, so index i reshapes to the tensor axes
(..., i_z, i_y, i_x) in C order.  The cell results are summed per dof by
gather in a fixed order (ops/local_apply.py ``gather_sum``), the same bits
on every run.  Each apply runs in a "sumfac.apply" span (utils/trace.py)
and counts one in ``stencil_kernels.APPLIES["sumfac"]``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn

from mfmg_torch.ops.local_apply import gather_sum, incidence
from mfmg_torch.ops.stencil_kernels import APPLIES
from mfmg_torch.utils.trace import span


class SumFactoredOperator(nn.Module):
    """cells (n_cells, n_loc) int64, x-fastest local order; constrained
    (n_dofs,) bool Dirichlet mask; diag (n_dofs,) the raw diagonal (the
    identity-row scale at constrained dofs); op_diag (n_dofs,) the operator
    diagonal, precomputed on the host; K (n_cells, n_q, dim, dim) the metric
    (JxW * coeff * Jinv Jinv^T); V, D (n_q_1d, k+1) the 1-D shape value and
    derivative tables."""

    def __init__(self, cells, constrained, diag, op_diag, K, V, D):
        super().__init__()
        cells = torch.as_tensor(cells).to(torch.int64)
        for name, t in (("cells", cells), ("constrained", constrained),
                        ("diag", diag), ("op_diag", op_diag), ("K", K),
                        ("V", V), ("D", D)):
            self.register_buffer(name, t)
        self.register_buffer("inc", incidence(cells.cpu().numpy(),
                                              diag.shape[0]).to(cells.device))

    @property
    def shape(self):
        n = self.diag.shape[0]
        return (n, n)

    def forward(self, u):
        APPLIES["sumfac"] += 1
        with span("sumfac.apply"):
            return sumfac_apply(self, u)


def _contract_axis(w: torch.Tensor, M: torch.Tensor, spatial_axis: int,
                   dim: int) -> torch.Tensor:
    """Contract the 1-D operator M (out, in) along spatial axis d of w, of
    shape (n_cells, a_{dim-1}, ..., a_0): axis d sits at tensor position
    dim - d (x last)."""
    ax = dim - spatial_axis
    return torch.movedim(torch.movedim(w, ax, -1) @ M.T, -1, ax)


def sumfac_apply(op: SumFactoredOperator, u: torch.Tensor) -> torch.Tensor:
    dim = op.K.shape[-1]
    n_cells = op.cells.shape[0]
    n1, nq1 = op.V.shape[1], op.V.shape[0]
    n_q = op.K.shape[1]

    uz = torch.where(op.constrained, torch.zeros_like(u), u)
    w0 = uz[op.cells].reshape((n_cells,) + (n1,) * dim)
    # forward: reference-space gradients at the quadrature points
    t = []
    for a in range(dim):
        w = w0
        for d in range(dim):
            w = _contract_axis(w, op.D if d == a else op.V, d, dim)
        t.append(w.reshape(n_cells, n_q))
    t = torch.stack(t, dim=-1)                          # (c, q, dim)
    s = torch.einsum("cqab,cqb->cqa", op.K, t)          # metric contraction
    # backward: integrate with the transposed 1-D operators
    y_loc = torch.zeros((n_cells,) + (n1,) * dim, dtype=u.dtype,
                        device=u.device)
    for a in range(dim):
        w = s[..., a].reshape((n_cells,) + (nq1,) * dim)
        for d in range(dim):
            w = _contract_axis(w, (op.D if d == a else op.V).T, d, dim)
        y_loc = y_loc + w
    y = gather_sum(y_loc.reshape(-1), op.inc)
    return torch.where(op.constrained, op.diag * u, y)


def build_sumfac_operator(mesh, coeff_at_q: np.ndarray, diag_raw: np.ndarray,
                          A_loc: np.ndarray, dtype=torch.float32,
                          device="cpu") -> SumFactoredOperator:
    """The operator from host setup data (mfmg_tpu/ops/sumfac.py:117-142).
    A_loc serves only the operator diagonal (one host sum at setup); the
    device never holds the O(n_loc^2) cell matrices."""
    from mfmg_torch.fem.geometry import compute_metric
    from mfmg_torch.fem.reference import reference_element

    ref = reference_element(mesh.dim, mesh.degree)
    K = compute_metric(mesh, coeff_at_q)
    d_loc = np.einsum("cii->ci", A_loc)
    op_diag = np.zeros(mesh.n_nodes)
    np.add.at(op_diag, mesh.cells.reshape(-1), d_loc.reshape(-1))
    op_diag = np.where(mesh.boundary_dofs, diag_raw, op_diag)

    def dev(a, dt=dtype):
        return torch.as_tensor(np.asarray(a), dtype=dt, device=device)

    return SumFactoredOperator(
        cells=torch.as_tensor(mesh.cells, device=device),
        constrained=torch.as_tensor(mesh.boundary_dofs, device=device),
        diag=dev(diag_raw), op_diag=dev(op_diag), K=dev(K), V=dev(ref.v1d),
        D=dev(ref.g1d))

"""The reference's own mesh and operator of upstream's matrix-free application
at fe_degree 2 (tests/hierarchy_driver.cc, matrix_free_two_grids<3, 2>, over
tests/laplace_matrix_free.hpp): the unit cube cut into 2^r cells a side,
each a triquadratic Lagrange (FE_Q(2)) element, integrated by the 3x3x3
Gauss-Legendre rule (QGauss(fe_degree + 1)), every node on the cube's
surface a Dirichlet dof.

Written from the element's and the bilinear form's definitions: the 1-D
quadratic Lagrange polynomials through 0, 1/2 and 1, their tensor products
in the x-fastest local order, and the cell matrices
sum_q JxW c(x_q) grad(phi_i).grad(phi_j) of fem.py's Operator, whose
Dirichlet convention (constrained rows and columns zero but for the
assembled diagonal) and apply this module's Operator keeps.  The geometry
is deal.II's default MappingQ1, trilinear through each cell's eight
vertices.  Where the program maps a cell through all of its Q2 nodes, the
two agree exactly on this mesh, whose cells are cubes: both maps are
affine there.  Plain PyTorch, float64 unless a lower precision is asked
for.
"""

from __future__ import annotations

import itertools
import math

import numpy as np
import torch

from portbench.reference.fem import Operator as Q1Operator
from portbench.reference.fem import _inverse_3x3, coefficient
from portbench.reference.hyper_cube_q1 import locate  # noqa: F401 (the grid lookup)

# 3-point Gauss-Legendre on [0, 1]
_GAUSS = (0.5 - 0.5 * math.sqrt(0.6), 0.5, 0.5 + 0.5 * math.sqrt(0.6))
_WEIGHTS = (5.0 / 18.0, 8.0 / 18.0, 5.0 / 18.0)
# the local index (x fastest, 3 a side) of each vertex v = vx + 2 vy + 4 vz
VERTICES = tuple(2 * (v & 1) + 6 * ((v >> 1) & 1) + 18 * (v >> 2)
                 for v in range(8))


def _quadratic(t: float):
    """Values and derivatives at t of the quadratic Lagrange polynomials
    through 0, 1/2 and 1."""
    return ((1 - t) * (1 - 2 * t), 4 * t * (1 - t), t * (2 * t - 1)), \
        (4 * t - 3, 4 - 8 * t, 4 * t - 1)


def _linear(t: float):
    """Values and derivatives at t of the linear Lagrange polynomials
    through 0 and 1."""
    return (1 - t, t), (-1.0, 1.0)


def tensor_tables(basis_1d):
    """(N, D, W) of the tensor-product element of ``basis_1d`` at the
    3x3x3 Gauss points q = qx + 3 qy + 9 qz: shape values N[q, i], reference
    gradients D[q, d, i] (i x fastest) and weights W[q], float64."""
    n1 = len(basis_1d(0.0)[0])
    tab = [basis_1d(t) for t in _GAUSS]
    n_loc = n1 ** 3
    N = np.zeros((27, n_loc))
    D = np.zeros((27, 3, n_loc))
    W = np.zeros(27)
    for q, i in itertools.product(range(27), range(n_loc)):
        qa = (q % 3, (q // 3) % 3, q // 9)
        ia = (i % n1, (i // n1) % n1, i // (n1 * n1))
        v = [tab[qa[d]][0][ia[d]] for d in range(3)]
        g = [tab[qa[d]][1][ia[d]] for d in range(3)]
        N[q, i] = v[0] * v[1] * v[2]
        for d in range(3):
            D[q, d, i] = g[d] * math.prod(v[e] for e in range(3) if e != d)
        W[q] = math.prod(_WEIGHTS[a] for a in qa)
    return N, D, W


def mesh(cfg: dict, n_refinements: int, device):
    """(nodes (n, 3) float64, cells (n_cells, 27) int64, constrained (n,)
    bool) on ``device``: the (2 * 2^r + 1)^3 grid of the cells' nodes,
    node ix + m iy + m^2 iz at (ix, iy, iz) / (2 * 2^r)."""
    k = 2 ** n_refinements
    m = 2 * k + 1
    i = torch.arange(m, device=device)
    iz, iy, ix = torch.meshgrid(i, i, i, indexing="ij")
    grid = torch.stack([ix, iy, iz], -1).reshape(-1, 3)
    nodes = grid.to(torch.float64) / (m - 1)
    constrained = ((grid == 0) | (grid == m - 1)).any(1)
    c = torch.arange(k, device=device)
    cz, cy, cx = (t.reshape(-1) for t in torch.meshgrid(c, c, c, indexing="ij"))
    corner = 2 * (cx + m * cy + m * m * cz)
    local = torch.tensor([(l % 3) + m * ((l // 3) % 3) + m * m * (l // 9)
                          for l in range(27)], device=device)
    return nodes, corner[:, None] + local[None, :], constrained


class Operator(Q1Operator):
    """fem.py's eliminated operator over Q2 cells (n_cells, 27), with the
    cell matrices of the triquadratic element at the 3x3x3 Gauss points.
    Chunks of 2^15 cells: a chunk's gradient table is 17.5 KB a cell in
    float64 (573 MB a chunk)."""

    def __init__(self, nodes, cells, constrained, material: str, device,
                 chunk: int = 1 << 15, store: bool = True):
        f64 = dict(dtype=torch.float64, device=torch.device(device))
        N1, D1, _ = tensor_tables(_linear)
        _, D2, W = tensor_tables(_quadratic)
        self._q2_tables = tuple(torch.as_tensor(t, **f64) for t in (N1, D1, D2, W))
        self._vertices = torch.tensor(VERTICES, device=torch.device(device))
        super().__init__(nodes, cells, constrained, material, device,
                         chunk=chunk, store=store)

    def _cell_matrices(self, c):
        """(A_loc, det) of the cells c (k, 27): (k, 27, 27) and (k, 27)."""
        N1, D1, D2, W = self._q2_tables
        xv = self.nodes[c[:, self._vertices]]                 # (k, 8, 3)
        J = torch.einsum("cva,qbv->cqab", xv, D1)            # dx_a / dt_b
        det, Jinv = _inverse_3x3(J)
        G = torch.einsum("cqba,qbi->cqai", Jinv, D2)         # J^-T grad
        xq = torch.einsum("cva,qv->cqa", xv, N1)
        s = W * det.abs() * coefficient(self.material, xq)
        return torch.einsum("cq,cqai,cqaj->cij", s, G, G), det

"""The yardstick of the matrix-free operators: the operations and bytes of
one apply of the sum-factorised Q_k operator, worked out from the mesh's
shapes, to be read against work.bound.

Frozen with the benchmark, as work.py is.  Each buffer the apply needs is
counted once, as the program stores it today: u in and y out, the
diagonal and the Dirichlet flags at the dofs, the per-cell metric
(n_q_1d^dim x dim x dim entries a cell) and the cells' dof indices; the
1-D tables are a few hundred bytes and left out.
"""

from __future__ import annotations


def sumfac_work(n: int, n_cells: int, n1: int, nq1: int, dim: int,
                vec_bytes: int, metric_bytes: int,
                index_bytes: int) -> tuple[int, int]:
    """(bytes, flops) of y = A u by sum factorisation on ``n_cells`` Q_k
    cells of ``n1`` = k + 1 nodes and ``nq1`` Gauss points a side over ``n``
    dofs.  Bytes: u, y and the diagonal at ``vec_bytes``, one flag byte a
    dof, the metric at ``metric_bytes`` and the cells at ``index_bytes``.
    Flops a cell: for each of the dim directions, dim 1-D contractions to the
    quadrature points (n1 multiply-adds an output) and dim back (nq1 an
    output), the dim x dim metric at each point, and the sums of the
    directions and of the cells at each node."""
    fwd = bwd = 0
    for d in range(dim):
        # contraction d + 1 of dim: d + 1 axes at the points, the rest at
        # the nodes (forward); the reverse going back
        fwd += n1 * nq1 ** (d + 1) * n1 ** (dim - d - 1)
        bwd += nq1 * n1 ** (d + 1) * nq1 ** (dim - d - 1)
    per_cell = (2 * dim * (fwd + bwd) + 2 * dim * dim * nq1 ** dim
                + dim * n1 ** dim)
    n_bytes = (3 * n * vec_bytes + n + n_cells * nq1 ** dim * dim * dim * metric_bytes
               + n_cells * n1 ** dim * index_bytes)
    return n_bytes, n_cells * per_cell

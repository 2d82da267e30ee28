"""The benchmark's yardstick: operations and bytes a layer's call needs,
worked out from the problem's shapes, and the published peaks of one H100.

Frozen with the benchmark, so that a later change to the program is read
against the same work.  Each input byte is counted once and each output
byte once, whatever an implementation reads again; an operator counts its
nonzeros (a symmetric one its upper triangle with the diagonal), not the
padding or the layout it is stored in.
"""

from __future__ import annotations

import math

import numpy as np

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W power limit
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS = 67e12


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """(seconds, "bytes" | "operations"): the least time the chip could take,
    the larger of bytes over the HBM rate and float32 operations over the
    float32 peak."""
    tb, to = bytes_moved / HBM_BYTES_PER_S, flops / F32_FLOPS
    return max(tb, to), ("bytes" if tb >= to else "operations")


def neighbour_pairs(grid) -> int:
    """Ordered (site, neighbour) pairs of the 27-point neighbourhood on a box
    of ``grid`` sites, each site with itself included."""
    return math.prod(3 * int(g) - 2 for g in grid)


def symmetric_half(nnz: int, n: int) -> int:
    """Upper triangle with the diagonal of a symmetric matrix of ``nnz``
    nonzeros and a full diagonal of ``n``."""
    return (nnz + n) // 2


def cube_stencil_nnz(nodes_per_dim: int) -> int:
    """Nonzeros of the Dirichlet-eliminated Q1 operator on a cube of
    ``nodes_per_dim``^3 nodes: the interior nodes couple with their interior
    neighbours, every boundary node keeps its diagonal alone."""
    n = nodes_per_dim ** 3
    interior = nodes_per_dim - 2
    return neighbour_pairs((interior,) * 3) + (n - interior ** 3)


def mesh_operator_nnz(cells: np.ndarray, constrained: np.ndarray) -> int:
    """Nonzeros of the Dirichlet-eliminated operator of a conforming mesh:
    pairs of free dofs that share a cell, plus every diagonal."""
    n = len(constrained)
    free = ~np.asarray(constrained, dtype=bool)
    c = np.asarray(cells, dtype=np.int64)
    both = free[c][:, :, None] & free[c][:, None, :]
    keys = (c[:, :, None] * n + c[:, None, :])[both]
    # the free diagonals are among the pairs; the constrained ones are added
    return int(len(np.unique(keys)) + (n - np.count_nonzero(free)))


def k2_work(n: int, half_nnz: int, nnz: int, degree: int, want_res: bool,
            coeff_bytes: int, vec_bytes: int) -> tuple[int, int]:
    """A Chebyshev smoothing step of ``degree`` on the fine operator (the
    pre-smoothing with the V-cycle residual when ``want_res``): the operator
    once, x, b and the inverse diagonal in, x out (and the residual out);
    ``degree`` applies plus the residual's, 8 flops a point per degree for
    the recurrence."""
    applies = degree + int(want_res)
    return (half_nnz * coeff_bytes + vec_bytes * n * (4 + int(want_res)),
            applies * 2 * nnz + 8 * degree * n)


def tail_subcycle_work(n1: int, n2: int, a1_nnz: int, r1_nnz: int, degree: int,
                       nss: int, coeff_bytes: int,
                       vec_bytes: int) -> tuple[int, int]:
    """The level-1 sub-cycle of a three-level V-cycle (level-1 smoothing,
    restriction to level 2, the dense coarse solve, prolongation, level-1
    smoothing): the level-1 operator's upper triangle, the level-1 -> 2
    weights and the coarse inverse's upper triangle once at ``coeff_bytes``,
    the level-1 inverse diagonal, b1 in and x1 out at ``vec_bytes``.
    Applies of A_1: degree - 1 in the first pre-smoothing step (from x = 0),
    degree in each further one, one for the residual, degree in each
    post-smoothing step."""
    weights = symmetric_half(a1_nnz, n1) + r1_nnz + n2 * (n2 + 1) // 2
    applies = (degree - 1) + (nss - 1) * degree + 1 + nss * degree
    return (weights * coeff_bytes + 3 * n1 * vec_bytes,
            applies * 2 * a1_nnz + 4 * r1_nnz + 2 * n2 * n2)


def ell_work(nnz: int, n_rows: int, n_cols: int, val_bytes: int,
             idx_bytes: int, vec_bytes: int) -> tuple[int, int]:
    """y = A x of a sparse matrix: its stored nonzeros' values and column
    indices once, x and y once; 2 flops a nonzero."""
    return nnz * (val_bytes + idx_bytes) + (n_rows + n_cols) * vec_bytes, 2 * nnz


def cube_levels(n_refinements: int, block: int, n_ev: int, n_evd: int) -> dict:
    """Sizes of the three-level hierarchy on the Q1 cube of 2^r cells a side
    with ``block``^3 agglomerates at both coarsenings: the level-1 grid of
    agglomerates (n_ev components each), the level-2 grid of super
    agglomerates (n_evd each), A_1's nonzeros (the 27-point block
    neighbourhood) and R_1's (each level-1 dof lies in one super)."""
    cells = 2 ** n_refinements
    g1 = cells // block
    g2 = g1 // block
    n1 = g1 ** 3 * n_ev
    n2 = g2 ** 3 * n_evd
    return {"n0": (cells + 1) ** 3, "n1": n1, "n2": n2,
            "a0_nnz": cube_stencil_nnz(cells + 1),
            "a1_nnz": neighbour_pairs((g1,) * 3) * n_ev * n_ev,
            "r1_nnz": n1 * n_evd}

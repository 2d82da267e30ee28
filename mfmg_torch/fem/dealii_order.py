"""deal.II cell and dof orderings for structured hyper_cube meshes.

Port of mfmg_tpu/fem/dealii_order.py.  The reference inherits deal.II's
orderings wherever an ordering matters:
  * active cells iterate in refinement-tree order: for hyper_cube +
    refine_global(r), Morton (Z) order over the 2^r-per-dim cell grid,
    children numbered x fastest (child = ix + 2*iy + 4*iz);
  * DoFHandler numbering is first touch over that cell iteration, local
    vertices in deal.II order (x fastest); the sequential Gauss-Seidel
    goldens (test_hierarchy.cc:343-356) measure rates in it.

The meshes here number dofs x-fastest lexicographically; these helpers give
deal.II's permutations on top of that layout (the "block_dealii" partitioner,
the lexicographic Gauss-Seidel smoother's ``ordering="dealii"``).
"""

from __future__ import annotations

import numpy as np

from mfmg_torch.fem.mesh import Mesh


def _check_structured_pow2(mesh: Mesh) -> int:
    if not mesh.is_structured:
        raise ValueError("deal.II ordering is defined for structured "
                         "hyper_cube meshes only")
    shape = mesh.structured_shape
    nc = shape[0]
    if any(s != nc for s in shape):
        raise ValueError("deal.II ordering needs equal cells per dimension "
                         f"(refine_global semantics); got {shape}")
    r = int(nc).bit_length() - 1
    if 2 ** r != nc:
        raise ValueError(f"cells per dim must be a power of two, got {nc}")
    return r


def dealii_cell_order(mesh: Mesh) -> np.ndarray:
    """The mesh's cell ids in deal.II's active-cell iteration order:
    mesh.cells[order] walks the cells as deal.II's cell iterator does after
    refine_global (Morton order, x the least significant axis within each
    refinement level)."""
    r = _check_structured_pow2(mesh)
    mi = mesh.cell_multi_index()          # (n_cells, dim), x first
    key = np.zeros(mesh.n_cells, dtype=np.int64)
    for level in range(r - 1, -1, -1):
        child = np.zeros(mesh.n_cells, dtype=np.int64)
        for d in range(mesh.dim):
            child += ((mi[:, d] >> level) & 1) << d
        key = key * (2 ** mesh.dim) + child
    return np.argsort(key, kind="stable")


def dealii_dof_numbering(mesh: Mesh) -> np.ndarray:
    """deal.II dof number of each dof of a Q1 structured hyper_cube:
    dealii_of[dof] is its first-touch rank over the cells in deal.II order,
    local vertices x fastest (the local order here too, for Q1)."""
    if mesh.degree != 1:
        raise NotImplementedError(
            "deal.II numbering implemented for Q1 (the reference goldens' "
            "fe_degree); FE_Q<k>'s vertex/line/quad/hex block order is not "
            "reproduced for k > 1")
    seq = mesh.cells[dealii_cell_order(mesh)].reshape(-1)
    _, first_pos = np.unique(seq, return_index=True)   # by dof id
    dealii_of = np.empty(mesh.n_nodes, dtype=np.int64)
    dealii_of[np.argsort(first_pos, kind="stable")] = np.arange(mesh.n_nodes)
    return dealii_of

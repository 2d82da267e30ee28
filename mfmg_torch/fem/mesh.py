"""Meshes and DoF numbering (structured hyper_cube path).

Port of the structured part of mfmg_tpu/fem/mesh.py, which replaces the
deal.II Triangulation/DoFHandler subset the reference tests use (reference
tests/laplace.hpp:88-152: hyper_cube + refine_global + boundary id 1
everywhere + optional distort_random).

A mesh is plain host data: node coordinates, cell->dof connectivity, and a
Dirichlet-boundary dof mask.  DoFs are geometric Lagrange nodes (continuous
Q_k).  The structured metadata (cells per dim, degree) lets the stencil and
structured-transfer paths use closed-form index maps.  Ball, adaptive and
renumbered meshes are not ported yet (ROADMAP Queue 1, Slice E).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from mfmg_torch.fem.reference import gauss_lobatto_points_1d, reference_element


@dataclasses.dataclass
class Mesh:
    dim: int
    degree: int
    nodes: np.ndarray            # (n_nodes, dim) float64
    cells: np.ndarray            # (n_cells, n_loc) int32 global dof ids, lexicographic local order
    boundary_dofs: np.ndarray    # (n_nodes,) bool — Dirichlet (boundary id 1) dofs
    structured_shape: tuple | None = None   # cells per dim, e.g. (4, 4, 4)

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_cells(self) -> int:
        return self.cells.shape[0]

    @property
    def n_loc(self) -> int:
        return self.cells.shape[1]

    @property
    def is_structured(self) -> bool:
        return self.structured_shape is not None

    @property
    def constrained_mask(self) -> np.ndarray:
        """Dofs with constrained rows (Dirichlet; hanging-node meshes are not
        ported, so nothing else is constrained)."""
        return self.boundary_dofs

    def cell_multi_index(self) -> np.ndarray:
        """(n_cells, dim) integer cell coordinates for structured meshes."""
        if not self.is_structured:
            raise ValueError("cell_multi_index needs a structured mesh")
        shape = self.structured_shape
        idx = np.arange(self.n_cells)
        out = np.empty((self.n_cells, self.dim), dtype=np.int64)
        for d in range(self.dim):
            out[:, d] = idx % shape[d]
            idx = idx // shape[d]
        return out


def hyper_cube(dim: int, n_refinements: int, degree: int = 1,
               distort_random: bool = False, distort_factor: float = 0.1,
               seed: int = 0) -> Mesh:
    """Unit cube [0,1]^dim refined n_refinements times (2^n cells per dim),
    as dealii GridGenerator::hyper_cube + refine_global
    (reference tests/laplace.hpp:91-97), all boundary faces Dirichlet."""
    nc = 2 ** n_refinements
    return structured_cube(dim, (nc,) * dim, degree=degree,
                           distort_random=distort_random,
                           distort_factor=distort_factor, seed=seed)


def structured_cube(dim: int, cells_per_dim: tuple, degree: int = 1,
                    distort_random: bool = False, distort_factor: float = 0.1,
                    seed: int = 0,
                    lengths: tuple | None = None) -> Mesh:
    """Structured grid of cells_per_dim Q_degree cells on [0,L]^dim."""
    k = degree
    nc = tuple(int(c) for c in cells_per_dim)
    if lengths is None:
        lengths = (1.0,) * dim
    n1 = tuple(k * c + 1 for c in nc)          # nodes per dim
    ref = reference_element(dim, degree)
    gll = gauss_lobatto_points_1d(k)
    axes = []
    for d in range(dim):
        h = lengths[d] / nc[d]
        coords = np.empty(n1[d])
        for c in range(nc[d]):
            coords[c * k: (c + 1) * k + 1] = (c + gll) * h
        axes.append(coords)
    grids = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([g.flatten(order="F") for g in grids], axis=-1)

    # Cell connectivity, x fastest for both cells and local dofs.
    strides = np.cumprod((1,) + n1[:-1])       # node id strides per dim
    n_cells = int(np.prod(nc))
    cell_idx = np.arange(n_cells)
    cell_mi = np.empty((n_cells, dim), dtype=np.int64)
    tmp = cell_idx.copy()
    for d in range(dim):
        cell_mi[:, d] = tmp % nc[d]
        tmp //= nc[d]
    lm = ref.local_multi_index                  # (n_loc, dim)
    cells = np.zeros((n_cells, ref.n_loc), dtype=np.int64)
    for d in range(dim):
        cells += (cell_mi[:, None, d] * k + lm[None, :, d]) * strides[d]

    # Dirichlet boundary: any coordinate index at 0 or n1-1.
    node_idx = np.arange(int(np.prod(n1)))
    boundary = np.zeros(len(node_idx), dtype=bool)
    tmp = node_idx.copy()
    for d in range(dim):
        md = tmp % n1[d]
        boundary |= (md == 0) | (md == n1[d] - 1)
        tmp //= n1[d]

    if distort_random:
        # deal.II GridTools::distort_random semantics: every interior vertex
        # moves by exactly factor * (shortest adjacent edge) in a random
        # direction (same numpy stream as mfmg_tpu)
        rng = np.random.default_rng(seed)
        h_min = min(lengths[d] / nc[d] for d in range(dim))
        shift = rng.uniform(-1.0, 1.0, size=nodes.shape)
        norm = np.linalg.norm(shift, axis=1, keepdims=True)
        shift *= distort_factor * h_min / np.where(norm > 0, norm, 1.0)
        nodes = nodes + (~boundary)[:, None] * shift

    return Mesh(dim=dim, degree=degree, nodes=nodes,
                cells=cells.astype(np.int32), boundary_dofs=boundary,
                structured_shape=nc)

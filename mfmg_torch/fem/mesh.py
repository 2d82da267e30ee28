"""Meshes and DoF numbering.

Port of mfmg_tpu/fem/mesh.py, which replaces the deal.II
Triangulation/DoFHandler subset the reference tests use (reference
tests/laplace.hpp:88-152: hyper_cube/hyper_ball + refine_global + boundary
id 1 everywhere + optional distort_random).

A mesh is plain host data: node coordinates, cell->dof connectivity, and a
Dirichlet-boundary dof mask.  DoFs are geometric Lagrange nodes (continuous
Q_k).  The structured hyper_cube keeps its metadata (cells per dim, degree)
so the stencil and structured-transfer paths can use closed-form index
maps; ball and adaptive meshes (``hyper_ball``, ``from_cell_complex``,
fem/adaptive.py) are unstructured and go through the generic arrays.
Renumbered meshes (``renumber_dofs``) are not ported yet (ROADMAP Queue 1).
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
    # Hanging-node constraints of a 1-irregular adaptive mesh (Q1 only);
    # None on conforming meshes.  See fem/adaptive.py.
    hanging: "HangingConstraints | None" = None

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
        """Dofs with constrained rows in the condensed system: Dirichlet plus
        hanging slaves.  The AMGe setup and solvers treat both identically
        (identity rows, untouched by the V-cycle); hanging values are
        recovered by ``LaplaceProblem.distribute`` after the solve."""
        if self.hanging is None:
            return self.boundary_dofs
        return self.boundary_dofs | self.hanging.slave_mask(self.n_nodes)

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


def hyper_ball(dim: int, n_refinements: int, degree: int = 1,
               radius: float = 1.0,
               distort_random: bool = False, distort_factor: float = 0.1,
               seed: int = 0) -> Mesh:
    """Ball mesh à la dealii::GridGenerator::hyper_ball + refine_global
    (reference tests/laplace.hpp:92-93): 5 (2D) / 7 (3D) coarse cells refined
    with spherical projection of new boundary points."""
    from mfmg_torch.fem.ball import hyper_ball_base, refine_ball

    verts, cells_v = hyper_ball_base(dim, radius)
    for _ in range(n_refinements):
        verts, cells_v = refine_ball(verts, cells_v, radius)
    mesh = from_cell_complex(verts, cells_v, degree)
    if distort_random:
        # deal.II distort_random semantics (see structured_cube): exact-length
        # shift factor * (shortest adjacent edge) in a random direction.  The
        # per-vertex shortest adjacent edge is approximated by the cell-min
        # first-edge length over cells touching the vertex.
        rng = np.random.default_rng(seed)
        edge = np.linalg.norm(mesh.nodes[mesh.cells[:, 1]] - mesh.nodes[mesh.cells[:, 0]], axis=1)
        h_min = edge.min()
        shift = rng.uniform(-1.0, 1.0, size=mesh.nodes.shape)
        norm = np.linalg.norm(shift, axis=1, keepdims=True)
        shift *= distort_factor * h_min / np.where(norm > 0, norm, 1.0)
        mesh.nodes = mesh.nodes + (~mesh.boundary_dofs)[:, None] * shift
    return mesh


def from_cell_complex(verts: np.ndarray, cells_v: np.ndarray, degree: int = 1,
                      interior_faces: set | None = None) -> Mesh:
    """Build a Mesh (Q_degree dofs) from a vertex/hex-cell complex.

    Higher-order nodes are placed by the multilinear (MappingQ1-equivalent,
    deal.II's default) map of the cell vertices and deduplicated by
    coordinate hashing; Dirichlet dofs are the nodes on boundary faces (faces
    belonging to exactly one cell — all boundary gets id 1, laplace.hpp:100-108).

    interior_faces: sorted-vertex-tuple facets that are interior despite
    appearing in only one cell — the hanging interfaces of a 1-irregular
    adaptive complex (see fem/adaptive.py)."""
    dim = verts.shape[1]
    n_cells = len(cells_v)
    k = degree
    ref = reference_element(dim, k)

    if k == 1:
        nodes = np.asarray(verts, dtype=float)
        cells = np.asarray(cells_v, dtype=np.int32)
    else:
        # multilinear map of reference support points
        corners = verts[cells_v]                       # (c, 2^dim, dim)
        pts = ref.nodes                                # (n_loc, dim) in [0,1]^dim
        w = np.ones((ref.n_loc, 2 ** dim))
        for ci in range(2 ** dim):
            corner = [(ci >> d) & 1 for d in range(dim)]
            for d in range(dim):
                t = pts[:, d]
                w[:, ci] *= t if corner[d] else (1.0 - t)
        phys = np.einsum("lc,gcd->gld", w, corners)    # (c, n_loc, dim)
        flat = phys.reshape(-1, dim)
        key = np.round(flat / 1e-10).astype(np.int64)
        uniq, inv = np.unique(key, axis=0, return_inverse=True)
        # representative coordinates
        nodes = np.zeros((len(uniq), dim))
        nodes[inv] = flat
        cells = inv.reshape(n_cells, ref.n_loc).astype(np.int32)

    # boundary faces -> boundary dofs
    lm = ref.local_multi_index
    face_nodes = [np.nonzero(lm[:, d] == side)[0]
                  for d in range(dim) for side in (0, k)]
    boundary = np.zeros(len(nodes), dtype=bool)
    ci, fi = boundary_faces(cells_v, interior_faces)
    for f, fn in enumerate(face_nodes):
        boundary[cells[ci[fi == f]][:, fn]] = True

    return Mesh(dim=dim, degree=k, nodes=np.asarray(nodes, dtype=float),
                cells=cells, boundary_dofs=boundary, structured_shape=None)


def boundary_faces(cells_v: np.ndarray, interior_faces: set | None = None):
    """(cell, local face) index pairs of the faces that belong to one cell
    only and are not in interior_faces, in cell-major order: the
    reference's face count (mfmg_tpu/fem/mesh.py:155-166) as one sort of
    the sorted face-vertex keys."""
    from mfmg_torch.fem.ball import _cell_faces
    cells_v = np.asarray(cells_v, dtype=np.int64)
    faces = np.asarray(_cell_faces(int(np.log2(cells_v.shape[1]))))
    keys = np.sort(cells_v[:, faces], axis=2).reshape(-1, faces.shape[1])
    _, inv, counts = np.unique(keys, axis=0, return_inverse=True,
                               return_counts=True)
    once = counts[inv.reshape(-1)] == 1
    if interior_faces:
        for r in np.nonzero(once)[0]:
            once[r] = tuple(keys[r].tolist()) not in interior_faces
    return np.divmod(np.nonzero(once)[0], len(faces))


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

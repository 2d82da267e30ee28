"""Agglomerate partitioning of mesh cells.

Port of mfmg_tpu/amge/agglomeration.py, the analog of
AMGe::build_agglomerates (reference common/amge.templates.hpp:51-85):
  * "block": group nx x ny x nz neighbouring cells per agglomerate, the
    reference's x->y->z walk (amge.templates.hpp:412-499).  On a structured
    grid it is a closed-form index computation (the same partition); on an
    unstructured mesh (ball, adaptive) the walk itself, through each cell's
    local x+/y+/z+ faces (``_block_walk_unstructured``);
  * "metis": the multilevel graph partitioner of amge/graph_partition.py
    over the cell connectivity graph (amge.templates.hpp:501-594);
  * "zoltan"/"rcb": recursive coordinate bisection of the cell centroids
    (Zoltan's default, balanced parts).
  * "block_dealii": the walk seeded in deal.II's cell iteration order
    (fem/dealii_order.py), which gives the reference's literal
    agglomerate-id goldens (test_agglomerate.cc:79-288); structured
    power-of-two hyper_cubes only.
The ids are those of mfmg_tpu on the same mesh.
"""

from __future__ import annotations

import numpy as np

from mfmg_torch.fem.mesh import Mesh
from mfmg_torch.fem.reference import reference_element


def build_agglomerates(mesh: Mesh, agg_cfg) -> np.ndarray:
    """Returns (n_cells,) agglomerate ids in [0, n_agg)."""
    if agg_cfg.partitioner == "block":
        return build_agglomerates_block(mesh, agg_cfg.block_dims(mesh.dim))
    if agg_cfg.partitioner == "block_dealii":
        from mfmg_torch.fem.dealii_order import dealii_cell_order
        return _block_walk_unstructured(mesh, agg_cfg.block_dims(mesh.dim),
                                        seed_order=dealii_cell_order(mesh))
    if agg_cfg.partitioner == "metis":
        from mfmg_torch.amge.graph_partition import build_agglomerates_multilevel
        return build_agglomerates_multilevel(mesh, agg_cfg.n_agglomerates)
    if agg_cfg.partitioner in ("zoltan", "rcb"):
        return build_agglomerates_rcb(mesh, agg_cfg.n_agglomerates)
    raise ValueError(f"unknown partitioner {agg_cfg.partitioner!r}")


def build_agglomerates_block(mesh: Mesh, block_dims) -> np.ndarray:
    if not mesh.is_structured:
        return _block_walk_unstructured(mesh, block_dims)
    nc = mesh.structured_shape
    mi = mesh.cell_multi_index()                     # (n_cells, dim)
    agg = np.zeros(mesh.n_cells, dtype=np.int64)
    stride = 1
    for d in range(mesh.dim):
        agg += (mi[:, d] // block_dims[d]) * stride
        stride *= -(-nc[d] // block_dims[d])
    return agg


def _cell_centroids(mesh: Mesh) -> np.ndarray:
    return mesh.nodes[mesh.cells].mean(axis=1)


def _face_keys(mesh: Mesh) -> np.ndarray:
    """(n_cells, 2*dim, n_face_nodes) sorted dof ids of each local face, in
    deal.II's face order x-, x+, y-, y+, z-, z+."""
    k = mesh.degree
    lm = reference_element(mesh.dim, k).local_multi_index
    face_local = np.stack([np.nonzero(lm[:, d] == side)[0]
                           for d in range(mesh.dim) for side in (0, k)])
    return np.sort(mesh.cells[:, face_local].astype(np.int64), axis=2)


def face_neighbors(mesh: Mesh) -> np.ndarray:
    """(n_cells, 2*dim) neighbour across each local face, -1 at the boundary
    (and across the coarse side of a hanging interface, whose faces no
    other cell shares whole).

    Face order matches deal.II (amge.templates.hpp:416-420): x-,x+,y-,y+,z-,z+
    in the CELL-LOCAL frame.  A face shared by exactly two cells pairs them,
    as the reference's cell loop does (mfmg_tpu/amge/agglomeration.py:
    58-83); a face in more than two cells (no mesh of this package makes
    one) raises ValueError."""
    keys = _face_keys(mesh)
    n_cells, n_faces = keys.shape[:2]
    flat = keys.reshape(n_cells * n_faces, -1)
    _, inv, counts = np.unique(flat, axis=0, return_inverse=True,
                               return_counts=True)
    inv = inv.reshape(-1)
    if counts.max(initial=0) > 2:
        raise ValueError(f"a face is shared by {int(counts.max())} cells; "
                         f"face_neighbors pairs at most two")
    order = np.argsort(inv, kind="stable")
    sk = inv[order]
    pair = np.nonzero(sk[1:] == sk[:-1])[0]
    a, b = order[pair], order[pair + 1]
    nbrs = -np.ones(n_cells * n_faces, dtype=np.int64)
    nbrs[a] = b // n_faces
    nbrs[b] = a // n_faces
    return nbrs.reshape(n_cells, n_faces)


def _block_walk_unstructured(mesh: Mesh, block_dims,
                             seed_order=None) -> np.ndarray:
    """The reference's x->y->z block walk, verbatim semantics
    (amge.templates.hpp:422-494): seed at the first unassigned cell in cell
    order, then walk nx cells through each cell's local x+ face, stepping the
    row start through y+ and the plane start through z+.  Cells are
    (re)marked unconditionally during a walk, as the reference's
    set_user_index does.  seed_order: the cell order of the seeds (deal.II's
    for "block_dealii"), the mesh's own by default."""
    dim = mesh.dim
    nbrs = face_neighbors(mesh).tolist()
    X_P, Y_P, Z_P = 1, 3, 5                     # local face ids (x+, y+, z+)
    n_cells = mesh.n_cells
    agg = [0] * n_cells                         # 0 = unassigned (reference convention)
    current = 0
    nx, ny = block_dims[0], block_dims[1]
    d3 = block_dims[2] if dim == 3 else 1
    for c0 in (range(n_cells) if seed_order is None else seed_order.tolist()):
        if agg[c0] != 0:
            continue
        current += 1
        agg[c0] = current
        z_cell = c0
        for _k in range(d3):
            y_cell = z_cell
            for _j in range(ny):
                cell = y_cell
                for _i in range(nx):
                    agg[cell] = current
                    nxt = nbrs[cell][X_P]
                    if nxt < 0:
                        break
                    cell = nxt
                nxt = nbrs[y_cell][Y_P]
                if nxt < 0:
                    break
                y_cell = nxt
            if dim == 3:
                nxt = nbrs[z_cell][Z_P]
                if nxt < 0:
                    break
                z_cell = nxt
    # compress ids (stolen cells can empty an agglomerate) and 0-base
    _, agg = np.unique(np.asarray(agg, dtype=np.int64), return_inverse=True)
    return agg.reshape(-1)


def build_agglomerates_rcb(mesh: Mesh, n_agglomerates: int) -> np.ndarray:
    """Recursive coordinate bisection into n_agglomerates balanced parts."""
    centroids = _cell_centroids(mesh)
    ids = np.arange(mesh.n_cells)
    parts = [(ids, n_agglomerates)]
    out = np.zeros(mesh.n_cells, dtype=np.int64)
    next_id = 0
    while parts:
        idx, k = parts.pop()
        if k <= 1:
            out[idx] = next_id
            next_id += 1
            continue
        pts = centroids[idx]
        spread = pts.max(axis=0) - pts.min(axis=0)
        d = int(np.argmax(spread))
        order = np.argsort(pts[:, d], kind="stable")
        k_left = k // 2
        split = int(round(len(idx) * k_left / k))
        parts.append((idx[order[:split]], k_left))
        parts.append((idx[order[split:]], k - k_left))
    return out
